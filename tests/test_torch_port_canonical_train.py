"""Parity of the torch port's canonical-stage training with the JAX package,
on the CPU: train-mode BatchNorm and its running statistics against Flax's,
the dropout's generator, `canonical_stage_loss` (every key, `only_seg`,
the eval-tail mask) and its gradients, one whole `make_canonical_steps`
train step at identical weights, and a loss that falls.

Shapes are small: the 48-vertex ring garment (`synthetic(6, 8)`), a
200-vertex synthetic body, B=3, T=1, N=2048 (2048 is the smallest N that
the backbone's 1024-point SA1 and the 512-point garment SA1 take). The
dropout is held out on both sides for parity: a Flax method interceptor
returns the input of every `nn.Dropout`, and the port's dropout gets p=0.
The same numpy inputs go to both packages; each test states its
tolerance.

The whole-step test compares in float64 (JAX's x64 mode; the port's model
and batch in double), against JAX's step compiled without XLA's algebraic
simplifier, for three measured reasons:
  * on the CPU, XLA's `algsimp` pass changes the jitted backward of the
    train-mode SA stages: an SA1 module's parameter gradients move by
    4.2e-4 relative L2 between `jax.jit(jax.grad(f))` and `jax.grad(f)`,
    the backbone's by 14 in float64; central finite differences side with
    the eager gradient and with the port; with `algsimp` disabled the
    jitted gradient is the eager one (`tests/check_jax_algsimp.py`);
  * the train-mode BatchNorms (Flax's E[x^2] - E[x]^2 variance) leave
    these gradients ill-conditioned in fp32 at this size: the port's own
    fp32 gradients differ from its float64 ones by up to 9.5e-4 (same
    script);
  * B=3, not 2: the PCA head's BatchNorm over two rows has a gradient of
    order eps / d^2, which amplifies the float32 casts inside JAX's model
    (`as32`, the PCA inverse transform) beyond these tolerances.
Index decisions (FPS, ball query, 3-NN) stay fp32 in JAX, so the point
cloud lies on a 1/256 grid, where fp32 and float64 distances are exact and
both packages choose the same indices.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn
from flax import traverse_util

from garment4d_tpu import losses as JL
from garment4d_tpu import smpl as jsmpl
from garment4d_tpu.data.synthetic import make_batch as jmake_batch
from garment4d_tpu.models import CanonicalGarmentModel as JCanonical
from garment4d_tpu.models import GarmentAssets as JAssets
from garment4d_tpu.train.step import make_state_for as jmake_state_for

from garment4d_tpu_torch import losses as TL
from garment4d_tpu_torch.models import CanonicalGarmentModel
from garment4d_tpu_torch.models import GarmentAssets as TAssets
from garment4d_tpu_torch.nn import BatchNorm, Dropout
from garment4d_tpu_torch.train import make_canonical_steps, make_state_for
from garment4d_tpu_torch.train.convert import flax_to_torch
from torch_port_threads import one_torch_thread  # noqa: F401

B, T, N, NB = 3, 1, 2048, 200
LR = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy()


def _rel_l2(got, want) -> float:
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


def _no_dropout(next_fun, args, kwargs, context):
    """Flax method interceptor: every `nn.Dropout` returns its input."""
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.fixture(scope="module")
def jassets():
    return JAssets.synthetic(num_rings=6, ring_size=8)


@pytest.fixture(scope="module")
def jbody():
    return jsmpl.synthetic_smpl(num_verts=NB)


# ---- BatchNorm and dropout ---------------------------------------------------


@pytest.mark.parametrize("rows", [1, 37])
def test_batchnorm_train_matches_flax(rows, rng):
    """Three train-mode updates from the same parameters and inputs: the
    outputs, the running statistics (Flax's biased variance, momentum 0.9)
    and the input's and affine parameters' gradients against Flax's
    `BatchNorm` (fp32 reductions in another order: rtol 1e-5 / atol 1e-5
    on the outputs and statistics, 1e-4 on the gradients). A batch of one
    row normalises to the bias, as Flax does; torch's own BatchNorm refuses
    it."""
    C = 5
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    xs = [(rng.randn(rows, C) * 2 + 1).astype(np.float32) for _ in range(3)]
    scale = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    stats = {"mean": (0.1 * rng.randn(C)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
    cot = rng.randn(rows, C).astype(np.float32)
    tbn = BatchNorm(C).train()
    tbn.load_state_dict({"weight": _t(scale), "bias": _t(bias), "running_mean": _t(stats["mean"]),
                         "running_var": _t(stats["var"]), "num_batches_tracked": torch.tensor(0)})
    jstats = {k: jnp.asarray(v) for k, v in stats.items()}
    for x in xs:
        def f(x_, s_, b_, st=jstats):
            return jbn.apply({"params": {"scale": s_, "bias": b_}, "batch_stats": st},
                             x_, mutable=["batch_stats"])
        (jy, mutated), vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
        jgrads = vjp((jnp.asarray(cot), jax.tree_util.tree_map(jnp.zeros_like, mutated)))
        jstats = mutated["batch_stats"]
        tx = _t(x).requires_grad_(True)
        ty = tbn(tx)
        tgrads = torch.autograd.grad(ty, [tx, tbn.weight, tbn.bias], _t(cot))
        np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)
        for g, w in zip(tgrads, jgrads):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tbn.running_mean), np.asarray(jstats["mean"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tbn.running_var), np.asarray(jstats["var"]),
                               rtol=1e-5, atol=1e-5)
    if rows == 1:
        np.testing.assert_array_equal(_np(ty), np.broadcast_to(bias, (1, C)))


def test_dropout_seeded_and_scaled():
    """The same seed draws the same mask; kept elements are scaled by 2 at
    p=0.5, about half are kept; eval mode and p=0 are the identity; training
    without a generator raises."""
    x = torch.rand(64, 32) + 0.5
    drop = Dropout(0.5).train()
    a = drop(x, torch.Generator().manual_seed(7))
    b = drop(x, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    kept = a != 0
    torch.testing.assert_close(a[kept], 2 * x[kept], rtol=0, atol=0)
    assert 0.4 < kept.float().mean().item() < 0.6
    assert not torch.equal(a, drop(x, torch.Generator().manual_seed(8)))
    with pytest.raises(ValueError, match="torch.Generator"):
        drop(x, None)
    assert drop.eval()(x, None) is x
    assert Dropout(0.0).train()(x, None) is x


# ---- canonical_stage_loss ------------------------------------------------------


def _loss_case(jassets, jbody, rng):
    """A random CanonicalOutput near the ground truth and its batch: three
    sequences of two frames of 64 points."""
    V = jassets.num_verts
    batch = jmake_batch(jassets, jbody, batch_size=3, T=2, npoints=64, seed=2)
    batch = {k: np.asarray(v) for k, v in batch.items()}
    logits = rng.randn(3 * 2, 64, 7).astype(np.float32)
    coeff = (batch["pca_coeff"] + 0.3 * rng.randn(*batch["pca_coeff"].shape)).astype(np.float32)
    tpose = (batch["garment_template_vertices"]
             + 0.02 * rng.randn(3, V, 3)).astype(np.float32)
    return batch, [logits, coeff, tpose]


def _canonical_output(logits, coeff, tpose):
    return types.SimpleNamespace(backbone=types.SimpleNamespace(sem_logits=logits),
                                 pca_coeff=coeff, tpose_garment=tpose)


@pytest.mark.parametrize("only_seg,masked", [(False, False), (False, True), (True, False)])
def test_canonical_stage_loss(jassets, jbody, rng, only_seg, masked):
    """Every key of JAX's `canonical_stage_loss`, with `only_seg` and with
    the eval-tail mask, and the total loss's gradient w.r.t. the logits,
    the PCA coefficients and the T-pose garment (through the 1-NN, the
    vertex normals and the cotangent Laplacian): fp32 roundoff, rtol 1e-5 /
    atol 1e-6 on the values, rtol 1e-4 / atol 1e-6 on the gradients."""
    batch, leaves_np = _loss_case(jassets, jbody, rng)
    valid = np.array([1.0, 0.0, 1.0], np.float32) if masked else None
    weights = JL.LossWeights()

    def jloss(leaves):
        return JL.canonical_stage_loss(
            _canonical_output(*leaves), {k: jnp.asarray(v) for k, v in batch.items()},
            jassets.faces_tri, jbody.faces, weights, only_seg=only_seg,
            valid=None if valid is None else jnp.asarray(valid))

    def total(ls):
        losses = jloss(ls)
        return losses["total_loss"], losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        [jnp.asarray(a) for a in leaves_np])
    leaves = [_t(a).requires_grad_(True) for a in leaves_np]
    got = TL.canonical_stage_loss(
        _canonical_output(*leaves), {k: _t(v) for k, v in batch.items()},
        jassets.faces_tri, jbody.faces, TL.LossWeights(), only_seg=only_seg,
        valid=None if valid is None else _t(valid))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    if not only_seg:
        assert float(got["interpenetration_loss"].detach()) > 0
        assert float(got["garment_lap_loss"].detach()) > 0
    tgrads = torch.autograd.grad(got["total_loss"], leaves, allow_unused=True)
    for name, g, w in zip(("logits", "pca_coeff", "tpose"), tgrads, jgrads):
        if only_seg and name != "logits":
            assert g is None
            continue
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-6, err_msg=name)


# ---- the whole train step ---------------------------------------------------------


@pytest.fixture(scope="module")
def step_case(jassets, jbody):
    """JAX's canonical train step (`make_canonical_steps`' loss, its
    gradients, the Adam update and the new batch statistics) in float64 at
    random weights, dropout intercepted, in one compile; the batch and the
    weights the port gets."""
    batch = {k: np.asarray(v) for k, v in
             jmake_batch(jassets, jbody, batch_size=B, T=T, npoints=N, seed=5).items()}
    batch["pcd"] = (np.round(batch["pcd"] * 256) / 256).astype(np.float32)
    model = JCanonical(assets=jassets)
    shapes = jax.eval_shape(lambda p: model.init(jax.random.PRNGKey(0), p, train=False),
                            batch["pcd"])
    rng = np.random.RandomState(5)
    flat = {}
    for coll in ("params", "batch_stats"):
        for k, v in traverse_util.flatten_dict(shapes[coll], sep="/").items():
            if k.endswith("kernel"):
                a = rng.randn(*v.shape) * np.sqrt(2.0 / v.shape[0])
            elif k.endswith("bn/var"):
                a = rng.uniform(0.5, 1.5, v.shape)
            elif k.endswith("bn/scale"):
                a = 1.0 + 0.1 * rng.randn(*v.shape)
            else:
                a = 0.1 * rng.randn(*v.shape)
            flat[f"{coll}/{k}"] = a.astype(np.float32)

    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else jnp.asarray(a),
                tree)

        variables = f64(traverse_util.unflatten_dict(flat, sep="/"))
        variables["constants"] = f64({k: getattr(jassets, k) for k in
                                      ("pca_components", "pca_mean", "pca_scale")})
        state = jmake_state_for(model, variables, jassets, lr=LR)
        jbatch = dict(f64(batch), pcd=jnp.asarray(batch["pcd"]))  # geometry stays fp32

        def step(state, batch):
            def loss_fn(params):  # make_canonical_steps' loss_fn
                out, mutated = model.apply(
                    {"params": params, "batch_stats": state.batch_stats,
                     "constants": {k: v for k, v in state.constants.items()
                                   if k != "loss_lap_adj"}},
                    batch["pcd"], train=True, rngs={"dropout": jax.random.PRNGKey(1)},
                    mutable=["batch_stats"])
                losses = JL.canonical_stage_loss(out, batch, jassets.faces_tri, jbody.faces,
                                                 JL.LossWeights())
                return losses["total_loss"], (losses, mutated["batch_stats"])

            (_, (losses, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params)
            return losses, grads, state.apply_gradients(grads).params, stats

        with fnn.intercept_methods(_no_dropout):
            compiled = jax.jit(step).lower(state, jbatch).compile(
                compiler_options={"xla_disable_hlo_passes": "algsimp"})
            losses, grads, params, stats = compiled(state, jbatch)

    def as_torch(coll, tree):
        return {k: v.double() for k, v in flax_to_torch(
            {f"{coll}/{k}": np.asarray(v) for k, v in
             traverse_util.flatten_dict(tree, sep="/").items()}).items()}

    return (batch, flat, {k: float(v) for k, v in losses.items()}, as_torch("params", grads),
            as_torch("params", params), as_torch("batch_stats", stats))


def _port_state(flat):
    model = CanonicalGarmentModel(TAssets.synthetic(num_rings=6, ring_size=8))
    model.load_state_dict(flax_to_torch(flat), strict=True)
    return model, make_state_for(model, lr=LR)


def test_train_step_matches_jax(jbody, step_case):
    """One `make_canonical_steps` train step of the port from the same
    weights and batch, in float64, dropout held out on both sides: every
    loss term within 1e-5 relative of JAX's; every parameter's gradient
    within 1e-4 relative L2, where the reference gradient is not zero (the
    PCA head's conv biases sit before a train-mode BatchNorm, and the
    garment summary's last BatchNorm bias shifts every sample alike before
    one; their gradients are 0 in exact arithmetic, and here below 1e-9 of
    the largest gradient on both sides); the running statistics within
    1e-5 of Flax's; every parameter after Adam within 1e-6 of JAX's, except
    where its gradient element is below 1e-5 of the tensor's largest. Adam's
    first step moves an element by lr g / (|g| + 1e-8), about +-lr whatever
    the gradient's size, with a slope of lr 1e-8 / g^2: the float32 casts
    inside JAX's model leave its gradient elements ~1e-7 of the tensor's
    largest off, which moves an element at 1e-6 of the largest (g ~ 1e-6)
    by ~1e-6 (measured: 1.06e-6 at 1.3e-6)."""
    batch, flat, jlosses, jgrads, jparams, jstats = step_case
    model, state = _port_state(flat)
    model.double()
    model.pointnet.dropout.p = 0.0
    train_step, _ = make_canonical_steps(model, TAssets.synthetic(num_rings=6, ring_size=8),
                                         jbody.faces)
    tbatch = {k: _t(v).double() if v.dtype == np.float32 else _t(v) for k, v in batch.items()}
    losses = train_step(state, tbatch, torch.Generator().manual_seed(0))
    assert set(losses) == set(jlosses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(losses[k]), v, rtol=1e-5, atol=0, err_msg=k)
    params = dict(model.named_parameters())
    assert set(params) == set(jgrads)
    largest = max(float(torch.linalg.vector_norm(g)) for g in jgrads.values())
    for name, want in jgrads.items():
        p = params[name]
        if float(torch.linalg.vector_norm(want)) < 1e-9 * largest:
            assert float(torch.linalg.vector_norm(p.grad)) < 1e-9 * largest, name
        else:
            assert _rel_l2(p.grad, want) <= 1e-4, f"{name}: relative L2 {_rel_l2(p.grad, want)}"
        kept = (want.abs() >= 1e-5 * want.abs().max()).numpy()
        np.testing.assert_allclose(_np(p)[kept], jparams[name].numpy()[kept],
                                   rtol=0, atol=1e-6, err_msg=name)
    buffers = dict(model.named_buffers())
    for name, want in jstats.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(_np(buffers[name]), want.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert state.step == 1


def test_loss_decreases(jbody, step_case):
    """Four fp32 train steps from the port's own initialisation (dropout on,
    from a seeded generator) on one batch: the train loss falls, as in the
    JAX package's `test_train.py`; the eval step runs and takes the
    eval-tail mask."""
    batch = {k: _t(v) for k, v in step_case[0].items()}
    torch.manual_seed(0)
    model = CanonicalGarmentModel(TAssets.synthetic(num_rings=6, ring_size=8))
    state = make_state_for(model, lr=LR)
    train_step, eval_step = make_canonical_steps(
        model, TAssets.synthetic(num_rings=6, ring_size=8), jbody.faces)
    g = torch.Generator().manual_seed(0)
    totals = []
    for _ in range(4):
        losses = train_step(state, batch, g)
        assert all(torch.isfinite(v).all() for v in losses.values())
        totals.append(float(losses["total_loss"]))
    assert totals[-1] < totals[0], totals
    full = eval_step(state, batch)
    part = eval_step(state, dict(batch, valid_mask=torch.tensor([1.0, 0.0, 1.0])))
    assert np.isfinite(float(full["total_loss"]))
    assert float(part["total_loss"]) != float(full["total_loss"])
