"""The port's `--bf16`, `--remat` and `--debug_nans` on the CPU, held
against the JAX package's `compute_dtype=jnp.bfloat16` and
`jax_debug_nans`; `--remat`, a no-op on the port, against the step
without it.

Sizes are those of the JAX package's `TestBf16Mode` (tests/test_models.py):
the 48-vertex ring garment (`synthetic(6, 8)`), a 250-vertex synthetic
body, B=1, T=2, 512 points; the whole-step bf16 case runs at the smallest
size whose fp32 gradients the existing canonical train-step test trusts
(B=3, T=1, N=2048). Weights are random, from numpy seeds; the segmentation
head's garment-label bias is moved so that about half of the points take
the garment label (at init none does, and the garment encoder would see
only zero rows).

The JAX bf16 references are compiled with `xla_allow_excess_precision`
off: by default XLA's CPU compiler keeps some bf16 intermediates in fp32
across fused ops, so the compiled program is not the one the model
writes (with it on, the labels differ from the port's at random weights
of these shapes; with it off most logits are bitwise the port's). The
train-step reference also disables `algsimp`, as the existing canonical
train-step test does.

Each test states its tolerances beside the values measured when it was
written: in ulps of bf16 (`_ulp`: the spacing of bf16 numbers at a value,
7 stored significand bits) with an absolute floor, or as relative L2
distances. Where a bf16 result is compared with JAX's, the test also
requires it to be at most half as far from JAX's bf16 as from the
port's own fp32, so that it sees the bf16 semantics and not only noise.
"""

import logging

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
from garment4d_tpu.nn.layers import ConvBNRelu as JConvBNRelu
from garment4d_tpu.nn.layers import SharedMLP as JSharedMLP
from garment4d_tpu.nn.pointnet import FPModule as JFPModule
from garment4d_tpu.nn.pointnet import SAModuleMSG as JSAModuleMSG

from garment4d_tpu_torch import smpl as tsmpl
from garment4d_tpu_torch import train_temporal
from garment4d_tpu_torch.data.synthetic import make_batch as tmake_batch
from garment4d_tpu_torch.models import CanonicalGarmentModel, PosedGarmentModel
from garment4d_tpu_torch.models import GarmentAssets as TAssets
from garment4d_tpu_torch.nn import BatchNorm, ConvBNRelu, FPModule, SAModuleMSG, SharedMLP
from garment4d_tpu_torch.train import make_canonical_steps, make_posed_steps, make_state_for
from garment4d_tpu_torch.train.convert import flax_to_torch
from garment4d_tpu_torch.utils.config import parse_args
from garment4d_tpu_torch.utils.debug_nans import NanTripwire
from torch_port_threads import one_torch_thread  # noqa: F401

B, T, N, NB = 1, 2, 512, 250
BF16 = jnp.bfloat16
# the program as written: no fp32 carried across bf16 ops
STRICT = {"xla_allow_excess_precision": False}
STRICT_STEP = dict(STRICT, xla_disable_hlo_passes="algsimp")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _ulp(x):
    """The spacing of bf16 numbers at |x| (7 stored significand bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _within_ulps(got, want, ulps, atol=0.0):
    got, want = _np(got), _np(want)
    diff = np.abs(got - want)
    bad = diff > ulps * np.maximum(_ulp(got), _ulp(want)) + atol
    assert not bad.any(), (f"{int(bad.sum())} of {bad.size} elements beyond {ulps} ulps; "
                           f"largest difference {diff.max()}")


def _no_dropout(next_fun, args, kwargs, context):
    """Flax method interceptor: every `nn.Dropout` returns its input."""
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _random_weights(model, pcd, seed: int) -> dict:
    """Flat 'params/...', 'batch_stats/...' numpy weights for a JAX model's
    tree: kaiming kernels, BatchNorm scales near 1, statistics off their
    init."""
    shapes = jax.eval_shape(lambda p: model.init(jax.random.PRNGKey(0), p, train=False), pcd)
    rng = np.random.RandomState(seed)
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
    return flat


def _variables(flat, assets=None):
    """The Flax variables of `flat`; with `assets`, the canonical model's
    PCA constants."""
    tree = traverse_util.unflatten_dict(flat, sep="/")
    v = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    if assets is not None:
        v["constants"] = {k: jnp.asarray(getattr(assets, k))
                          for k in ("pca_components", "pca_mean", "pca_scale")}
    return v


def _port(flat, assets, dtype, only_seg=False):
    model = CanonicalGarmentModel(assets, only_seg=only_seg, compute_dtype=dtype)
    model.load_state_dict(flax_to_torch(flat), strict=True)
    model.pointnet.dropout.p = 0.0  # held out on both sides
    return model


@pytest.fixture(scope="module")
def jassets():
    return JAssets.synthetic(num_rings=6, ring_size=8)


@pytest.fixture(scope="module")
def tassets():
    return TAssets.synthetic(num_rings=6, ring_size=8)


@pytest.fixture(scope="module")
def jbody():
    return jsmpl.synthetic_smpl(num_verts=NB)


@pytest.fixture(scope="module")
def tbody():
    return tsmpl.synthetic_smpl(num_verts=NB, device="cpu")


@pytest.fixture(scope="module")
def canonical_case(jassets, tassets, jbody):
    """The batch's point cloud and random canonical weights whose
    segmentation head puts about half of the points on the garment label
    (its bias moved to the median margin of the port's fp32 eval-mode
    logits)."""
    pcd = np.asarray(jmake_batch(jassets, jbody, batch_size=B, T=T, npoints=N)["pcd"])
    flat = _random_weights(JCanonical(assets=jassets), pcd, seed=3)
    with torch.no_grad():
        logits = _port(flat, tassets, None).eval()(_t(pcd)).backbone.sem_logits
    logits = logits.reshape(-1, logits.shape[-1]).numpy()
    label = jassets.label
    margin = np.delete(logits, label, axis=1).max(axis=1) - logits[:, label]
    key = "params/pointnet/head1/conv/bias"
    flat[key] = flat[key].copy()
    flat[key][label] += np.float32(np.median(margin))
    return pcd, flat


# ---- (a) the bf16 canonical forward -------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_bn"])
def test_bf16_canonical_forward_matches_jax(jassets, tassets, canonical_case, train):
    """The canonical model at compute_dtype bf16, eval mode or train-mode
    BatchNorm (dropout held out), against JAX's at jnp.bfloat16 from the same
    weights: labels equal; each output at most half as far from JAX's bf16
    as from the port's own fp32 (relative L2; measured 1/19 and less in
    eval, 0.42 and 0.12 in train mode); in eval `sem_logits` and
    `garment_summary` within 2 ulps + 1e-3 of JAX's, `tpose_garment` within
    5e-4 (measured: 1 ulp, bitwise, 3.6e-7); in train mode, where each
    BatchNorm's batch statistics pass a one-ulp difference on to every row
    after it (the port's bf16 forward on 1 and on 4 CPU threads: 0.36% and
    1.0% apart), `sem_logits` within 5e-2 and `garment_summary` within 1e-1
    relative L2 (measured 2.0e-2 and 3.3e-2; the fp32 path is 4.7e-2 and
    0.27 away), the first BatchNorm's running statistics within 1e-6 of
    Flax's and every other within 5e-2 relative L2 (measured 5e-8 and at
    most 2.3e-2); every
    parameter fp32, the state_dict keys the fp32 model's, every output
    fp32."""
    pcd, flat = canonical_case
    jmodel = JCanonical(assets=jassets, compute_dtype=BF16)

    def apply(v, p):
        out, mutated = jmodel.apply(v, p, train=train, mutable=["batch_stats"],
                                    rngs={"dropout": jax.random.PRNGKey(1)})
        return out, mutated["batch_stats"]

    with fnn.intercept_methods(_no_dropout):
        v = _variables(flat, jassets)
        jout, jstats = jax.jit(apply).lower(v, pcd).compile(compiler_options=STRICT)(v, pcd)

    def port(dtype):
        model = _port(flat, tassets, dtype).train(train)
        with torch.no_grad():
            return model, model(_t(pcd), torch.Generator().manual_seed(0))

    model16, out16 = port(torch.bfloat16)
    model32, out32 = port(None)
    assert all(p.dtype == torch.float32 for p in model16.parameters())
    assert list(model16.state_dict()) == list(model32.state_dict())
    for field in ("sem_logits",):
        assert getattr(out16.backbone, field).dtype == torch.float32
    assert all(f.dtype == torch.float32 for f in out16.backbone.features)
    assert all(f.dtype == torch.float32 for f in out16.garment_features)
    for t in (out16.garment_summary, out16.pca_coeff, out16.tpose_garment):
        assert t.dtype == torch.float32

    np.testing.assert_array_equal(out16.backbone.sem_logits.argmax(-1).numpy(),
                                  np.asarray(jout.backbone.sem_logits).argmax(-1))
    # enough garment points to fill the selection's N/4, and not all
    label_share = float((out16.backbone.sem_logits.argmax(-1) == jassets.label).float().mean())
    assert 0.25 < label_share < 1, label_share
    pairs = {"sem_logits": (out16.backbone.sem_logits, out32.backbone.sem_logits,
                            jout.backbone.sem_logits),
             "garment_summary": (out16.garment_summary, out32.garment_summary,
                                 jout.garment_summary)}
    if not train:
        pairs["tpose_garment"] = (out16.tpose_garment, out32.tpose_garment,
                                  jout.tpose_garment)
        _within_ulps(out16.backbone.sem_logits, jout.backbone.sem_logits, 2, atol=1e-3)
        _within_ulps(out16.garment_summary, jout.garment_summary, 2, atol=1e-3)
        _within_ulps(out16.tpose_garment, jout.tpose_garment, 0, atol=5e-4)
    else:
        # the PCA head's train-mode BatchNorm over B=1 row gives its bias:
        # `tpose_garment` does not depend on the stages before it here
        _within_ulps(out16.tpose_garment, jout.tpose_garment, 0, atol=1e-6)
        for name, tol in (("sem_logits", 5e-2), ("garment_summary", 1e-1)):
            got, _, want = pairs[name]
            assert _rel_l2(got, want) <= tol, (name, _rel_l2(got, want))
    for name, (got, fp32, want) in pairs.items():
        assert _rel_l2(got, want) <= 0.5 * _rel_l2(got, fp32), (
            name, _rel_l2(got, want), _rel_l2(got, fp32))
    if train:
        want = flax_to_torch({f"batch_stats/{k}": np.asarray(v) for k, v in
                              traverse_util.flatten_dict(jstats, sep="/").items()})
        buffers = dict(model16.named_buffers())
        errs = {name: _rel_l2(buffers[name], w) for name, w in want.items()
                if "running" in name}
        first = "pointnet.sa1.mlp0.layer0.bn.running_"
        assert max(errs[first + "mean"], errs[first + "var"]) <= 1e-6, errs
        assert max(errs.values()) <= 5e-2, max(errs.items(), key=lambda kv: kv[1])


# ---- (b) one BatchNorm and the blocks -----------------------------------------------


@pytest.mark.parametrize("rows", [1, 37, 4096])
def test_bf16_batchnorm_matches_flax(rows, rng):
    """Three train-mode updates, then eval, of a bf16 BatchNorm against
    `flax.linen.BatchNorm(dtype=bf16)` from the same parameters and bf16
    inputs: outputs within 1 ulp (bitwise but where an fp32 summation
    order flips a rounding), running statistics within 1e-6 relative; the
    output bf16, the statistics fp32."""
    C = 6
    jbn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=BF16)
    scale = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    stats = {"mean": (0.1 * rng.randn(C)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
    tbn = BatchNorm(C, dtype=torch.bfloat16).train()
    tbn.load_state_dict({"weight": _t(scale), "bias": _t(bias),
                         "running_mean": _t(stats["mean"]), "running_var": _t(stats["var"]),
                         "num_batches_tracked": torch.tensor(0)})
    jstats = {k: jnp.asarray(v) for k, v in stats.items()}
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    for step in range(4):
        train = step < 3
        x = jnp.asarray((rng.randn(rows, C) * 2 + 1).astype(np.float32), BF16)
        jy, mutated = jbn.apply({"params": params, "batch_stats": jstats}, x,
                                use_running_average=not train, mutable=["batch_stats"])
        jstats = mutated["batch_stats"]
        ty = tbn.train(train)(_t(np.asarray(x.astype(jnp.float32))).bfloat16())
        assert ty.dtype == torch.bfloat16 and jy.dtype == BF16
        _within_ulps(ty, jy.astype(jnp.float32), ulps=1)
    assert tbn.running_mean.dtype == torch.float32
    np.testing.assert_allclose(_np(tbn.running_mean), np.asarray(jstats["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(tbn.running_var), np.asarray(jstats["var"]),
                               rtol=1e-6, atol=1e-7)


def _block_case(name, rng):
    """(JAX module, port module factory, numpy inputs, the cotangent's
    shape, the gradient tolerance) of a block. The FP stage's last input,
    the coarse level's features, is a bf16 table (a bf16 SA stage's
    output), so its interpolation gathers bf16 rows."""
    if name == "conv_bn_relu":
        return (JConvBNRelu(32, dtype=BF16), lambda d: ConvBNRelu(35, 32, dtype=d),
                [rng.randn(4096, 35).astype(np.float32)], (4096, 32), 1e-4)
    if name == "shared_mlp":
        return (JSharedMLP((32, 32, 64), dtype=BF16),
                lambda d: SharedMLP(35, (32, 32, 64), dtype=d),
                [rng.randn(4096, 35).astype(np.float32)], (4096, 64), 2e-3)
    if name == "fp_stage":
        grid = lambda *shape: (np.round(rng.rand(*shape) * 256) / 256).astype(np.float32)
        return (JFPModule((64, 32), dtype=BF16), lambda d: FPModule((64, 32), 32 + 64, d),
                [grid(2, 1024, 3), grid(2, 256, 3), rng.randn(2, 1024, 32).astype(np.float32),
                 jnp.asarray(rng.randn(2, 256, 64), BF16)], (2, 1024, 32), 1e-2)
    xyz = (np.round(rng.rand(2, 2048, 3) * 256) / 256).astype(np.float32)
    return (JSAModuleMSG(npoint=256, radii=(0.1, 0.2), nsamples=(16, 32),
                         mlps=((32, 32, 64), (64, 64, 128)), dtype=BF16),
            lambda d: SAModuleMSG(256, (0.1, 0.2), (16, 32), ((32, 32, 64), (64, 64, 128)),
                                  32, d),
            [xyz, rng.randn(2, 2048, 32).astype(np.float32)], (2, 256, 192), 3e-2)


@pytest.mark.parametrize("name", ["conv_bn_relu", "shared_mlp", "sa_stage", "fp_stage"])
def test_bf16_block_training_matches_jax(name, rng):
    """A bf16 block in training (train-mode BatchNorm) against JAX's from
    the same weights, inputs and cotangent: outputs within 1 ulp (or one
    ulp at the output's largest magnitude; measured: 50 of the SA stage's
    98304 outputs need it); the
    gradients of the last input and of every parameter within the block's
    relative L2 distance (ConvBNRelu 1e-4, SharedMLP 2e-3, an SA stage
    3e-2, an FP stage 1e-2; measured 5e-7, 4.3e-4, 1.1e-2, 5.2e-3: in the
    SA stage a few hundred summation-order flips of single roundings feed
    the next BatchNorms; the FP stage's bf16 table gradient sums its rows'
    bf16 cotangents in fp32, as the JAX package's TPU backward does, where
    its CPU backward, run here, sums them in bf16), and at most half as
    far from JAX's as from the port's fp32 gradients.
    This holds the backward's bf16 semantics the whole train step cannot:
    JAX rounds the cotangent of each of a BatchNorm's two paths (its
    statistics, its normalisation) to bf16 before adding them, and its max
    over samples splits the cotangent among tied samples."""
    jmod, make, inputs, cot_shape, tol = _block_case(name, rng)
    variables = jax.eval_shape(lambda *xs: jmod.init(jax.random.PRNGKey(0), *xs, train=False),
                               *inputs)
    flat = {}
    for coll in ("params", "batch_stats"):
        for k, v in traverse_util.flatten_dict(variables[coll], sep="/").items():
            a = (rng.randn(*v.shape) * np.sqrt(2.0 / v.shape[0]) if k.endswith("kernel")
                 else rng.uniform(0.5, 1.5, v.shape) if k.endswith(("var", "scale"))
                 else 0.1 * rng.randn(*v.shape))
            flat[f"{coll}/{k}"] = a.astype(np.float32)
    v = _variables(flat)
    cot = rng.randn(*cot_shape).astype(np.float32)

    def loss(params, *xs):
        out, _ = jmod.apply({"params": params, "batch_stats": v["batch_stats"]}, *xs,
                            train=True, mutable=["batch_stats"])
        out = out[1] if isinstance(out, tuple) else out
        return jnp.sum(out.astype(jnp.float32) * cot), out

    grad = jax.grad(loss, argnums=tuple(range(len(inputs) + 1)), has_aux=True)
    (jgp, *jgx), jout = jax.jit(grad).lower(v["params"], *inputs).compile(
        compiler_options=STRICT)(v["params"], *inputs)
    jgrads = flax_to_torch({f"params/{k}": np.asarray(g) for k, g in
                            traverse_util.flatten_dict(jgp, sep="/").items()})
    jgrads["input"] = jgx[-1]

    def port(dtype):
        model = make(dtype)
        model.load_state_dict(flax_to_torch(flat), strict=True)
        xs = [(_t(np.asarray(x, np.float32)).bfloat16() if x.dtype == BF16 else _t(x))
              .requires_grad_(True) for x in inputs]
        out = model.train()(*xs)
        out = out[1] if isinstance(out, tuple) else out
        (out.float() * _t(cot)).sum().backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        grads["input"] = xs[-1].grad
        return out, grads

    out16, grads16 = port(torch.bfloat16)
    _, grads32 = port(None)
    assert out16.dtype == torch.bfloat16
    # one ulp, or one ulp at the output's scale: a BatchNorm's batch
    # statistics in another fp32 order move its outputs near its mean by
    # many of their own (small) ulps
    jout = np.asarray(jout.astype(jnp.float32))
    _within_ulps(out16, jout, ulps=1, atol=float(_ulp(np.abs(jout).max())))
    assert set(grads16) == set(jgrads)
    for k, want in jgrads.items():
        assert grads16[k].dtype == (torch.bfloat16 if k == "input" and inputs[-1].dtype == BF16
                                    else torch.float32), k
        to_jax = _rel_l2(grads16[k], want)
        assert to_jax <= tol, f"{k}: relative L2 {to_jax} > {tol}"
        assert to_jax <= 0.5 * _rel_l2(grads16[k], grads32[k]), k


def test_bf16_gather_rounds_each_row_cotangent():
    """A bf16 table's rows come out of `gather_points` in bf16, bitwise the
    table's, as JAX's `take_along_axis` gives them; the backward rounds
    each gathered row's cotangent to bf16, sums them in fp32 and casts the
    sum once (the JAX package's TPU backward): bitwise that sum (sums of a
    few bf16 values are exact in fp32, so the order cannot move them), and
    not one rounding of the unrounded cotangents' sum."""
    from garment4d_tpu_torch import ops

    rng = np.random.RandomState(3)
    table = _t(rng.randn(2, 64, 8).astype(np.float32)).bfloat16().requires_grad_(True)
    idx = _t(rng.randint(0, 64, (2, 512)).astype(np.int32))
    rows = ops.gather_points(table, idx)
    batch = torch.arange(2)[:, None].expand(2, 512)
    assert rows.dtype == torch.bfloat16
    assert torch.equal(rows, table.detach()[batch, idx.long()])
    cot = _t(rng.randn(2, 512, 8).astype(np.float32))
    (rows.float() * cot).sum().backward()

    def summed(c):
        return torch.zeros(2, 64, 8).index_put_((batch, idx.long()), c, accumulate=True)

    assert table.grad.dtype == torch.bfloat16
    assert torch.equal(table.grad, summed(cot.bfloat16().float()).bfloat16())
    assert not torch.equal(table.grad, summed(cot).bfloat16())


# ---- (c) the whole bf16 canonical train step ------------------------------------


@pytest.fixture(scope="module")
def seg_step_case(jassets, jbody):
    """The --only_seg train step at B=3, T=1, N=2048 (the point cloud on a
    1/256 grid, as the canonical train-step test's) in bf16 by JAX, dropout
    held out, from random weights: (batch, weights, losses, gradients
    under the port's names)."""
    batch = {k: np.asarray(v) for k, v in
             jmake_batch(jassets, jbody, batch_size=3, T=1, npoints=2048, seed=5).items()}
    batch["pcd"] = (np.round(batch["pcd"] * 256) / 256).astype(np.float32)
    model = JCanonical(assets=jassets, only_seg=True, compute_dtype=BF16)
    flat = _random_weights(model, batch["pcd"], seed=5)
    v = _variables(flat)

    def step(params, stats, batch):
        def loss_fn(params):
            out, _ = model.apply({"params": params, "batch_stats": stats}, batch["pcd"],
                                 train=True, rngs={"dropout": jax.random.PRNGKey(1)},
                                 mutable=["batch_stats"])
            losses = JL.canonical_stage_loss(out, batch, jassets.faces_tri, jbody.faces,
                                             JL.LossWeights(), only_seg=True)
            return losses["total_loss"], losses
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    with fnn.intercept_methods(_no_dropout):
        compiled = jax.jit(step).lower(v["params"], v["batch_stats"], jbatch).compile(
            compiler_options=STRICT_STEP)
        (_, losses), grads = compiled(v["params"], v["batch_stats"], jbatch)
    grads = flax_to_torch({f"params/{k}": np.asarray(g) for k, g in
                           traverse_util.flatten_dict(grads, sep="/").items()})
    return batch, flat, {k: float(a) for k, a in losses.items()}, grads


def _seg_port_step(tassets, tbody, seg_step_case, dtype):
    """The port's --only_seg train step on `seg_step_case`'s weights and
    batch at `dtype`: (losses, gradients)."""
    batch, flat = seg_step_case[:2]
    model = _port(dict(flat), tassets, dtype, only_seg=True)
    state = make_state_for(model, lr=1e-3)
    train_step, _ = make_canonical_steps(model, tassets, tbody.faces, only_seg=True)
    losses = train_step(state, {k: _t(a) for k, a in batch.items()},
                        torch.Generator().manual_seed(0))
    return losses, {n: p.grad for n, p in model.named_parameters()}


def _flat_grads(grads, names) -> torch.Tensor:
    return torch.cat([torch.as_tensor(grads[k]).flatten() for k in sorted(names)])


def test_bf16_canonical_train_step_matches_jax(tassets, tbody, seg_step_case):
    """One `make_canonical_steps` train step of the bf16 canonical model
    (--only_seg, the segmentation backbone) against JAX's
    `jax.value_and_grad` in bf16 from the same weights and batch, dropout
    held out on both sides. The loss within 2e-4 relative (measured 9e-5;
    the port's fp32 loss is 1.7e-3 away); the segmentation head's
    gradients (head1) within 2e-2 relative L2 (measured 6e-3); the whole
    gradient within 1.25 x the port's own bf16-to-fp32 distance in
    relative L2 (measured 0.47 against 0.44). Below the head the bf16
    gradients are dominated by rounding: at this size the train-mode
    BatchNorms amplify a one-ulp difference in a layer's input into
    gradients that differ by tens of percent (the port's bf16 step on 1
    and on 4 CPU threads: 7%; JAX's bf16 against JAX's fp32: 47%), so
    the whole-step gate is that noise band, and the blocks' test holds
    the backward's semantics tightly. The full step adds the garment
    selection and the PCA head's BatchNorm over B rows, where the forward
    itself is that ill-conditioned (its losses move by 7% between thread
    counts); `test_bf16_canonical_forward_matches_jax` holds those stages
    in eval and train mode."""
    batch, flat, jlosses, jgrads = seg_step_case
    losses16, grads16 = _seg_port_step(tassets, tbody, seg_step_case, torch.bfloat16)
    losses32, grads32 = _seg_port_step(tassets, tbody, seg_step_case, None)
    assert set(losses16) == set(jlosses)
    for k, want in jlosses.items():
        np.testing.assert_allclose(float(losses16[k]), want, rtol=2e-4, err_msg=k)
    assert abs(float(losses32["sem_seg_loss"]) - jlosses["sem_seg_loss"]) > 5e-4
    assert set(grads16) == set(jgrads)
    for k in ("pointnet.head1.conv.weight", "pointnet.head1.conv.bias"):
        assert _rel_l2(grads16[k], jgrads[k]) <= 2e-2, k

    to_jax = _rel_l2(_flat_grads(grads16, jgrads), _flat_grads(jgrads, jgrads))
    to_fp32 = _rel_l2(_flat_grads(grads16, jgrads), _flat_grads(grads32, jgrads))
    assert to_jax <= 1.25 * to_fp32, (to_jax, to_fp32)
    assert all(bool(torch.isfinite(g).all()) for g in grads16.values())


class _Bf16SummedGather(torch.autograd.Function):
    """`gather_points` of a bf16 table whose backward adds the rows'
    cotangents one at a time in bf16, each add rounded: the rule of the
    JAX package's backward on the CPU (XLA's scatter-add in the table's
    dtype), which this file's JAX references run."""

    @staticmethod
    def forward(ctx, points, idx, gather):
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return gather(points, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        out = torch.zeros(g.shape[0], ctx.n, g.shape[-1], dtype=g.dtype)
        for b in range(g.shape[0]):
            for r, i in enumerate(idx[b].tolist()):
                out[b, i] += g[b, r]
        return out, None, None


def test_bf16_train_step_gap_is_the_table_sum(tassets, tbody, seg_step_case, monkeypatch):
    """Where the whole bf16 step's distance to JAX's comes from. The FP
    stages interpolate bf16 tables; the port sums a table row's bf16
    cotangents in fp32 (the JAX package's rule on the TPU), the JAX
    reference on the CPU in bf16. With the CPU rule emulated in the port
    (`_Bf16SummedGather`) the whole gradient comes within 0.35 of JAX's in
    relative L2 (measured 0.28, against 0.47 with the port's own sum) and
    within 0.7 x its distance to the port's fp32 gradients (measured 0.28
    against 0.49). What is left is the train-mode BatchNorms amplifying
    the differences of single roundings already seen at the head (head1's
    gradients 6e-3 from JAX's)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    jgrads = seg_step_case[3]
    _, grads16 = _seg_port_step(tassets, tbody, seg_step_case, torch.bfloat16)
    gather = pc.gather_points
    monkeypatch.setattr(pc, "gather_points", lambda points, idx: (
        _Bf16SummedGather.apply(points, idx, gather) if points.dtype == torch.bfloat16
        else gather(points, idx)))
    _, emulated = _seg_port_step(tassets, tbody, seg_step_case, torch.bfloat16)
    _, grads32 = _seg_port_step(tassets, tbody, seg_step_case, None)
    want = _flat_grads(jgrads, jgrads)
    to_jax = _rel_l2(_flat_grads(emulated, jgrads), want)
    assert to_jax <= 0.35, to_jax
    assert to_jax < _rel_l2(_flat_grads(grads16, jgrads), want)
    assert to_jax <= 0.7 * _rel_l2(_flat_grads(emulated, jgrads), _flat_grads(grads32, jgrads))


# ---- (d) --remat and (e) --debug_nans on the posed train step -----------------------------


@pytest.fixture(scope="module")
def posed_batch(tassets, tbody):
    return tmake_batch(tassets, tbody, batch_size=B, T=T, npoints=N, device="cpu")


def _posed_step(tassets, tbody, batch, tripwire=False, nan=None):
    """One posed train step (2 iterations, lbs_k 4) from torch seed 0's
    weights, with `nan` = (parameter name or batch key) set to NaN first
    (its first element): (losses, gradients, parameters, buffers, the
    tripwire or None)."""
    torch.manual_seed(0)
    model = PosedGarmentModel(tassets, tbody.faces, lbs_k=4, iterations=2)
    state = make_state_for(model, lr=1e-3, freeze_canonical=True)
    wire = NanTripwire(model) if tripwire else None
    train_step, _ = make_posed_steps(model, tassets, tbody.faces, tripwire=wire)
    if nan in dict(model.named_parameters()):
        with torch.no_grad():
            dict(model.named_parameters())[nan].view(-1)[0] = float("nan")
    elif nan is not None:
        batch = dict(batch, **{nan: batch[nan].clone()})
        batch[nan].view(-1)[0] = float("nan")
    losses = train_step(state, batch)
    return (losses, {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
            {n: p.detach() for n, p in model.named_parameters()},
            {n: b for n, b in model.named_buffers()}, wire)


def _bitwise(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def posed_plain(tassets, tbody, posed_batch):
    return _posed_step(tassets, tbody, posed_batch)


def test_remat_is_a_logged_noop(tassets, tbody, posed_batch, posed_plain, caplog):
    """`--remat 1` parses and is logged as a no-op: the entry point's
    `_make_state` builds the model and state it builds without it (the
    config's posed model cut to lbs_k 4 and 2 iterations), and one posed
    train step from them is bitwise the step without the flag (losses,
    gradients, parameters after Adam, buffers)."""
    args, cfg = parse_args(["--config", "cfgs/skirt.yaml", "--GarmentPCALBS", "1",
                            "--fix_PCA", "1", "--lr", "1e-3", "--remat", "1"])
    cfg.NETWORK.LBSK, cfg.NETWORK.ITERATION = 4, 2
    logger = logging.getLogger("test_remat")
    with caplog.at_level(logging.INFO, logger="test_remat"):
        state, _ = train_temporal._make_state(args, cfg, tassets, tbody, "cpu", logger)
    assert "--remat 1: a no-op" in caplog.text
    train_step, _ = make_posed_steps(state.model, tassets, tbody.faces)
    losses = train_step(state, posed_batch)
    model = state.model
    got = (losses, {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
           {n: p.detach() for n, p in model.named_parameters()}, dict(model.named_buffers()))
    for a, b in zip(got, posed_plain[:4]):
        _bitwise(a, b)
    assert len(posed_plain[1]) > 0


def test_debug_nans_clean_step_bitwise(tassets, tbody, posed_batch, posed_plain):
    """With the tripwire installed, a clean posed train step is bitwise the
    step without it (losses, gradients, parameters, buffers)."""
    got = _posed_step(tassets, tbody, posed_batch, tripwire=True)
    for a, b in zip(got[:4], posed_plain[:4]):
        _bitwise(a, b)
    assert got[4].modules == len(list(PosedGarmentModel(
        tassets, tbody.faces, lbs_k=4, iterations=2).modules()))


@pytest.mark.parametrize("nan,message", [
    ("garment_pe1.linear0.weight", "NaN in parameter garment_pe1.linear0.weight"),
    ("pose", "NaN in the output of module garment_pe0"),
    ("garment", "NaN in loss "),
])
def test_debug_nans_raises_naming_it(tassets, tbody, posed_batch, nan, message):
    """A NaN set into a parameter, a body input or the ground truth stops
    the posed train step with FloatingPointError naming the parameter, the
    first module whose output it reached, or the loss term; without the
    tripwire the same step runs on with NaN losses."""
    with pytest.raises(FloatingPointError, match=message):
        _posed_step(tassets, tbody, posed_batch, tripwire=True, nan=nan)
    losses = _posed_step(tassets, tbody, posed_batch, nan=nan)[0]
    assert not bool(torch.isfinite(losses["total_loss"]))


def test_debug_nans_jax_raises_on_the_same_injection(jassets, tassets, tbody, canonical_case):
    """The same injection, a NaN in the first element of the canonical
    model's first SA kernel, stops JAX's forward under
    `jax.debug_nans(True)` with FloatingPointError and the port's
    canonical train step under the tripwire with FloatingPointError
    naming the parameter (the kernel's transpose: element 0 either way)."""
    pcd, flat = canonical_case
    key = "params/pointnet/sa1/mlp0/layer0/conv/kernel"
    poisoned = dict(flat, **{key: flat[key].copy()})
    poisoned[key][0, 0] = np.nan
    jmodel = JCanonical(assets=jassets)
    with pytest.raises(FloatingPointError, match="nan"):
        with jax.debug_nans(True):
            jax.jit(lambda v, p: jmodel.apply(v, p, train=False))(
                _variables(poisoned, jassets), pcd)
    model = _port(poisoned, tassets, None)
    state = make_state_for(model, lr=1e-3)
    train_step, _ = make_canonical_steps(model, tassets, tbody.faces,
                                         tripwire=NanTripwire(model))
    batch = tmake_batch(tassets, tbody, batch_size=B, T=T, npoints=N, device="cpu")
    with pytest.raises(FloatingPointError,
                       match="NaN in parameter pointnet.sa1.mlp0.layer0.conv.weight"):
        train_step(state, batch, torch.Generator().manual_seed(0))
