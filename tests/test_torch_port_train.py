"""Parity of the torch port's posed-stage training with the JAX package, on
the CPU: the GCN stack's gradients, every posed-stage loss term and its
gradient, the whole train step's parameter gradients at identical weights,
the optimizer and the plateau schedule, and a loss that falls.

Shapes are small: the 48-vertex ring garment (`synthetic(6, 8)`) and its
vertex-shuffled copy, a 200-vertex synthetic body, B=2, T=3 (so the
acceleration terms are not zero), N=512 points, lbs_k=16. The same numpy
inputs go to both packages; each test states its tolerance.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from garment4d_tpu import losses as JL
from garment4d_tpu import ops as jops
from garment4d_tpu import smpl as jsmpl
from garment4d_tpu.data.synthetic import make_batch as jmake_batch
from garment4d_tpu.models import GarmentAssets as JAssets
from garment4d_tpu.models import PosedGarmentModel as JPosed
from garment4d_tpu.train.state import PlateauScheduler as JPlateau
from garment4d_tpu.train.state import create_train_state as jcreate_state
from garment4d_tpu.train.step import body_inputs_from_batch as jbody_inputs

from garment4d_tpu_torch import losses as TL
from garment4d_tpu_torch import ops as tops
from garment4d_tpu_torch import smpl as tsmpl
from garment4d_tpu_torch.api import GarmentReconstructor
from garment4d_tpu_torch.train import PlateauScheduler, make_posed_steps, make_state_for
from garment4d_tpu_torch.train.convert import flax_to_torch

from test_torch_port_posed import _port_assets, _random_variables, _t
from torch_port_threads import one_torch_thread  # noqa: F401

B, T, N, NB, LBS_K = 2, 3, 512, 200, 16


def _np(x):
    return x.detach().numpy()


@pytest.fixture(scope="module")
def ring():
    return JAssets.synthetic(num_rings=6, ring_size=8)


@pytest.fixture(scope="module")
def shuffled(ring):
    return ring.permuted(np.random.RandomState(11).permutation(ring.num_verts))


@pytest.fixture(scope="module")
def jbody():
    return jsmpl.synthetic_smpl(num_verts=NB)


def _lap_band(jassets):
    """The JAX train step's loss-Laplacian offsets and relabeling."""
    offs = jops.graph.cyclic_diagonals(np.asarray(jassets.lap_adj))
    if offs is not None:
        return offs, None
    perm, offs = jops.graph.bandwidth_permutation(np.asarray(jassets.lap_adj))
    return offs, perm


# ---- GCN stack -------------------------------------------------------------


@pytest.mark.parametrize("banded", [True, False])
def test_gcn_stack_gradients(ring, rng, banded):
    """Gradients of the pieces, weights and biases through both outputs
    against jax.vjp of JAX's `gcn_stack` (its recompute VJP): fp32
    roundoff, rtol 1e-4 / atol 1e-5 (sums over 3 x 48 vertices and up to
    195 channels, in another order)."""
    V = ring.num_verts
    widths = (3, 32, 32, 128)
    xs = [rng.randn(3, V, w).astype(np.float32) for w in widths]
    dims = (sum(widths), 128, 128, 128, 3)
    ws = [(rng.randn(a, b) / np.sqrt(a)).astype(np.float32) for a, b in zip(dims, dims[1:])]
    bs = [(0.1 * rng.randn(b)).astype(np.float32) for b in dims[1:]]
    g_out = rng.randn(3, V, 3).astype(np.float32)
    g_hid = rng.randn(3, V, 128).astype(np.float32)
    offsets = jops.graph.cyclic_diagonals(ring.gcn_adj) if banded else None
    relus = (True, True, True, False)
    _, vjp = jax.vjp(lambda x_, w_, b_: jops.graph.gcn_stack(
        x_, w_, b_, jnp.asarray(ring.gcn_adj), offsets, relus, 2),
        tuple(jnp.asarray(x) for x in xs), tuple(jnp.asarray(w) for w in ws),
        tuple(jnp.asarray(b) for b in bs))
    jdx, jdw, jdb = vjp((jnp.asarray(g_out), jnp.asarray(g_hid)))
    leaves = [_t(a).requires_grad_(True) for a in xs + ws + bs]
    out, hid = tops.gcn_stack(leaves[:4], leaves[4:8], leaves[8:], _t(ring.gcn_adj),
                              offsets, relus, 2)
    got = torch.autograd.grad((out * _t(g_out)).sum() + (hid * _t(g_hid)).sum(), leaves)
    for g, w in zip(got, list(jdx) + list(jdw) + list(jdb)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5)


# ---- losses ----------------------------------------------------------------


def _loss_inputs(jassets, jbody, rng):
    """Random predictions near the ground truth and a body around them."""
    V = jassets.num_verts
    gt = (jassets.template_v[None, None] + 0.01 * rng.randn(B, T, V, 3)).astype(np.float32)
    root = (0.1 * rng.randn(B, T, 3)).astype(np.float32)
    target = gt + root[:, :, None]
    preds = [(target + s * rng.randn(B, T, V, 3)).astype(np.float32)
             for s in (0.05, 0.03, 0.02)]
    lbs = (target + 0.08 * rng.randn(B, T, V, 3)).astype(np.float32)
    body = (np.concatenate([jassets.template_v] * 5)[None, None, :NB]
            + 0.05 * rng.randn(B, T, NB, 3)).astype(np.float32)
    batch = dict(pose=np.zeros((B, T, 72), np.float32), garment=gt,
                 smpl_root_joints=root, smpl_vertices=body)
    return preds, lbs, batch


def _output(preds, lbs, arr):
    return types.SimpleNamespace(iter_garment_v=tuple(arr(p) for p in preds),
                                 lbs=types.SimpleNamespace(posed_garment=arr(lbs)))


@pytest.mark.parametrize("template", ["ring", "shuffled"])
@pytest.mark.parametrize("masked", [False, True])
def test_posed_stage_loss(request, template, masked, jbody, rng):
    """Every key of JAX's `posed_stage_loss` (the shuffled template runs
    the loss Laplacian through its RCM relabeling), with and without the
    eval-tail mask, and the gradient of the total loss w.r.t. every
    iteration's vertices (through the 1-NN and banded-Laplacian
    backwards): fp32 roundoff, rtol 1e-5 / atol 1e-6 on the values, rtol
    1e-4 / atol 1e-6 on the gradients."""
    jassets = request.getfixturevalue(template)
    preds, lbs, batch = _loss_inputs(jassets, jbody, rng)
    valid = np.array([1.0, 0.0], np.float32) if masked else None
    offs, perm = _lap_band(jassets)
    assert (perm is not None) == (template == "shuffled")
    weights = JL.LossWeights()

    def jloss(ps):
        return JL.posed_stage_loss(
            _output(ps, lbs, jnp.asarray), {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(jassets.lap_adj), jbody.faces, weights,
            valid=None if valid is None else jnp.asarray(valid), lap_offsets=offs,
            lap_perm=None if perm is None else jnp.asarray(perm))

    want = jloss(preds)
    jgrads = jax.grad(lambda ps: jloss(ps)["total_loss"])(tuple(jnp.asarray(p) for p in preds))

    leaves = [_t(p).requires_grad_(True) for p in preds]
    got = TL.posed_stage_loss(
        _output(leaves, lbs, lambda a: a if torch.is_tensor(a) else _t(a)),
        {k: _t(v) for k, v in batch.items()}, _t(jassets.lap_adj), jbody.faces,
        TL.LossWeights(), valid=None if valid is None else _t(valid), lap_offsets=offs,
        lap_perm=None if perm is None else torch.from_numpy(perm.astype(np.int64)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(got["lbs_interpenetration_loss"].detach()) > 0
    assert float(got["acceleration_error"].detach()) > 0
    tgrads = torch.autograd.grad(got["total_loss"], leaves)
    for i, (g, w) in enumerate(zip(tgrads, jgrads)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-6,
                                   err_msg=f"iteration {i}")


def test_acceleration_error_needs_three_frames(rng):
    v = _t(rng.randn(2, 2, 5, 3).astype(np.float32))
    assert float(TL.acceleration_error(v, v + 1.0)) == 0.0


# ---- the whole train step ---------------------------------------------------


@pytest.fixture(scope="module")
def step_case(ring, jbody):
    """JAX's posed loss and its parameter gradients at random weights (one
    compile), with the batch and the weights the port gets."""
    batch = jmake_batch(ring, jbody, batch_size=B, T=T, npoints=N, seed=4)
    body = jbody_inputs(batch)
    model = JPosed(assets=ring, body_faces=jbody.faces, lbs_k=LBS_K, iterations=3)
    flat, variables = _random_variables(model, batch["pcd"], body, ring, jbody,
                                        np.random.RandomState(4))
    offs, perm = _lap_band(ring)

    def loss_fn(params):
        out = model.apply(dict(variables, params=params), batch["pcd"], body, train=False)
        losses = JL.posed_stage_loss(out, batch, jnp.asarray(ring.lap_adj), jbody.faces,
                                     JL.LossWeights(), lap_offsets=offs, lap_perm=perm)
        return losses["total_loss"], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    flat_grads = {f"params/{k}": np.asarray(v) for k, v in
                  traverse_util.flatten_dict(grads, sep="/").items()}
    return batch, flat, losses, flax_to_torch(flat_grads)


def _port_state(jassets, jbody, flat, lr=1e-3):
    tbody = tsmpl.synthetic_smpl(num_verts=NB, device="cpu")
    np.testing.assert_array_equal(tbody.faces, jbody.faces)
    recon = GarmentReconstructor.from_assets(
        _port_assets(jassets), tbody, device="cpu", state_dict=flax_to_torch(flat),
        lbs_k=LBS_K)
    state = make_state_for(recon.model, lr=lr, freeze_canonical=True)
    return recon.model, state, make_posed_steps(recon.model, _port_assets(jassets),
                                                tbody.faces)


def test_train_step_matches_jax(ring, jbody, step_case):
    """One train step of the port from the same weights and batch: every
    loss term within rtol 1e-4 of JAX's; every trainable parameter's
    gradient within 1e-4 relative L2 of JAX's (fp32 roundoff through the
    canonical stage, three iterations and the max routing, read at most
    3.2e-6; a tie routed the other way would be O(1)); the canonical stage's parameters and
    buffers bitwise unchanged, every trainable parameter moved."""
    batch, flat, jlosses, jgrads = step_case
    model, state, (train_step, _) = _port_state(ring, jbody, flat)
    canonical = {k: v.clone() for k, v in model.canonical.state_dict().items()}
    before = {k: p.detach().clone() for k, p in model.named_parameters() if p.requires_grad}
    losses = train_step(state, {k: _t(v) for k, v in batch.items()})
    assert set(losses) == set(jlosses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(_np(losses[k]), np.asarray(v), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    params = dict(model.named_parameters())
    assert set(before) == {k for k in jgrads if not k.startswith("canonical.")}
    for name, want in jgrads.items():
        p = params[name]
        if name.startswith("canonical."):
            assert not p.requires_grad and p.grad is None
            continue
        rel = float(torch.linalg.vector_norm(p.grad - want) /
                    torch.linalg.vector_norm(want).clamp_min(1e-12))
        assert rel <= 1e-4, f"{name}: relative L2 {rel}"
        assert not torch.equal(p.detach(), before[name]), name
    for k, v in model.canonical.state_dict().items():
        assert torch.equal(v, canonical[k]), k
    assert state.step == 1


def test_loss_decreases(ring, jbody):
    """Five steps from random init on one synthetic batch: the loss falls."""
    torch.manual_seed(0)
    tbody = tsmpl.synthetic_smpl(num_verts=NB, device="cpu")
    assets = _port_assets(ring)
    from garment4d_tpu_torch.data.synthetic import make_batch

    batch = make_batch(assets, tbody, batch_size=1, T=T, npoints=N, device="cpu")
    model = GarmentReconstructor.from_assets(assets, tbody, device="cpu", lbs_k=LBS_K).model
    state = make_state_for(model, lr=1e-3, freeze_canonical=True)
    train_step, eval_step = make_posed_steps(model, assets, tbody.faces)
    first = float(eval_step(state, batch)["total_loss"])
    for _ in range(5):
        losses = train_step(state, batch)
        assert np.isfinite(float(losses["total_loss"]))
    last = float(eval_step(state, batch)["total_loss"])
    assert last < first


# ---- optimizer and schedule ---------------------------------------------------


def test_adam_matches_optax(rng):
    """Three steps on the same numpy gradients, the third at lr_scale 0.1,
    against JAX's TrainState (optax.adam with its lr scale): the parameters
    agree to fp32 roundoff of the update (atol 1e-9 at lr 1e-3, rtol 1e-6)."""
    shapes = {"a": (4, 5), "b": (7,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    jstate = jcreate_state({k: jnp.asarray(v) for k, v in init.items()}, {}, lr=1e-3)
    module = torch.nn.Module()
    module.p = torch.nn.ParameterDict({k: torch.nn.Parameter(_t(v)) for k, v in init.items()})
    tstate = make_state_for(module, lr=1e-3)
    for i, g in enumerate(grads):
        scale = 0.1 if i == 2 else 1.0
        jstate = jstate.replace(lr_scale=jnp.asarray(scale))
        jstate = jstate.apply_gradients({k: jnp.asarray(v) for k, v in g.items()})
        tstate.lr_scale = scale
        for k, p in module.p.items():
            p.grad = _t(g[k])
        tstate.apply_gradients()
    for k, p in module.p.items():
        np.testing.assert_allclose(_np(p), np.asarray(jstate.params[k]), rtol=1e-6,
                                   atol=1e-9)
    assert tstate.step == int(jstate.step) == 3
    assert isinstance(tstate.optimizer, torch.optim.Adam)
    assert tstate.optimizer.defaults["eps"] == 1e-8
    assert tstate.optimizer.defaults["betas"] == (0.9, 0.999)
    assert optax.adam  # the reference optimizer the JAX state wraps


@pytest.mark.parametrize("kw", [dict(), dict(patience=2), dict(patience=3), dict(patience=0)])
def test_plateau_scheduler_matches_jax(rng, kw):
    # falling, then flat with noise (long enough for patience 0 to reach
    # the eps guard): the schedule cuts the rate
    metrics = np.concatenate([1.0 / (1.0 + 0.1 * np.arange(20)),
                              np.full(40, 0.3)]) + 0.02 * rng.rand(60)
    ours, theirs = PlateauScheduler(**kw), JPlateau(**kw)
    assert [ours.update(float(m)) for m in metrics] == \
        [theirs.update(float(m)) for m in metrics]
    assert ours.scale < 1.0
