"""Parity of the port's MGN variant (`--MGN 1`) with the JAX package, on the
CPU: the single-nearest-neighbour LBS, the whole `MgnGarmentModel`
forward at identical weights (carried by `flax_to_torch`), one train step
against the JAX package's `make_posed_steps`, the frozen canonical stage
through two Adam steps, the `GraphConvolution` layer (dense and banded),
and one epoch of the entry point.

Shapes are small: the 48-vertex ring garment (`synthetic(6, 8)`), a
200-vertex synthetic body, B=2, T=3 (so the acceleration terms are not
zero), N=512 points. The same numpy inputs go to both packages; each test
states its tolerance. The canonical head's last bias is moved so that
about half of the points take the garment's label (with all-random weights
every point takes one class).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from garment4d_tpu import nn as jnn
from garment4d_tpu import ops as jops
from garment4d_tpu import smpl as jsmpl
from garment4d_tpu.data.synthetic import make_batch as jmake_batch
from garment4d_tpu.models import GarmentAssets as JAssets
from garment4d_tpu.models import MgnGarmentModel as JMgn
from garment4d_tpu.models.posed import _SMPL_PARENTS
from garment4d_tpu.models.skinning import lbs_garment_single_nn as jlbs_single_nn
from garment4d_tpu.train.step import body_inputs_from_batch as jbody_inputs
from garment4d_tpu.train.step import make_posed_steps as jmake_posed_steps
from garment4d_tpu.train.step import make_state_for as jmake_state_for

from garment4d_tpu_torch import train_temporal
from garment4d_tpu_torch.models import MgnGarmentModel
from garment4d_tpu_torch.models.skinning import lbs_garment_single_nn
from garment4d_tpu_torch.nn import GraphConvolution
from garment4d_tpu_torch.train import make_posed_steps, make_state_for
from garment4d_tpu_torch.train.convert import flax_to_torch
from garment4d_tpu_torch.train.step import body_inputs_from_batch as tbody_inputs
from test_torch_port_import import _jax_variables
from test_torch_port_posed import _port_assets, _random_variables, _t
from torch_port_threads import one_torch_thread  # noqa: F401

B, T, N, NB = 2, 3, 512, 200
HEAD_BIAS = "params/canonical/pointnet/head1/conv/bias"


def _np(x):
    return x.detach().numpy()


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.fixture(scope="module")
def world():
    jassets = JAssets.synthetic(num_rings=6, ring_size=8)
    jbody = jsmpl.synthetic_smpl(num_verts=NB)
    batch = jmake_batch(jassets, jbody, batch_size=B, T=T, npoints=N, seed=6)
    return dict(jassets=jassets, assets=_port_assets(jassets), jbody=jbody, batch=batch,
                tbatch={k: _t(v) for k, v in batch.items()})


def _port_model(world, flat):
    model = MgnGarmentModel(world["assets"], world["jbody"].faces)
    model.load_state_dict(flax_to_torch(flat), strict=True)
    return model


@pytest.fixture(scope="module")
def weights(world):
    """Numpy-drawn variables of the JAX MGN model (`_random_variables`'
    distribution), the head's last bias balanced on this batch, and the
    constants as the model builds them."""
    model = JMgn(assets=world["jassets"])
    args = (world["batch"]["pcd"], jbody_inputs(world["batch"]))
    flat, _ = _random_variables(model, *args, world["jassets"], world["jbody"],
                                np.random.RandomState(6))
    port = _port_model(world, flat).eval()
    with torch.no_grad():
        logits = port.canonical.pointnet(world["tbatch"]["pcd"].reshape(B * T, N, 3)).sem_logits
    g = port.canonical.garment_label
    others = torch.cat([logits[..., :g], logits[..., g + 1:]], dim=-1).amax(-1)
    flat[HEAD_BIAS] = flat[HEAD_BIAS].copy()
    flat[HEAD_BIAS][g] += float((others - logits[..., g]).median())
    variables = _jax_variables(model, args, world["jassets"], world["jbody"])
    tree = {}
    for key, value in flat.items():
        coll, *path = key.split("/")
        node = tree.setdefault(coll, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(value)
    return flat, dict(variables, params=tree["params"], batch_stats=tree["batch_stats"])


def test_lbs_single_nn_matches_jax(world, rng):
    """Posed and unposed garments within 1e-5 of JAX's, the nearest body
    vertex of every garment vertex and frame equal."""
    batch = world["batch"]
    Vg = world["jassets"].num_verts
    garment = (world["jassets"].template_v[None, None]
               + 0.05 * rng.randn(B, T, Vg, 3)).astype(np.float32)
    keys = ("tpose_smpl_vertices", "tpose_smpl_root_joints", "zeropose_smpl_vertices", "pose",
            "J_regressor", "lbs_weights")
    want = jax.jit(lambda g, *a: jlbs_single_nn(g, *a, parents=_SMPL_PARENTS))(
        garment, *(batch[k] for k in keys))
    got = lbs_garment_single_nn(_t(garment), *(world["tbatch"][k] for k in keys),
                                parents=_SMPL_PARENTS)
    np.testing.assert_array_equal(_np(got.nn_idx), np.asarray(want.nn_idx))
    assert len(np.unique(_np(got.nn_idx))) > 10
    np.testing.assert_allclose(_np(got.posed_garment), np.asarray(want.posed_garment),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(got.unposed_garment), np.asarray(want.unposed_garment),
                               rtol=0, atol=1e-5)


def test_mgn_forward_matches_jax(world, weights):
    """`lbs.posed_garment` within 1e-4 of JAX's (fp32 roundoff through the
    canonical stage and the displacement MLP), `iter_garment_v` the LBS
    result, the canonical garment within 1e-5, nearest indices equal."""
    flat, variables = weights
    batch = world["batch"]
    want = jax.jit(lambda v, p, b: JMgn(assets=world["jassets"]).apply(v, p, b, train=False))(
        variables, batch["pcd"], jbody_inputs(batch))
    model = _port_model(world, flat).eval()
    with torch.no_grad():
        got = model(world["tbatch"]["pcd"], tbody_inputs(world["tbatch"]))
    labels = got.canonical.backbone.sem_logits.argmax(-1)
    assert bool(((labels == model.canonical.garment_label).sum(-1) >= N // 4).all())
    np.testing.assert_allclose(_np(got.canonical.tpose_garment),
                               np.asarray(want.canonical.tpose_garment), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_np(got.lbs.nn_idx), np.asarray(want.lbs.nn_idx))
    np.testing.assert_allclose(_np(got.lbs.posed_garment), np.asarray(want.lbs.posed_garment),
                               rtol=0, atol=1e-4)
    assert len(got.iter_garment_v) == 1 and got.iter_garment_v[0] is got.lbs.posed_garment


def _adam_first_moments(opt_state):
    """The `mu` tree of the optax Adam state in `opt_state`."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0].mu


def test_train_step_matches_jax(world, weights):
    """One train step from the same weights and batch against the JAX
    package's `make_posed_steps`: every loss term within 1e-5 relative;
    each displacement tensor's gradient within 1e-4 relative L2 of JAX's
    (read from Adam's first moment after one step, mu = 0.1 g); the
    canonical stage without gradient and bitwise unchanged. JAX's step is
    compiled without XLA's algebraic simplifier: on the CPU that pass moves
    this step's displacement gradients by 1.3e-2 relative L2 away from
    `jax.grad` of the same loss, jitted or eager, which agree with each
    other and with the port to 2.4e-7 (as for the canonical train step,
    `tests/check_jax_algsimp.py`)."""
    flat, variables = weights
    jassets, jbody, batch = world["jassets"], world["jbody"], world["batch"]
    jmodel = JMgn(assets=jassets)
    # the step donates its state: a copy keeps the fixture's arrays
    jstate = jmake_state_for(jmodel, jax.tree_util.tree_map(jnp.array, variables), jassets,
                             lr=1e-3)
    jtrain, _ = jmake_posed_steps(jmodel, jassets, jbody.faces)
    rng = jax.random.PRNGKey(0)
    jtrain = jtrain.lower(jstate, batch, rng).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})
    jstate, jlosses = jtrain(jstate, batch, rng)
    mu = _adam_first_moments(jstate.opt_state)["displacement"]

    model = _port_model(world, flat)
    state = make_state_for(model, lr=1e-3)
    train_step, _ = make_posed_steps(model, world["assets"], jbody.faces)
    canonical = {k: v.clone() for k, v in model.canonical.state_dict().items()}
    losses = train_step(state, world["tbatch"])
    assert set(losses) == set(jlosses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(_np(losses[k]), np.asarray(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    grads = flax_to_torch({f"params/{layer}/{leaf}": np.asarray(v) / 0.1
                           for layer, leaves in mu.items() for leaf, v in leaves.items()})
    for name, want in grads.items():
        got = model.displacement.get_parameter(name).grad
        assert _rel_l2(_np(got), _np(want)) <= 1e-4, name
    assert all(p.grad is None for p in model.canonical.parameters())
    for k, v in model.canonical.state_dict().items():
        assert torch.equal(v, canonical[k]), k


@pytest.mark.parametrize("fix_pca", [False, True])
def test_canonical_unchanged(world, weights, fix_pca):
    """Two Adam steps with and without `--fix_PCA`: the canonical stage's
    parameters and statistics bitwise as they were (no gradient reaches
    them, and torch's Adam skips a parameter without one), every
    displacement tensor moved."""
    model = _port_model(world, weights[0])
    state = make_state_for(model, lr=1e-3, freeze_canonical=fix_pca)
    assert all(p.requires_grad != fix_pca for p in model.canonical.parameters())
    train_step, _ = make_posed_steps(model, world["assets"], world["jbody"].faces)
    canonical = {k: v.clone() for k, v in model.canonical.state_dict().items()}
    before = {k: v.detach().clone() for k, v in model.displacement.named_parameters()}
    for _ in range(2):
        losses = train_step(state, world["tbatch"])
        assert np.isfinite(float(losses["total_loss"]))
    for k, v in model.canonical.state_dict().items():
        assert torch.equal(v, canonical[k]), k
    for k, p in model.displacement.named_parameters():
        assert not torch.equal(p.detach(), before[k]), k
    assert state.step == 2


@pytest.mark.parametrize("banded", [False, True])
def test_graph_convolution_matches_jax(world, rng, banded):
    """`GraphConvolution` at JAX's weights, dense and banded (the ring's
    cyclic diagonals): within rtol 1e-5 / atol 1e-6."""
    adj = world["jassets"].gcn_adj
    offsets = jops.graph.cyclic_diagonals(adj) if banded else None
    assert (offsets is not None) == banded
    x = rng.randn(3, adj.shape[0], 35).astype(np.float32)
    layer = jnn.GraphConvolution(features=16, diag_offsets=offsets)
    params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(adj))
    want = layer.apply(params, jnp.asarray(x), jnp.asarray(adj))
    port = GraphConvolution(35, 16, diag_offsets=offsets)
    port.load_state_dict({k: _t(v) for k, v in params["params"].items()}, strict=True)
    got = port(_t(x), _t(adj))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_entry_point_mgn_epoch(tmp_path):
    """`train_temporal.main` with `--GarmentPCALBS 1 --MGN 1` on synthetic
    data: one epoch, finite losses, a checkpoint of the MGN model."""
    out = str(tmp_path / "mgn")
    hist = train_temporal.main(
        ["--config", "cfgs/skirt.yaml", "--synthetic_data", "1", "--GarmentPCALBS", "1",
         "--MGN", "1", "--batch_size", "1", "--T", "2", "--npoints", "512",
         "--epoch_num", "1", "--output_dir", out], device="cpu")
    assert len(hist) == 1
    for split in ("train", "eval"):
        assert all(np.isfinite(v) for v in hist[0][split].values()), split
    assert "lbs_garment_msre" in hist[0]["eval"]
    saved = torch.load(os.path.join(out, "ckpt", "model.ckpt"), weights_only=True)
    assert "displacement.linear2.weight" in saved["model_state"]
    assert saved["other_state"]["step"] == 2
