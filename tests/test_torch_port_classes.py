"""The Trousers and Tshirt garment classes on the port, against the JAX
package on the CPU.

Every other port test builds a Skirt. Trousers samples its garment PE
blocks at (32, 8, 4), so garment pe2 runs at S=4 (below the kernels'
8-row tile); Tshirt changes the garment label the canonical stage's
selection keeps (7, 0-based 6). Here, at the fixtures of
`test_torch_port_train.py` (the 48-vertex ring under the class's name, a
200-vertex synthetic body, B=2, T=3, N=512, lbs_k 16):

- the posed forward and one posed train step's gradients, from one JAX
  compile a class (`jax.value_and_grad` with the output as aux): every
  `iter_garment_v` within atol 1e-4, LBS within 1e-5, the garment levels
  within 1e-5, every loss within rtol 1e-4 and each trainable
  parameter's gradient within 1e-4 relative L2, as in
  `test_torch_port_posed.py` and `test_torch_port_train.py`;
- the canonical stage's garment selection under labels 6 and 7 (0-based 5
  and 6), zero-padded where a frame has fewer points, bitwise;
- the plain PE block and its backward at S=4 against JAX's VJP where
  another row ties slot 0 exactly (a duplicated row; the zero rows the
  selection pads with);
- one synthetic epoch of the entry point per config (`cfgs/trousers.yaml`,
  `cfgs/tshirt.yaml`), which builds a model of that class and radii.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from garment4d_tpu import losses as JL
from garment4d_tpu import smpl as jsmpl
from garment4d_tpu.data.synthetic import make_batch as jmake_batch
from garment4d_tpu.models import GarmentAssets as JAssets
from garment4d_tpu.models import PosedGarmentModel as JPosed
from garment4d_tpu.models.canonical import select_garment_points as jselect
from garment4d_tpu.train.step import body_inputs_from_batch as jbody_inputs

from garment4d_tpu_torch import ops as tops
from garment4d_tpu_torch import train_temporal
from garment4d_tpu_torch.models.canonical import select_garment_points as tselect
from garment4d_tpu_torch.train.convert import flax_to_torch
from garment4d_tpu_torch.train.step import body_inputs_from_batch as tbody_inputs

from test_torch_port_posed import _random_variables, _t
from test_torch_port_train import _lap_band, _port_state
from torch_port_threads import one_torch_thread  # noqa: F401

B, T, N, NB, LBS_K = 2, 3, 512, 200, 16
CLASSES = ("Trousers", "Tshirt")


def _np(x):
    return x.detach().numpy()


@pytest.fixture(scope="module")
def jbody():
    return jsmpl.synthetic_smpl(num_verts=NB)


@pytest.fixture(scope="module", params=CLASSES)
def case(request, jbody):
    """One class: the JAX posed forward's output, its losses and its
    parameter gradients at random weights (one compile), with the batch
    and the weights the port gets."""
    jassets = JAssets.synthetic(name=request.param, num_rings=6, ring_size=8)
    batch = jmake_batch(jassets, jbody, batch_size=B, T=T, npoints=N, seed=6)
    body = jbody_inputs(batch)
    model = JPosed(assets=jassets, body_faces=jbody.faces, lbs_k=LBS_K, iterations=3)
    flat, variables = _random_variables(model, batch["pcd"], body, jassets, jbody,
                                        np.random.RandomState(6))
    offs, perm = _lap_band(jassets)

    def loss_fn(params):
        out = model.apply(dict(variables, params=params), batch["pcd"], body, train=False)
        losses = JL.posed_stage_loss(out, batch, jnp.asarray(jassets.lap_adj), jbody.faces,
                                     JL.LossWeights(), lap_offsets=offs, lap_perm=perm)
        return losses["total_loss"], (losses, out)

    (_, (losses, out)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    flat_grads = {f"params/{k}": np.asarray(v) for k, v in
                  traverse_util.flatten_dict(grads, sep="/").items()}
    return jassets, batch, flat, out, losses, flax_to_torch(flat_grads)


def test_radii(case, jbody):
    jassets = case[0]
    model = _port_state(jassets, jbody, case[2])[0]
    want = (32, 8, 4) if jassets.name == "Trousers" else (32, 16, 8)
    assert model.radii == JPosed(assets=jassets, body_faces=np.zeros((1, 3), np.int32))._radii
    assert tuple(getattr(model, f"garment_pe{i}").nsample for i in range(3)) == want
    assert model.canonical.garment_label == jassets.label == {"Trousers": 5, "Tshirt": 6}[
        jassets.name]


def test_posed_forward_and_train_step(case, jbody):
    """The forward (eval mode) and one train step of the port from the
    JAX weights and batch: the forward's outputs, then every loss term and
    every trainable parameter's gradient."""
    jassets, batch, flat, jout, jlosses, jgrads = case
    model, state, (train_step, _) = _port_state(jassets, jbody, flat)
    tbatch = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        model.eval()
        out = model(tbatch["pcd"], tbody_inputs(tbatch))
    np.testing.assert_array_equal(out.lbs.nn_idx.numpy(), np.asarray(jout.lbs.nn_idx))
    np.testing.assert_allclose(out.lbs.posed_garment.numpy(),
                               np.asarray(jout.lbs.posed_garment), atol=1e-5)
    for i, (a, b) in enumerate(zip(out.canonical.garment_xyz, jout.canonical.garment_xyz)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=f"level {i}")
    assert len(out.iter_garment_v) == 3
    for i, (a, b) in enumerate(zip(out.iter_garment_v, jout.iter_garment_v)):
        assert a.shape == (B, T, jassets.num_verts, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   err_msg=f"iteration {i}")

    losses = train_step(state, tbatch)
    assert set(losses) == set(jlosses)
    for k, v in jlosses.items():
        np.testing.assert_allclose(_np(losses[k]), np.asarray(v), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    params = dict(model.named_parameters())
    for name, want in jgrads.items():
        p = params[name]
        if name.startswith("canonical."):
            assert not p.requires_grad and p.grad is None
            continue
        rel = float(torch.linalg.vector_norm(p.grad - want) /
                    torch.linalg.vector_norm(want).clamp_min(1e-12))
        assert rel <= 1e-4, f"{name}: relative L2 {rel}"


@pytest.mark.parametrize("label", [5, 6])
def test_garment_selection(rng, label):
    """Labels 6 and 7 (0-based 5 and 6): the first n points of the class in
    index order, zero-padded; frames with more than n, fewer, and none."""
    Bs, Np, n, C = 3, 64, 20, 5
    labels = rng.randint(0, 7, (Bs, Np)).astype(np.int32)
    labels[1, 10:] = (label + 1) % 7  # at most 10 of the class
    labels[2] = (label + 1) % 7       # none
    labels[0, :40] = label            # more than n
    xyz = rng.randn(Bs, Np, 3).astype(np.float32)
    feat = rng.randn(Bs, Np, C).astype(np.float32)
    jx, jf = jselect(jnp.asarray(xyz), jnp.asarray(feat), jnp.asarray(labels), label, n)
    tx, tf = tselect(_t(xyz), _t(feat), _t(labels), label, n)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert not tx[2].any() and tx[1, (labels[1] == label).sum():].abs().sum() == 0


@pytest.mark.parametrize("tie", ["duplicate row", "zero rows"])
def test_pe_block_s4_tie_on_slot0(rng, tie):
    """The plain PE block and its backward at S=4 (garment pe2 of a
    Trousers model) where slot 0 ties exactly with a slot that reads
    another row: rows 25 and 27 equal, or two of the all-zero rows the
    garment selection pads with. Through `ops.group_pe_max` with a
    trainable table, against the VJP of JAX's `group_pe_max`: the output,
    dtable, dcenters and the weight gradients within rtol 1e-5 / atol 1e-5
    (fp32 roundoff), the tie split evenly between the two rows."""
    from garment4d_tpu.ops import group_pe_max as jgroup_pe_max

    Bs, Nt, M, S, C, F = 1, 40, 12, 4, 6, 32
    table = rng.randn(Bs, Nt, C).astype(np.float32)
    if tie == "duplicate row":
        table[:, 27] = table[:, 25]
        pair = (25, 27)
    else:
        table[:, 30:] = 0.0
        pair = (30, 35)
    idx = rng.randint(0, 20, (Bs, M, S)).astype(np.int32)
    idx[:, :, 0], idx[:, :, 2] = pair  # the pair's rows read nowhere else
    centers = (0.1 * rng.randn(Bs, M, 3)).astype(np.float32)
    k0 = (0.3 * rng.randn(C, F)).astype(np.float32)
    b0 = (0.1 * rng.randn(F)).astype(np.float32)
    k1 = (0.3 * rng.randn(F, F)).astype(np.float32)
    b1 = (0.1 * rng.randn(F)).astype(np.float32)
    cot = rng.randn(Bs, M, F).astype(np.float32)
    args = (table, centers, k0, b0, k1, b1)
    jout, vjp = jax.vjp(lambda t, c, a0, a1, a2, a3: jgroup_pe_max(
        t, jnp.asarray(idx), c, a0, a1, a2, a3), *[jnp.asarray(a) for a in args])
    want = vjp(jnp.asarray(cot))
    leaves = [_t(a).requires_grad_(True) for a in args]
    out = tops.group_pe_max(leaves[0], _t(idx), *leaves[1:], table_grad=True)
    got = torch.autograd.grad((out * _t(cot)).sum(), leaves)
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=1e-5, atol=1e-5)
    dtable = np.asarray(want[0])[0]
    assert np.abs(dtable[pair[1]]).sum() > 0  # the tie routes
    np.testing.assert_allclose(_np(got[0])[0, pair[0]], _np(got[0])[0, pair[1]],
                               rtol=1e-5, atol=1e-6)  # split evenly
    for name, g, w in zip(("dtable", "dcenters", "dk0", "db0", "dk1", "db1"), got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("config,name,lbs_k", [("cfgs/trousers.yaml", "Trousers", 128),
                                               ("cfgs/tshirt.yaml", "Tshirt", 256)])
def test_entry_point_class(tmp_path, monkeypatch, config, name, lbs_k):
    """One synthetic posed epoch of `train_temporal.main` per config: the
    model it builds is the class's (name, label, garment samples, the
    config's LBSK), and its losses are finite."""
    built = []
    make_state = train_temporal._make_state

    def recording(*args, **kwargs):
        built.append(make_state(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(train_temporal, "_make_state", recording)
    hist = train_temporal.main(
        ["--config", config, "--GarmentPCALBS", "1", "--synthetic_data", "1",
         "--batch_size", "1", "--T", "2", "--npoints", "512", "--epoch_num", "1",
         "--output_dir", str(tmp_path / name)], device="cpu")
    model = built[0][0].model
    assert model.assets.name == name and model.lbs_k == lbs_k
    assert model.canonical.garment_label == {"Trousers": 5, "Tshirt": 6}[name]
    assert model.garment_pe2.nsample == (4 if name == "Trousers" else 8)
    assert model.radii["garment_nsample"] == ((32, 8, 4) if name == "Trousers"
                                              else (32, 16, 8))
    assert len(hist) == 1
    for split in ("train", "eval"):
        assert all(np.isfinite(v) for v in hist[0][split].values()), split
