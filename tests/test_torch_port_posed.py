"""Parity of the torch port's posed-stage slice with the JAX package, on the
CPU: interpolated LBS, the GCN stack, the Flax-checkpoint conversion of the
posed tree, and the whole PosedGarmentModel forward at identical weights.

Shapes are small: a 48-vertex ring garment (`synthetic(6, 8)`), a
1100-vertex synthetic body (N >= 1024, so the body queries take the
candidate-compaction path), B=1, T=2, N=512 points, lbs_k=16, 3 iterations.
The same numpy inputs go to both packages. Tolerances: every
`iter_garment_v` within atol 1e-4 (fp32 roundoff through the canonical
stage and three 4-layer GCNs), the LBS result within 1e-5, indices equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from garment4d_tpu import ops as jops
from garment4d_tpu import smpl as jsmpl
from garment4d_tpu.data.synthetic import make_batch as jmake_batch
from garment4d_tpu.models import GarmentAssets as JAssets
from garment4d_tpu.models import PosedGarmentModel as JPosed
from garment4d_tpu.models.posed import _SMPL_PARENTS
from garment4d_tpu.models.skinning import lbs_garment_interpolation as jlbs
from garment4d_tpu.train.step import body_inputs_from_batch as jbody_inputs

from garment4d_tpu_torch import ops as tops
from garment4d_tpu_torch import smpl as tsmpl
from garment4d_tpu_torch.api import GarmentReconstructor
from garment4d_tpu_torch.data.synthetic import make_batch as tmake_batch
from garment4d_tpu_torch.models import GarmentAssets as TAssets
from garment4d_tpu_torch.models.skinning import lbs_garment_interpolation as tlbs
from garment4d_tpu_torch.train.convert import flax_to_torch, load_npz
from garment4d_tpu_torch.train.step import body_inputs_from_batch as tbody_inputs
from torch_port_threads import one_torch_thread  # noqa: F401

B, T, N = 1, 2, 512
NB = 1100  # body vertices
LBS_K = 16
WEIGHTS = "ckpt_synth/posed_synth.npz"


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_assets(jassets):
    """The port's GarmentAssets holding exactly the JAX assets' arrays."""
    return TAssets(**{f.name: getattr(jassets, f.name)
                      for f in dataclasses.fields(TAssets)})


@pytest.fixture(scope="module")
def jbody():
    return jsmpl.synthetic_smpl(num_verts=NB)


def _random_variables(model, pcd, body, jassets, jbody, rng):
    """Numpy-drawn variables of the JAX posed model, shaped by an abstract
    init (no compile): kernels ~ N(0, 1/fan_in), GCN weights
    U(-1/sqrt(out), 1/sqrt(out)), biases, BatchNorm affines and statistics
    off their init values; the constants as the model builds them."""
    shapes = jax.eval_shape(
        lambda p, b: model.init(jax.random.PRNGKey(0), p, b, train=False), pcd, body)
    flat = {}
    for coll in ("params", "batch_stats"):
        for k, v in traverse_util.flatten_dict(shapes[coll], sep="/").items():
            shape, leaf = v.shape, k.rsplit("/", 1)[-1]
            if leaf == "kernel":
                a = rng.randn(*shape) / np.sqrt(shape[0])
            elif leaf == "weight":
                a = rng.uniform(-1.0, 1.0, shape) / np.sqrt(shape[1])
            elif leaf == "var":
                a = rng.uniform(0.8, 1.2, shape)
            elif leaf == "scale":
                a = 1.0 + 0.1 * rng.randn(*shape)
            else:  # bias, mean
                a = 0.05 * rng.randn(*shape)
            flat[f"{coll}/{k}"] = a.astype(np.float32)
    tree = traverse_util.unflatten_dict(flat, sep="/")
    constants = {
        "body_faces": jnp.asarray(np.asarray(jbody.faces, np.int32)),
        "smooth_op": jnp.asarray(jassets.smooth_op),
        "gcn_adj": jnp.asarray(jassets.gcn_adj),
        "canonical": {k: jnp.asarray(getattr(jassets, k)) for k in
                      ("pca_components", "pca_mean", "pca_scale")},
    }
    return flat, dict(params=tree["params"], batch_stats=tree["batch_stats"],
                      constants=constants)


def _setup(jassets, jbody, seed):
    """JAX batch, random JAX posed variables and the JAX forward's output
    (one compile: the apply)."""
    batch = jmake_batch(jassets, jbody, batch_size=B, T=T, npoints=N, seed=seed)
    body = jbody_inputs(batch)
    model = JPosed(assets=jassets, body_faces=jbody.faces, lbs_k=LBS_K, iterations=3)
    flat, variables = _random_variables(model, batch["pcd"], body, jassets, jbody,
                                        np.random.RandomState(seed))
    out = jax.jit(lambda v, p, b: model.apply(v, p, b, train=False))(
        variables, batch["pcd"], body)
    return batch, flat, out


def _port_forward(jassets, jbody, batch, flat):
    tbody = tsmpl.SmplModel(**{f.name: getattr(jbody, f.name) if f.name in ("parents", "faces")
                               else _t(getattr(jbody, f.name))
                               for f in dataclasses.fields(tsmpl.SmplModel)})
    recon = GarmentReconstructor.from_assets(
        _port_assets(jassets), tbody, device="cpu", state_dict=flax_to_torch(flat),
        lbs_k=LBS_K)
    tbatch = {k: _t(v) for k, v in batch.items()}
    return recon, recon.posed(tbatch["pcd"], tbody_inputs(tbatch), return_all=True)


@pytest.fixture(scope="module")
def ring():
    jassets = JAssets.synthetic(num_rings=6, ring_size=8)
    return jassets


@pytest.fixture(scope="module")
def shuffled(ring):
    jassets = ring.permuted(np.random.RandomState(11).permutation(ring.num_verts))
    assert jops.graph.cyclic_diagonals(jassets.gcn_adj) is None
    return jassets


@pytest.mark.parametrize("template", ["ring", "shuffled"])
def test_posed_forward_parity(request, template, jbody):
    jassets = request.getfixturevalue(template)
    batch, flat, jout = _setup(jassets, jbody, seed=3)
    recon, tout = _port_forward(jassets, jbody, batch, flat)
    assert recon.model.band_reordered == (template == "shuffled")
    np.testing.assert_array_equal(tout.lbs.nn_idx.numpy(), np.asarray(jout.lbs.nn_idx))
    np.testing.assert_allclose(tout.lbs.posed_garment.numpy(),
                               np.asarray(jout.lbs.posed_garment), atol=1e-5)
    assert len(tout.iter_garment_v) == 3
    for i, (a, b) in enumerate(zip(tout.iter_garment_v, jout.iter_garment_v)):
        assert a.shape == (B, T, jassets.num_verts, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   err_msg=f"iteration {i}")
    np.testing.assert_allclose(
        recon.posed(_t(batch["pcd"]), tbody_inputs({k: _t(v) for k, v in batch.items()})).numpy(),
        np.asarray(jout.iter_garment_v[-1]), atol=1e-4)


@pytest.mark.parametrize("K", [16, 96])
def test_lbs_garment_interpolation(jbody, ring, K):
    """K=16: K64 == K; K=96: K64 = 64 < K."""
    batch = jmake_batch(ring, jbody, batch_size=2, T=2, npoints=256, seed=5)
    rng = np.random.RandomState(K)
    garment = (ring.template_v[None] + 0.02 * rng.randn(2, ring.num_verts, 3)).astype(np.float32)
    args = [garment] + [np.asarray(batch[k]) for k in (
        "tpose_smpl_vertices", "tpose_smpl_root_joints", "zeropose_smpl_vertices",
        "pose", "J_regressor", "lbs_weights")]
    want = jlbs(*[jnp.asarray(a) for a in args], parents=_SMPL_PARENTS,
                smooth_op=jnp.asarray(ring.smooth_op), K=K)
    got = tlbs(*[_t(a) for a in args], parents=_SMPL_PARENTS,
               smooth_op=_t(ring.smooth_op), K=K)
    np.testing.assert_array_equal(got.nn_idx.numpy(), np.asarray(want.nn_idx))
    assert got.nn_idx.dtype == torch.int32
    np.testing.assert_allclose(got.posed_garment.numpy(), np.asarray(want.posed_garment),
                               atol=1e-5)
    np.testing.assert_allclose(got.unposed_garment.numpy(),
                               np.asarray(want.unposed_garment), atol=1e-5)


@pytest.mark.parametrize("banded", [True, False])
def test_gcn_stack(ring, rng, banded):
    V = ring.num_verts
    widths = (3, 32, 32, 128)
    xs = [rng.randn(3, V, w).astype(np.float32) for w in widths]
    dims = (sum(widths), 128, 128, 128, 3)
    ws = [(rng.randn(a, b) / np.sqrt(a)).astype(np.float32) for a, b in zip(dims, dims[1:])]
    bs = [(0.1 * rng.randn(b)).astype(np.float32) for b in dims[1:]]
    offsets = jops.graph.cyclic_diagonals(ring.gcn_adj) if banded else None
    assert banded == (offsets is not None)
    relus = (True, True, True, False)
    jo, jh = jops.graph.gcn_stack(tuple(jnp.asarray(x) for x in xs),
                                  tuple(jnp.asarray(w) for w in ws),
                                  tuple(jnp.asarray(b) for b in bs),
                                  jnp.asarray(ring.gcn_adj), offsets, relus, 2)
    to, th = tops.gcn_stack([_t(x) for x in xs], [_t(w) for w in ws],
                            [_t(b) for b in bs], _t(ring.gcn_adj), offsets, relus, 2)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)


def test_vertex_normals(jbody, rng):
    v = rng.randn(2, NB, 3).astype(np.float32)
    want = jops.vertex_normals(jnp.asarray(v), jbody.faces)
    got = tops.vertex_normals(_t(v), jbody.faces)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_bandwidth_permutation_matches_jax(shuffled):
    jp, jo = jops.graph.bandwidth_permutation(shuffled.gcn_adj)
    tp, to = tops.bandwidth_permutation(shuffled.gcn_adj)
    np.testing.assert_array_equal(tp, jp)
    assert to == jo is not None


def test_whole_posed_npz_loads_strict(ring):
    body = tsmpl.synthetic_smpl(num_verts=200, device="cpu")
    recon = GarmentReconstructor.from_npz(_port_assets(ring), body, WEIGHTS, device="cpu")
    sd = recon.model.state_dict()
    with np.load(WEIGHTS) as data:
        posed_keys = [k for k in data.files if "/canonical/" not in k]
        assert len(posed_keys) == 50
        for key in posed_keys:
            coll, *path, leaf = key.split("/")
            name = {"kernel": "weight", "weight": "weight", "bias": "bias"}[leaf]
            want = data[key].T if leaf == "kernel" else data[key]
            np.testing.assert_array_equal(sd[".".join(path + [name])].numpy(), want)


def test_square_gcn_weight_is_not_transposed(ring, rng):
    """`params/gcn*_*/weight` is (in, out) in both packages: a square
    128x128 layer gives the JAX output, which its transpose would not."""
    V = ring.num_verts
    w = rng.randn(128, 128).astype(np.float32) / 11.0
    b = (0.1 * rng.randn(128)).astype(np.float32)
    sd = flax_to_torch({"params/gcn0_1/weight": w, "params/gcn0_1/bias": b})
    x = rng.randn(2, V, 128).astype(np.float32)
    offsets = jops.graph.cyclic_diagonals(ring.gcn_adj)
    jo, _ = jops.graph.gcn_stack((jnp.asarray(x),), (jnp.asarray(w),), (jnp.asarray(b),),
                                 jnp.asarray(ring.gcn_adj), offsets, (True,), 0)
    to, _ = tops.gcn_stack([_t(x)], [sd["gcn0_1.weight"]], [sd["gcn0_1.bias"]],
                           _t(ring.gcn_adj), offsets, (True,), 0)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    tt, _ = tops.gcn_stack([_t(x)], [sd["gcn0_1.weight"].t()], [sd["gcn0_1.bias"]],
                           _t(ring.gcn_adj), offsets, (True,), 0)
    assert not np.allclose(tt.numpy(), np.asarray(jo), atol=1e-3)


def test_load_npz_keys_match_the_posed_model(ring):
    from garment4d_tpu_torch.models import PosedGarmentModel

    model = PosedGarmentModel(_port_assets(ring), np.zeros((1, 3), np.int64))
    assert set(load_npz(WEIGHTS)) == set(model.state_dict())


class TestDeviceDefault:
    """Without a card the entry points raise unless asked for the CPU."""

    @pytest.fixture(autouse=True)
    def no_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_from_npz_raises(self, ring):
        body = tsmpl.synthetic_smpl(num_verts=200, device="cpu")
        with pytest.raises(RuntimeError, match="cuda"):
            GarmentReconstructor.from_npz(_port_assets(ring), body, WEIGHTS)

    def test_data_entry_points_raise(self, ring):
        with pytest.raises(RuntimeError, match="cuda"):
            tsmpl.synthetic_smpl(num_verts=200)
        body = tsmpl.synthetic_smpl(num_verts=200, device="cpu")
        with pytest.raises(RuntimeError, match="cuda"):
            tmake_batch(_port_assets(ring), body, npoints=64)
        from garment4d_tpu_torch.data.synthetic import template_pose
        with pytest.raises(RuntimeError, match="cuda"):
            template_pose(2)
        assert template_pose(2, device="cpu").shape == (2, 72)
