"""Parity of the torch port's canonical-stage slice with the JAX package, on
the CPU: assets, SMPL, synthetic batch, Flax-checkpoint conversion and the
whole CanonicalGarmentModel forward at identical weights.

Shapes follow tests/test_models.py: a 192-vertex ring garment, a 400-vertex
synthetic body, B=1, T=2, N=2048. Tolerances: sem_logits and tpose_garment
atol 1e-4 (fp32 roundoff through ~12 matmul layers), labels identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from garment4d_tpu import smpl as jsmpl
from garment4d_tpu.data.synthetic import make_batch as jmake_batch
from garment4d_tpu.models import CanonicalGarmentModel as JCanonical
from garment4d_tpu.models import GarmentAssets as JAssets
from garment4d_tpu.train.checkpoint import save_variables_npz

from garment4d_tpu_torch import smpl as tsmpl
from garment4d_tpu_torch.api import GarmentReconstructor
from garment4d_tpu_torch.data.synthetic import make_batch as tmake_batch
from garment4d_tpu_torch.models import CanonicalGarmentModel
from garment4d_tpu_torch.models import GarmentAssets as TAssets
from garment4d_tpu_torch.models import select_garment_points
from garment4d_tpu_torch.train.convert import flax_to_torch, load_npz_subtree
from torch_port_threads import one_torch_thread  # noqa: F401

B, T, N = 1, 2, 2048


@pytest.fixture(scope="module")
def assets():
    return JAssets.synthetic(num_rings=12, ring_size=16), TAssets.synthetic(
        num_rings=12, ring_size=16)


@pytest.fixture(scope="module")
def bodies():
    return jsmpl.synthetic_smpl(num_verts=400), tsmpl.synthetic_smpl(num_verts=400,
                                                                     device="cpu")


@pytest.fixture(scope="module")
def batches(assets, bodies):
    return (jmake_batch(assets[0], bodies[0], batch_size=B, T=T, npoints=N),
            tmake_batch(assets[1], bodies[1], batch_size=B, T=T, npoints=N, device="cpu"))


@pytest.fixture(scope="module")
def jax_canonical(assets, batches):
    """Random JAX weights (BatchNorm moved off its init) and the JAX
    forward's outputs."""
    model = JCanonical(assets=assets[0])
    pcd = batches[0]["pcd"]
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), pcd, train=False)
    rng = np.random.RandomState(3)
    flat = {}
    for coll in ("params", "batch_stats"):
        for k, v in traverse_util.flatten_dict(variables[coll], sep="/").items():
            v = np.asarray(v)
            if k.endswith("bn/mean"):
                v = (0.05 * rng.randn(*v.shape)).astype(np.float32)
            elif k.endswith("bn/var"):
                v = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            flat[f"{coll}/{k}"] = v
    tree = traverse_util.unflatten_dict(flat, sep="/")
    variables = dict(variables, params=tree["params"],
                     batch_stats=tree["batch_stats"])
    out = jax.jit(lambda v, p: model.apply(v, p, train=False))(variables, pcd)
    return variables, flat, out


def test_synthetic_assets_bit_identical(assets):
    ja, ta = assets
    for field in ("template_v", "faces_tri", "pca_components", "pca_mean",
                  "pca_explained", "pca_scale", "gcn_adj", "lap_adj", "smooth_op"):
        np.testing.assert_array_equal(getattr(ta, field), getattr(ja, field))
    assert ta.faces == ja.faces and ta.label == ja.label


def test_smpl_forward(bodies, rng):
    jb, tb = bodies
    betas = rng.randn(3, 10).astype(np.float32) * 0.5
    pose = rng.randn(3, 72).astype(np.float32) * 0.3
    jv, jj = jb.forward_axis_angle(jnp.asarray(betas), jnp.asarray(pose))
    tv, tj = tb.forward_axis_angle(torch.from_numpy(betas), torch.from_numpy(pose))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=1e-5)


def test_make_batch_pcd(batches):
    jbatch, tbatch = batches
    np.testing.assert_allclose(tbatch["pcd"].numpy(), np.asarray(jbatch["pcd"]),
                               atol=1e-5)
    for key in ("pcd_label", "garment", "pca_coeff", "pose", "beta"):
        np.testing.assert_array_equal(tbatch[key].numpy(), np.asarray(jbatch[key]))


def test_select_garment_points_matches_python_loop(rng):
    n = 8
    xyz = rng.randn(3, 20, 3).astype(np.float32)
    feats = rng.randn(3, 20, 5).astype(np.float32)
    labels = rng.randint(0, 3, size=(3, 20))
    sx, sf = select_garment_points(torch.from_numpy(xyz), torch.from_numpy(feats),
                                   torch.from_numpy(labels), 1, n)
    for b in range(3):
        mask = labels[b] == 1
        for got, src in ((sx, xyz), (sf, feats)):
            want = src[b][mask][:n]
            want = np.concatenate([want, np.zeros((n - len(want), src.shape[-1]),
                                                  np.float32)])
            np.testing.assert_array_equal(got[b].numpy(), want)


def test_npz_round_trip_exact(assets, jax_canonical, tmp_path):
    """Flax variables -> npz -> load_npz_subtree -> the model's state_dict
    holds exactly the Flax arrays (Dense kernels transposed)."""
    variables, flat, _ = jax_canonical
    path = str(tmp_path / "vars.npz")
    save_variables_npz(path, {"params": {"canonical": variables["params"]},
                              "batch_stats": {"canonical": variables["batch_stats"]}})
    converted = load_npz_subtree(path, "canonical")
    model = CanonicalGarmentModel(assets[1])
    model.load_state_dict(converted, strict=True)
    sd = model.state_dict()
    assert set(converted) == set(sd)
    for key, array in flat.items():
        coll, *path_, leaf = key.split("/")
        name = {"kernel": "weight", "scale": "weight", "bias": "bias",
                "mean": "running_mean", "var": "running_var"}[leaf]
        want = array.T if leaf == "kernel" else array
        np.testing.assert_array_equal(sd[".".join(path_ + [name])].numpy(), want)


def test_flax_to_torch_rejects_unknown_leaves():
    with pytest.raises(KeyError):
        flax_to_torch({"params/a/embedding": np.zeros(3, np.float32)})


def test_canonical_forward_parity(assets, bodies, batches, jax_canonical):
    _, flat, jout = jax_canonical
    recon = GarmentReconstructor.from_assets(assets[1], bodies[1], device="cpu")
    recon.canonical_model.load_state_dict(flax_to_torch(flat), strict=True)
    pcd = torch.from_numpy(np.array(batches[0]["pcd"]))  # the JAX model's input
    tout = recon.run(pcd)
    np.testing.assert_allclose(tout.backbone.sem_logits.numpy(),
                               np.asarray(jout.backbone.sem_logits), atol=1e-4)
    np.testing.assert_array_equal(
        tout.backbone.sem_logits.argmax(-1).numpy(),
        np.asarray(jout.backbone.sem_logits.argmax(-1)))
    for tx, jx in zip(tout.garment_xyz, jout.garment_xyz):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(tout.tpose_garment.numpy(),
                               np.asarray(jout.tpose_garment), atol=1e-4)
    assert tout.tpose_garment.shape == (B, assets[1].num_verts, 3)
    seg = recon.segment(pcd)
    assert seg.shape == (B, T, N)
