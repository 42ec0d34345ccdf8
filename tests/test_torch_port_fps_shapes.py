"""The port's FPS and canonical stage at the JAX package's own shapes, on the
CPU.

The JAX package samples more centers than a frame has points wherever its
tests and its entry point run `npoints` 512 (`tests/test_models.py`,
`train_temporal.py`): SA1 takes 1024 centers, and the garment encoder 512
from the N // 4 points that the garment selection keeps, so every N below
2048 reaches it. Its FPS then runs on past N: once every running distance
is 0, each step takes index 0. Here the port's `furthest_point_sample` (its
plain version on the CPU; `chip_smoke.py` phase 17 holds the kernel to it on
the card) is held bitwise to the JAX package's XLA path at npoint > N, and
the port's canonical forward at N = 512 and N = 1536 to the JAX package's at
the weights of `ckpt_synth/posed_synth.npz`, with the tolerances of
`tests/test_torch_port_canonical.py` (which runs N = 2048): logits and the
T-pose garment within atol 1e-4 (fp32 roundoff through ~12 matmul layers),
labels, the garment selection and every sampled level's xyz identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from garment4d_tpu import ops as jops
from garment4d_tpu.models import CanonicalGarmentModel as JCanonical
from garment4d_tpu.models import GarmentAssets as JAssets

from garment4d_tpu_torch import ops as tops
from garment4d_tpu_torch import smpl as tsmpl
from garment4d_tpu_torch.data.synthetic import make_batch as tmake_batch
from garment4d_tpu_torch.models import CanonicalGarmentModel
from garment4d_tpu_torch.models import GarmentAssets as TAssets
from garment4d_tpu_torch.train.convert import load_npz_subtree
from torch_port_threads import one_torch_thread  # noqa: F401

WEIGHTS = "ckpt_synth/posed_synth.npz"
B, T = 1, 2


def _frames(kind: str, B: int, N: int, seed: int) -> np.ndarray:
    """(B, N, 3) float32: uniform points; every point equal; each point
    twice (the second copy at i + N // 2); or the garment selection's
    zero padding over the last quarter."""
    rng = np.random.RandomState(seed)
    pts = rng.rand(B, N, 3).astype(np.float32)
    if kind == "all_equal":
        pts[:] = np.float32(0.5)
    elif kind == "pairs":
        pts[:, N // 2:] = pts[:, :N // 2]
    elif kind == "padded":
        pts[:, N - N // 4:] = 0
    return pts


@pytest.mark.parametrize("kind,B,N,npoint", [
    ("random", 2, 100, 250), ("random", 4, 5, 12), ("all_equal", 2, 64, 200),
    ("pairs", 2, 100, 160), ("padded", 2, 128, 512)])
def test_fps_past_n_bitwise_jax(kind, B, N, npoint):
    """More centers than points: the port's FPS bitwise the JAX package's
    XLA path; past the frame's distinct points every center is index 0."""
    xyz = _frames(kind, B, N, seed=N + npoint)
    want = np.asarray(jops.furthest_point_sample(jnp.asarray(xyz), npoint, use_pallas=False))
    got = tops.furthest_point_sample(torch.from_numpy(xyz), npoint)
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    distinct = len(np.unique(xyz[0], axis=0))
    assert (want[:, distinct:] == 0).all()


@pytest.fixture(scope="module")
def canonical_pair():
    """The JAX canonical model and the port's, both at `posed_synth.npz`'s
    canonical weights (its shapes do not depend on the template's size),
    on a 192-vertex ring, and the port's synthetic 400-vertex body (the
    batches are the port's, fed to both as numpy)."""
    jassets = JAssets.synthetic(num_rings=12, ring_size=16)
    with np.load(WEIGHTS) as data:
        flat = {k: data[k] for k in data.files}
    tree = traverse_util.unflatten_dict(flat, sep="/")
    variables = dict(
        params=tree["params"]["canonical"], batch_stats=tree["batch_stats"]["canonical"],
        constants={k: jnp.asarray(getattr(jassets, k))
                   for k in ("pca_components", "pca_mean", "pca_scale")})
    jmodel = JCanonical(assets=jassets)
    tassets = TAssets.synthetic(num_rings=12, ring_size=16)
    model = CanonicalGarmentModel(tassets)
    model.load_state_dict(load_npz_subtree(WEIGHTS, "canonical"), strict=True)
    body = tsmpl.synthetic_smpl(num_verts=400, device="cpu")
    return jassets, jmodel, variables, model.eval(), tassets, body


@pytest.mark.parametrize("N", [512, 1536])
def test_canonical_forward_past_n_matches_jax(canonical_pair, N):
    """N = 512: SA1 (1024 centers) and the garment encoder (512 from 128
    selected points) both sample past N; N = 1536: only the garment encoder
    (512 from 384). The port's canonical forward against the JAX package's
    at the same weights and batch."""
    jassets, jmodel, variables, model, tassets, body = canonical_pair
    pcd = tmake_batch(tassets, body, batch_size=B, T=T, npoints=N, seed=N, device="cpu")["pcd"]
    jout = jax.jit(lambda v, p: jmodel.apply(v, p, train=False))(variables, pcd.numpy())
    with torch.inference_mode():
        tout = model(pcd)
    labels = np.asarray(jout.backbone.sem_logits.argmax(-1))
    np.testing.assert_array_equal(tout.backbone.sem_logits.argmax(-1).numpy(), labels)
    assert 0 < (labels == jassets.label).sum(-1).min()  # the encoder sees garment points
    np.testing.assert_allclose(tout.backbone.sem_logits.numpy(),
                               np.asarray(jout.backbone.sem_logits), atol=1e-4)
    for tx, jx in zip(tout.backbone.xyz, jout.backbone.xyz):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    for tx, jx in zip(tout.garment_xyz, jout.garment_xyz):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    # the sampled levels past N: SA1's centers repeat point 0 at N = 512,
    # the garment encoder's first level repeats its first selected point
    sa1, g1 = tout.backbone.xyz[1], tout.garment_xyz[1]
    n_sel = N // 4
    assert sa1.shape[1] == 1024 and g1.shape[1] == 512 > n_sel
    assert torch.equal(g1[:, -1], g1[:, 0])
    if N < 1024:
        assert torch.equal(sa1[:, -1], sa1[:, 0])
    np.testing.assert_allclose(tout.tpose_garment.numpy(), np.asarray(jout.tpose_garment),
                               atol=1e-4)
