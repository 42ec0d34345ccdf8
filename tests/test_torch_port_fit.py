"""The port's body fitting, SMPL rotation-matrix forward and joint
metadata (`garment4d_tpu_torch/tools/fit_body.py`, `tools/transfer.py:
fit_smpl_staged`, `smpl/model.py:forward_rotmats`, `smpl/joints.py`)
against the JAX package's, on the CPU, modelled on tests/test_tools.py.
250-vertex `synthetic_smpl` bodies, few iterations.

Tolerances:
- `forward_rotmats`: within 1e-5 of JAX's and of the port's own axis-angle
  forward on the same rotations;
- `joints_with_extras` / `select_extra_joints`: bitwise;
- `nearest_vertex_correspondence`: indices bitwise where JAX's float32 gap
  to the next neighbour exceeds 1e-4 (JAX's CPU K-NN takes the expansion
  form of the distance, the port the difference form), weights within 1e-6
  there of the JAX package's weights on its difference-form distances, and
  within 1e-3 of its function's (the expansion form's ~1e-7 absolute error
  in a squared distance of ~1e-4);
- `fit_smpl_to_vertices(use_lbfgs=False)`: within 1e-4 of optax's Adam
  after 50 steps;
- the LBFGS and staged fits: a residual bound on targets the JAX package
  fits too (its own tests' bounds). The two LBFGS implementations
  (`torch.optim.LBFGS`, optax's) are not bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from garment4d_tpu import ops as jops
from garment4d_tpu import smpl as jsmpl
from garment4d_tpu.smpl import joints as jjoints
from garment4d_tpu.tools import fit_body as jfit

from garment4d_tpu_torch import smpl as tsmpl
from garment4d_tpu_torch.smpl.model import NUM_BODY_VERTS
from garment4d_tpu_torch.tools import fit_body as tfit
from garment4d_tpu_torch.tools import transfer as ttransfer
from torch_port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def models():
    return (tsmpl.synthetic_smpl(num_verts=250, device="cpu"),
            jsmpl.synthetic_smpl(num_verts=250))


def _err(a, b):
    return np.sqrt(((np.asarray(a) - np.asarray(b)) ** 2).sum(-1)).mean()


def test_forward_rotmats(models, rng):
    tmodel, jmodel = models
    betas = (rng.randn(2, 10) * 0.5).astype(np.float32)
    pose = (rng.randn(2, 72) * 0.3).astype(np.float32)
    rot = tsmpl.batch_rodrigues(torch.from_numpy(pose).reshape(2, 24, 3))
    v, j = tmodel.forward_rotmats(torch.from_numpy(betas), rot)
    jv, jj = jmodel.forward_rotmats(jnp.asarray(betas), jnp.asarray(rot.numpy()))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), rtol=1e-5, atol=1e-5)
    av, aj = tmodel.forward_axis_angle(torch.from_numpy(betas), torch.from_numpy(pose))
    np.testing.assert_allclose(v.numpy(), av.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(j.numpy(), aj.numpy(), rtol=1e-5, atol=1e-5)


def test_joint_metadata(rng):
    assert tsmpl.SMPL_JOINT_NAMES == jjoints.SMPL_JOINT_NAMES
    assert tsmpl.SMPL_VERTEX_IDS == jjoints.SMPL_VERTEX_IDS
    assert [tsmpl.joint_index(n) for n in tsmpl.SMPL_JOINT_NAMES] == list(range(24))
    verts = rng.randn(2, NUM_BODY_VERTS, 3).astype(np.float32)
    joints = rng.randn(2, 24, 3).astype(np.float32)
    got = tsmpl.joints_with_extras(torch.from_numpy(joints), torch.from_numpy(verts))
    want = jjoints.joints_with_extras(jnp.asarray(joints), jnp.asarray(verts))
    assert got.shape == (2, 24 + len(tsmpl.SMPL_VERTEX_IDS), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ids = [332, 6260, 17]
    np.testing.assert_array_equal(
        tsmpl.select_extra_joints(torch.from_numpy(verts), ids).numpy(),
        np.asarray(jjoints.select_extra_joints(jnp.asarray(verts), ids)))


def test_nearest_vertex_correspondence(models, rng):
    tmodel, _ = models
    src = tmodel.v_template.numpy()
    sel = rng.permutation(250)[:120]
    dst = src[sel] + 0.01 * rng.randn(120, 3).astype(np.float32)
    idx, w = tfit.nearest_vertex_correspondence(src, dst, K=3, device="cpu")
    jidx, jw = jfit.nearest_vertex_correspondence(src, dst, K=3)
    d2 = np.asarray(jops.knn_points(jnp.asarray(dst[None]), jnp.asarray(src[None]),
                                    K=4).dists)[0]
    clear = (np.diff(d2, axis=1) > 1e-4).all(axis=1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(idx[clear], jidx[clear])
    # the JAX package's weights on its difference-form distances
    exact = jops.knn_points(jnp.asarray(dst[None]), jnp.asarray(src[None]), K=3, exact=True)
    np.testing.assert_array_equal(idx[clear], np.asarray(exact.idx[0])[clear])
    jw_exact = 1.0 / np.maximum(np.asarray(exact.dists[0]), 1e-9)
    jw_exact = (jw_exact / jw_exact.sum(axis=1, keepdims=True)).astype(np.float32)
    np.testing.assert_allclose(w[clear], jw_exact[clear], rtol=0, atol=1e-6)
    # its own function's expansion-form distances err by ~1e-7 absolute,
    # which moves a weight by ~1e-3 relative at these 0.01-unit distances
    np.testing.assert_allclose(w[clear], jw[clear], rtol=0, atol=1e-3)
    assert idx.dtype == np.int32 and w.dtype == np.float32
    # exact copies at K=1: each target's own vertex
    idx1, w1 = tfit.nearest_vertex_correspondence(src, src[sel], K=1, device="cpu")
    np.testing.assert_array_equal(idx1[:, 0], sel)
    np.testing.assert_array_equal(w1, 1.0)


def test_stable_ties_go_low():
    """K > 1: equal distances keep the lower index first (a stable sort)."""
    src = np.array([[1, 0, 0], [-1, 0, 0], [0, 2, 0], [1, 0, 0]], np.float32)
    idx, _ = tfit.nearest_vertex_correspondence(src, np.zeros((1, 3), np.float32), K=3,
                                                device="cpu")
    np.testing.assert_array_equal(idx[0], [0, 1, 3])


def test_adam_fit_matches_optax(models, rng):
    tmodel, jmodel = models
    betas = (rng.randn(1, 10) * 0.5).astype(np.float32)
    pose = (rng.randn(1, 72) * 0.1).astype(np.float32)
    target, _ = jmodel.forward_axis_angle(jnp.asarray(betas), jnp.asarray(pose))
    kw = dict(iters=50, use_lbfgs=False, lr=0.05, shape_reg=1e-5, pose_reg=1e-5)
    got = tfit.fit_smpl_to_vertices(tmodel, np.asarray(target), **kw)
    want = jfit.fit_smpl_to_vertices(jmodel, target, **kw)
    for k in ("betas", "pose", "transl", "vertices"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=1e-4, atol=1e-4)
    assert got.final_loss == pytest.approx(want.final_loss, rel=1e-3, abs=1e-7)


def test_lbfgs_fit(models, rng):
    """The JAX test's LBFGS target (shape only, 50 iterations): both fit it
    within its bound of 0.05, the port far below it."""
    tmodel, jmodel = models
    betas = (rng.randn(1, 10) * 0.3).astype(np.float32)
    target, _ = jmodel.forward_axis_angle(jnp.asarray(betas), jnp.zeros((1, 72)))
    kw = dict(iters=50, use_lbfgs=True, shape_reg=1e-6, pose_reg=1e-6)
    got = tfit.fit_smpl_to_vertices(tmodel, np.asarray(target), **kw)
    want = jfit.fit_smpl_to_vertices(jmodel, target, **kw)
    assert _err(want.vertices, target) < 0.05
    assert _err(got.vertices, target) < 0.01
    assert got.final_loss < 1e-4


def test_correspondence_fit(models, rng):
    """A target of another topology (a jittered subset, mapped by the K=3
    correspondence), LBFGS: the selected vertices within 0.05."""
    tmodel, _ = models
    betas = torch.from_numpy((rng.randn(1, 10) * 0.3).astype(np.float32))
    full, _ = tmodel.forward_axis_angle(betas, torch.zeros(1, 72))
    sel = rng.permutation(250)[:120]
    rest = tmodel.v_template.numpy()
    dst_rest = rest[sel] + 0.002 * rng.randn(120, 3).astype(np.float32)
    corr = tfit.nearest_vertex_correspondence(rest, dst_rest, K=3, device="cpu")
    target = full.numpy()[:, sel]
    res = tfit.fit_smpl_to_vertices(tmodel, target, correspondence=corr, iters=60,
                                    shape_reg=1e-6, pose_reg=1e-6)
    assert _err(res.vertices[:, sel], target) < 0.05


def test_staged_fit(models):
    """The JAX test's staged target (root orientation, some body pose,
    shape, a translation), the JAX test's bound of 0.02."""
    tmodel, _ = models
    rng = np.random.RandomState(1)
    pose = np.zeros((1, 72), np.float32)
    pose[:, :3] = 0.4
    pose[:, 3:9] = 0.2
    betas = (rng.randn(1, 10) * 0.3).astype(np.float32)
    target, _ = tmodel.forward_axis_angle(torch.from_numpy(betas), torch.from_numpy(pose))
    target = target + torch.tensor([[0.1, -0.05, 0.2]])[:, None, :]
    res = ttransfer.fit_smpl_staged(tmodel, target, iters=(40, 80, 80))
    fitted, _ = tmodel.forward_axis_angle(torch.from_numpy(res.betas),
                                          torch.from_numpy(res.pose))
    fitted = fitted.numpy() + res.transl[:, None, :]
    assert _err(fitted, target) < 0.02
    np.testing.assert_allclose(res.vertices, fitted, rtol=0, atol=1e-6)


def test_default_device_is_the_card(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = models[0].v_template.numpy()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfit.nearest_vertex_correspondence(src, src[:3])
