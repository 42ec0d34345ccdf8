"""The port's post-processing (`garment4d_tpu_torch/data/postprocess.py`)
and the projection of `tools/transfer.py` against the JAX package's, on the
CPU (`device="cpu"`), modelled on tests/test_postprocess.py and
tests/test_tools.py. A 48-vertex ring garment (6 x 8) and 200- and
300-vertex `synthetic_smpl` bodies; the JAX side runs its plain XLA and
numpy paths.

Tolerances:
- `laplacian_smooth`, 100 steps: 1e-5;
- `detect_penetration`: masks, nearest vertices and normals bitwise on the
  rows where JAX's float32 gap between the first and second neighbour
  exceeds 1e-4 (JAX's CPU path takes the expansion form of the distance,
  the port the difference form);
- `_project_points_to_triangles` / `surface_correspondence`: face indices
  bitwise, barycentrics within 1e-12 (bitwise here: the port writes the
  sums in numpy's orders);
- `nearest_surface_points`: within 1e-6 of JAX's (float32 normals cast to
  float64) and within 1e-12 of a float64 numpy oracle: the port computes
  the body normals in float64 (a reference fix);
- `remove_interpenetration` with `garment_faces`: the same rounds,
  vertices within 1e-5 (also inside `process_frame`; its whole result
  within 1e-4 of JAX's, the smoothing's float32 rounding amplified by the
  solve); `garment_faces=None` is refused (a reference fix: the JAX
  package silently skips the push-out flip).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from garment4d_tpu import ops as jops
from garment4d_tpu.data import postprocess as jpost
from garment4d_tpu.models import GarmentAssets as JAssets
from garment4d_tpu.tools import transfer as jtransfer

from garment4d_tpu_torch import ops as tops
from garment4d_tpu_torch.data import postprocess as tpost
from garment4d_tpu_torch.smpl import synthetic_smpl
from garment4d_tpu_torch.tools import transfer as ttransfer
from torch_port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ring():
    return JAssets.synthetic(num_rings=6, ring_size=8)


@pytest.fixture(scope="module")
def body():
    m = synthetic_smpl(num_verts=300, device="cpu")
    return m.v_template.numpy(), m.faces


def _oracle_nearest(points, body_v, faces):
    """`nearest_surface_points` in float64 numpy throughout: the JAX
    package's algorithm with float64 face and vertex normals."""
    f = np.asarray(faces, np.int64)
    fi, bary, vidx = jtransfer.surface_correspondence(body_v, f, points)
    v = np.asarray(body_v, np.float64)
    nearest = np.einsum("pk,pkd->pd", bary, v[vidx])
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-6)
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    vn = vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-6)
    zero = bary <= 0.0
    nz = zero.sum(1)
    normals = fn[fi].copy()
    rows = np.where(nz == 2)[0]
    normals[rows] = vn[vidx[rows, np.argmin(zero[rows], axis=1)]]
    rows = np.where(nz == 1)[0]
    ends = vidx[rows][~zero[rows]].reshape(len(rows), 2)
    normals[rows] = vn[ends[:, 0]] + vn[ends[:, 1]]
    return nearest, normals / (np.linalg.norm(normals, axis=-1, keepdims=True) + 1e-10)


def test_laplacian_smooth_100_steps(ring, rng):
    adj = tops.build_mesh_adjacency(ring.faces, ring.num_verts)
    norm = tops.row_normalize(adj)
    v = (ring.template_v[None] + 0.05 * rng.randn(3, ring.num_verts, 3)).astype(np.float32)
    got = tpost.laplacian_smooth(torch.from_numpy(v), torch.from_numpy(norm))
    want = np.asarray(jpost.laplacian_smooth(jnp.asarray(v), jnp.asarray(norm)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_detect_penetration_and_push(body, rng):
    body_v, faces = body
    bv = np.stack([body_v, body_v + 0.01 * rng.randn(*body_v.shape).astype(np.float32)])
    bvn = np.asarray(jops.vertex_normals(jnp.asarray(bv), faces))
    garment = (bv[:, :120] - 0.01 * bvn[:, :120] + 0.02 * rng.randn(2, 120, 3)).astype(np.float32)
    got = tpost.detect_penetration(torch.from_numpy(garment), torch.from_numpy(bv),
                                   torch.from_numpy(bvn))
    want = jpost.detect_penetration(jnp.asarray(garment), jnp.asarray(bv), jnp.asarray(bvn))
    d2 = np.asarray(jops.knn_points(jnp.asarray(garment), jnp.asarray(bv), K=2).dists)
    clear = (d2[..., 1] - d2[..., 0]) > 1e-4
    assert clear.mean() > 0.9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[clear], np.asarray(w)[clear])
    assert 0.2 < got[0].float().mean() < 0.9
    inside, nearest, normal = got
    pushed = tpost.push_out_targets(torch.from_numpy(garment), inside, nearest, normal)
    want_pushed = jpost.push_out_targets(jnp.asarray(garment), *(jnp.asarray(t.numpy())
                                                                 for t in got))
    np.testing.assert_array_equal(pushed.numpy(), np.asarray(want_pushed))


def test_point_triangle_projection(body, rng):
    """The regions of one triangle (as the JAX test), then a body's soup:
    distances and barycentrics bitwise JAX's numpy."""
    tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float64)
    pts = np.array([[0.25, 0.25, 1.0], [2.0, -1.0, 0.0], [-1.0, -1.0, 0.5],
                    [0.5, -2.0, 0.0], [2.0, 2.0, 0.0]])
    d2, bary = ttransfer._project_points_to_triangles(torch.from_numpy(pts),
                                                      torch.from_numpy(tri))
    np.testing.assert_allclose(bary[:, 0].numpy(), [[0.5, 0.25, 0.25], [0, 1, 0], [1, 0, 0],
                                                    [0.5, 0.5, 0], [0, 0.5, 0.5]], atol=1e-12)
    body_v, faces = body
    tri = body_v.astype(np.float64)[faces.astype(np.int64)]
    pts = rng.randn(150, 3) * 0.4
    d2, bary = ttransfer._project_points_to_triangles(torch.from_numpy(pts),
                                                      torch.from_numpy(tri))
    jd2, jbary = jtransfer._project_points_to_triangles(pts, tri)
    np.testing.assert_array_equal(d2.numpy(), jd2)
    np.testing.assert_allclose(bary.numpy(), jbary, rtol=0, atol=1e-12)


def test_surface_correspondence_and_transfer(body, rng):
    body_v, faces = body
    dst = rng.randn(200, 3) * 0.4
    got = ttransfer.surface_correspondence(body_v, faces, dst, chunk=64, device="cpu")
    want = jtransfer.surface_correspondence(body_v, faces, dst, chunk=64)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got[2], want[2])
    M = ttransfer.deformation_transfer_matrix(body_v, faces, dst[:50], device="cpu")
    np.testing.assert_allclose(M, jtransfer.deformation_transfer_matrix(body_v, faces, dst[:50]),
                               rtol=0, atol=1e-7)
    src = torch.from_numpy(rng.randn(2, len(body_v), 3).astype(np.float32))
    np.testing.assert_allclose(
        ttransfer.apply_deformation_transfer(M, src).numpy(),
        np.asarray(jtransfer.apply_deformation_transfer(M, src.numpy())), rtol=1e-5, atol=1e-5)


def test_nearest_surface_points(body, rng):
    body_v, faces = body
    pts = rng.randn(200, 3) * 0.4
    near, nrm = tpost.nearest_surface_points(pts, body_v, faces, device="cpu")
    jnear, jnrm = jpost.nearest_surface_points(pts, body_v, faces)
    np.testing.assert_allclose(near, jnear, rtol=0, atol=1e-12)
    np.testing.assert_allclose(nrm, jnrm, rtol=0, atol=1e-6)
    onear, onrm = _oracle_nearest(pts, body_v, faces)
    np.testing.assert_allclose(near, onear, rtol=0, atol=1e-12)
    np.testing.assert_allclose(nrm, onrm, rtol=0, atol=1e-12)
    # the float64 normals are not the float32 ones cast (the reference fix)
    assert np.abs(nrm - jnrm).max() > 1e-10


def test_region_normals_and_ties():
    """The JAX test's cases: an interior projection far from every vertex,
    a vertex region (the vertex normal), a boundary edge (the sum of its two
    vertex normals); a point whose nearest point is a vertex shared by both
    faces takes the first face."""
    body_v = np.array([[0, 0, 0], [2, 0, 0], [1, 2, 0], [3, 2, 1.0]], np.float64)
    faces = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    pts = np.array([[1.0, 0.5, 0.5], [-1.0, -1.0, 0.3], [1.0, -1.0, 0.2], [2.0, 2.0, 3.0]])
    near, nrm = tpost.nearest_surface_points(pts, body_v, faces, device="cpu")
    jnear, jnrm = jpost.nearest_surface_points(pts, body_v, faces)
    np.testing.assert_allclose(near, jnear, rtol=0, atol=1e-12)
    np.testing.assert_allclose(nrm, jnrm, rtol=0, atol=1e-6)
    onear, onrm = _oracle_nearest(pts, body_v, faces)
    np.testing.assert_allclose(nrm, onrm, rtol=0, atol=1e-12)
    np.testing.assert_allclose(near[0], [1.0, 0.5, 0.0], atol=1e-12)
    fi, _, _ = ttransfer.surface_correspondence(body_v, faces, body_v[[2, 1]], device="cpu")
    np.testing.assert_array_equal(fi, [0, 0])  # shared vertices: the first face


def test_remove_interpenetration_matches_jax(ring, body):
    """A garment deep inside the body (several rounds): the same rounds and
    vertices within 1e-5, with the garment faces."""
    body_v, faces = body
    adj = tops.build_mesh_adjacency(ring.faces, ring.num_verts)
    garment = ring.template_v * 0.02
    got, rounds = tpost.remove_interpenetration(garment, body_v, faces, adj, ring.faces_tri,
                                                return_rounds=True, device="cpu")
    want, jrounds = jpost.remove_interpenetration(garment, body_v, faces, adj,
                                                  garment_faces=ring.faces_tri,
                                                  return_rounds=True)
    assert rounds == jrounds >= 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_process_frame_matches_jax(ring, body, rng):
    """The port's smoothing, then its removal: on the port's smoothed
    garment the removal is JAX's (the same rounds, within 1e-5); against
    JAX's whole `process_frame` within 1e-4, since the two smoothings
    differ by float32 rounding (1e-6) and the solve moves a vertex that
    flips inside by more."""
    body_v, faces = body
    adj = tops.build_mesh_adjacency(ring.faces, ring.num_verts)
    norm = tops.row_normalize(adj)
    garment = (ring.template_v * 0.3 + 0.01 * rng.randn(ring.num_verts, 3)).astype(np.float32)
    got, rounds = tpost.process_frame(garment, body_v, faces, adj, norm,
                                      garment_faces=ring.faces_tri, return_rounds=True,
                                      device="cpu")
    smoothed = tpost.laplacian_smooth(torch.from_numpy(garment[None]),
                                      torch.from_numpy(norm))[0].numpy()
    want, jrounds = jpost.remove_interpenetration(smoothed, body_v, faces, adj,
                                                  garment_faces=ring.faces_tri,
                                                  return_rounds=True)
    assert rounds == jrounds and 1 <= rounds <= 5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    whole = jpost.process_frame(garment, body_v, faces, adj, norm,
                                garment_faces=ring.faces_tri)
    np.testing.assert_allclose(got, whole, rtol=1e-4, atol=1e-4)


def test_garment_faces_required(ring, body):
    body_v, faces = body
    adj = tops.build_mesh_adjacency(ring.faces, ring.num_verts)
    with pytest.raises(ValueError, match="garment_faces is required"):
        tpost.remove_interpenetration(ring.template_v, body_v, faces, adj, None, device="cpu")
    with pytest.raises(ValueError, match="garment_faces is required"):
        tpost.process_frame(ring.template_v, body_v, faces, adj, tops.row_normalize(adj),
                            garment_faces=None, device="cpu")
    with pytest.raises(TypeError):
        tpost.process_frame(ring.template_v, body_v, faces, adj, tops.row_normalize(adj),
                            device="cpu")


def test_default_device_is_the_card(body, monkeypatch):
    """Without `device`, the tools ask for the card (here: none visible)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    body_v, faces = body
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpost.nearest_surface_points(body_v[:3], body_v, faces)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttransfer.surface_correspondence(body_v, faces, body_v[:3])
