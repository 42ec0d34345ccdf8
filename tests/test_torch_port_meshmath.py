"""The port's deterministic mesh sums (`garment4d_tpu_torch/ops/meshmath.py`)
against the JAX package and against the `index_add_` form they replace, on
the CPU.

`vertex_normals` and `cot_laplacian_apply` sum each vertex's incident
terms over a cached (Dmax, V) incidence table, gathered and added left to
right from 0.0, in the JAX package's scatter order (the normals: corner 0
over the faces in ascending order, then corner 1, then corner 2; the
Laplacian: the edges' `rows` scatter, then `cols`). So:

- the normals are bitwise JAX's on the CPU (the face normals agree bitwise
  and the sum follows XLA's sequential scatter order, which `np.add.at`
  also keeps);
- the Laplacian is bitwise JAX's given the same cotangent weights; the two
  packages' weights differ by float32 rounding (the vector norms), so the
  outputs agree within 1e-5, and its VJP within 1e-5;
- both agree with the `index_add_` form to float32 order, bitwise on the
  CPU, where `index_add_` also adds in index order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from garment4d_tpu import ops as jops
from garment4d_tpu.ops import meshmath as jmesh
from garment4d_tpu.models import GarmentAssets as JAssets

from garment4d_tpu_torch import ops as tops
from garment4d_tpu_torch.ops import meshmath as tmesh
from garment4d_tpu_torch.smpl import synthetic_smpl
from torch_port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def body():
    return synthetic_smpl(num_verts=200, device="cpu")


@pytest.fixture(scope="module")
def ring():
    return JAssets.synthetic(num_rings=8, ring_size=12)


def _index_add_normals(verts, faces):
    """The form the incidence tables replaced: three `index_add_` scatters."""
    f = torch.as_tensor(faces, dtype=torch.long)
    fn = tmesh.face_normals(verts, f)
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn.index_add_(-2, f[:, k], fn)
    return vn / torch.linalg.norm(vn, dim=-1, keepdim=True).clamp_min(1e-6)


def _index_add_laplacian(vw, x, faces):
    f = torch.as_tensor(faces, dtype=torch.long)
    with torch.no_grad():
        w = tmesh.cotangent_weights(vw, f).reshape(x.shape[0], -1)
    rows = f[:, [1, 2, 0]].reshape(-1)
    cols = f[:, [2, 0, 1]].reshape(-1)
    y = torch.zeros_like(x).index_add(1, rows, w[..., None] * x[:, cols])
    y = y.index_add(1, cols, w[..., None] * x[:, rows])
    diag = torch.zeros(x.shape[:2], dtype=x.dtype).index_add(1, rows, w).index_add(1, cols, w)
    return y - diag[..., None] * x


def test_vertex_normals_bitwise_jax_and_index_add(body, rng):
    v = rng.randn(3, 200, 3).astype(np.float32)
    got = tops.vertex_normals(torch.from_numpy(v), body.faces)
    want = np.asarray(jops.vertex_normals(jnp.asarray(v), body.faces))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, _index_add_normals(torch.from_numpy(v), body.faces))
    # leading axes beyond one batch axis
    got4 = tops.vertex_normals(torch.from_numpy(v.reshape(3, 1, 200, 3)), body.faces)
    assert torch.equal(got4[:, 0], got)


def test_normal_sum_is_the_scatter_order(body, rng):
    """Given the same face normals, the table's sum equals `np.add.at` over
    corner 0, 1, 2 (sequential, the JAX package's order) bit for bit."""
    v = rng.randn(2, 200, 3).astype(np.float32)
    fn = tmesh.face_normals(torch.from_numpy(v), body.faces)
    key, F = tmesh._faces_key(body.faces)
    idx, = tmesh._slot_index("normals", key, F, 200, torch.device("cpu"), 2)
    got = tmesh._sum_slots(tmesh._gather_slots(tmesh._pad_row(fn), idx)).numpy()
    want = np.zeros_like(v)
    for b in range(2):
        for k in range(3):
            np.add.at(want[b], body.faces[:, k], fn[b].numpy())
    np.testing.assert_array_equal(got, want)


def test_incidence_tables_by_hand():
    """Slots in scatter order, padded with the zero row; one table per
    face array, cached."""
    faces = np.array([[0, 1, 2], [2, 1, 3], [3, 0, 1]], np.int32)
    key, F = tmesh._faces_key(faces)
    table = tmesh._normal_slots_np(key, F, 5).T  # slot-major: a vertex's slots in a column
    # vertex 1: corner 1 of face 0, corner 1 of face 1, corner 2 of face 2
    np.testing.assert_array_equal(table[1], [0, 1, 2])
    # vertex 0: corner 0 of face 0, corner 1 of face 2, then the pad F
    np.testing.assert_array_equal(table[0], [0, 2, F])
    np.testing.assert_array_equal(table[4], [F, F, F])  # no incident face
    dev = torch.device("cpu")
    idx = tmesh._slot_index("normals", key, F, 5, dev, 2)
    assert idx is tmesh._slot_index("normals", key, F, 5, dev, 2)
    assert idx[0].shape == (2, 3, 5) and idx[0].dtype == torch.int32
    w_slot, x_slot = (t.T for t in tmesh._laplacian_slots_np(key, F, 5))
    rows = faces[:, [1, 2, 0]].reshape(-1)
    cols = faces[:, [2, 0, 1]].reshape(-1)
    # vertex 2: the edges with r == 2 in order, then those with c == 2
    want_w = [p for p in range(3 * F) if rows[p] == 2] + [p for p in range(3 * F) if cols[p] == 2]
    want_x = [cols[p] for p in range(3 * F) if rows[p] == 2] + [
        rows[p] for p in range(3 * F) if cols[p] == 2]
    n = len(want_w)
    np.testing.assert_array_equal(w_slot[2, :n], want_w)
    np.testing.assert_array_equal(x_slot[2, :n], want_x)
    assert (w_slot[2, n:] == 3 * F).all() and (x_slot[2, n:] == 5).all()
    assert (x_slot[4] == 5).all()


def test_vertex_normals_float64(body, rng):
    """Float64 (the body normals of post-processing) against a float64
    numpy oracle: the table is gathered as float32 pairs, bits intact."""
    v = rng.randn(2, 200, 3)
    got = tops.vertex_normals(torch.from_numpy(v), body.faces)
    assert got.dtype == torch.float64
    f = body.faces.astype(np.int64)
    fn = np.cross(v[:, f[:, 1]] - v[:, f[:, 0]], v[:, f[:, 2]] - v[:, f[:, 0]])
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-6)
    vn = np.zeros_like(v)
    for b in range(2):
        for k in range(3):
            np.add.at(vn[b], f[:, k], fn[b])
    vn = vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-6)
    np.testing.assert_allclose(got.numpy(), vn, rtol=0, atol=1e-12)


def test_cot_laplacian_against_jax(ring, rng, monkeypatch):
    """Within 1e-5 of JAX's; bitwise given the same weights."""
    faces = ring.faces_tri
    vw = (ring.template_v[None] + 0.01 * rng.randn(2, ring.num_verts, 3)).astype(np.float32)
    x = rng.randn(2, ring.num_verts, 3).astype(np.float32)
    got = tops.cot_laplacian_apply(torch.from_numpy(vw), torch.from_numpy(x), faces).numpy()
    want = np.asarray(jops.cot_laplacian_apply(jnp.asarray(vw), jnp.asarray(x), faces))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    weights = tmesh.cotangent_weights(torch.from_numpy(vw), faces).numpy()
    monkeypatch.setattr(jmesh, "cotangent_weights", lambda *_: jnp.asarray(weights))
    same = np.asarray(jmesh.cot_laplacian_apply(jnp.asarray(vw), jnp.asarray(x), faces))
    np.testing.assert_array_equal(got, same)
    old = _index_add_laplacian(torch.from_numpy(vw), torch.from_numpy(x), faces).numpy()
    np.testing.assert_array_equal(got, old)


def test_cot_laplacian_vjp(ring, rng):
    """The gradient into x (L^T g, the gathers' scatter-add) against
    `jax.vjp` within 1e-5 and the `index_add_` form's within 1e-6."""
    faces = ring.faces_tri
    vw = (ring.template_v[None] + 0.01 * rng.randn(2, ring.num_verts, 3)).astype(np.float32)
    x = rng.randn(2, ring.num_verts, 3).astype(np.float32)
    g = rng.randn(2, ring.num_verts, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: jops.cot_laplacian_apply(jnp.asarray(vw), xx, faces),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    grads = []
    for fn in (tops.cot_laplacian_apply, _index_add_laplacian):
        tx = torch.from_numpy(x).requires_grad_(True)
        (fn(torch.from_numpy(vw), tx, faces) * torch.from_numpy(g)).sum().backward()
        grads.append(tx.grad.numpy())
    np.testing.assert_allclose(grads[0], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-6, atol=1e-6)


def test_isolated_vertex_and_repeats(rng):
    """A vertex no face touches gets a zero normal (the clamp), as in JAX;
    a second call reuses the cached table and repeats bitwise."""
    faces = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    v = rng.randn(1, 5, 3).astype(np.float32)
    got = tops.vertex_normals(torch.from_numpy(v), faces)
    want = np.asarray(jops.vertex_normals(jnp.asarray(v), faces))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, 4] == 0).all()
    assert torch.equal(tops.vertex_normals(torch.from_numpy(v), faces), got)
