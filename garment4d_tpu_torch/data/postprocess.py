"""Post-processing: Laplacian smoothing and body-garment interpenetration
removal.

Counterpart of `garment4d_tpu/data/postprocess.py` (reference
`utils/post_processing.py`):

* `laplacian_smooth`: 100 alternating diffusion steps (+0.05 / -0.052)
  with the row-normalised adjacency, `graph_matmul` on the tensors' device
  (batched over frames);
* `detect_penetration` / `push_out_targets`: the nearest body vertex (the
  1-NN kernel on the card) and its normal (row gathers), the inside test;
* `nearest_surface_points`: the exact nearest point of the body surface
  and the normal of the region it lands in, in float64 on `device`;
* `remove_interpenetration`: at most 5 rounds of push-out targets and the
  Laplacian-regularised least squares, its normal equations solved by
  `scipy.sparse.linalg.spsolve` on the host as in the reference;
* `process_frame`: smoothing, then interpenetration removal.

Where the port differs from the JAX package (its faults, fixed here):
`garment_faces` is required (the JAX package's None silently flips no
push-out direction); the body's face and vertex normals are computed in
float64 (the JAX package casts float32 normals to float64). The tie rules
stay the reference's: the first face of least distance, and the region
from the exact zeros of the clamped barycentrics.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from garment4d_tpu_torch import _device, ops
from garment4d_tpu_torch.tools.transfer import _dot, _surface_correspondence


def laplacian_smooth(verts: torch.Tensor, norm_adj: torch.Tensor, iters: int = 100,
                     lam: float = 0.05, mu: float = -0.052) -> torch.Tensor:
    """Taubin-style alternating smoothing (reference `post_processing.py:
    300-309`): verts (..., V, 3), norm_adj (V, V) row-normalised adjacency
    on the same device, every frame in one product a step. Even steps move
    towards the neighbourhood mean by `lam`, odd steps away by `mu`."""
    lead, V = verts.shape[:-2], verts.shape[-2]
    # the frames as columns: one (V, V) x (V, frames * 3) product a step
    v = verts.reshape(-1, V, 3).transpose(0, 1).reshape(V, -1)
    for i in range(iters):
        coeff = lam if i % 2 == 0 else mu
        v = v + coeff * (ops.graph_matmul(norm_adj, v) - v)
    return v.reshape(V, -1, 3).transpose(0, 1).reshape(*lead, V, 3)


def detect_penetration(garment_v: torch.Tensor, body_v: torch.Tensor,
                       body_vn: torch.Tensor, threshold: float = -1e-6):
    """The nearest body VERTEX and the inside test, the quick screen:
    garment_v (B, Vg, 3), body_v and body_vn (B, Vb, 3) -> (inside (B, Vg)
    bool, nearest (B, Vg, 3), its normal (B, Vg, 3)). On the card the 1-NN
    kernel finds the vertex (ties to the lower index) and the row gather
    reads it and its normal."""
    _, idx = ops.knn_points(garment_v, body_v, K=1)
    nearest = ops.group_points(body_v, idx)[:, :, 0, :]
    normal = ops.group_points(body_vn, idx)[:, :, 0, :]
    return _dot(normal, garment_v - nearest) <= threshold, nearest, normal


def push_out_targets(garment_v: torch.Tensor, inside: torch.Tensor, nearest: torch.Tensor,
                     normal: torch.Tensor, eps: float = 0.008) -> torch.Tensor:
    """Inside vertices moved to nearest + eps * normal, the others kept."""
    return torch.where(inside[..., None], nearest + eps * normal, garment_v)


def _unit(x: torch.Tensor) -> torch.Tensor:
    """x / (|x| + 1e-10), the norm summed left to right (numpy's)."""
    return x / (torch.sqrt(_dot(x, x)) + 1e-10)[..., None]


class _Body:
    """A body surface on a device, in float64: vertices, faces, face
    normals and vertex normals (computed in float64, not cast)."""

    def __init__(self, body_v, body_faces, device):
        self.v = _device.tensor(body_v, device, torch.float64)
        self.faces = _device.tensor(np.asarray(body_faces, np.int64), device, torch.long)
        self.fn = ops.face_normals(self.v[None], self.faces)[0]
        self.vn = ops.vertex_normals(self.v[None], self.faces)[0]


def _nearest_on(body: _Body, points: torch.Tensor, chunk: int = 512):
    """`nearest_surface_points` against a prepared body: points (P, 3)
    float64 on its device -> (nearest, normals) (P, 3) float64."""
    face_idx, bary, vidx = _surface_correspondence(body.v, body.faces, points, chunk)
    tri = body.v[vidx]  # (P, 3, 3)
    nearest = (bary[:, 0, None] * tri[:, 0] + bary[:, 1, None] * tri[:, 1]
               + bary[:, 2, None] * tri[:, 2])
    # the region from the exact zeros of the clamped barycentrics: none
    # the interior (the face normal), one an edge (the sum of its two
    # vertex normals), two a vertex (its normal)
    zero = (bary <= 0.0).to(torch.int8)
    nz = zero.sum(dim=1)
    # the first and the last nonzero coordinate: a vertex region's one
    # corner, an edge region's two ends in corner order
    first = vidx.gather(1, torch.argmin(zero, dim=1)[:, None])[:, 0]
    last = vidx.gather(1, 2 - torch.argmin(zero.flip(1), dim=1)[:, None])[:, 0]
    normals = torch.where((nz == 2)[:, None], body.vn[first], body.fn[face_idx])
    normals = torch.where((nz == 1)[:, None], body.vn[first] + body.vn[last], normals)
    return nearest, _unit(normals)


def nearest_surface_points(points, body_v, body_faces,
                           device=_device.DEFAULT) -> Tuple[np.ndarray, np.ndarray]:
    """The exact nearest point ON the body surface and its region's normal
    (reference `post_processing.py:145-177`, an AABB-tree query there): the
    closest point of each query to the triangle soup
    (`tools/transfer.py`), and the face normal where it lands inside a
    triangle, the vertex normal at a vertex, the sum of the two end vertex
    normals on an edge, normalised with the reference's +1e-10 guard. All
    in float64 on `device`. points (P, 3), body_v (Vb, 3), body_faces (F,
    3) -> numpy (nearest (P, 3), normals (P, 3)) float64."""
    dev = _device.resolve(device)
    nearest, normals = _nearest_on(_Body(body_v, body_faces, dev),
                                   _device.tensor(points, dev, torch.float64))
    return nearest.cpu().numpy(), normals.cpu().numpy()


def _lsq_laplacian_csr(adj: np.ndarray):
    """L = I - rownorm(clip(adj, 0, 1)), the reference's least-squares
    regulariser (`post_processing.py:131-142`)."""
    import scipy.sparse as sp

    a = np.clip(np.asarray(adj, np.float64), 0.0, 1.0)
    rowsum = a.sum(axis=1)
    rowsum[rowsum == 0] = 1.0
    return sp.csr_matrix(np.eye(a.shape[0]) - a / rowsum[:, None])


def _require_faces(garment_faces):
    if garment_faces is None:
        raise ValueError(
            "garment_faces is required: the push-out direction is flipped by the sign of "
            "<garment vertex normal, body normal>, as in the reference (the JAX package's "
            "garment_faces=None silently skips the flip)")


def remove_interpenetration(garment_v: np.ndarray, body_v: np.ndarray,
                            body_faces: np.ndarray, adj: np.ndarray,
                            garment_faces: np.ndarray, eps: float = 0.008,
                            weight: float = 2.0, max_iters: int = 5,
                            return_rounds: bool = False, device=_device.DEFAULT):
    """Iterated push-out with Laplacian-regularised least squares
    (reference `remove_interpenetration_fast`, `post_processing.py:179-228`,
    in its <= 5-round loop, `:314-317`): the nearest surface point and
    region normal of every garment vertex (`nearest_surface_points` on
    `device`), inside where sign(<v - nearest, n>) <= -1e-6; the push-out
    direction (nearest - v) flipped by the sign of <garment vertex normal,
    body normal> (the garment's normals in float32 on `device`, as the
    reference), target nearest + eps * unit(direction) with the 0.0001 norm
    guard; weight `weight` on inside rows, 1 elsewhere; L = I -
    rownorm(adj); the normal equations (A^T A) x = A^T b, A = [L; I], by
    `scipy.sparse.linalg.spsolve` on the host. Stops early when no vertex
    is inside. garment_v (Vg, 3), body_v (Vb, 3), body_faces (F, 3), adj
    (Vg, Vg), garment_faces (Fg, 3) required -> float32 (Vg, 3) (and the
    rounds solved, with `return_rounds`)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    _require_faces(garment_faces)
    dev = _device.resolve(device)
    body = _Body(body_v, body_faces, dev)
    g_faces = np.asarray(garment_faces, np.int64)
    v = np.asarray(garment_v, np.float64)
    L = _lsq_laplacian_csr(adj)
    Vg = v.shape[0]

    rounds = 0
    for _ in range(max_iters):
        nearest, normals = (t.cpu().numpy() for t in _nearest_on(
            body, torch.from_numpy(v).to(dev)))
        direction = np.sign(np.sum((v - nearest) * normals, axis=-1))
        indices = np.where(direction <= -1e-6)[0]
        if len(indices) < 1:
            break

        gvn = ops.vertex_normals(torch.from_numpy(v[None].astype(np.float32)).to(dev),
                                 g_faces)[0].cpu().numpy().astype(np.float64)
        nds = np.sign(np.sum(gvn * normals, axis=-1))[:, None]
        pent = (nearest[indices] - v[indices]) * nds[indices]
        pent = nearest[indices] + eps * pent / np.expand_dims(
            0.0001 + np.linalg.norm(pent, axis=1), 1)
        tgt = v.copy()
        tgt[indices] = weight * pent

        data = np.ones(Vg)
        data[indices] *= weight
        rc = np.arange(Vg)
        I = sp.csr_matrix((data, (rc, rc)), shape=(Vg, Vg))
        A = sp.vstack([L, I]).tocsr()
        b = np.vstack([L @ v, tgt])
        AtA = (A.T @ A).tocsr()
        Atb = A.T @ b
        v = np.column_stack([spla.spsolve(AtA, Atb[:, c]) for c in range(3)])
        rounds += 1
    if return_rounds:
        return v.astype(np.float32), rounds
    return v.astype(np.float32)


def process_frame(garment_v: np.ndarray, body_v: np.ndarray, body_faces: np.ndarray,
                  adj: np.ndarray, norm_adj: np.ndarray, smooth_iters: int = 100, *,
                  garment_faces: np.ndarray, return_rounds: bool = False,
                  device=_device.DEFAULT):
    """One frame's post-process (reference `process_single_frame`,
    `post_processing.py:300-317`): `laplacian_smooth` on `device`, then
    `remove_interpenetration`. `garment_faces` is required."""
    _require_faces(garment_faces)
    dev = _device.resolve(device)
    smoothed = laplacian_smooth(_device.tensor(np.asarray(garment_v)[None], dev),
                                _device.tensor(norm_adj, dev), iters=smooth_iters)
    return remove_interpenetration(smoothed[0].cpu().numpy(), body_v, body_faces, adj,
                                   garment_faces, return_rounds=return_rounds, device=dev)
