"""Plain torch geometry of the reference network: furthest point sampling,
ball query, k nearest neighbours, mesh operators.

Semantics of the reference's CUDA kernels (`pointnet2` and `pygcn`):
squared distances in difference form, FPS from index 0 taking the first
index of the largest running minimum, the first `S` in-radius points in
index order with the first hit copied into the slots past the hit count
(index 0 where there is no hit), nearest neighbours ascending with ties
to the lower index. Written over whole tensors in blocks of rows, so the
card runs it at the benchmark's sizes; no part of it comes from the
program.
"""

from __future__ import annotations

import numpy as np
import torch

# elements of a (rows x points) distance block
BLOCK = 1 << 27


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcast a (..., 3) - b (..., 3) -> squared distance, summed x, y, z
    in that order."""
    d = a - b
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _blocks(rows: int, per_row: int):
    step = max(1, BLOCK // max(per_row, 1))
    return range(0, rows, step), step


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) -> (B, npoint) int64 indices."""
    B, N, _ = xyz.shape
    out = torch.zeros((B, npoint), dtype=torch.int64, device=xyz.device)
    mind = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    last = torch.zeros((B,), dtype=torch.int64, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    for j in range(1, npoint):
        mind = torch.minimum(mind, sqdist(xyz, xyz[rows, last][:, None, :]))
        last = torch.argmax(mind, dim=-1)
        out[:, j] = last
    return out


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               centers: torch.Tensor) -> torch.Tensor:
    """xyz (B, N, 3), centers (B, M, 3) -> (B, M, nsample) int64: the first
    `nsample` points with squared distance below the float32 square of
    `radius`, in index order, the first copied past the hit count, 0 where
    none."""
    B, N, _ = xyz.shape
    M = centers.shape[1]
    r2 = float(np.float32(radius * radius))
    iota = torch.arange(N, device=xyz.device)
    S = min(nsample, N)
    out = []
    starts, step = _blocks(M, B * N)
    for m0 in starts:
        hit = sqdist(centers[:, m0:m0 + step, None, :], xyz[:, None, :, :]) < r2
        pos = torch.where(hit, iota, N)
        first = torch.topk(pos, S, dim=-1, largest=False, sorted=True).values
        if S < nsample:
            first = torch.cat([first, first.new_full((*first.shape[:-1], nsample - S), N)], -1)
        lead = torch.where(first[..., :1] < N, first[..., :1], torch.zeros_like(first[..., :1]))
        out.append(torch.where(first < N, first, lead))
    return torch.cat(out, dim=1)


def nearest(query: torch.Tensor, points: torch.Tensor, k: int):
    """query (B, M, 3), points (B, N, 3) -> (squared distances (B, M, k)
    ascending, indices (B, M, k) int64), ties to the lower index."""
    B, N, _ = points.shape
    M = query.shape[1]
    ds, ix = [], []
    starts, step = _blocks(M, B * N)
    for m0 in starts:
        d2 = sqdist(query[:, m0:m0 + step, None, :], points[:, None, :, :])
        d, i = torch.sort(d2, dim=-1, stable=True)
        ds.append(d[..., :k])
        ix.append(i[..., :k])
    return torch.cat(ds, 1), torch.cat(ix, 1)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, N, C), idx (B, ...) -> (B, ..., C)."""
    B = table.shape[0]
    flat = idx.reshape(B, -1)
    got = torch.gather(table, 1, flat[..., None].expand(-1, -1, table.shape[-1]))
    return got.reshape(*idx.shape, table.shape[-1])


# --- the template's graph operators (reference `mesh_encoder.py:288-305`) ----

def mesh_adjacency(faces: np.ndarray, V: int) -> np.ndarray:
    """The reference's edge-buffer adjacency of quad faces: directed edges
    (f0,f1), (f1,f2), (f2,f3), (f3,f0), duplicates summed, symmetrised as
    the elementwise max with the transpose. float64 (V, V)."""
    f = np.asarray(faces, np.int64)
    if f.shape[1] != 4:
        raise ValueError("the reference adjacency here takes quad faces")
    a = np.zeros((V, V), np.float64)
    for s, t in ((0, 1), (1, 2), (2, 3), (3, 0)):
        np.add.at(a, (f[:, s], f[:, t]), 1.0)
    return np.maximum(a, a.T)


def row_normalize(a: np.ndarray) -> np.ndarray:
    s = a.sum(1)
    inv = np.where(s > 0, 1.0 / np.where(s > 0, s, 1.0), 0.0)
    return a * inv[:, None]


def quads_to_tris(faces: np.ndarray) -> np.ndarray:
    f = np.asarray(faces, np.int64)
    return np.concatenate([f[:, [0, 1, 2]], f[:, [0, 2, 3]]], 0)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """verts (B, V, 3), faces (F, 3) int64 -> unit vertex normals: the sum
    of the incident unit face normals (norms clamped at 1e-6)."""
    v0, v1, v2 = verts[:, faces[:, 0]], verts[:, faces[:, 1]], verts[:, faces[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    fn = fn / fn.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn = vn.index_add(1, faces[:, k], fn)
    return vn / vn.norm(dim=-1, keepdim=True).clamp_min(1e-6)


def cot_laplacian(weights_from: torch.Tensor, x: torch.Tensor, faces: torch.Tensor):
    """The cotangent Laplacian of the mesh at `weights_from` (constant for
    autodiff) applied to x: (B, V, 3) -> (B, V, 3). Edge (i, j) opposite
    corner k has weight cot_k / 4 (law of cosines over twice the Heron
    area, non-finite weights zeroed); L x = sum_j w_ij (x_j - x_i)."""
    with torch.no_grad():
        v = weights_from.detach()
        p1, p2, p3 = v[:, faces[:, 0]], v[:, faces[:, 1]], v[:, faces[:, 2]]
        l1 = (p2 - p3).norm(dim=-1)
        l2 = (p3 - p1).norm(dim=-1)
        l3 = (p1 - p2).norm(dim=-1)
        s = (l1 + l2 + l3) * 0.5
        area2 = 2.0 * torch.sqrt(torch.clamp(s * (s - l1) * (s - l2) * (s - l3), min=0.0))
        c = torch.stack([l2 ** 2 + l3 ** 2 - l1 ** 2, l1 ** 2 + l3 ** 2 - l2 ** 2,
                         l1 ** 2 + l2 ** 2 - l3 ** 2], -1) / area2[..., None] / 4.0
        c = torch.where(torch.isfinite(c), c, torch.zeros_like(c))
    out = torch.zeros_like(x)
    # corner k's weight joins the edge of the other two corners
    for k, (i, j) in enumerate(((1, 2), (2, 0), (0, 1))):
        w = c[:, :, k:k + 1]
        fi, fj = faces[:, i], faces[:, j]
        xi, xj = x[:, fi], x[:, fj]
        out = out.index_add(1, fi, w * (xj - xi)).index_add(1, fj, w * (xi - xj))
    return out
