"""Mesh normals and the cotangent Laplacian over a static triangle list.

Counterpart of `garment4d_tpu/ops/meshmath.py`: the vertex normal is the
sum of the incident face normals, normalised; the cotangent Laplacian is
applied matrix-free, each vertex summing its edge terms. Both sums run in
a fixed order over a static incidence table (`_normal_slots_np`,
`_laplacian_slots_np`: a vertex's slots in the JAX package's scatter order,
padded with the index of an all-zero row, slot-major so that each slot's
rows lie together), gathered by the row gather
(`gather.cu` on the card) and added left to right from 0.0. So they repeat
bitwise from run to run on the card, with no atomics, and follow the JAX
package's update order on the CPU; the Laplacian's gradient is the
gathers' backward, the deterministic scatter-add (`scatter_add.cu`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from garment4d_tpu_torch.ops.pointcloud import group_points


def face_normals(verts: torch.Tensor, faces) -> torch.Tensor:
    """verts (..., V, 3), faces (F, 3) -> (..., F, 3) unit normals:
    cross(v1 - v0, v2 - v0), norm clamped at 1e-6."""
    faces = torch.as_tensor(faces, dtype=torch.long, device=verts.device)
    v0 = verts[..., faces[:, 0], :]
    v1 = verts[..., faces[:, 1], :]
    v2 = verts[..., faces[:, 2], :]
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    return fn / torch.linalg.norm(fn, dim=-1, keepdim=True).clamp_min(1e-6)


def _slot_table(owner: np.ndarray, V: int, pad: int) -> np.ndarray:
    """(Dmax, V) int32, slot-major: column v lists the positions p with
    owner[p] == v in ascending p, then `pad`."""
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=V)
    dmax = max(int(counts.max()) if counts.size else 0, 1)
    table = np.full((dmax, V), pad, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(owner.size) - np.repeat(starts, counts)
    table[rank, owner[order]] = order
    return table


@functools.lru_cache(maxsize=64)
def _normal_slots_np(faces_bytes: bytes, F: int, V: int) -> np.ndarray:
    """The normals' (Dmax, V) table: vertex v's incident faces as corner 0 over the
    faces in ascending order, then corner 1, then corner 2 (the JAX
    package's three scatters); the pad F indexes a zero row."""
    faces = np.frombuffer(faces_bytes, np.int64).reshape(F, 3)
    slots = _slot_table(faces.T.reshape(-1), V, 3 * F)  # positions k * F + f
    return np.where(slots < 3 * F, slots % max(F, 1), F).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _laplacian_slots_np(faces_bytes: bytes, F: int, V: int):
    """The Laplacian's tables over the 3F edges (r, c) = faces[:, (1, 2, 0)],
    faces[:, (2, 0, 1)], face-major: vertex v's slots are the edges with
    r == v in ascending order, then those with c == v (the JAX package's
    `y.at[r].add(...)` then `.at[c].add(...)`). Returns (weight index into
    the 3F weights, 3F the zero pad; the other end's vertex, V the zero
    pad)."""
    faces = np.frombuffer(faces_bytes, np.int64).reshape(F, 3)
    rows = faces[:, [1, 2, 0]].reshape(-1)
    cols = faces[:, [2, 0, 1]].reshape(-1)
    slots = _slot_table(np.concatenate([rows, cols]), V, 6 * F)
    pad = slots == 6 * F
    edge = slots % max(3 * F, 1)
    other = np.where(slots < 3 * F, cols[edge], rows[edge])
    return (np.where(pad, 3 * F, edge).astype(np.int32),
            np.where(pad, V, other).astype(np.int32))


def _faces_key(faces):
    f = np.ascontiguousarray(np.asarray(faces.cpu() if torch.is_tensor(faces) else faces,
                                        np.int64).reshape(-1, 3))
    return f.tobytes(), f.shape[0]


@functools.lru_cache(maxsize=16)
def _slot_index(kind: str, faces_bytes: bytes, F: int, V: int, device: torch.device,
                frames: int) -> tuple:
    """The slot tables of `kind` ("normals": one, "laplacian": two) as the
    row gather's (frames, Dmax, V) int32 indices on `device`, made once per
    face array, device and frame count."""
    tables = ((_normal_slots_np(faces_bytes, F, V),) if kind == "normals"
              else _laplacian_slots_np(faces_bytes, F, V))
    return tuple(torch.from_numpy(t).to(device).expand(frames, *t.shape).contiguous()
                 for t in tables)


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> (B, N + 1, C), the last row zero."""
    return torch.cat([x, x.new_zeros((x.shape[0], 1, x.shape[2]))], dim=1)


def _gather_slots(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, D, V) -> (B, D, V, C) by the row gather. A
    float64 table that needs no gradient is gathered as float32 pairs (the
    gather copies bits), so it too takes the kernel on the card."""
    if x.dtype == torch.float64 and not (x.requires_grad and torch.is_grad_enabled()):
        pairs = x.contiguous().view(torch.float32)
        return group_points(pairs, idx).view(torch.float64)
    return group_points(x, idx)


def _sum_slots(g: torch.Tensor) -> torch.Tensor:
    """(B, D, V, C) -> (B, V, C): slot 0 first, left to right from 0.0."""
    acc = torch.zeros_like(g[:, 0])
    for d in range(g.shape[1]):
        acc = acc + g[:, d]
    return acc


def vertex_normals(verts: torch.Tensor, faces) -> torch.Tensor:
    """verts (..., V, 3), faces (F, 3) -> (..., V, 3): the normalised sum
    of the incident face normals (norm clamped at 1e-6), summed in the JAX
    package's order over the cached incidence table. Float32 or float64."""
    key, F = _faces_key(faces)
    lead, V = verts.shape[:-2], verts.shape[-2]
    fn = face_normals(verts.reshape(-1, V, 3), faces)  # (B, F, 3)
    idx, = _slot_index("normals", key, F, V, verts.device, fn.shape[0])
    vn = _sum_slots(_gather_slots(_pad_row(fn), idx))
    vn = vn / torch.linalg.norm(vn, dim=-1, keepdim=True).clamp_min(1e-6)
    return vn.reshape(*lead, V, 3)


def cotangent_weights(verts: torch.Tensor, faces) -> torch.Tensor:
    """Per-face cotangent weights of the edges (23, 31, 12): verts (B, V, 3),
    faces (F, 3) -> (B, F, 3). The Heron area and the law of cosines, C =
    cot / (4 * twice the area), NaN and Inf zeroed (a degenerate face gets
    0)."""
    faces = torch.as_tensor(faces, dtype=torch.long, device=verts.device)
    v1 = verts[:, faces[:, 0], :]
    v2 = verts[:, faces[:, 1], :]
    v3 = verts[:, faces[:, 2], :]
    l1 = torch.linalg.vector_norm(v2 - v3, dim=-1)
    l2 = torch.linalg.vector_norm(v3 - v1, dim=-1)
    l3 = torch.linalg.vector_norm(v1 - v2, dim=-1)
    sp = (l1 + l2 + l3) * 0.5
    area2 = 2.0 * torch.sqrt(torch.clamp(sp * (sp - l1) * (sp - l2) * (sp - l3), min=0.0))
    cot23 = l2 ** 2 + l3 ** 2 - l1 ** 2
    cot31 = l1 ** 2 + l3 ** 2 - l2 ** 2
    cot12 = l1 ** 2 + l2 ** 2 - l3 ** 2
    C = torch.stack([cot23, cot31, cot12], dim=-1) / area2[..., None] / 4.0
    return torch.where(torch.isfinite(C), C, torch.zeros_like(C))


def cot_laplacian_apply(verts_for_weights: torch.Tensor, x: torch.Tensor,
                        faces) -> torch.Tensor:
    """L(verts_for_weights) @ x, verts_for_weights and x (B, V, 3) ->
    (B, V, 3): L = (A + A^T) - diag(row sums) with A[f1, f2] = cot23 and so
    on, each vertex's edge terms summed in the JAX package's order over the
    cached tables. The weights are constants for autodiff (the gradient is
    L^T g, through the gathers' deterministic scatter-add)."""
    key, F = _faces_key(faces)
    B, V = x.shape[:2]
    with torch.no_grad():
        w = cotangent_weights(verts_for_weights.detach(), faces).reshape(B, 3 * F, 1)
    w_slot, x_slot = _slot_index("laplacian", key, F, V, x.device, B)
    wg = _gather_slots(_pad_row(w), w_slot)  # (B, D, V, 1)
    xg = _gather_slots(_pad_row(x), x_slot)  # (B, D, V, 3)
    y = _sum_slots(wg * xg)
    diag = _sum_slots(wg)
    return y - diag * x
