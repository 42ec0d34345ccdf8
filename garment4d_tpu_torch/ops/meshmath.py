"""Mesh normals and the cotangent Laplacian over a static triangle list.

Counterpart of `garment4d_tpu/ops/meshmath.py`: the vertex normal is the
sum of the incident face normals, normalised; the cotangent Laplacian is
applied matrix-free with two scatter-adds per face edge. Both scatter with
`index_add_` (XLA scatters in JAX, no Pallas kernel), which on the card
adds with atomics: these sums are not bitwise from run to run there.
"""

from __future__ import annotations

import torch


def face_normals(verts: torch.Tensor, faces) -> torch.Tensor:
    """verts (..., V, 3), faces (F, 3) -> (..., F, 3) unit normals:
    cross(v1 - v0, v2 - v0), norm clamped at 1e-6."""
    faces = torch.as_tensor(faces, dtype=torch.long, device=verts.device)
    v0 = verts[..., faces[:, 0], :]
    v1 = verts[..., faces[:, 1], :]
    v2 = verts[..., faces[:, 2], :]
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    return fn / torch.linalg.norm(fn, dim=-1, keepdim=True).clamp_min(1e-6)


def vertex_normals(verts: torch.Tensor, faces) -> torch.Tensor:
    """verts (..., V, 3), faces (F, 3) -> (..., V, 3): the normalised sum
    of the incident face normals (norm clamped at 1e-6)."""
    faces = torch.as_tensor(faces, dtype=torch.long, device=verts.device)
    fn = face_normals(verts, faces)
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn.index_add_(-2, faces[:, k], fn)
    return vn / torch.linalg.norm(vn, dim=-1, keepdim=True).clamp_min(1e-6)


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
    on. The weights are constants for autodiff (the gradient is L^T g)."""
    faces = torch.as_tensor(faces, dtype=torch.long, device=x.device)
    with torch.no_grad():
        w = cotangent_weights(verts_for_weights.detach(), faces)
    B = w.shape[0]
    w = w.reshape(B, -1)  # (B, 3F), face-major as the edge lists below
    rows = faces[:, [1, 2, 0]].reshape(-1)
    cols = faces[:, [2, 0, 1]].reshape(-1)
    y = torch.zeros_like(x).index_add(1, rows, w[..., None] * x[:, cols])
    y = y.index_add(1, cols, w[..., None] * x[:, rows])
    diag = torch.zeros(x.shape[:2], dtype=x.dtype, device=x.device)
    diag = diag.index_add(1, rows, w).index_add(1, cols, w)
    return y - diag[..., None] * x
