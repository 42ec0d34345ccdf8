"""Mesh normals over a static triangle list.

Counterpart of `face_normals` and `vertex_normals` in
`garment4d_tpu/ops/meshmath.py`: the vertex normal is the sum of the
incident face normals (a scatter-add by `index_add_`), normalised. The
cotangent Laplacian waits for the losses.
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
