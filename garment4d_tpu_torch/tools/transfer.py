"""Deformation transfer between body-model topologies.

Counterpart of `garment4d_tpu/tools/transfer.py` (the reference's
`smplx/transfer_model`, `transfer_model/__main__.py:36-100`,
`transfer_model.py:257+`):

* `surface_correspondence` builds the transfer matrix: every target vertex
  projected onto its nearest point of the source surface (exact
  point-to-triangle projection) as barycentric weights of that face, in
  float64 on `device`, a chunk of target vertices at a time;
* `deformation_transfer_matrix` and `apply_deformation_transfer` build and
  apply the dense (Vd, Vs) matrix;
* `fit_smpl_staged` runs the reference's schedule: root orientation and
  translation, then the body pose, then the shape (`fit_body.py`).

The projection writes its sums out in numpy's orders (`_dot`, `_edot`), so it
agrees with the JAX package's numpy version bit for bit where the rounding
allows, and the card with the CPU.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from garment4d_tpu_torch import _device
from garment4d_tpu_torch.smpl import SmplModel
from garment4d_tpu_torch.tools.fit_body import FitResult, fit_smpl_to_vertices


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of 3, left to right: (a0 b0 + a1 b1) + a2 b2
    (numpy's `sum(axis=-1)` of three)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _edot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a0 b0 + a2 b2) + a1 b1: the order of numpy's `einsum("fk,pfk->pf")`
    (numpy 2.0, measured)."""
    return (a[..., 0] * b[..., 0] + a[..., 2] * b[..., 2]) + a[..., 1] * b[..., 1]


def _corners(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.stack([u, v, w], dim=-1)


def _project_points_to_triangles(points: torch.Tensor, tri_v: torch.Tensor):
    """The closest point of each point to each triangle, by region
    (clamped barycentrics): points (P, 3), tri_v (F, 3, 3) -> (dist2 (P,
    F), bary (P, F, 3)). The regions are tested as the JAX package tests
    them: vertices last, so they win; clamped coordinates are exact zeros."""
    a, b, c = tri_v[:, 0], tri_v[:, 1], tri_v[:, 2]  # (F, 3)
    ab = (b - a)[None]
    ac = (c - a)[None]
    p = points[:, None, :]  # (P, 1, 3)
    ap = p - a[None]
    d1, d2 = _edot(ab, ap), _edot(ac, ap)
    bp = p - b[None]
    d3, d4 = _edot(ab, bp), _edot(ac, bp)
    cp = p - c[None]
    d5, d6 = _edot(ab, cp), _edot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp(va + vb + vc, min=1e-20)
    v = vb / denom
    w = vc / denom
    bary = _corners(1.0 - v - w, v, w)

    vert_a = (d1 <= 0) & (d2 <= 0)
    vert_b = (d3 >= 0) & (d4 <= d3)
    vert_c = (d6 >= 0) & (d5 <= d6)
    t_ab = d1 / torch.clamp(d1 - d3, min=1e-20)
    edge_ab = (~vert_a) & (~vert_b) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    t_ac = d2 / torch.clamp(d2 - d6, min=1e-20)
    edge_ac = (~vert_a) & (~vert_c) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    t_bc = (d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6), min=1e-20)
    edge_bc = (~vert_b) & (~vert_c) & (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    zero = torch.zeros_like(t_ab)
    one = torch.ones_like(t_ab)
    bary = torch.where(edge_bc[..., None], _corners(zero, 1 - t_bc, t_bc), bary)
    bary = torch.where(edge_ac[..., None], _corners(1 - t_ac, zero, t_ac), bary)
    bary = torch.where(edge_ab[..., None], _corners(1 - t_ab, t_ab, zero), bary)
    bary = torch.where(vert_c[..., None], _corners(zero, zero, one), bary)
    bary = torch.where(vert_b[..., None], _corners(zero, one, zero), bary)
    bary = torch.where(vert_a[..., None], _corners(one, zero, zero), bary)
    bary = torch.clamp(bary, 0.0, 1.0)
    total = bary[..., 0] + bary[..., 1] + bary[..., 2]
    bary = bary / torch.clamp(total, min=1e-20)[..., None]

    # closest = sum_k bary_k tri_k, (P, F, 3)
    closest = (bary[..., 0, None] * a[None] + bary[..., 1, None] * b[None]
               + bary[..., 2, None] * c[None])
    diff = p - closest
    return _dot(diff, diff), bary


def _surface_correspondence(src: torch.Tensor, faces: torch.Tensor, dst: torch.Tensor,
                            chunk: int):
    """`surface_correspondence` on tensors: src (Vs, 3) and dst (Vd, 3)
    float64, faces (F, 3) long, all on one device -> (face_idx (Vd,) long,
    bary (Vd, 3) float64, vert_idx (Vd, 3) long)."""
    tri_v = src[faces]  # (F, 3, 3)
    face_idx, bary = [], []
    for i in range(0, dst.shape[0], chunk):
        d2, b = _project_points_to_triangles(dst[i:i + chunk], tri_v)
        fi = torch.argmin(d2, dim=1)  # the first face attaining the minimum
        face_idx.append(fi)
        bary.append(b[torch.arange(fi.shape[0], device=fi.device), fi])
    face_idx = torch.cat(face_idx)
    return face_idx, torch.cat(bary), faces[face_idx]


def surface_correspondence(src_verts, src_faces, dst_verts, chunk: int = 512,
                           device=_device.DEFAULT):
    """Nearest-point-on-surface barycentric correspondence, in float64 on
    `device`: returns numpy (face_idx (Vd,) int64, bary (Vd, 3) float64,
    vert_idx (Vd, 3) int64) with dst[i] ~= sum_k bary[i, k] *
    src[vert_idx[i, k]]. Ties go to the first face. `chunk` target
    vertices a pass bound the (chunk, F, 3) temporaries."""
    dev = _device.resolve(device)
    fi, bary, vidx = _surface_correspondence(
        _device.tensor(src_verts, dev, torch.float64),
        _device.tensor(src_faces, dev, torch.long),
        _device.tensor(dst_verts, dev, torch.float64), chunk)
    return fi.cpu().numpy(), bary.cpu().numpy(), vidx.cpu().numpy()


def deformation_transfer_matrix(src_verts, src_faces, dst_verts,
                                device=_device.DEFAULT) -> np.ndarray:
    """Dense (Vd, Vs) float32 transfer matrix M with dst ~= M @ src (the
    reference's def_matrix)."""
    _, bary, vidx = surface_correspondence(src_verts, src_faces, dst_verts, device=device)
    Vd, Vs = len(dst_verts), len(src_verts)
    M = np.zeros((Vd, Vs), np.float32)
    rows = np.repeat(np.arange(Vd), 3)
    M[rows, vidx.reshape(-1)] += bary.reshape(-1)
    return M


def apply_deformation_transfer(def_matrix, src_verts: torch.Tensor) -> torch.Tensor:
    """def_matrix (Vd, Vs), src_verts (B, Vs, 3) -> (B, Vd, 3), on the
    device of `src_verts`."""
    m = _device.tensor(def_matrix, src_verts.device, src_verts.dtype)
    return torch.einsum("dv,bvk->bdk", m, src_verts)


def fit_smpl_staged(
    model: SmplModel,
    target_verts,                             # (B, V, 3) in model topology
    vertex_mask: Optional[np.ndarray] = None,
    iters: Tuple[int, int, int] = (60, 120, 120),
    init: Optional[Dict[str, np.ndarray]] = None,
) -> FitResult:
    """The reference's staged schedule (`transfer_model.py:257+`), on the
    model's device: root orientation and translation first (the body pose
    and shape pinned by a 1e6 regulariser), then the pose, then the shape,
    each stage an LBFGS fit from the previous stage's result."""
    stage1 = fit_smpl_to_vertices(
        model, target_verts, vertex_mask=vertex_mask, iters=iters[0],
        pose_reg=1e6, shape_reg=1e6, init=init)
    stage2 = fit_smpl_to_vertices(
        model, target_verts, vertex_mask=vertex_mask, iters=iters[1],
        pose_reg=1e-3, shape_reg=1e6,
        init={"betas": stage1.betas, "pose": stage1.pose, "transl": stage1.transl})
    return fit_smpl_to_vertices(
        model, target_verts, vertex_mask=vertex_mask, iters=iters[2],
        pose_reg=1e-3, shape_reg=1e-3,
        init={"betas": stage2.betas, "pose": stage2.pose, "transl": stage2.transl})
