"""Linear blend skinning math as batched tensor products.

Counterpart of `garment4d_tpu/smpl/lbs.py` (reference `smplx/smplx/lbs.py`):
blend shapes, joint regression, Rodrigues rotations, kinematic-chain rigid
transforms and per-vertex skinning, in float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def batch_rodrigues(rot_vecs: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3), with the
    reference's `+1e-8` inside the norm."""
    shape = rot_vecs.shape[:-1]
    rv = rot_vecs.reshape(-1, 3)
    angle = torch.linalg.norm(rv + epsilon, dim=1, keepdim=True)  # (N, 1)
    rot_dir = rv / angle
    cos = torch.cos(angle)[:, :, None]
    sin = torch.sin(angle)[:, :, None]
    rx, ry, rz = rot_dir[:, 0], rot_dir[:, 1], rot_dir[:, 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                    dim=1).reshape(-1, 3, 3)
    ident = torch.eye(3, dtype=rv.dtype, device=rv.device)
    rot = ident + sin * K + (1.0 - cos) * torch.bmm(K, K)
    return rot.reshape(*shape, 3, 3)


def transform_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """R (..., 3, 3), t (..., 3) -> homogeneous (..., 4, 4)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(*R.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics: rot_mats (B, J, 3, 3), joints (B, J, 3), parents
    (J,) -> (posed_joints (B, J, 3), rel_transforms (B, J, 4, 4))."""
    parents = np.asarray(parents)
    J = parents.shape[0]
    rel_joints = joints.clone()
    rel_joints[:, 1:] = joints[:, 1:] - joints[:, parents[1:]]
    transforms_mat = transform_mat(rot_mats, rel_joints)

    chain = [transforms_mat[:, 0]]
    for i in range(1, J):
        chain.append(torch.bmm(chain[int(parents[i])], transforms_mat[:, i]))
    transforms = torch.stack(chain, dim=1)  # (B, J, 4, 4)

    posed_joints = transforms[:, :, :3, 3]
    # subtract the rest-pose joint location: T - [0 | T[:, :3] @ j]
    tj = torch.einsum("bjik,bjk->bji", transforms[:, :, :, :3], joints)
    correction = torch.zeros_like(transforms)
    correction[:, :, :, 3] = tj
    return posed_joints, transforms - correction


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """J_regressor (J, V), vertices (B, V, 3) -> (B, J, 3)."""
    return torch.einsum("bvc,jv->bjc", vertices, J_regressor)


def vertices2joints_b(J_regressor_b: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """Batched regressor: J_regressor_b (B, J, V), vertices (B, V, 3) ->
    (B, J, 3)."""
    return torch.einsum("bvc,bjv->bjc", vertices, J_regressor_b)


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor) -> torch.Tensor:
    """betas (B, nb), shape_disps (V, 3, nb) -> (B, V, 3)."""
    return torch.einsum("bl,mkl->bmk", betas, shape_disps)


def skin_vertices(W: torch.Tensor, A: torch.Tensor, v_posed: torch.Tensor) -> torch.Tensor:
    """W (B, V, J) weights, A (B, J, 4, 4) transforms, v_posed (B, V, 3)
    -> (B, V, 3)."""
    T = torch.einsum("bvj,bjpq->bvpq", W, A)
    return torch.einsum("bvpq,bvq->bvp", T[:, :, :3, :3], v_posed) + T[:, :, :3, 3]


def lbs(betas: torch.Tensor, pose: torch.Tensor, v_template: torch.Tensor,
        shapedirs: torch.Tensor, posedirs: torch.Tensor,
        J_regressor: torch.Tensor, parents: np.ndarray,
        lbs_weights: torch.Tensor):
    """Full SMPL skinning: betas (B, 10); pose (B, J*3) axis-angle ->
    (vertices (B, V, 3), joints (B, J, 3))."""
    B = max(betas.shape[0], pose.shape[0])
    v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
    J = vertices2joints(J_regressor, v_shaped)
    rot_mats = batch_rodrigues(pose.reshape(B, -1, 3))
    ident = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    v_posed = v_shaped + (pose_feature @ posedirs).reshape(B, -1, 3)
    J_transformed, A = batch_rigid_transform(rot_mats, J, parents)
    W = lbs_weights[None].expand(B, *lbs_weights.shape)
    return skin_vertices(W, A, v_posed), J_transformed
