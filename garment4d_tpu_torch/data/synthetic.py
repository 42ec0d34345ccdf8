"""Synthetic mini-CLOTH3D batches.

Counterpart of `garment4d_tpu/data/synthetic.py`: the data-pipeline batch
built from a synthetic SMPL body and a synthetic garment template, with the
three per-frame SMPL forwards (posed / T-pose / zero-pose) run batched on
the given device. The numpy draws are the JAX package's, in the same order,
so the point clouds agree to float32 roundoff of the SMPL forward.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from garment4d_tpu_torch import _device
from garment4d_tpu_torch.models.assets import GarmentAssets
from garment4d_tpu_torch.smpl import SmplModel


def template_pose(batch: int, device=_device.DEFAULT) -> torch.Tensor:
    """The dataset's fixed template pose: root x-rot +pi/2, hips z +/-0.15."""
    pose = torch.zeros((batch, 24, 3), device=_device.resolve(device))
    pose[:, 0, 0] = np.pi / 2
    pose[:, 1, 2] = 0.15
    pose[:, 2, 2] = -0.15
    return pose.reshape(batch, 72)


def smpl_triple_forward(model: SmplModel, pose: torch.Tensor,
                        betas: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The 3 SMPL forwards of the data pipeline, batched: pose (B, T, 72),
    betas (B, T, 10) -> posed vertices/root joints, T-pose vertices/root
    joints and zero-pose vertices."""
    B, T, _ = pose.shape
    flat_pose = pose.reshape(B * T, 72)
    flat_betas = betas.reshape(B * T, -1)
    posed_v, posed_j = model.forward_axis_angle(flat_betas, flat_pose)
    tpose_v, tpose_j = model.forward_axis_angle(
        betas[:, 0], template_pose(B, pose.device))
    zero_v, _ = model.forward_axis_angle(flat_betas, torch.zeros_like(flat_pose))
    V = posed_v.shape[1]
    return dict(
        smpl_vertices=posed_v.reshape(B, T, V, 3),
        smpl_root_joints=posed_j[:, 0, :].reshape(B, T, 3),
        tpose_smpl_vertices=tpose_v,
        tpose_smpl_root_joints=tpose_j[:, 0, :],
        zeropose_smpl_vertices=zero_v.reshape(B, T, V, 3),
    )


@torch.no_grad()
def make_batch(assets: GarmentAssets, model: SmplModel, *, batch_size: int = 1,
               T: int = 3, npoints: int = 2048, seed: int = 0,
               device=_device.DEFAULT) -> Dict[str, torch.Tensor]:
    """A full synthetic batch with the data-pipeline keys, on `device`
    (`model` must live there too)."""
    device = _device.resolve(device)
    rng = np.random.RandomState(seed)
    B = batch_size
    Vg = assets.num_verts
    Vb = model.num_verts

    def dev(a):
        return torch.from_numpy(np.array(a, dtype=a.dtype)).to(device)

    pose = dev(rng.randn(B, T, 72).astype(np.float32) * 0.1)
    betas = dev(np.broadcast_to(
        rng.randn(B, 1, 10).astype(np.float32) * 0.5, (B, T, 10)))
    body = smpl_triple_forward(model, pose, betas)
    body_v = body["smpl_vertices"].cpu().numpy()
    root = body["smpl_root_joints"].cpu().numpy()

    # garment GT: template + per-frame noise
    template = assets.template_v
    garment = template[None, None] + rng.randn(B, T, Vg, 3).astype(np.float32) * 0.01

    # point cloud: body vertices + garment points near the posed body
    n_body = npoints - npoints // 2
    n_gar = npoints // 2
    pcd = np.zeros((B, T, npoints, 3), np.float32)
    labels = np.zeros((B, T, npoints), np.int32)
    for b in range(B):
        for t in range(T):
            bsel = rng.randint(0, Vb, size=n_body)
            gsel = rng.randint(0, Vg, size=n_gar)
            pts = np.concatenate([body_v[b, t, bsel],
                                  garment[b, t, gsel] + root[b, t]], 0)
            lab = np.concatenate([np.zeros(n_body, np.int32),
                                  np.full(n_gar, assets.label, np.int32)])
            perm = rng.permutation(npoints)
            pcd[b, t] = pts[perm]
            labels[b, t] = lab[perm]

    J = model.J_regressor.shape[0]
    return dict(
        pose=pose,
        beta=betas,
        pcd=dev(pcd),
        pcd_label=dev(labels),
        garment=dev(garment),
        garment_template_vertices=dev(np.broadcast_to(template[None], (B, Vg, 3))),
        pca_coeff=dev(rng.randn(B, assets.pca_dim).astype(np.float32)),
        J_regressor=model.J_regressor[None, None].expand(B, T, J, Vb),
        lbs_weights=model.lbs_weights[None, None].expand(B, T, Vb, J),
        **body,
    )
