"""SMPL body model: a tensor container with an axis-angle forward.

Counterpart of `garment4d_tpu/smpl/model.py`. `synthetic_smpl` draws the
same `RandomState` numbers as the JAX package, so both build the same body.
The SMPL pickle/npz loaders wait for a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from garment4d_tpu_torch import _device
from garment4d_tpu_torch.smpl.lbs import lbs as _lbs

NUM_JOINTS = 24
NUM_BETAS = 10
NUM_BODY_VERTS = 6890


@dataclasses.dataclass(frozen=True)
class SmplModel:
    """SMPL buffers: v_template (V, 3), shapedirs (V, 3, 10), posedirs
    (P, V*3) with P = (J-1)*9, J_regressor (J, V), lbs_weights (V, J);
    parents (J,) and faces (F, 3) stay numpy."""

    v_template: torch.Tensor
    shapedirs: torch.Tensor
    posedirs: torch.Tensor
    J_regressor: torch.Tensor
    lbs_weights: torch.Tensor
    parents: np.ndarray
    faces: np.ndarray

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    def forward_axis_angle(self, betas: torch.Tensor, pose: torch.Tensor):
        """betas (B, 10), pose (B, J*3) axis-angle -> (vertices, joints)."""
        return _lbs(betas, pose, self.v_template, self.shapedirs,
                    self.posedirs, self.J_regressor, self.parents,
                    self.lbs_weights)


def synthetic_smpl(num_verts: int = 400, seed: int = 0,
                   num_joints: int = NUM_JOINTS,
                   device=_device.DEFAULT) -> SmplModel:
    """A small random-but-valid SMPL-shaped body model: vertices on a
    capsule-ish blob, the real SMPL parent tree (if num_joints == 24),
    softmax-local skinning weights, small random blendshapes. On the card
    unless `device` says otherwise."""
    device = _device.resolve(device)
    rng = np.random.RandomState(seed)
    smpl_parents = np.array(
        [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
         18, 19, 20, 21], np.int64)
    if num_joints == NUM_JOINTS:
        parents = smpl_parents
    else:
        parents = np.concatenate([[0], np.arange(num_joints - 1)]).astype(np.int64)

    v_template = rng.randn(num_verts, 3).astype(np.float32) * 0.3
    v_template[:, 1] = np.linspace(-1.0, 0.6, num_verts) + rng.randn(num_verts) * 0.05
    joint_pos = rng.randn(num_joints, 3).astype(np.float32) * 0.4

    d2 = np.sum((joint_pos[:, None, :] - v_template[None, :, :]) ** 2, axis=-1)
    J_regressor = np.exp(-d2 / 0.1)
    J_regressor /= J_regressor.sum(axis=1, keepdims=True)
    J_regressor = J_regressor.astype(np.float32)

    w = np.exp(-d2.T / 0.05)  # (V, J)
    lbs_weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    shapedirs = (rng.randn(num_verts, 3, NUM_BETAS) * 0.01).astype(np.float32)
    posedirs = (rng.randn((num_joints - 1) * 9, num_verts * 3) * 0.001).astype(np.float32)

    faces = rng.randint(0, num_verts, size=(2 * num_verts, 3)).astype(np.int32)
    bad = (faces[:, 0] == faces[:, 1]) | (faces[:, 1] == faces[:, 2]) | (faces[:, 0] == faces[:, 2])
    faces = faces[~bad]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return SmplModel(v_template=t(v_template), shapedirs=t(shapedirs),
                     posedirs=t(posedirs), J_regressor=t(J_regressor),
                     lbs_weights=t(lbs_weights), parents=parents, faces=faces)
