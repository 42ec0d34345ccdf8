"""SMPL joint names and the vertex-picked extra joints.

Counterpart of `garment4d_tpu/smpl/joints.py` (reference
`smplx/smplx/joint_names.py`, `vertex_joint_selector.py`, `vertex_ids.py`):
the names of the 24 SMPL joints and the keypoints (face, hands, feet) read
off mesh vertices and appended after the regressed joints.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

SMPL_JOINT_NAMES = (
    "pelvis", "left_hip", "right_hip", "spine1", "left_knee", "right_knee",
    "spine2", "left_ankle", "right_ankle", "spine3", "left_foot",
    "right_foot", "neck", "left_collar", "right_collar", "head",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hand", "right_hand",
)

# the SMPL topology's keypoint vertex ids (the public smplx vertex_ids table)
SMPL_VERTEX_IDS: Dict[str, int] = {
    "nose": 332,
    "reye": 6260,
    "leye": 2800,
    "rear": 4071,
    "lear": 583,
    "rthumb": 6191,
    "rindex": 5782,
    "rmiddle": 5905,
    "rring": 6016,
    "rpinky": 6133,
    "lthumb": 2746,
    "lindex": 2319,
    "lmiddle": 2445,
    "lring": 2556,
    "lpinky": 2673,
    "LBigToe": 3216,
    "LSmallToe": 3226,
    "LHeel": 3387,
    "RBigToe": 6617,
    "RSmallToe": 6624,
    "RHeel": 6787,
}


def joint_index(name: str) -> int:
    return SMPL_JOINT_NAMES.index(name)


def select_extra_joints(vertices: torch.Tensor,
                        vertex_ids: Sequence[int]) -> torch.Tensor:
    """Keypoints read off the mesh: vertices (B, V, 3) -> (B, len(ids), 3)."""
    ids = torch.as_tensor(list(vertex_ids), dtype=torch.long, device=vertices.device)
    return vertices[:, ids, :]


def joints_with_extras(joints: torch.Tensor, vertices: torch.Tensor,
                       vertex_ids: Dict[str, int] = SMPL_VERTEX_IDS) -> torch.Tensor:
    """The regressed joints, then the vertex keypoints (the reference's
    joint layout)."""
    extra = select_extra_joints(vertices, list(vertex_ids.values()))
    return torch.cat([joints, extra], dim=1)
