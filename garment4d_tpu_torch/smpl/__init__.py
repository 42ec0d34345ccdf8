"""SMPL body model, linear blend skinning and joint metadata."""

from garment4d_tpu_torch.smpl.joints import (
    SMPL_JOINT_NAMES,
    SMPL_VERTEX_IDS,
    joint_index,
    joints_with_extras,
    select_extra_joints,
)
from garment4d_tpu_torch.smpl.lbs import (
    batch_rigid_transform,
    batch_rodrigues,
    blend_shapes,
    lbs,
    skin_vertices,
    vertices2joints,
    vertices2joints_b,
)
from garment4d_tpu_torch.smpl.model import (
    SmplModel,
    load_smpl,
    load_smpl_npz,
    load_smpl_pickle,
    synthetic_smpl,
)

__all__ = [
    "SMPL_JOINT_NAMES", "SMPL_VERTEX_IDS", "SmplModel", "batch_rigid_transform",
    "batch_rodrigues", "blend_shapes", "joint_index", "joints_with_extras", "lbs",
    "load_smpl", "load_smpl_npz", "load_smpl_pickle", "select_extra_joints",
    "skin_vertices", "synthetic_smpl", "vertices2joints", "vertices2joints_b",
]
