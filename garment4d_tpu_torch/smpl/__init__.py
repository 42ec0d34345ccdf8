"""SMPL body model and linear blend skinning."""

from garment4d_tpu_torch.smpl.lbs import (
    batch_rigid_transform,
    batch_rodrigues,
    blend_shapes,
    lbs,
    skin_vertices,
    vertices2joints,
    vertices2joints_b,
)
from garment4d_tpu_torch.smpl.model import SmplModel, synthetic_smpl

__all__ = [
    "SmplModel", "batch_rigid_transform", "batch_rodrigues", "blend_shapes",
    "lbs", "skin_vertices", "synthetic_smpl", "vertices2joints",
    "vertices2joints_b",
]
