"""Losses and metrics (posed stage)."""

from garment4d_tpu_torch.losses.losses import (
    LossWeights,
    acceleration_error,
    interpenetration_loss,
    interpenetration_penalties,
    posed_stage_loss,
    temporal_constraint_loss,
    temporal_diff_norms,
    uniform_laplacian_norms,
    uniform_laplacian_regularizer,
    vertex_l2_loss,
    vertex_msre,
)

__all__ = [
    "LossWeights", "acceleration_error", "interpenetration_loss",
    "interpenetration_penalties", "posed_stage_loss", "temporal_constraint_loss",
    "temporal_diff_norms", "uniform_laplacian_norms", "uniform_laplacian_regularizer",
    "vertex_l2_loss", "vertex_msre",
]
