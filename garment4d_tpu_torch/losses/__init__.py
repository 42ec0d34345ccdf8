"""Losses and metrics of both stages."""

from garment4d_tpu_torch.losses.losses import (
    LossWeights,
    acceleration_error,
    canonical_stage_loss,
    cot_laplacian_loss,
    cot_laplacian_residuals,
    interpenetration_loss,
    interpenetration_penalties,
    posed_stage_loss,
    sem_seg_loss,
    shape_l2_loss,
    temporal_constraint_loss,
    temporal_diff_norms,
    uniform_laplacian_norms,
    uniform_laplacian_regularizer,
    vertex_l2_loss,
    vertex_msre,
)

__all__ = [
    "LossWeights", "acceleration_error", "canonical_stage_loss", "cot_laplacian_loss",
    "cot_laplacian_residuals", "interpenetration_loss", "interpenetration_penalties",
    "posed_stage_loss", "sem_seg_loss", "shape_l2_loss", "temporal_constraint_loss",
    "temporal_diff_norms", "uniform_laplacian_norms", "uniform_laplacian_regularizer",
    "vertex_l2_loss", "vertex_msre",
]
