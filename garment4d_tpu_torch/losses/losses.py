"""Losses and metrics of both stages.

Counterpart of `garment4d_tpu/losses/losses.py` (reference
`smplx/loss/temporal_loss.py`): segmentation cross-entropy, PCA-coefficient
MSE, vertex L2 / MSRE, body-garment interpenetration, cotangent-Laplacian
matching, the uniform-Laplacian regulariser, temporal smoothness, the
acceleration error, and the stage bundles `canonical_stage_loss` and
`posed_stage_loss`. The interpenetration term's 1-NN query is the 1-NN
kernel on the card (`ops.knn_points`), the banded Laplacian the banded
kernel (`ops.graph_matmul_banded`), both differentiable. The vertex normals
and the cotangent Laplacian sum over fixed incidence tables through the row
gather (`ops/meshmath.py`; its backward the deterministic scatter-add), so
the losses repeat bitwise from run to run on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from garment4d_tpu_torch import ops


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """The 9 lambdas of cfg.LOSS (reference `cfgs/*.yaml`)."""

    sem_seg: float = 0.05
    garment_l2: float = 40.0
    garment_lap: float = 1.0
    interpenetration: float = 50.0
    garment_pca_coeff_l2: float = 0.001
    lbs_garment_l2: float = 20.0
    lbs_garment_lap: float = 10.0
    lbs_interpenetration: float = 100.0
    temporal_constraint: float = 5.0


def sem_seg_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over the point classes: logits (..., C), labels (...)
    int."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0].mean()


def shape_l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Plain MSE."""
    return ((pred - target) ** 2).mean()


def vertex_l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Summed-per-vertex squared L2, averaged."""
    return ((pred - target) ** 2).sum(dim=-1).mean()


def vertex_msre(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean per-vertex euclidean error."""
    return torch.sqrt(((pred - target) ** 2).sum(dim=-1)).mean()


def interpenetration_penalties(garment_v: torch.Tensor, body_v: torch.Tensor,
                               body_vn: torch.Tensor) -> torch.Tensor:
    """relu(-n_b . (g - b)) per garment vertex against its nearest body
    vertex. garment_v (B, Vg, 3), body_v / body_vn (B, Vb, 3) -> (B, Vg)."""
    _, idx = ops.knn_points(garment_v, body_v, K=1)
    b = ops.group_points(body_v, idx)[:, :, 0, :]
    n = ops.group_points(body_vn, idx)[:, :, 0, :]
    return torch.relu(-(n * (garment_v - b)).sum(dim=-1))


def interpenetration_loss(garment_v: torch.Tensor, body_v: torch.Tensor,
                          body_vn: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """Reduced `interpenetration_penalties`: 'sum' over vertices then mean
    over the batch (the reference helper's form), or 'mean' (what both
    training stages use)."""
    pen = interpenetration_penalties(garment_v, body_v, body_vn)
    if reduce == "sum":
        return pen.sum(dim=-1).mean()
    if reduce == "mean":
        return pen.mean()
    raise ValueError(reduce)


def cot_laplacian_residuals(pred_v: torch.Tensor, gt_v: torch.Tensor,
                            faces_tri) -> torch.Tensor:
    """| ||L(pred) pred|| - ||L(gt) gt|| | per vertex, each side's cotangent
    Laplacian built from its own vertices, its weights constant for
    autodiff; the ground truth's side gets no gradient."""
    lx_pred = ops.cot_laplacian_apply(pred_v, pred_v, faces_tri)
    with torch.no_grad():
        n_gt = torch.linalg.vector_norm(ops.cot_laplacian_apply(gt_v, gt_v, faces_tri), dim=-1)
    return (torch.linalg.vector_norm(lx_pred, dim=-1) - n_gt).abs()


def cot_laplacian_loss(pred_v: torch.Tensor, gt_v: torch.Tensor,
                       faces_tri) -> torch.Tensor:
    return cot_laplacian_residuals(pred_v, gt_v, faces_tri).mean()


def uniform_laplacian_norms(pred_v: torch.Tensor, lap_adj: torch.Tensor,
                            lap_offsets=None) -> torch.Tensor:
    """||(I - norm(A)) v|| per vertex. pred_v (..., V, 3), lap_adj (V, V);
    `lap_offsets` (from `ops.cyclic_diagonals(lap_adj)`) selects the banded
    product."""
    if lap_offsets is not None:
        lap = ops.graph_matmul_banded(lap_adj, pred_v, lap_offsets)
    else:
        lap = ops.graph_matmul(lap_adj, pred_v)
    return torch.linalg.vector_norm(lap, dim=-1)


def uniform_laplacian_regularizer(pred_v: torch.Tensor, lap_adj: torch.Tensor,
                                  lap_offsets=None) -> torch.Tensor:
    return uniform_laplacian_norms(pred_v, lap_adj, lap_offsets).mean()


def temporal_diff_norms(pred_v: torch.Tensor) -> torch.Tensor:
    """||v_t - v_{t+1}|| per vertex pair: (B, T, V, 3) -> (B, T-1, V)."""
    diff = pred_v[:, :-1] - pred_v[:, 1:]
    return torch.sqrt((diff ** 2).sum(dim=-1))


def temporal_constraint_loss(pred_v: torch.Tensor) -> torch.Tensor:
    return temporal_diff_norms(pred_v).mean()


def _accel(v: torch.Tensor, fps: float) -> torch.Tensor:
    dt = 1.0 / fps
    vel = (v[:, 1:] - v[:, :-1]) / dt
    return (vel[:, 1:] - vel[:, :-1]) / dt


def _accel_err(pred_v: torch.Tensor, gt_v: torch.Tensor, mean,
               fps: float = 30.0) -> torch.Tensor:
    """Finite-difference acceleration error of (B, T, V, 3) sequences,
    reduced by `mean`; 0 for T < 3 (the reference NaNs on an empty mean)."""
    if pred_v.shape[1] < 3:
        return torch.zeros((), device=pred_v.device)
    return mean(torch.sqrt(((_accel(pred_v, fps) - _accel(gt_v, fps)) ** 2).sum(dim=-1)))


def acceleration_error(pred_v: torch.Tensor, gt_v: torch.Tensor,
                       fps: float = 30.0) -> torch.Tensor:
    return _accel_err(pred_v, gt_v, torch.mean, fps)


def _bmean(x: torch.Tensor, batch: int, valid: torch.Tensor) -> torch.Tensor:
    """Per-sample means of x (leading dim `batch` or a multiple of it),
    weighted by the (B,) validity mask (excludes eval-tail padding)."""
    per = x.reshape(batch, -1).mean(dim=1)
    w = valid.to(per.dtype)
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def canonical_stage_loss(output, batch: Dict[str, torch.Tensor], faces_tri,
                         body_faces, weights: LossWeights, only_seg: bool = False,
                         valid: torch.Tensor = None) -> Dict[str, torch.Tensor]:
    """All canonical-stage losses (reference `temporal_loss_PCA`). `output`
    is a CanonicalOutput; `valid` an optional (B,) mask excluding eval-tail
    padding duplicates; `only_seg` keeps the segmentation term alone."""
    B, T = batch["pose"].shape[:2]
    losses: Dict[str, torch.Tensor] = {}

    def mean(x):
        return x.mean() if valid is None else _bmean(x, B, valid)

    logits = output.backbone.sem_logits
    logits = logits.reshape(B * T, -1, logits.shape[-1])
    labels = batch["pcd_label"].reshape(B * T, -1).long()
    picked = torch.gather(torch.log_softmax(logits, dim=-1), -1, labels[..., None])[..., 0]
    l_seg = mean(-picked.reshape(B, -1))
    losses["sem_seg_loss"] = l_seg
    total = l_seg * weights.sem_seg
    if only_seg:
        losses["total_loss"] = total
        return losses

    l_pca = mean((output.pca_coeff - batch["pca_coeff"]) ** 2)
    losses["garment_pca_coeff_l2"] = l_pca
    total = total + l_pca * weights.garment_pca_coeff_l2

    gt_garment = batch["garment_template_vertices"]  # (B, V, 3)
    pred = output.tpose_garment
    sq = ((pred - gt_garment) ** 2).sum(dim=-1)
    losses["garment_l2_loss"] = mean(sq)
    losses["garment_msre"] = mean(torch.sqrt(sq))
    total = total + losses["garment_l2_loss"] * weights.garment_l2

    tpose_body = batch["tpose_smpl_vertices"]  # (B, Vb, 3)
    body_vn = ops.vertex_normals(tpose_body, body_faces)
    garment_rooted = pred + batch["tpose_smpl_root_joints"][:, None, :]
    l_pen = mean(interpenetration_penalties(garment_rooted, tpose_body, body_vn))
    losses["interpenetration_loss"] = l_pen
    total = total + l_pen * weights.interpenetration

    l_lap = mean(cot_laplacian_residuals(pred, gt_garment, faces_tri))
    losses["garment_lap_loss"] = l_lap
    total = total + l_lap * weights.garment_lap
    losses["total_loss"] = total
    return losses


def posed_stage_loss(output, batch: Dict[str, torch.Tensor], lap_adj: torch.Tensor,
                     body_faces: np.ndarray, weights: LossWeights,
                     valid: torch.Tensor = None, lap_offsets=None,
                     lap_perm: torch.Tensor = None) -> Dict[str, torch.Tensor]:
    """All posed-stage losses (reference `temporal_loss_PCA_LBS`). `output`
    is a PosedOutput. `valid` is an optional (B,) mask excluding eval-tail
    padding duplicates. `lap_offsets` enables the banded Laplacian;
    `lap_perm` (V,) applies a band-recovering vertex relabeling first
    (exact: the mean of per-vertex norms is permutation-invariant)."""
    B, T = batch["pose"].shape[:2]
    losses: Dict[str, torch.Tensor] = {}

    def mean(x):
        return x.mean() if valid is None else _bmean(x, B, valid)

    gt_garment = batch["garment"] + batch["smpl_root_joints"].reshape(B, T, 1, 3)

    l2_acc = 0.0
    iters = output.iter_garment_v
    for i, pred in enumerate(iters):
        sq = ((pred - gt_garment) ** 2).sum(dim=-1)
        l2_acc = l2_acc + mean(sq)
        if i == len(iters) - 1:
            per_frame = torch.sqrt(sq).mean(dim=-1)
            losses["lbs_garment_msre"] = mean(per_frame)
            losses["lbs_garment_msre_list"] = per_frame  # (B, T)
    losses["only_lbs_garment_msre"] = mean(torch.sqrt(
        ((output.lbs.posed_garment - gt_garment) ** 2).sum(dim=-1)))
    losses["lbs_garment_l2_loss"] = l2_acc
    total = l2_acc * weights.lbs_garment_l2

    la = lap_adj if lap_perm is None else lap_adj[lap_perm][:, lap_perm]
    lap_acc = 0.0
    for pred in iters:
        p = pred if lap_perm is None else pred[..., lap_perm, :]
        lap_acc = lap_acc + mean(uniform_laplacian_norms(p, la, lap_offsets))
    losses["lbs_garment_lap_loss"] = lap_acc
    total = total + lap_acc * weights.lbs_garment_lap

    body_v = batch["smpl_vertices"].reshape(B * T, -1, 3)
    body_vn = ops.vertex_normals(body_v, body_faces)
    pen_acc = 0.0
    for pred in iters:
        pen = interpenetration_penalties(pred.reshape(B * T, -1, 3), body_v, body_vn)
        pen_acc = pen_acc + mean(pen.reshape(B, -1))
    losses["lbs_interpenetration_loss"] = pen_acc
    total = total + pen_acc * weights.lbs_interpenetration

    last = iters[-1]
    l_temp = mean(temporal_diff_norms(last))
    losses["temporal_constraint_loss"] = l_temp
    total = total + l_temp * weights.temporal_constraint

    losses["acceleration_error"] = _accel_err(last, gt_garment, mean)
    losses["only_lbs_acceleration_error"] = _accel_err(
        output.lbs.posed_garment, gt_garment, mean)
    losses["total_loss"] = total
    return losses
