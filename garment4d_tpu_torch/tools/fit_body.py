"""Body-model fitting: SMPL parameters for a target mesh or scan.

Counterpart of `garment4d_tpu/tools/fit_body.py` (the reference's vendored
`smplx/transfer_model`, `transfer_model.py:257+`): given target vertices,
optimise (betas, pose, translation) of an SMPL model to fit them, with
`torch.optim.LBFGS` (strong-Wolfe line search, history 10) for the JAX
package's fixed iteration count, or Adam. A target of another topology is
mapped through `nearest_vertex_correspondence` (K nearest model vertices,
inverse-distance weights). The fit runs on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from garment4d_tpu_torch import _device, ops
from garment4d_tpu_torch.smpl import SmplModel


@dataclasses.dataclass
class FitResult:
    betas: np.ndarray      # (B, 10)
    pose: np.ndarray       # (B, 72) axis-angle
    transl: np.ndarray     # (B, 3)
    vertices: np.ndarray   # (B, V, 3) fitted model vertices
    final_loss: float


def nearest_vertex_correspondence(src_verts: np.ndarray, dst_verts: np.ndarray,
                                  K: int = 3, device=_device.DEFAULT):
    """K-NN inverse-distance map from the dst topology to src: returns (idx
    (Vd, K), weights (Vd, K) float32) with dst ~= sum_k w[:, k] *
    src[idx[:, k]]. The neighbours come from `ops.knn_points` on `device`
    (squared distances, ties to the lower index); the weights are 1 /
    max(d2, 1e-9), normalised, in numpy as the JAX package computes them."""
    dev = _device.resolve(device)
    d2, idx = ops.knn_points(_device.tensor(dst_verts, dev)[None],
                             _device.tensor(src_verts, dev)[None], K=K)
    d = d2[0].cpu().numpy()
    w = 1.0 / np.maximum(d, 1e-9)
    w = w / w.sum(axis=1, keepdims=True)
    return idx[0].cpu().numpy(), w.astype(np.float32)


def fit_smpl_to_vertices(
    model: SmplModel,
    target_verts,                      # (B, Vt, 3)
    correspondence: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    vertex_mask: Optional[np.ndarray] = None,  # (Vt,) weight per target vertex
    iters: int = 200,
    lr: float = 0.05,
    shape_reg: float = 1e-3,
    pose_reg: float = 1e-3,
    use_lbfgs: bool = True,
    init: Optional[Dict[str, np.ndarray]] = None,
) -> FitResult:
    """Optimise (betas, pose, transl) so that the model matches
    `target_verts`: the loss is the masked mean squared vertex error plus
    shape_reg * mean(betas^2) + pose_reg * mean(body pose^2) (the root
    orientation pose[:, :3] is free). `iters` LBFGS iterations (each with
    its line search), or `iters` Adam steps at `lr` with `use_lbfgs=False`.
    """
    dev = model.v_template.device
    target = _device.tensor(target_verts, dev)
    B, Vt, _ = target.shape
    mask = (torch.ones(Vt, device=dev) if vertex_mask is None
            else _device.tensor(vertex_mask, dev))
    if correspondence is not None:
        corr_idx = _device.tensor(correspondence[0], dev, torch.long)
        corr_w = _device.tensor(correspondence[1], dev)
    else:
        corr_idx = corr_w = None

    start = {"betas": np.zeros((B, 10), np.float32), "pose": np.zeros((B, 72), np.float32),
             "transl": np.zeros((B, 3), np.float32)}
    if init:
        start.update(init)
    params = {k: _device.tensor(v, dev).clone().requires_grad_(True) for k, v in start.items()}

    def model_verts():
        v, _ = model.forward_axis_angle(params["betas"], params["pose"])
        v = v + params["transl"][:, None, :]
        if corr_idx is not None:
            picked = v[:, corr_idx.reshape(-1), :].reshape(B, Vt, -1, 3)
            v = (picked * corr_w[None, :, :, None]).sum(dim=2)
        return v

    def loss_fn():
        data = (mask[None, :, None] * (model_verts() - target) ** 2).mean()
        reg = (shape_reg * (params["betas"] ** 2).mean()
               + pose_reg * (params["pose"][:, 3:] ** 2).mean())
        return data + reg

    leaves = list(params.values())
    if use_lbfgs:
        opt = torch.optim.LBFGS(leaves, lr=1.0, max_iter=iters, max_eval=25 * iters,
                                tolerance_grad=0.0, tolerance_change=0.0, history_size=10,
                                line_search_fn="strong_wolfe")

        def closure():
            opt.zero_grad(set_to_none=True)
            loss = loss_fn()
            loss.backward()
            return loss

        if iters > 0:
            opt.step(closure)
    else:
        opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        for _ in range(iters):
            opt.zero_grad(set_to_none=True)
            loss_fn().backward()
            opt.step()

    with torch.no_grad():
        final_loss = float(loss_fn())
        verts, _ = model.forward_axis_angle(params["betas"], params["pose"])
        verts = verts + params["transl"][:, None, :]
    return FitResult(
        betas=params["betas"].detach().cpu().numpy(),
        pose=params["pose"].detach().cpu().numpy(),
        transl=params["transl"].detach().cpu().numpy(),
        vertices=verts.cpu().numpy(),
        final_loss=final_loss,
    )
