"""The reference's losses and training steps (reference
`smplx/loss/temporal_loss.py`, `train_temporal.py`), in plain float32 torch.

`steps` runs the posed or the canonical recipe from the weights file for a
few steps on given batches: the stage's losses, autograd's gradients of
their weighted sum and torch's default Adam (betas 0.9, 0.999, eps 1e-8),
written out. The posed stage trains every variable outside `canonical/`
and keeps the canonical stage in eval mode; the canonical stage trains all
of its own variables in training mode.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference import geometry as G
from portbench.reference.network import Net

POSED_WEIGHTS = dict(lbs_garment_l2_loss=20.0, lbs_garment_lap_loss=10.0,
                     lbs_interpenetration_loss=100.0, temporal_constraint_loss=5.0)
CANONICAL_WEIGHTS = dict(sem_seg_loss=0.05, garment_pca_coeff_l2=0.001, garment_l2_loss=40.0,
                         interpenetration_loss=50.0, garment_lap_loss=1.0)
BETAS, EPS = (0.9, 0.999), 1e-8


def penetration(garment: torch.Tensor, body: torch.Tensor, normals: torch.Tensor):
    """relu(-n . (g - b)) against each garment vertex's nearest body vertex
    b (squared distance, ties to the lower index): (F, V)."""
    _, idx = G.nearest(garment.detach(), body, 1)
    b = G.gather_rows(body, idx[..., 0])
    n = G.gather_rows(normals, idx[..., 0])
    return torch.relu(-(n * (garment - b)).sum(-1))


def posed_losses(net: Net, out: dict, batch: dict) -> Dict[str, torch.Tensor]:
    B, T = batch["pose"].shape[:2]
    gt = batch["garment"] + batch["smpl_root_joints"].reshape(B, T, 1, 3)
    iters = out["iters"]
    body_v = batch["smpl_vertices"].reshape(B * T, -1, 3)
    normals = G.vertex_normals(body_v, net.body_faces)
    L = {
        "lbs_garment_l2_loss": sum(((p - gt) ** 2).sum(-1).mean() for p in iters),
        "lbs_garment_lap_loss": sum(torch.einsum("vw,btwc->btvc", net.lap, p).norm(dim=-1).mean()
                                    for p in iters),
        "lbs_interpenetration_loss": sum(
            penetration(p.reshape(B * T, -1, 3), body_v, normals).mean() for p in iters),
        "temporal_constraint_loss": (iters[-1][:, :-1] - iters[-1][:, 1:]).norm(dim=-1).mean(),
    }
    L["total_loss"] = sum(L[k] * w for k, w in POSED_WEIGHTS.items())
    return L


def canonical_losses(net: Net, out: dict, batch: dict) -> Dict[str, torch.Tensor]:
    logits = out["sem_logits"]
    labels = batch["pcd_label"].reshape(logits.shape[0], -1).long()
    logp = torch.log_softmax(logits, -1)
    pred, gt = out["tpose_garment"], batch["garment_template_vertices"]
    tpose_body = batch["tpose_smpl_vertices"]
    normals = G.vertex_normals(tpose_body, net.body_faces)
    rooted = pred + batch["tpose_smpl_root_joints"][:, None, :]
    with torch.no_grad():
        gt_lap = G.cot_laplacian(gt, gt, net.faces_tri).norm(dim=-1)
    L = {
        "sem_seg_loss": -torch.gather(logp, -1, labels[..., None]).mean(),
        "garment_pca_coeff_l2": ((out["pca_coeff"] - batch["pca_coeff"]) ** 2).mean(),
        "garment_l2_loss": ((pred - gt) ** 2).sum(-1).mean(),
        "interpenetration_loss": penetration(rooted, tpose_body, normals).mean(),
        "garment_lap_loss": (G.cot_laplacian(pred, pred, net.faces_tri).norm(dim=-1)
                             - gt_lap).abs().mean(),
    }
    L["total_loss"] = sum(L[k] * w for k, w in CANONICAL_WEIGHTS.items())
    return L


def trained_names(net: Net, kind: str) -> List[str]:
    if kind == "posed":
        return sorted(k for k in net.W if k.startswith("params/")
                      and not k.startswith("params/canonical/"))
    return sorted(k for k in net.W if k.startswith("params/"))


def steps(net: Net, kind: str, batches: List[dict], lr: float,
          generator: torch.Generator = None) -> dict:
    """Train `net.W` in place for len(batches) steps of `kind` ("posed" or
    "canonical"; the canonical stage's dropout draws from `generator`).
    -> {"losses": [{term: float}] a step, "grads": the first step's
    gradients, "start": the trained tensors before the first step}."""
    names = trained_names(net, kind)
    start = {n: net.W[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(net.W[n]) for n in names}
    v = {n: torch.zeros_like(net.W[n]) for n in names}
    losses, first = [], {}
    for t, batch in enumerate(batches, 1):
        for n in names:
            net.W[n] = net.W[n].detach().requires_grad_(True)
        if kind == "posed":
            L = posed_losses(net, net.posed(batch["pcd"], batch), batch)
        else:
            L = canonical_losses(net, net.canonical(batch["pcd"], True, generator), batch)
        grads = torch.autograd.grad(L["total_loss"], [net.W[n] for n in names],
                                    allow_unused=True)
        losses.append({k: float(x.detach()) for k, x in L.items()})
        with torch.no_grad():
            for n, g in zip(names, grads):
                g = torch.zeros_like(net.W[n]) if g is None else g
                if t == 1:
                    first[n] = g.clone()
                m[n] = BETAS[0] * m[n] + (1 - BETAS[0]) * g
                v[n] = BETAS[1] * v[n] + (1 - BETAS[1]) * g * g
                c1, c2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
                denom = v[n].sqrt() / math.sqrt(c2) + EPS
                net.W[n] = net.W[n].detach() - (lr / c1) * m[n] / denom
        del L, grads
    return {"losses": losses, "grads": first, "start": start}
