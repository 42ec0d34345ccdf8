"""Train and eval steps of both stages.

Counterpart of `garment4d_tpu/train/step.py`. `make_canonical_steps`
returns a train step (the canonical model in train mode: BatchNorm on batch
statistics, the head's dropout from the caller's `torch.Generator`; the
canonical-stage losses, backward, one Adam step over every parameter, the
running statistics updated) and an eval step (forward under inference
mode, the fused eval-mode SA path on the card, the losses with the
optional eval-tail mask). `make_posed_steps` returns the posed stage's:
forward in train mode with the canonical stage frozen in eval mode, the
posed-stage losses, backward, one Adam step; its loss Laplacian is banded
through its cyclic diagonals, or through the reverse Cuthill-McKee
relabeling that makes it banded, as the model's GCN stack is.

In a process group (`parallel.in_group`) the same steps run on this rank's
share of the global batch: BatchNorm statistics and dropout masks are the
global batch's, the gradients are averaged over the ranks before the
update, and the train step's loss dict holds the global batch's values
(`parallel.mean_over_ranks`). The eval step stays per rank;
`train/loop.py` reduces its means.

With a `tripwire` (`utils/debug_nans.NanTripwire`, `--debug_nans 1`) the
steps raise FloatingPointError at the first NaN: in a module's output (its
hooks), in the loss terms, in the backward or in a gradient; a NaN that
an update writes into a parameter is named by the next forward's check of
the model's state. The checks only read: a step computes the same bits
with a tripwire as without one.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from garment4d_tpu_torch import losses as L
from garment4d_tpu_torch.models.posed import BodyInputs
from garment4d_tpu_torch.ops.graph import bandwidth_permutation, cyclic_diagonals
from garment4d_tpu_torch.parallel.data import broadcast_module, mean_over_ranks
from garment4d_tpu_torch.parallel.launch import in_group
from garment4d_tpu_torch.train.state import TrainState, make_optimizer
from garment4d_tpu_torch.utils.debug_nans import NanTripwire


def body_inputs_from_batch(batch: Dict[str, torch.Tensor]) -> BodyInputs:
    return BodyInputs(
        pose=batch["pose"],
        smpl_vertices=batch["smpl_vertices"],
        tpose_vertices=batch["tpose_smpl_vertices"],
        tpose_root_joints=batch["tpose_smpl_root_joints"],
        zeropose_vertices=batch["zeropose_smpl_vertices"],
        J_regressor=batch["J_regressor"],
        lbs_weights=batch["lbs_weights"],
    )


def _backward_and_update(state: TrainState, losses: Dict[str, torch.Tensor],
                         tripwire: Optional[NanTripwire]) -> None:
    """The total loss's backward and one Adam step; with a tripwire the
    loss terms and the gradients are checked."""
    state.optimizer.zero_grad(set_to_none=True)
    if tripwire is None:
        losses["total_loss"].backward()
        state.apply_gradients()
        return
    tripwire.check("loss", losses)
    tripwire.backward(losses["total_loss"])
    tripwire.check("the gradient of", {n: p.grad for n, p in state.model.named_parameters()
                                       if p.requires_grad})
    state.apply_gradients()


def _step_losses(state: TrainState, losses: Dict[str, torch.Tensor]):
    """The train step's detached loss dict; the global batch's in a process
    group."""
    losses = {k: v.detach() for k, v in losses.items()}
    return mean_over_ranks(losses) if in_group() else losses


def make_canonical_steps(model, assets, body_faces: np.ndarray,
                         weights: Optional[L.LossWeights] = None,
                         only_seg: bool = False,
                         tripwire: Optional[NanTripwire] = None) -> Tuple[Callable, Callable]:
    """-> (train_step(state, batch, generator), eval_step(state, batch)),
    each returning the loss dict (detached). `generator` is the
    `torch.Generator` on the batch's device that the dropout draws from
    (JAX's `dropout_rng`). The loss-side constants live on the device of
    the model's buffers when this is called. `tripwire`: the NaN checks
    of `--debug_nans` (module docstring)."""
    weights = weights or L.LossWeights()
    device = model.pca_mean.device
    faces_tri = torch.as_tensor(np.asarray(assets.faces_tri), dtype=torch.long, device=device)
    faces = torch.as_tensor(np.asarray(body_faces), dtype=torch.long, device=device)

    def loss_dict(out, batch, valid=None):
        return L.canonical_stage_loss(out, batch, faces_tri, faces, weights,
                                      only_seg=only_seg, valid=valid)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator):
        state.model.train()
        losses = loss_dict(state.model(batch["pcd"], generator), batch)
        _backward_and_update(state, losses, tripwire)
        return _step_losses(state, losses)

    @torch.inference_mode()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.eval()
        losses = loss_dict(state.model(batch["pcd"]), batch, valid=batch.get("valid_mask"))
        if tripwire is not None:
            tripwire.check("eval loss", losses)
        return losses

    return train_step, eval_step


def make_posed_steps(model, assets, body_faces: np.ndarray,
                     weights: Optional[L.LossWeights] = None,
                     tripwire: Optional[NanTripwire] = None
                     ) -> Tuple[Callable, Callable]:
    """-> (train_step(state, batch, generator=None), eval_step(state,
    batch)), each returning the loss dict (detached). The train step takes
    the canonical stage's `generator` argument and ignores it (the posed
    stage draws no random numbers), so a loop calls both stages alike. The
    loss-side constants live on the device of the model's parameters when
    this is called. `tripwire`: the NaN checks of `--debug_nans` (module
    docstring)."""
    weights = weights or L.LossWeights()
    device = next(model.parameters()).device
    lap_adj = np.asarray(assets.lap_adj)
    lap_offsets = cyclic_diagonals(lap_adj)
    lap_perm = None
    if lap_offsets is None:
        perm, offs = bandwidth_permutation(lap_adj)
        if offs is not None:
            lap_perm = torch.from_numpy(perm.astype(np.int64)).to(device)
            lap_offsets = offs
    lap = torch.from_numpy(np.ascontiguousarray(lap_adj)).to(device)
    faces = torch.as_tensor(np.asarray(body_faces), dtype=torch.long, device=device)

    def loss_dict(out, batch, valid=None):
        return L.posed_stage_loss(out, batch, lap, faces, weights, valid=valid,
                                  lap_offsets=lap_offsets, lap_perm=lap_perm)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        state.model.train()
        out = state.model(batch["pcd"], body_inputs_from_batch(batch))
        losses = loss_dict(out, batch)
        _backward_and_update(state, losses, tripwire)
        return _step_losses(state, losses)

    @torch.inference_mode()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state.model.eval()
        out = state.model(batch["pcd"], body_inputs_from_batch(batch))
        losses = loss_dict(out, batch, valid=batch.get("valid_mask"))
        if tripwire is not None:
            tripwire.check("eval loss", losses)
        return losses

    return train_step, eval_step


def make_state_for(model, lr: float, freeze_canonical: bool = False) -> TrainState:
    """A TrainState over the model's parameters (the model already holds its
    weights and constants): Adam at `lr` over every parameter that requires
    grad, the posed model's canonical stage frozen with `freeze_canonical`.
    BatchNorm running statistics are buffers, updated by the forward. In a
    process group the model's parameters and buffers are set to rank 0's."""
    if in_group():
        broadcast_module(model)
    return TrainState(model=model, lr=lr,
                      optimizer=make_optimizer(model, lr, freeze_canonical))
