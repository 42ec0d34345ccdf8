"""Training state: optimizer, plateau schedule, parameter freezing.

Counterpart of `garment4d_tpu/train/state.py` (reference
`train_temporal.py:124-187`): Adam with the torch defaults the reference
relies on (betas (0.9, 0.999), eps 1e-8); `--fix_PCA`-style freezing of the
canonical stage by `requires_grad_(False)` on its parameters, so they get
no gradient and no update (JAX zeroes their updates with
`optax.set_to_zero`); ReduceLROnPlateau as a host-side learning-rate scale.
In a process group the gradients are averaged over the ranks before each
update (`parallel.average_gradients`).
"""

from __future__ import annotations

import dataclasses

import torch

from garment4d_tpu_torch.parallel.data import average_gradients
from garment4d_tpu_torch.parallel.launch import in_group


def make_optimizer(model: torch.nn.Module, lr: float,
                   freeze_canonical: bool = False) -> torch.optim.Adam:
    """Adam over the model's trainable parameters (every one of the
    canonical model's); with `freeze_canonical` the posed model's
    `canonical` subtree is frozen first."""
    if freeze_canonical:
        model.freeze_canonical()
    params = [p for p in model.parameters() if p.requires_grad]
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the step count and the plateau schedule's
    learning-rate multiplier (applied to the base rate at every step)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr: float
    step: int = 0
    lr_scale: float = 1.0

    def apply_gradients(self) -> None:
        """One optimizer step on the gradients in the parameters' `.grad`,
        first averaged over the ranks in a process group."""
        if in_group():
            average_gradients(p for group in self.optimizer.param_groups
                              for p in group["params"])
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr * self.lr_scale
        self.optimizer.step()
        self.step += 1


# torch's ReduceLROnPlateau defaults, which the reference keeps
_PLATEAU_FACTOR = 0.1
_PLATEAU_THRESHOLD = 1e-4  # relative: better means a < best * (1 - threshold)
_PLATEAU_EPS = 1e-8  # the update guard


@dataclasses.dataclass
class PlateauScheduler:
    """Host-side ReduceLROnPlateau (mode 'min') as the reference builds it,
    `ReduceLROnPlateau(optimizer, 'min', patience=8)`, with torch's other
    defaults: factor 0.1, relative threshold 1e-4, cooldown 0, min_lr 0 and
    the eps=1e-8 update guard. `update` returns the new scale for
    `TrainState.lr_scale`."""

    patience: int = 8
    best: float = float("inf")
    num_bad: int = 0
    scale: float = 1.0

    def update(self, metric: float) -> float:
        if metric < self.best * (1.0 - _PLATEAU_THRESHOLD):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            new_scale = self.scale * _PLATEAU_FACTOR
            if self.scale - new_scale > _PLATEAU_EPS:
                self.scale = new_scale
            self.num_bad = 0
        return self.scale
