"""The NaN tripwire of `--debug_nans 1`: the port's counterpart of JAX's
`jax_debug_nans`, which the JAX package's entry point turns on in place of
the reference's isnan -> pdb checks (reference `train_temporal.py:250`).

While a `NanTripwire` is installed on a model:

- before each forward of the model, every parameter and buffer is checked,
  and one that holds a NaN raises FloatingPointError naming it (so an
  update that wrote a NaN is named at the next step's forward or the
  epoch's eval);
- a forward hook on every submodule raises FloatingPointError at the first
  module output that holds a NaN, naming the module's path;
- `backward(loss)` runs the backward under torch's anomaly mode, which
  stops at the first backward function that returns a NaN; its error is
  raised again as FloatingPointError, naming that function;
- `check(what, tensors)` raises FloatingPointError naming the first tensor
  of a dict that holds a NaN: the train and eval steps (`train/step.py`)
  check the loss terms and the gradients with it.

It reads and never writes: a step with the tripwire computes the same bits
as one without it. Each module output and each `check` of a dict is one
read of a device flag, so the steps wait for the device at every module
output.

One difference from JAX: `jax_debug_nans` checks the output of every
primitive, so it also raises on a NaN that the program makes and masks at
once. The hooks see module outputs only, and anomaly mode the outputs of
backward functions: a NaN made and masked between two module outputs
passes. `MgnGarmentModel` masks the NaN of its displacement MLP's output,
which is a module output, so there the port raises as JAX does.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn


def _first_nan(x) -> bool:
    """Whether a tensor, or any floating tensor in a (named) tuple, list or
    dict of them, holds a NaN."""
    if isinstance(x, torch.Tensor):
        return x.is_floating_point() and bool(torch.isnan(x).any())
    if isinstance(x, (tuple, list)):
        return any(_first_nan(v) for v in x)
    if isinstance(x, dict):
        return any(_first_nan(v) for v in x.values())
    return False


class NanTripwire:
    """Hooks on `model` that raise FloatingPointError at a NaN in its state
    before a forward and at the first NaN output of any of its modules, and
    the checks the steps call. `close()` removes the hooks."""

    def __init__(self, model: nn.Module):
        def check_state(_module, _inputs) -> None:
            self.check("parameter", dict(model.named_parameters()))
            self.check("buffer", dict(model.named_buffers()))

        self._handles = [model.register_forward_pre_hook(check_state)] + [
            module.register_forward_hook(self._hook(f"module {name}" if name else "the model"))
            for name, module in model.named_modules()]
        self.modules = len(self._handles) - 1  # the modules whose outputs it watches

    @staticmethod
    def _hook(what: str):
        def hook(module, _inputs, output) -> None:
            if _first_nan(output):
                raise FloatingPointError(
                    f"NaN in the output of {what} ({type(module).__name__})")
        return hook

    def check(self, what: str, tensors: Mapping[str, Optional[torch.Tensor]]) -> None:
        """Raise FloatingPointError naming the first of `tensors` (None and
        non-floating entries skipped) that holds a NaN; one device read
        when none does."""
        named = [(n, t) for n, t in tensors.items() if t is not None and t.is_floating_point()]
        if not named or not bool(torch.stack([torch.isnan(t).any() for _, t in named]).any()):
            return
        for name, t in named:
            if _first_nan(t):
                raise FloatingPointError(f"NaN in {what} {name}")

    def backward(self, loss: torch.Tensor) -> None:
        """`loss.backward()` under anomaly mode; a NaN returned by a
        backward function raises FloatingPointError."""
        with torch.autograd.set_detect_anomaly(True, check_nan=True):
            try:
                loss.backward()
            except RuntimeError as e:
                if "returned nan values" not in str(e):
                    raise
                raise FloatingPointError(f"NaN in the backward: {e}") from e

    def close(self) -> None:
        for handle in self._handles:
            handle.remove()
        self._handles = []
