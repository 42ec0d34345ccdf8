"""Checkpoint save/restore and pretrained-weight loads.

Counterpart of `garment4d_tpu/train/checkpoint.py` (reference
`utils/train_utils.py:94-211`): full resume (weights, BatchNorm running
statistics, optimizer state, epoch and other state), pretrained weights
only, and the stage-1 -> stage-2 bootstrap (`--GarmentPCA_pretrain`).

A checkpoint is one `torch.save` file in the reference's layout,
`{epoch, model_state, optimizer_state, other_state}`; the train state's
`step` and `lr_scale`, and where `fit` has run an epoch the state of its
dropout generator and plateau schedule, travel in `other_state`. A
checkpoint written after epoch e resumes at epoch e + 1.
`load_pretrained` and `bootstrap_canonical` also take the reference's own
`.ckpt` files, keyed by the reference's module names
(`train/torch_import.py`).

Under data parallelism rank 0 writes (`save_on_main`) and every rank reads
the same file, so the replicas start equal.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from garment4d_tpu_torch.parallel.launch import barrier, is_main_process
from garment4d_tpu_torch.train.convert import load_npz
from garment4d_tpu_torch.train.state import TrainState
from garment4d_tpu_torch.train.torch_import import (
    import_reference_state_dict,
    is_reference_named,
    load_reference_state_dict,
    map_reference_state_dict,
)


def save_checkpoint(path: str, state: TrainState, epoch: int,
                    other_state: Optional[Dict[str, Any]] = None) -> None:
    """Write `path` (its directory made as needed) atomically: a temporary
    file beside it, then a rename."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "model_state": state.model.state_dict(),
        "optimizer_state": state.optimizer.state_dict(),
        "other_state": {**(other_state or {}), "step": int(state.step),
                        "lr_scale": float(state.lr_scale),
                        **_loop_state(state)},
    }
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _loop_state(state: TrainState) -> dict:
    """The loop's resumable state, where `fit` has set it."""
    out = {}
    if state.generator_state is not None:
        out["generator_state"] = state.generator_state.cpu()
    if state.plateau is not None:
        out["plateau"] = dict(state.plateau)
    return out


def save_on_main(path: str, state: TrainState, epoch: int,
                 other_state: Optional[Dict[str, Any]] = None) -> None:
    """`save_checkpoint` on rank 0 (every process outside a process group);
    the other ranks, whose state equals rank 0's, wait at a barrier until
    the file is written."""
    if is_main_process():
        save_checkpoint(path, state, epoch, other_state)
    barrier()


def _read(path: str, device) -> dict:
    return torch.load(path, map_location=device, weights_only=True)


def restore_checkpoint(path: str, state: TrainState):
    """Full resume into `state` (built as the saved one was): returns
    (state, epoch, other_state without `step`, `lr_scale` and the loop's
    state, which go to `state`). The run continues at epoch + 1."""
    device = next(iter(state.model.state_dict().values())).device
    payload = _read(path, device)
    state.model.load_state_dict(payload["model_state"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer_state"])
    other = dict(payload["other_state"])
    state.step = int(other.pop("step"))
    state.lr_scale = float(other.pop("lr_scale"))
    gen = other.pop("generator_state", None)
    state.generator_state = None if gen is None else gen.cpu()
    state.plateau = other.pop("plateau", None)
    return state, int(payload["epoch"]), other


def _strip_module(key: str) -> str:
    return key[len("module."):] if key.startswith("module.") else key


def _weights(path: str) -> dict:
    """The tensors of a port checkpoint, a bare state_dict or a Flax
    variables npz (through `train/convert.py`), keys as the file has them."""
    if path.endswith(".npz"):
        return load_npz(path)
    return load_reference_state_dict(path)


def _reference_named(path: str, state_dict: dict, own: dict) -> bool:
    """Whether the file's keys are the reference's (`train/torch_import.py`)
    rather than the port's. A file is reference-named when some key (other
    than `num_batches_tracked`) is one the reference map knows, and
    port-named when some key, without its `module.` prefix, is one of the
    model's own; the two sets of names are disjoint, so a file with keys of
    both kinds raises ValueError."""
    reference = is_reference_named(state_dict)
    port = any(_strip_module(k) in own for k in state_dict
               if not k.endswith("num_batches_tracked"))
    if reference and port:
        raise ValueError(f"{path}: holds both reference-named and port-named keys")
    return reference


def load_pretrained(path: str, model: torch.nn.Module) -> Dict[str, list]:
    """Load only the weights (and BatchNorm statistics) of `path` into
    `model`: a port checkpoint, a bare state_dict, a Flax variables npz, or
    a reference checkpoint (`_reference_named`: mapped by
    `import_reference_state_dict`, tolerant). Keys may carry a `module.`
    prefix; a tensor loads where the model has its key with its shape.
    Returns {"loaded": keys, "skipped": keys of the file not loaded};
    raises KeyError when no tensor matches."""
    state_dict = _weights(path)
    own = model.state_dict()
    if _reference_named(path, state_dict, own):
        report = import_reference_state_dict(state_dict, model)
        if not report["loaded"]:
            raise KeyError(f"{path}: none of its reference-named tensors matches a key "
                           f"and shape of {type(model).__name__}")
        return report
    matched, skipped = {}, []
    for key, value in state_dict.items():
        name = _strip_module(key)
        if (name in own and isinstance(value, torch.Tensor)
                and tuple(own[name].shape) == tuple(value.shape)):
            matched[name] = value
        else:
            skipped.append(key)
    if not matched:
        raise KeyError(f"{path}: none of its {len(state_dict)} tensors matches a "
                       f"key and shape of {type(model).__name__}")
    model.load_state_dict(matched, strict=False)
    return {"loaded": sorted(matched), "skipped": skipped}


def bootstrap_canonical(path: str, posed_model: torch.nn.Module) -> Dict[str, list]:
    """Stage-1 -> stage-2 bootstrap: the canonical-stage weights of `path`
    into the posed model's `canonical` submodule (reference
    `--GarmentPCA_pretrain`, `train_temporal.py:162-178`). The file is a
    port checkpoint or state_dict of the canonical model, or the
    reference's bare canonical-stage file (`PCAGarmentEncoderSeg`'s keys,
    `_reference_named`). The whole submodule is replaced, as the JAX
    package replaces its `canonical` subtree: every tensor must come from
    the file with its shape (keys may carry a `module.` prefix), else
    KeyError names the missing, unexpected and mismatched keys (a
    checkpoint of another PCADIM, or one trained with `--only_seg`, which
    has no PCA head)."""
    raw = _weights(path)
    own = posed_model.canonical.state_dict()
    if _reference_named(path, raw, own):
        state_dict = map_reference_state_dict(raw)
        for name, value in own.items():  # the port's own count, not the file's
            if name.endswith("num_batches_tracked"):
                state_dict[name] = value
    else:
        state_dict = {_strip_module(k): v for k, v in raw.items()}
    missing = sorted(set(own) - set(state_dict))
    unexpected = sorted(set(state_dict) - set(own))
    mismatched = sorted(k for k in set(own) & set(state_dict)
                        if tuple(own[k].shape) != tuple(state_dict[k].shape))
    if missing or unexpected or mismatched:
        raise KeyError(f"{path} is not a canonical stage of this posed model: missing "
                       f"{missing}, unexpected {unexpected}, shapes differ {mismatched}")
    posed_model.canonical.load_state_dict(state_dict, strict=True)
    return {"loaded": sorted(own), "skipped": []}
