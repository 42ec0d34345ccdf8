"""Flax checkpoint -> torch state_dict.

The JAX package saves variables as one flat npz
(`garment4d_tpu/train/checkpoint.py:save_variables_npz`), keyed
`params/<module path>/<leaf>` and `batch_stats/<module path>/<leaf>`. The
port names its submodules by the same module paths, so conversion is a
rename plus a transpose of Dense kernels:

  params/.../conv/kernel (in, out)  -> ...conv.weight (out, in)
  params/.../conv/bias              -> ...conv.bias
  params/.../bn/scale, bn/bias      -> ...bn.weight, ...bn.bias
  params/gcn*_*/weight (in, out)    -> gcn*_*.weight (in, out), as it is
  batch_stats/.../bn/mean, bn/var   -> ...bn.running_mean, ...bn.running_var

Loading the reference's torch `.ckpt` files waits for a later slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("params", "weight"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def flax_to_torch(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{'params/a/b/kernel': array, 'batch_stats/a/bn/mean': array, ...}
    -> {'a.b.weight': tensor, 'a.bn.running_mean': tensor, ...}.

    Every BatchNorm also gets `num_batches_tracked` = 0 (Flax keeps no
    count), so the result loads with `load_state_dict(strict=True)`."""
    out = {}
    for key, value in flat.items():
        coll, *path, leaf = key.split("/")
        name = _LEAVES.get((coll, leaf))
        if name is None or not path:
            raise KeyError(f"unrecognised Flax variable {key!r}")
        arr = np.asarray(value, np.float32)
        if leaf == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{key}: expected a 2-D Dense kernel, got {arr.shape}")
            arr = arr.T
        out[".".join(path + [name])] = torch.from_numpy(np.array(arr))
        if coll == "batch_stats" and leaf == "mean":
            out[".".join(path + ["num_batches_tracked"])] = torch.tensor(0)
    return out


def load_npz_subtree(path: str, subtree: str) -> Dict[str, torch.Tensor]:
    """The state_dict of one model subtree of a Flax variables npz, e.g.
    `load_npz_subtree("ckpt_synth/posed_synth.npz", "canonical")`."""
    flat = {}
    with np.load(path) as data:
        for key in data.files:
            coll, _, rest = key.partition("/")
            head, _, tail = rest.partition("/")
            if head == subtree and tail:
                flat[f"{coll}/{tail}"] = data[key]
    if not flat:
        raise KeyError(f"{path}: no variables under {subtree!r}")
    return flax_to_torch(flat)


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of the whole variable tree of a Flax variables npz,
    e.g. the posed model's from `ckpt_synth/posed_synth.npz`. A key without
    a "/" names no variable (`{collection}/{path}`) and is skipped."""
    with np.load(path) as data:
        return flax_to_torch({key: data[key] for key in data.files if "/" in key})
