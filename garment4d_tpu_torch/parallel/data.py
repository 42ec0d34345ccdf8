"""Data parallelism over a `torch.distributed` process group.

Counterpart of `garment4d_tpu/parallel/mesh.py`. The JAX package shards
the batch over a device mesh and lets `jit` make the step over N devices
at global batch B the single-device step at batch B. Here every process
holds the model and its contiguous block of the global batch's rows, and
the same semantics come from explicit collectives:

  * BatchNorm statistics over the global batch (`nn/layers.py:BatchNorm`,
    one differentiable all-reduce of [sum x, sum x^2] a BatchNorm), which
    subsumes the reference's SyncBatchNorm as the mesh does;
  * dropout masks drawn for the global batch (`nn/layers.py:Dropout`);
  * gradients and loss scalars averaged over the ranks (`train/step.py`);
  * eval means reduced as weighted global sums (`train/loop.py`).

Each of them is on exactly when the process is a rank of a group
(`launch.in_group`); outside one every path is the single-process one.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from garment4d_tpu_torch.parallel.launch import rank, world_size


def check_batch_divisible(batch_size: int, process_count: Optional[int] = None) -> None:
    """AssertionError unless the global batch divides by the process count
    (the JAX package's check against the mesh axis)."""
    n = world_size() if process_count is None else process_count
    if batch_size % n != 0:
        raise AssertionError(
            f"global batch {batch_size} not divisible by the process count {n}"
            " (parity with reference utils/train_utils.py:70-73)")


def local_batch_indices(global_indices, process_index: Optional[int] = None,
                        process_count: Optional[int] = None):
    """The rows of a global batch that this process owns: the contiguous
    block `process_index` of `process_count` equal blocks."""
    p = rank() if process_index is None else process_index
    n = world_size() if process_count is None else process_count
    local = len(global_indices) // n
    return global_indices[p * local:(p + 1) * local]


def shard_batch(batch: Dict[str, torch.Tensor], process_index: Optional[int] = None,
                process_count: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """This process's rows (`local_batch_indices`) of every entry of a
    global batch dict, each sliced along its leading (sequence) axis."""
    return {k: local_batch_indices(v, process_index, process_count) for k, v in batch.items()}


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's input is the sum of
    every rank's output gradient."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks of the default group."""
    return _AllReduceSum.apply(x)


def global_moments(x: torch.Tensor):
    """(E[x], E[x^2]) per channel of x (rows, C) over every rank's rows, from
    one differentiable all-reduce of [sum x, sum x^2]. Every rank holds as
    many rows (the global batch divides by the world size)."""
    C = x.shape[1]
    sums = all_reduce_sum(torch.cat([x.sum(dim=0), (x * x).sum(dim=0)]))
    total = x.shape[0] * world_size()
    return sums[:C] / total, sums[C:] / total


def global_rows(shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
    """Uniform draws for this rank's block of a global tensor whose leading
    axis is `shape[0]` times the world size: the single-process draw of the
    global tensor, then this rank's rows, so the generator advances as it
    does there."""
    n = shape[0]
    u = torch.rand((n * world_size(), *shape[1:]), generator=generator, dtype=dtype,
                   device=device)
    return u[rank() * n:(rank() + 1) * n]


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each parameter's `.grad` by its mean over the ranks, in one
    all-reduce of the gradients laid end to end. Parameters without a
    gradient (none on any rank: the graph is the same everywhere) keep
    none, so Adam leaves them as it does in one process."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world_size()
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def mean_over_ranks(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A loss dict of this rank's share as the global batch's, in one
    all-reduce: each 0-d entry (a mean over equal-sized shares) becomes its
    mean over the ranks; each other entry (per-sample values, leading axis
    this rank's sequences) the global batch's rows in rank order."""
    W, r = world_size(), rank()
    keys = list(values)
    parts = []
    for k in keys:
        v = values[k].detach()
        if v.ndim:
            rows = v.new_zeros((v.shape[0] * W, *v.shape[1:]))
            rows[r * v.shape[0]:(r + 1) * v.shape[0]] = v
            v = rows
        parts.append(v.reshape(-1))
    flat = torch.cat(parts)
    dist.all_reduce(flat)
    out, offset = {}, 0
    for k, part in zip(keys, parts):
        v = values[k]
        got = flat[offset:offset + part.numel()]
        offset += part.numel()
        out[k] = (got.view(()) / W if v.ndim == 0
                  else got.view(v.shape[0] * W, *v.shape[1:])).to(v.dtype)
    return out


def reduce_metric_sums(sums: Dict[str, float], count: float, device) -> tuple:
    """(global sums, global count) of a rank's `MetricAccumulator` sums and
    weight, in one float64 all-reduce on `device`. The key sets must be the
    same on every rank."""
    keys = sorted(sums)
    flat = torch.tensor([sums[k] for k in keys] + [count], dtype=torch.float64,
                        device=device)
    dist.all_reduce(flat)
    host = flat.tolist()
    return dict(zip(keys, host[:-1])), host[-1]


def shared_seed() -> int:
    """A seed from fresh entropy on rank 0, broadcast, so that every rank
    draws what rank 0 draws (the CLOTH3D train windows, which the dataset
    draws unseeded)."""
    seed = [int(np.random.SeedSequence().generate_state(1)[0])]
    dist.broadcast_object_list(seed, src=0)
    return seed[0]


def broadcast_module(model: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `model` set to rank `src`'s, as DDP
    does when it wraps a model."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src)
