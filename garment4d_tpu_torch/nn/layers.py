"""Dense building blocks over the trailing channel axis.

Counterpart of `garment4d_tpu/nn/layers.py`: a 1x1 convolution is a Linear
over the last axis, followed by BatchNorm (eps 1e-5, momentum 0.1 in
torch's convention, 0.9 in Flax's) and an optional ReLU. Train-mode
BatchNorm computes its statistics and updates its running ones as Flax
does; eval uses the running statistics. Submodule names follow the Flax
parameter paths (`layer0.conv`, `layer0.bn`, `linear0`), so a Flax
checkpoint maps onto them by renaming (`train/convert.py`). `MLP` is a
plain Linear/ReLU stack and `GraphConvolution` one pygcn layer, dense or
banded.

`BatchNorm`, `ConvBNRelu` and `SharedMLP` take a computation `dtype`
(`torch.bfloat16` under `--bf16`; None is fp32), as Flax's `Dense` and
`BatchNorm` take theirs: the parameters stay fp32 `nn.Parameter`s, so
state_dicts and checkpoints are the same either way.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from garment4d_tpu_torch.ops.graph import graph_matmul, graph_matmul_banded
from garment4d_tpu_torch.parallel.data import global_moments, global_rows
from garment4d_tpu_torch.parallel.launch import in_group


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over (rows, C) with Flax's train mode (flax.linen
    `BatchNorm` with `use_fast_variance`): mean = E[x], var = max(0,
    E[x^2] - E[x]^2), the biased variance, y = (x - mean) * (rsqrt(var +
    eps) * weight) + bias, and running statistics r = 0.9 r + 0.1 stat with
    that biased variance (torch's own BatchNorm updates with the unbiased
    one and refuses a batch of one row; Flax takes it). Eval mode is
    torch's, on the running statistics. The parameters and buffers are
    torch's, so state_dicts keep their names.

    With a computation `dtype` (Flax's `BatchNorm(dtype=...)` with its
    float32 reductions): the statistics are taken over the fp32 rows, the
    running statistics update in fp32, and y is computed in fp32 by the
    formula above, in eval mode too (on the running statistics), then cast
    to `dtype`. In training the rows are cast to fp32 twice, for the
    statistics and for the normalisation, as Flax's `_compute_stats` casts
    and its `x - mean` promotes: the backward rounds each path's
    cotangent to `dtype` and adds them there, as JAX's does.

    In a process group (`parallel.in_group`) the train-mode moments are
    the global batch's, from one differentiable all-reduce
    (`parallel.global_moments`), as the JAX package's BatchNorm takes them
    over a sharded batch: every rank then normalises alike and updates its
    running statistics alike."""

    def __init__(self, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__(features, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        if dtype is None and not self.training:
            return super().forward(x)
        if self.training:
            mean, var = self._batch_moments(x if dtype is None else x.float())
        else:
            mean, var = self.running_mean, self.running_var
        if dtype is not None:
            x = x.float()
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y if dtype is None else y.to(dtype)

    def _batch_moments(self, x: torch.Tensor):
        """The batch's mean and biased variance; the running statistics
        updated with them."""
        if in_group():
            mean, mean_sq = global_moments(x)
        else:
            mean, mean_sq = x.mean(dim=0), (x * x).mean(dim=0)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var + self.momentum * var)
            self.num_batches_tracked += 1
        return mean, var


class Dropout(nn.Module):
    """Flax's `nn.Dropout` with its random bits from an explicit
    `torch.Generator` (no global RNG): in training each element is kept
    where a uniform draw (fp32, or the input's dtype where wider) falls
    below 1 - p and scaled by 1 / (1 - p) in the input's dtype, else
    zeroed; in eval, and at p = 0, the identity. In a process group the
    draws are the global batch's (`parallel.global_rows`), of which this
    rank keeps its rows: the masks are the single-process ones."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in training draws from an explicit torch.Generator; "
                             "none was given")
        keep_prob = 1.0 - self.p
        dtype = torch.promote_types(x.dtype, torch.float32)
        if in_group():
            u = global_rows(x.shape, generator, dtype, x.device)
        else:
            u = torch.rand(x.shape, generator=generator, dtype=dtype, device=x.device)
        keep = u < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class ConvBNRelu(nn.Module):
    """Linear + optional BatchNorm + optional ReLU over the last axis; the
    Linear has a bias only when BN is off unless `bias` says otherwise.
    With a computation `dtype` (Flax's `Dense(dtype=...)`) the input, the
    weight and the bias are cast to it, the product comes out in it and the
    bias is added in it; the BatchNorm computes as `BatchNorm` says."""

    def __init__(self, in_features: int, features: int, bn: bool = True,
                 relu: bool = True, bias: Optional[bool] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        use_bias = bias if bias is not None else not bn
        self.conv = nn.Linear(in_features, features, bias=use_bias)
        nn.init.kaiming_normal_(self.conv.weight)
        self.bn = BatchNorm(features, dtype) if bn else None
        self.relu = relu
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        if dtype is None:
            x = self.conv(x)
        else:
            x = nn.functional.linear(x.to(dtype), self.conv.weight.to(dtype))
            if self.conv.bias is not None:
                x = x + self.conv.bias.to(dtype)
        if self.bn is not None:
            lead = x.shape[:-1]
            x = self.bn(x.reshape(-1, x.shape[-1])).reshape(*lead, -1)
        return torch.relu(x) if self.relu else x

    def folded(self):
        """Eval-mode (W' (in, out), b' (out,)) with BN folded into the
        Linear: the block before its ReLU is x @ W' + b' under running
        statistics. Differentiable in the parameters, so a forward-only
        kernel that takes them sees when autograd records."""
        w = self.conv.weight.t()
        b = (self.conv.bias if self.conv.bias is not None
             else torch.zeros_like(w[0]))
        if self.bn is None:
            return w.contiguous(), b.clone()
        scale = self.bn.weight / torch.sqrt(self.bn.running_var + self.bn.eps)
        return ((w * scale).contiguous(),
                (b - self.bn.running_mean) * scale + self.bn.bias)


class SharedMLP(nn.Module):
    """A stack of BatchNorm'd, ReLU'd ConvBNRelu blocks named layer0,
    layer1, ..., each computing in `dtype`."""

    def __init__(self, in_features: int, widths: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.widths = tuple(int(w) for w in widths)
        c = in_features
        for i, w in enumerate(self.widths):
            self.add_module(f"layer{i}", ConvBNRelu(c, w, dtype=dtype))
            c = w

    def blocks(self):
        return [getattr(self, f"layer{i}") for i in range(len(self.widths))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks():
            x = block(x)
        return x

    def folded(self):
        """Per-layer eval-mode (W', b') lists with BN folded; every layer of
        the stack is ReLU'd."""
        pairs = [block.folded() for block in self.blocks()]
        return [w for w, _ in pairs], [b for _, b in pairs]


class MLP(nn.Module):
    """Linear layers `linear0`, `linear1`, ... of the given widths over the
    last axis, a ReLU between consecutive ones (none after the last)."""

    def __init__(self, in_features: int, widths: Sequence[int]):
        super().__init__()
        self.widths = tuple(int(w) for w in widths)
        c = in_features
        for i, w in enumerate(self.widths):
            self.add_module(f"linear{i}", nn.Linear(c, w))
            c = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.widths) - 1
        for i in range(len(self.widths)):
            x = getattr(self, f"linear{i}")(x)
            if i != last:
                x = torch.relu(x)
        return x


class GraphConvolution(nn.Module):
    """One pygcn layer, adj @ (x @ W) + b: weight (in, out), bias (out,),
    both U(-1/sqrt(out), 1/sqrt(out)) at init. With `diag_offsets` (the
    adjacency's nonzero cyclic diagonals, `ops.cyclic_diagonals`) the
    product with the adjacency is `ops.graph_matmul_banded`, the banded
    kernel on the card; else the dense `ops.graph_matmul`."""

    def __init__(self, in_features: int, features: int, diag_offsets=None):
        super().__init__()
        stdv = 1.0 / features ** 0.5
        self.weight = nn.Parameter(torch.empty(in_features, features).uniform_(-stdv, stdv))
        self.bias = nn.Parameter(torch.empty(features).uniform_(-stdv, stdv))
        self.diag_offsets = None if diag_offsets is None else tuple(int(o) for o in diag_offsets)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        support = torch.matmul(x, self.weight)
        if self.diag_offsets is not None:
            out = graph_matmul_banded(adj, support, self.diag_offsets)
        else:
            out = graph_matmul(adj, support)
        return out + self.bias
