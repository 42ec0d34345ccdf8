"""PointNet++ set-abstraction and feature-propagation modules, channel-last.

Counterpart of `garment4d_tpu/nn/pointnet.py`: FPS -> gather -> ball-query
group -> SharedMLP -> max over samples per scale; three-NN inverse-distance
interpolation for upsampling. Neighbourhoods are (B, M, S, C).

In eval mode on CUDA tensors each SA stage runs fused, as the JAX package
does on the TPU: one multi-radius ball query for all scales, then per scale
one `group_chain_max` kernel with BatchNorm folded into the weights, so the
(B, M, S, C) neighbourhoods never reach device memory. Elsewhere (training,
CPU tensors, inside `ops.plain_ops()`, or with a computation `dtype`, as
the JAX package's `dtype is None` condition) it runs the unfused op-for-op
path.

With a computation `dtype` (bf16 under `--bf16`) the SharedMLPs compute in
it, and so does every feature they output; xyz stays fp32. Tables that mix
the two are promoted to fp32, as `jnp.concatenate` promotes them, so the
gathers take fp32 tables.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from garment4d_tpu_torch import ops
from garment4d_tpu_torch.nn.layers import SharedMLP


def max_over(x: torch.Tensor, dim: int, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The max over `dim`. With a computation `dtype` its backward splits
    the cotangent evenly among tied entries (`amax`), as `jnp.max`'s does:
    in bf16 distinct samples often tie. In fp32 the ties are copies of one
    row (the ball query's padding), for which routing the cotangent to one
    of them (`max`) gives the same gradients in exact arithmetic."""
    return x.max(dim=dim).values if dtype is None else x.amax(dim=dim)


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction with relative xyz prepended to
    the features (`use_xyz`); npoint=None groups all points as one
    neighbourhood. `in_channels` is the feature width (0 for xyz only); the
    MLPs see 3 + in_channels and compute in `dtype`."""

    def __init__(self, npoint: Optional[int], radii: Sequence[Optional[float]],
                 nsamples: Sequence[Optional[int]],
                 mlps: Sequence[Sequence[int]], in_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.compute_dtype = dtype
        for i, widths in enumerate(mlps):
            self.add_module(f"mlp{i}", SharedMLP(in_channels + 3, widths, dtype))
        self.n_scales = len(mlps)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor]):
        """xyz (B, N, 3), features (B, N, C) or None -> (new_xyz
        (B, npoint, 3) or None, new_features (B, npoint, sum C_out))."""
        new_xyz = None
        if self.npoint is not None:
            idx = ops.furthest_point_sample(xyz, self.npoint)
            new_xyz = ops.gather_points(xyz, idx)
        mlps = [getattr(self, f"mlp{i}") for i in range(self.n_scales)]

        fused = (not self.training and self.npoint is not None
                 and self.compute_dtype is None and ops.use_kernel(xyz))
        if fused:
            idxs = ops.ball_query_multi(self.radii, self.nsamples, xyz,
                                        new_xyz)
            table = (torch.cat([xyz, features], dim=-1)
                     if features is not None else xyz)
            outs = []
            for mlp, idx in zip(mlps, idxs):
                ws, bs = mlp.folded()
                outs.append(ops.group_chain_max(table, idx, new_xyz, ws, bs,
                                                (True,) * len(ws)))
            return new_xyz, torch.cat(outs, dim=-1)

        outs = []
        for i, mlp in enumerate(mlps):
            if self.npoint is not None:
                grouped = ops.query_and_group(
                    self.radii[i], self.nsamples[i], xyz, new_xyz,
                    features)  # (B, M, S, 3+C)
            else:
                grouped = ops.group_all(xyz, features)
            outs.append(max_over(mlp(grouped), 2, self.compute_dtype))
        return new_xyz, torch.cat(outs, dim=-1)


class FPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance interpolation + SharedMLP
    (the MLP sees known_channels + unknown_channels and computes in
    `dtype`)."""

    def __init__(self, mlp: Sequence[int], in_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp, dtype)

    def forward(self, unknown: torch.Tensor, known: torch.Tensor,
                unknown_feats: Optional[torch.Tensor],
                known_feats: torch.Tensor) -> torch.Tensor:
        """unknown (B, N, 3), known (B, M, 3), unknown_feats (B, N, C1) or
        None, known_feats (B, M, C2) -> (B, N, mlp[-1])."""
        dist, idx = ops.three_nn(unknown, known)
        weight = ops.interp_weights_from_dists(dist)
        interpolated = ops.three_interpolate(known_feats, idx, weight)
        if unknown_feats is not None:
            interpolated = torch.cat([interpolated, unknown_feats], dim=-1)
        return self.mlp(interpolated)
