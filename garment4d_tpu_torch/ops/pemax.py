"""Fused neighbourhood gather + MLP chain + max over samples, and the
posed stage's query-group positional-encoding (PE) blocks.

Counterpart of `garment4d_tpu/ops/pemax.py`. `group_chain_max` is the
eval-mode set-abstraction pattern; `group_pe_max` its 2-layer PE case
(ReLU after the first layer only). A CUDA tensor launches the fused kernel
`ops/csrc/fused_chain.cu`, which keeps the (S, width) neighbourhood
activations in shared memory and writes only the (M, C_L) max; a CPU tensor
(or any tensor inside `plain_ops()`) runs `_chain_reference`, the unfused
formulation. Each entry counts its launches under its own name
(`fused_chain`, `group_pe_max`).

`query_group_pe_multi` is the body-query front end: a coverage mask at the
largest radius, an order-preserving compaction of the covered body points
into a sentinel-padded table, one grouped ball query over it for all radii,
the PE blocks, and the reference's no-hit convention (a center with no hit
gathers full-space row 0). If a frame has more covered points than the
table holds, the query runs over the whole point set instead; that decision
is one host read per call. The control flow is the same on every device:
only the kernels swap for their plain versions.
"""

from __future__ import annotations

from typing import Sequence

import torch

from garment4d_tpu_torch.ops import _build
from garment4d_tpu_torch.ops.pointcloud import (
    _gather_rows_plain,
    _sqdist,
    _f32,
    ball_query_multi,
    covered_mask,
    gather_points,
    use_kernel,
)

_MAX_LAYERS = 4
_ROWS = 8  # rows per kernel thread tile; S must be a multiple


def _chain_reference(table: torch.Tensor, idx: torch.Tensor,
                     centers: torch.Tensor, weights, biases,
                     relus) -> torch.Tensor:
    """Unfused L-layer chain: gather, subtract the center on xyz channels,
    x @ W + b (+ ReLU) per layer, max over S."""
    B, M, S = idx.shape
    C = table.shape[-1]
    h = _gather_rows_plain(table, idx.reshape(B, M * S)).reshape(B, M, S, C)
    ctr = torch.nn.functional.pad(centers, (0, C - 3))
    h = h - ctr[:, :, None, :]
    for w, b, r in zip(weights, biases, relus):
        h = torch.matmul(h, w) + b
        if r:
            h = torch.relu(h)
    return h.max(dim=2).values


def _chain_kernel(table, idx, centers, weights, biases, relus,
                  name: str = "fused_chain"):
    _build.refuse_grad(name, table, centers, *weights, *biases)
    dev = table.device
    _build.require(table, "table", torch.float32, 3, dev)
    _build.require(idx, "idx", torch.int32, 3, dev)
    _build.require(centers, "centers", torch.float32, 3, dev)
    B, N, C = table.shape
    _, M, S = idx.shape
    L = len(weights)
    if idx.shape[0] != B or centers.shape != (B, M, 3) or C < 3:
        raise ValueError(f"fused_chain: table {tuple(table.shape)}, idx "
                         f"{tuple(idx.shape)}, centers {tuple(centers.shape)}")
    if not 1 <= L <= _MAX_LAYERS or len(biases) != L or len(relus) != L:
        raise ValueError(f"fused_chain: {L} layers (1..{_MAX_LAYERS} supported)")
    if S % _ROWS:
        # repeat slot 0 up to a multiple of the row tile: the max over S
        # is unchanged by a repeated row
        pad = _ROWS - S % _ROWS
        idx = torch.cat([idx, idx[..., :1].expand(B, M, pad)], dim=-1).contiguous()
        S += pad
    widths = [C]
    for w, b in zip(weights, biases):
        _build.require(w, "weight", torch.float32, 2, dev)
        _build.require(b, "bias", torch.float32, 1, dev)
        if w.shape[0] != widths[-1] or b.shape[0] != w.shape[1] or w.shape[1] % 4:
            raise ValueError(f"fused_chain: weight {tuple(w.shape)} after width "
                             f"{widths[-1]}, bias {tuple(b.shape)} (widths must "
                             f"be multiples of 4)")
        widths.append(w.shape[1])
    # activation buffers: 0 holds the inputs of even layers, 1 of odd layers,
    # rows padded to a multiple of 4 floats for float4 loads
    width_a = max(_build.pitch(widths[l]) for l in range(0, L, 2))
    width_b = max([_build.pitch(widths[l]) for l in range(1, L, 2)], default=0)

    def smem_bytes(G):
        rows = G * S
        return (rows * (width_a + width_b) + rows // _ROWS * widths[-1]) * 4

    # centers per block: up to 256 rows while two blocks still fit an SM
    G = 1
    while 2 * G * S <= 256 and smem_bytes(2 * G) <= _build.SMEM_TWO_BLOCKS:
        G *= 2
    smem = smem_bytes(G)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"fused_chain: {smem} B of shared memory needed "
                         f"(S={S}, widths {widths}) exceeds {_build.SMEM_LIMIT}")
    w_all = torch.cat([w.reshape(-1) for w in weights])
    b_all = torch.cat(list(biases))
    fs = widths[1:] + [0] * (_MAX_LAYERS - L)
    relu_mask = sum(1 << l for l, r in enumerate(relus) if r)
    out = torch.empty((B, M, widths[-1]), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.launch_counts[name] += 1
    _build.check(lib.g4d_fused_chain(
        table.data_ptr(), idx.data_ptr(), centers.data_ptr(),
        w_all.data_ptr(), b_all.data_ptr(), B, N, C, M, S, L, *fs, relu_mask,
        G, width_a, width_b, smem, out.data_ptr(), _build.stream_of(table)),
        name)
    return out


def _chain(table, idx, centers, weights, biases, relus, name):
    if use_kernel(table):
        return _chain_kernel(
            table.contiguous(), idx.to(torch.int32).contiguous(),
            centers.contiguous(), [w.contiguous() for w in weights],
            [b.contiguous() for b in biases], relus, name)
    return _chain_reference(table, idx, centers, weights, biases, relus)


def group_chain_max(table: torch.Tensor, idx: torch.Tensor,
                    centers: torch.Tensor, weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor],
                    relus: Sequence[bool]) -> torch.Tensor:
    """max_s chain(table[idx_s] - pad(centers)) -> (B, M, C_L).

    table (B, N, C) with xyz on channels 0..2; idx (B, M, S) int; centers
    (B, M, 3); weights: (C_{i-1}, C_i) matrices; biases: (C_i,); relus: bool
    per layer. The kernel path is forward-only: it raises when an input or
    weight requires grad under autograd."""
    return _chain(table, idx, centers, weights, biases,
                  tuple(bool(r) for r in relus), "fused_chain")


# ---------------------------------------------------------------------------
# posed-stage PE blocks
# ---------------------------------------------------------------------------

_PE_RELUS = (True, False)


def candidate_cap(n: int) -> int:
    """Rows of the compacted table for an n-point set: 72% of n, at least
    256, rounded up to 128. A frame with more covered points takes the
    full-set branch of `query_group_pe_multi`."""
    return ((max(int(n * 0.72), 256) + 127) // 128) * 128


def group_pe_max(table: torch.Tensor, idx: torch.Tensor, centers: torch.Tensor,
                 k0: torch.Tensor, b0: torch.Tensor, k1: torch.Tensor,
                 b1: torch.Tensor) -> torch.Tensor:
    """max_s (relu((table[idx_s] - pad(centers)) @ k0 + b0) @ k1 + b1):
    table (B, N, C) with xyz on channels 0..2, idx (B, M, S), centers
    (B, M, 3), k0 (C, F), k1 (F, G) -> (B, M, G). The chain kernel with two
    layers; forward-only on the card."""
    return _chain(table, idx, centers, (k0, k1), (b0, b1), _PE_RELUS, "group_pe_max")


def group_pe_max_split_frozen(xyz: torch.Tensor, features: torch.Tensor,
                              idx: torch.Tensor, centers: torch.Tensor,
                              k0: torch.Tensor, b0: torch.Tensor,
                              k1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """`group_pe_max` over concat(xyz, features) with the first layer split
    around the gather: the features are projected to F once per point
    (`features @ k0[3:]`, a plain matmul), so the gathered table is 3 + F
    wide, and the first layer becomes concat(k0[:3], I_F). k0 is the full
    (3 + C, F) weight."""
    proj = torch.matmul(features, k0[3:])
    packed = torch.cat([xyz, proj], dim=-1)
    kfull = torch.cat([k0[:3], torch.eye(k0.shape[1], dtype=k0.dtype,
                                         device=k0.device)], dim=0)
    return group_pe_max(packed, idx, centers, kfull, b0, k1, b1)


def _compact_candidates(xyz: torch.Tensor, centers: torch.Tensor,
                        cover_r: float, cap: int):
    """Coverage mask at `cover_r`, then the covered point indices in
    ascending order (keys where(cover, iota, 1 << 30), sorted), cut to
    `cap`. -> (counts (B,) int32, overflow: bool read on the host,
    compact_idx (B, cap) int32; entries past counts[b] are >= N)."""
    B, N, _ = xyz.shape
    cover = covered_mask(xyz, centers, cover_r)
    counts = cover.sum(dim=1, dtype=torch.int32)
    overflow = bool((counts > cap).any())  # the one host read of the call
    iota = torch.arange(N, dtype=torch.int32, device=xyz.device)
    keys = torch.where(cover > 0, iota[None, :],
                       torch.full_like(cover, 1 << 30))
    compact_idx = torch.sort(keys, dim=1).values[:, :cap]
    return counts, overflow, compact_idx


def _gather_candidates(xyz: torch.Tensor, packed: torch.Tensor,
                       compact_idx: torch.Tensor):
    """The compacted table: xyz rows (1e9 sentinels past the valid count)
    and packed feature rows (row 0 there)."""
    N = xyz.shape[1]
    valid = compact_idx < N
    safe_idx = torch.where(valid, compact_idx, torch.zeros_like(compact_idx))
    cxyz = gather_points(xyz, safe_idx)
    cxyz = torch.where(valid[..., None], cxyz, torch.full_like(cxyz, 1e9))
    return cxyz, gather_points(packed, safe_idx)


def _pe_all(table, idxs, centers, pe_params):
    return [group_pe_max(table, idx, centers, *params)
            for idx, params in zip(idxs, pe_params)]


def _no_hit_fix(outs, idxs, radii, row0, centers, cdist0, pe_params):
    """Centers whose compacted query found no hit gather full-space row 0
    (the reference's zero-filled slots): recompute their PE from `row0`
    (B, C). `cdist0` (B, M) is the squared distance to compacted row 0."""
    C = row0.shape[-1]
    qg0 = row0[:, None, :] - torch.nn.functional.pad(centers, (0, C - 3))
    fixed = []
    for out, idx, r, (k0, b0, k1, b1) in zip(outs, idxs, radii, pe_params):
        no_hit = (idx[:, :, 0] == 0) & ~(cdist0 < _f32(float(r) ** 2))
        h0 = torch.relu(torch.matmul(qg0, k0) + b0)
        h0 = torch.matmul(h0, k1) + b1
        fixed.append(torch.where(no_hit[..., None], h0, out))
    return tuple(fixed)


def query_group_pe_multi(radii: Sequence[float], nsamples: Sequence[int],
                         xyz: torch.Tensor, new_xyz: torch.Tensor,
                         features: torch.Tensor, pe_params: Sequence) -> tuple:
    """Multi-radius ball query + PE blocks over concat(xyz, features):
    a tuple of (B, M, G_i), exactly max_s PE_i over the neighbourhoods of
    `ball_query_multi(radii, nsamples, xyz, new_xyz)[i]`, including the
    no-hit row-0 convention. pe_params[i] = (k0, b0, k1, b1), k0 (3 + C, F).

    For N >= 1024 with cap < N the query runs over the candidates within
    max(radii) of any center, compacted in index order (so the first-S
    semantics hold) into a `candidate_cap(N)`-row table, unless a frame
    has more than that; the results are the same either way."""
    B, N, _ = xyz.shape
    S = tuple(int(s) for s in nsamples)
    packed = torch.cat([xyz, features], dim=-1)
    cap = candidate_cap(N)
    if cap >= N or N < 1024:
        return tuple(_pe_all(packed, ball_query_multi(radii, S, xyz, new_xyz),
                             new_xyz, pe_params))
    counts, overflow, compact_idx = _compact_candidates(
        xyz, new_xyz, float(max(radii)), cap)
    if overflow:
        full = torch.full((B,), N, dtype=torch.int32, device=xyz.device)
        idxs = ball_query_multi(radii, S, xyz, new_xyz, n_valid=full)
        return tuple(_pe_all(packed, idxs, new_xyz, pe_params))
    cxyz, cpacked = _gather_candidates(xyz, packed, compact_idx)
    idxs = ball_query_multi(radii, S, cxyz, new_xyz, n_valid=counts)
    outs = _pe_all(cpacked, idxs, new_xyz, pe_params)
    d0 = _sqdist(new_xyz, cxyz[:, 0:1, :])
    return _no_hit_fix(outs, idxs, radii, packed[:, 0, :], new_xyz, d0, pe_params)
