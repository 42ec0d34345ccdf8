"""Fused neighbourhood gather + MLP chain + max over samples, and the
posed stage's query-group positional-encoding (PE) blocks.

Counterpart of `garment4d_tpu/ops/pemax.py`. `group_chain_max` is the
eval-mode set-abstraction pattern; `group_pe_max` its 2-layer PE case
(ReLU after the first layer only). A CUDA tensor launches the fused kernel
`ops/csrc/fused_chain.cu`, which keeps the (S, width) neighbourhood
activations in shared memory and writes only the (M, C_L) max; a CPU tensor
(or any tensor inside `plain_ops()`) runs `_chain_reference`, the unfused
formulation. Each entry counts its launches under its own name
(`fused_chain`, `group_pe_max`, and `group_pe_max_nv` for the PE block over
a sentinel-padded table with its valid-row count, `n_valid`).

Both are differentiable on every device through autograd Functions that
save only their inputs, so no (B, M, S, C) activation outlives the forward.
`group_chain_max` recomputes `_chain_reference` in its backward, as JAX's
`_chain_bwd` does; on the card that recompute runs the gather kernel, and
the table's gradient the scatter-add kernel. The PE block's backward is the
fused PE-backward kernel `ops/csrc/pe_bwd.cu` (counter `pe_bwd`), which
recomputes the block, routes the cotangent through the max (split evenly
among exact ties, as JAX's `jnp.max` does) and returns the gradients of
the centers and the four weights; for a table that requires grad
(`table_grad=True`) it also writes the row gradient of each slot that won
a channel, which the scatter-add kernel sums into the table's gradient (JAX's
`fused_pe_bwd_pallas` with `table_grad=True`). `_pe_bwd_plain` is its
plain version.

`query_group_pe_multi` is the body-query front end: a coverage mask at the
largest radius, an order-preserving compaction of the covered body points
into a sentinel-padded table, one grouped ball query over it for all radii,
the PE blocks, and the reference's no-hit convention (a center with no hit
gathers full-space row 0). If a frame has more covered points than the
table holds, the query runs over the whole point set instead; that decision
is one host read per call. Its opt-in levers: `spatial` compacts in
Morton order (`ops/morton.py`), and `reuse_margin` widens the coverage by
a margin and returns the compacted table, for later calls to reuse while
their centers stay within the margin (a second host read a call). The
control flow is the same on every device: only the kernels swap for their
plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Sequence

import torch

from garment4d_tpu_torch.ops import _build, morton
from garment4d_tpu_torch.ops.pointcloud import (
    _gather_rows_plain,
    _scatter_add_rows_kernel,
    _scatter_add_rows_plain,
    _sqdist,
    _f32,
    ball_query_multi,
    covered_mask,
    dispatch_as,
    gather_points,
    use_kernel,
)

_MAX_LAYERS = 4
_ROWS = 8  # rows per kernel thread tile; S must be a multiple


def _chain_reference(table: torch.Tensor, idx: torch.Tensor,
                     centers: torch.Tensor, weights, biases,
                     relus) -> torch.Tensor:
    """Unfused L-layer chain: gather, subtract the center on xyz channels,
    x @ W + b (+ ReLU) per layer, max over S. The gather is
    `gather_points`, differentiable in the table on every device."""
    B, M, S = idx.shape
    C = table.shape[-1]
    h = gather_points(table, idx.reshape(B, M * S)).reshape(B, M, S, C)
    ctr = torch.nn.functional.pad(centers, (0, C - 3))
    h = h - ctr[:, :, None, :]
    for w, b, r in zip(weights, biases, relus):
        h = torch.matmul(h, w) + b
        if r:
            h = torch.relu(h)
    # amax, not max(dim): its gradient splits evenly among exact ties, as
    # JAX's jnp.max and the PE-backward kernel do
    return torch.amax(h, dim=2)


def _pad_slots(idx: torch.Tensor) -> torch.Tensor:
    """idx (B, M, S) with slot 0 repeated up to a multiple of the kernels'
    8-row tile."""
    B, M, S = idx.shape
    if S % _ROWS == 0:
        return idx
    pad = _ROWS - S % _ROWS
    return torch.cat([idx, idx[..., :1].expand(B, M, pad)], dim=-1).contiguous()


def _past_valid(idx: torch.Tensor, n_valid: torch.Tensor) -> bool:
    """Whether an index of frame b reaches max(n_valid[b], 1): past the
    rows a valid-count chain may gather."""
    bound = torch.clamp(n_valid.to(idx.device, torch.int64), min=1)
    return bool((idx.reshape(idx.shape[0], -1) >= bound[:, None]).any())


def _refuse_past_valid(name: str) -> None:
    raise ValueError(f"{name}: an index reaches past max(n_valid[b], 1), the "
                     f"frame's valid rows")


_CHAIN_THREADS = 256   # threads per block of fused_chain.cu
_CHAIN_MAX_ROWS = 512  # sample rows per group
_CHAIN_KCS = (32, 16)  # weight rows per streamed chunk, the first that fits
# where fused_chain.cu's layers read their weights (its kResident, kStreamed,
# kThroughL1), and the plan's weight on each
RESIDENT, STREAMED, THROUGH_L1 = 0, 1, 2
_CHAIN_WMODE_SCORE = {RESIDENT: 1.0, STREAMED: 0.9, THROUGH_L1: 0.85}
# the plan's weight on fetching the next group's rows after the last layer,
# and on one block per SM (against two)
_CHAIN_LATE_SCORE = 0.9
_CHAIN_ONE_BLOCK_SCORE = 0.8


def _chain_tc(R: int, F: int) -> int:
    """Columns of a thread's tile in an F-wide layer over R rows: 8 where
    8-wide tiles still give every thread an item, else 4."""
    return 8 if F % 8 == 0 and (R // _ROWS) * (F // 8) >= _CHAIN_THREADS else 4


def _chain_layout(C: int, S: int, widths, G: int, wmode: int, kc: int = 0,
                  late: bool = False) -> dict:
    """fused_chain.cu's shared memory for groups of G centers (R = G * S
    rows): offsets in floats of the gathered rows X (quad-major: a plane
    of R + R / 8 float4s per 4 channels), the
    two hidden-activation buffers (even and odd hidden layers), the
    weights (all of them when resident, three chunks of kc rows of the
    widest layer when streamed, none through L1), the last layer's per-tile maxima (only where the
    max over S cannot finish in warp shuffles), then two groups' indices
    (R ints each) and centers (G x 3 each). With `late` (three layers or
    more) the odd hidden buffer shares X's memory and the next group's rows
    are fetched after the last layer. Every region is a whole number of
    float4s."""
    L = len(widths)
    R = G * S
    Rp = R + 4  # float4 rows; 4 mod 32 spreads the gather's lanes over banks
    tcs = [_chain_tc(R, f) for f in widths]
    # warps of 4 x 8 tiles where a layer has 16 column tiles or more
    wts = [int(f // tc >= 16 and f // tc % 8 == 0 and R // _ROWS % 4 == 0)
           for f, tc in zip(widths, tcs)]
    # the last layer's max over S ends in shuffles where a center's T row
    # tiles lie in one warp, `ls` lanes apart
    T, nct = S // _ROWS, widths[-1] // tcs[-1]
    ls = 8 if wts[-1] else nct
    direct = T & (T - 1) == 0 and 32 % ls == 0 and T * ls <= 32
    x = _build.pitch(C) * (R + R // _ROWS)
    h0 = max([widths[l] for l in range(0, L - 1, 2)], default=0) * Rp
    h1 = max([widths[l] for l in range(1, L - 1, 2)], default=0) * Rp
    if late:  # X's memory holds the odd hidden layers too
        x, h1 = max(x, h1), 0
    stream = wmode == STREAMED
    wbuf = kc * max(widths) if stream else 0
    w = (3 * wbuf if stream else 0 if wmode == THROUGH_L1
         else sum(k * f for k, f in zip([C, *widths[:-1]], widths)))
    part = 0 if direct else R // _ROWS * widths[-1]
    w_off = x + h0 + h1
    ib_off = w_off + w + part
    cb_off = ib_off + 2 * R
    return dict(G=G, R=R, Rp=Rp, tcs=tcs, wts=wts, direct=direct, late=late, x_off=0,
                h_off=(x, 0 if late else x + h0),
                w_off=w_off, part_off=w_off + w, ib_off=ib_off, cb_off=cb_off,
                wmode=wmode, kc=kc if stream else 0, wbuf=wbuf,
                smem=(cb_off + _build.pitch(6 * G)) * 4,
                items=[R // _ROWS * f // tc for f, tc in zip(widths, tcs)])


@functools.lru_cache(maxsize=256)
def _chain_plan_cached(C: int, S: int, widths: tuple, M: int, knobs: tuple) -> dict:
    return _chain_plan_uncached(C, S, widths, M)


def _chain_plan(C: int, S: int, widths, M: int) -> dict:
    """`_chain_plan_uncached`, cached on its arguments and the module's
    planning knobs (the host's share of a launch: a launch of a small chain
    takes ~0.1 ms on the card); a copy, free to change."""
    knobs = (tuple(sorted(_CHAIN_WMODE_SCORE.items())), _CHAIN_LATE_SCORE,
             _CHAIN_ONE_BLOCK_SCORE, _CHAIN_KCS, _CHAIN_MAX_ROWS)
    return dict(_chain_plan_cached(C, S, tuple(widths), M, knobs))


def _chain_plan_uncached(C: int, S: int, widths, M: int) -> dict:
    """The launch plan of fused_chain.cu for C-wide tables, S slots (a
    multiple of 8) and layer widths `widths`, over M centers per frame.

    Candidates: groups of G centers (a power of two, R = G * S <= 512 rows,
    G no larger than M needs); weights resident or read through L1 (two
    blocks per SM where the shared memory allows, else one) or streamed (one
    block per SM, at most one item per thread). Each is scored by the share
    of the FMAs whose layer gives every thread an item, times
    _CHAIN_ONE_BLOCK_SCORE for one block per SM, the weight mode's
    _CHAIN_WMODE_SCORE (streamed and L1-read weights come from L2 again for
    every group) and _CHAIN_LATE_SCORE where X's memory is shared with a
    hidden layer; the best wins, ties going to the larger group. The knobs
    are set from timings on the H100 (`PERF.md` §6). Raises ValueError
    where nothing fits."""
    if C < 3 or S % _ROWS or not 1 <= len(widths) <= _MAX_LAYERS or any(
            f < 4 or f % 4 for f in widths):
        raise ValueError(f"fused_chain: C={C}, S={S}, widths {list(widths)} (C >= 3, "
                         f"S a multiple of {_ROWS}, 1..{_MAX_LAYERS} widths, multiples of 4)")
    work = [k * f for k, f in zip([C, *widths[:-1]], widths)]
    g_max = 1 << max(0, int(M) - 1).bit_length()
    best = None
    G = 1
    while G * S <= _CHAIN_MAX_ROWS and G <= g_max:
        for (wmode, mode_score), late in itertools.product(
                _CHAIN_WMODE_SCORE.items(), (False, True) if len(widths) >= 3 else (False,)):
            for kc in _CHAIN_KCS if wmode == STREAMED else (0,):
                lay = _chain_layout(C, S, widths, G, wmode, kc, late)
                if lay["smem"] <= _build.SMEM_LIMIT:
                    break
            if wmode == STREAMED and max(lay["items"]) > _CHAIN_THREADS:
                continue
            if wmode != STREAMED and lay["smem"] <= _build.SMEM_TWO_BLOCKS:
                per_sm = 2
            elif lay["smem"] <= _build.SMEM_LIMIT:
                per_sm = 1
            else:
                continue
            use = sum(w * min(1.0, n / _CHAIN_THREADS) for w, n in zip(work, lay["items"]))
            score = (use / sum(work) * (1.0 if per_sm == 2 else _CHAIN_ONE_BLOCK_SCORE)
                     * mode_score
                     * (_CHAIN_LATE_SCORE if late else 1.0))
            if best is None or score > best[0] or score == best[0] and G > best[1]["G"]:
                best = (score, dict(lay, per_sm=per_sm))
        G *= 2
    if best is None:
        raise ValueError(f"fused_chain: no plan fits the shared memory (C={C}, S={S}, "
                         f"widths {list(widths)}; {_build.SMEM_LIMIT} B per block)")
    return best[1]


def _chain_grid(B: int, M: int, plan: dict, sms: int) -> int:
    """The persistent grid: a block per group of centers, at most the
    plan's blocks per SM on each of `sms` SMs."""
    return max(1, min(B * -(-M // plan["G"]), plan["per_sm"] * sms))


def _chain_plan_ints(C: int, S: int, widths, relus, plan: dict) -> list:
    """The plan as fused_chain.cu's `ChainPlan`, field by field."""
    L = len(widths)
    pad = [0] * (_MAX_LAYERS - L)
    return [L, C, *widths, *pad, *plan["tcs"], *pad, *plan["wts"], *pad,
            sum(1 << l for l, r in enumerate(relus) if r),
            plan["G"], S, plan["R"], plan["Rp"], _build.pitch(C) // 4,
            plan["R"] + plan["R"] // _ROWS, plan["x_off"], *plan["h_off"],
            plan["w_off"], plan["part_off"], plan["ib_off"], plan["cb_off"], plan["wmode"],
            plan["kc"], plan["wbuf"], int(plan["direct"]), int(plan["late"])]


def _chain_kernel(table, idx, centers, weights, biases, relus,
                  name: str = "fused_chain", n_valid=None):
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
    if n_valid is not None:
        _build.require(n_valid, "n_valid", torch.int32, 1, dev)
        if n_valid.shape[0] != B:
            raise ValueError(f"fused_chain: n_valid {tuple(n_valid.shape)} for {B} frames")
    # the max over S is unchanged by a repeated row
    idx = _pad_slots(idx)
    S = idx.shape[2]
    widths = [C]
    for w, b in zip(weights, biases):
        _build.require(w, "weight", torch.float32, 2, dev)
        _build.require(b, "bias", torch.float32, 1, dev)
        if w.shape[0] != widths[-1] or b.shape[0] != w.shape[1] or w.shape[1] % 4:
            raise ValueError(f"fused_chain: weight {tuple(w.shape)} after width "
                             f"{widths[-1]}, bias {tuple(b.shape)} (widths must "
                             f"be multiples of 4)")
        widths.append(w.shape[1])
    plan = _chain_plan(C, S, widths[1:], M)
    ints = _chain_plan_ints(C, S, widths[1:], relus, plan)
    if C % 4 or table.data_ptr() % 16:  # rows of whole, aligned float4s
        table = torch.nn.functional.pad(table, (0, _build.pitch(C) - C))
    blocks = _chain_grid(B, M, plan, torch.cuda.get_device_properties(dev).multi_processor_count)
    # fresh tensors: 16-byte aligned for the kernel's float4 copies
    w_all = torch.cat([w.reshape(-1) for w in weights])
    b_all = torch.cat(list(biases))
    out = torch.empty((B, M, widths[-1]), dtype=torch.float32, device=dev)
    past = None if n_valid is None else torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _build.library()
    _build.launch_counts[name] += 1
    _build.check(lib.g4d_fused_chain(
        table.data_ptr(), idx.data_ptr(), centers.data_ptr(), w_all.data_ptr(),
        b_all.data_ptr(), B, N, M, (ctypes.c_int * len(ints))(*ints), len(ints), blocks,
        plan["smem"], None if n_valid is None else n_valid.data_ptr(),
        None if past is None else past.data_ptr(), out.data_ptr(),
        _build.stream_of(table)), name)
    if past is not None and bool(past.item()):  # the flag's one host read
        _refuse_past_valid(name)
    return out


def _chain(table, idx, centers, weights, biases, relus, name, n_valid=None):
    if use_kernel(table):
        args = (table.contiguous(), idx.to(torch.int32).contiguous(), centers.contiguous(),
                [w.contiguous() for w in weights], [b.contiguous() for b in biases],
                relus, name)
        if n_valid is None:
            return _chain_kernel(*args)
        return _chain_kernel(*args, n_valid=n_valid.to(torch.int32).contiguous())
    if n_valid is not None and _past_valid(idx, n_valid):
        _refuse_past_valid(name)
    return _chain_reference(table, idx, centers, weights, biases, relus)


class _ChainMax(torch.autograd.Function):
    """`group_chain_max` (JAX's custom VJP): the chain kernel forward, and a
    backward that recomputes `_chain_reference` under the forward's
    dispatch and differentiates it (the table's gradient through the
    scatter-add)."""

    @staticmethod
    def forward(ctx, table, idx, centers, relus, *weights_biases):
        ctx.kernel = use_kernel(table)
        ctx.relus = relus
        ctx.save_for_backward(table, idx, centers, *weights_biases)
        L = len(relus)
        return _chain(table, idx, centers, weights_biases[:L], weights_biases[L:],
                      relus, "fused_chain")

    @staticmethod
    def backward(ctx, cot):
        table, idx, centers, *wb = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0], ctx.needs_input_grad[2],
                 *ctx.needs_input_grad[4:])
        with dispatch_as(ctx.kernel), torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip([table, centers, *wb], needs)]
            L = len(ctx.relus)
            out = _chain_reference(leaves[0], idx, leaves[1], leaves[2:2 + L],
                                   leaves[2 + L:], ctx.relus)
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, cot) if wanted else ())
        dt, dc, *dwb = [next(got) if n else None for n in needs]
        return (dt, None, dc, None, *dwb)


def group_chain_max(table: torch.Tensor, idx: torch.Tensor,
                    centers: torch.Tensor, weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor],
                    relus: Sequence[bool]) -> torch.Tensor:
    """max_s chain(table[idx_s] - pad(centers)) -> (B, M, C_L).

    table (B, N, C) with xyz on channels 0..2; idx (B, M, S) int; centers
    (B, M, 3); weights: (C_{i-1}, C_i) matrices; biases: (C_i,); relus: bool
    per layer. Differentiable in everything but idx: the backward recomputes
    the unfused chain."""
    return _ChainMax.apply(table, idx, centers, tuple(bool(r) for r in relus),
                           *weights, *biases)


# ---------------------------------------------------------------------------
# posed-stage PE blocks
# ---------------------------------------------------------------------------

_PE_RELUS = (True, False)


def candidate_cap(n: int) -> int:
    """Rows of the compacted table for an n-point set: 72% of n, at least
    256, rounded up to 128. A frame with more covered points takes the
    full-set branch of `query_group_pe_multi`."""
    return ((max(int(n * 0.72), 256) + 127) // 128) * 128


def _pe_forward(table, idx, centers, k0, b0, k1, b1, n_valid=None):
    return _chain(table, idx, centers, (k0, k1), (b0, b1), _PE_RELUS,
                  "group_pe_max" if n_valid is None else "group_pe_max_nv", n_valid)


def _pe_bwd_plain(table, idx, centers, k0, b0, k1, cot, table_grad=False):
    """The PE block's VJP, written out as the kernel computes it: recompute,
    route `cot` (B, M, G) through the max over S (split evenly among exact
    ties; b1 is constant over S, so the routing compares h @ k1 without
    it), backprop both layers. -> (dcenters (B, M, 3), dk0 (C, F), db0 (F,),
    dk1 (F, G), db1 (G,)), led by dtable (B, N, C) with `table_grad` (as
    JAX's `fused_pe_bwd_pallas`): the scatter-add of the row gradients
    dh1 @ k0^T."""
    B, M, S = idx.shape
    N, C = table.shape[1:]
    qg = _gather_rows_plain(table, idx.reshape(B, M * S)).reshape(B, M, S, C)
    qg = qg - torch.nn.functional.pad(centers, (0, C - 3))[:, :, None, :]
    hpre = torch.matmul(qg, k0) + b0
    h = torch.relu(hpre)
    h2 = torch.matmul(h, k1)
    tie = h2 == torch.amax(h2, dim=2, keepdim=True)
    share = cot / tie.sum(dim=2, dtype=cot.dtype)
    dh2 = torch.where(tie, share[:, :, None, :], torch.zeros_like(h2))
    dk1 = torch.einsum("bmsf,bmsg->fg", h, dh2)
    dh1 = torch.where(hpre > 0, torch.matmul(dh2, k1.t()), torch.zeros_like(hpre))
    dk0 = torch.einsum("bmsc,bmsf->cf", qg, dh1)
    dcenters = -torch.matmul(dh1, k0[:3].t()).sum(dim=2)
    grads = (dcenters, dk0, dh1.sum(dim=(0, 1, 2)), dk1, cot.sum(dim=(0, 1)))
    if not table_grad:
        return grads
    dqg = torch.matmul(dh1, k0.t()).reshape(B, M * S, C)
    return (_scatter_add_rows_plain(dqg, idx.reshape(B, M * S), N),) + grads


# blocks of the PE-backward kernel: a fixed count, so that each weight
# gradient sums its per-block partials in the same order on every run
_PE_BWD_BLOCKS = 264
_PE_BWD_RED = 16 * 256  # floats of the kernel's partition-combine buffer
# dynamic shared memory of each of two PE-backward blocks on one H100 SM:
# the SM's 228 KB less 1 KB reserved per block, halved
_PE_BWD_TWO_BLOCKS = (233472 - 2 * 1024) // 2


def _pe_bwd_smem(gc: int, S: int, C: int, F: int, G: int) -> int:
    """Bytes of shared memory of a PE-backward block with tiles of gc
    centers (pe_bwd.cu's layout): k0 (unless the table is so wide that a
    thread owns several 4x4 blocks of dk0), k1 and k1^T, then per row the
    gathered row, hpre and h2/dh1 (rows padded by 4 floats), the mask of
    the channels it won, its table index, first copy and count of copies,
    and its list entry, per center the column sums of dh1 and the masks of
    live and won slots, per (center, channel) the share, the first slot at
    the max and the mask of the tied ones."""
    Pc, R, nw = _build.pitch(C), gc * S, (S + 31) // 32
    k0_shared = (Pc // 4) * (F // 4) <= 256
    tile = (R * (Pc + F + 4 + max(F, G) + 4 + (G + 31) // 32 + 3)
            + gc * (F + 3 * G + 2 * nw))
    return (Pc * F * k0_shared + 2 * F * G + max(tile, _PE_BWD_RED)) * 4


def _pe_bwd_plan(C: int, S: int, F: int, G: int) -> tuple:
    """(gc, smem bytes) of the PE-backward kernel for C-wide tables, S slots
    (padded to 8) and widths F, G: centers per tile, the most (a power of
    two) with at most 256 rows while two blocks fit an SM, else one center
    if one block fits. Raises ValueError for shapes the kernel refuses."""
    if (C < 3 or S < 1 or F % 4 or G % 4 or F < 4 or G < 4 or F > 256
            or _build.pitch(C) * F > 16 * 4 * 256 or F * G > 16 * 256):
        raise ValueError(f"pe_bwd: C={C}, F={F}, G={G} (C >= 3, F and G multiples of 4, "
                         f"F <= 256, C * F <= {16 * 4 * 256}, F * G <= {16 * 256})")
    gc = 1
    while 2 * gc * S <= 256 and _pe_bwd_smem(2 * gc, S, C, F, G) <= _PE_BWD_TWO_BLOCKS:
        gc *= 2
    smem = _pe_bwd_smem(gc, S, C, F, G)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"pe_bwd: {smem} B of shared memory needed (C={C}, S={S}, "
                         f"F={F}, G={G}) exceeds {_build.SMEM_LIMIT}")
    return gc, smem


def _pe_bwd_kernel(table, idx, centers, k0, b0, k1, cot, table_grad=False):
    _build.refuse_grad("pe_bwd", table, centers, k0, b0, k1, cot)
    dev = table.device
    for t, name, dtype, ndim in ((table, "table", torch.float32, 3),
                                 (idx, "idx", torch.int32, 3),
                                 (centers, "centers", torch.float32, 3),
                                 (k0, "k0", torch.float32, 2),
                                 (b0, "b0", torch.float32, 1),
                                 (k1, "k1", torch.float32, 2),
                                 (cot, "cot", torch.float32, 3)):
        _build.require(t, name, dtype, ndim, dev)
    B, N, C = table.shape
    M = idx.shape[1]
    F, G = k1.shape
    if (idx.shape[0] != B or centers.shape != (B, M, 3) or C < 3
            or k0.shape != (C, F) or b0.shape != (F,) or cot.shape != (B, M, G)):
        raise ValueError(f"pe_bwd: table {tuple(table.shape)}, idx {tuple(idx.shape)}, "
                         f"centers {tuple(centers.shape)}, k0 {tuple(k0.shape)}, "
                         f"k1 {tuple(k1.shape)}, cot {tuple(cot.shape)}")
    # the pads repeat slot 0 up to the 8-row tile; the kernel is told the
    # real slot count, so that a pad takes no share of a tie (with slot 0's
    # copies counted in the split, a tie of slot 0 with another row whose
    # content is equal would hand slot 0's row more than its share of dtable)
    S_real = idx.shape[2]
    idx = _pad_slots(idx)
    S = idx.shape[2]
    gc, smem = _pe_bwd_plan(C, S, F, G)
    n_acc = C * F + F + F * G + G
    Pc = _build.pitch(C)
    # float4 loads: k0 padded with zero rows to Pc, k0 and b0 16-byte aligned
    k0 = torch.nn.functional.pad(k0, (0, 0, 0, Pc - C))
    k0, b0 = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (k0, b0))
    n_tiles = B * ((M + gc - 1) // gc)
    blocks = max(1, min(n_tiles, _PE_BWD_BLOCKS))
    dcenters = torch.empty((B, M, 3), dtype=torch.float32, device=dev)
    partials = torch.empty((blocks, n_acc), dtype=torch.float32, device=dev)
    sums = torch.empty((n_acc,), dtype=torch.float32, device=dev)
    # the dtable half: the won slots' row gradients and their table rows
    # (-1 for a slot that won nothing), summed by the scatter-add
    dqg = (torch.empty((B, M * S, C), dtype=torch.float32, device=dev)
           if table_grad else None)
    idx_w = torch.empty((B, M * S), dtype=torch.int32, device=dev) if table_grad else None
    k0t = k0.t().contiguous() if table_grad else None  # (F, Pc)
    lib = _build.library()
    _build.launch_counts["pe_bwd"] += 1
    _build.check(lib.g4d_pe_bwd(
        table.data_ptr(), idx.data_ptr(), centers.data_ptr(), k0.data_ptr(),
        b0.data_ptr(), k1.data_ptr(), cot.data_ptr(), B, N, C, M, S, S_real, F, G, gc,
        blocks, smem, dcenters.data_ptr(), partials.data_ptr(), sums.data_ptr(),
        *(None, None, None) if not table_grad else
        (k0t.data_ptr(), dqg.data_ptr(), idx_w.data_ptr()),
        _build.stream_of(table)), "pe_bwd")
    dk0, db0, dk1, db1 = torch.split(sums, [C * F, F, F * G, G])
    grads = (dcenters, dk0.view(C, F), db0, dk1.view(F, G), db1)
    if not table_grad:
        return grads
    return (_scatter_add_rows_kernel(dqg, idx_w, N),) + grads


def _pe_bwd(table, idx, centers, k0, b0, k1, cot, table_grad=False):
    if use_kernel(table):
        return _pe_bwd_kernel(table.contiguous(), idx.to(torch.int32).contiguous(),
                              centers.contiguous(), k0.contiguous(), b0.contiguous(),
                              k1.contiguous(), cot.contiguous(), table_grad)
    return _pe_bwd_plain(table, idx, centers, k0, b0, k1, cot, table_grad)


class _PeMax(torch.autograd.Function):
    """`group_pe_max` (JAX's `_group_pe_max` and `_group_pe_max_nt`
    custom VJPs): the chain kernel forward, the PE-backward kernel backward,
    with its dtable half when the table needs a gradient."""

    @staticmethod
    def forward(ctx, table, idx, centers, k0, b0, k1, b1, n_valid):
        ctx.save_for_backward(table, idx, centers, k0, b0, k1)
        ctx.kernel = use_kernel(table)
        return _pe_forward(table, idx, centers, k0, b0, k1, b1, n_valid)

    @staticmethod
    def backward(ctx, cot):
        table, idx, centers, k0, b0, k1 = ctx.saved_tensors
        table_grad = ctx.needs_input_grad[0]
        with dispatch_as(ctx.kernel):
            grads = _pe_bwd(table, idx, centers, k0, b0, k1, cot, table_grad)
        if not table_grad:
            grads = (None,) + grads
        return (grads[0], None, *grads[1:], None)


class _PeMaxSplitFrozen(torch.autograd.Function):
    """JAX's `group_pe_max_split_frozen`: the split projection forward, the
    unsplit backward over the raw (3 + C)-wide table with the full k0."""

    @staticmethod
    def forward(ctx, xyz, features, idx, centers, k0, b0, k1, b1):
        ctx.save_for_backward(xyz, features, idx, centers, k0, b0, k1)
        ctx.kernel = use_kernel(xyz)
        proj = torch.matmul(features, k0[3:])
        packed = torch.cat([xyz, proj], dim=-1)
        kfull = torch.cat([k0[:3], torch.eye(k0.shape[1], dtype=k0.dtype,
                                             device=k0.device)], dim=0)
        return _pe_forward(packed, idx, centers, kfull, b0, k1, b1)

    @staticmethod
    def backward(ctx, cot):
        xyz, features, idx, centers, k0, b0, k1 = ctx.saved_tensors
        table = torch.cat([xyz, features], dim=-1)
        with dispatch_as(ctx.kernel):
            return (None, None, None) + _pe_bwd(table, idx, centers, k0, b0, k1, cot)


def group_pe_max(table: torch.Tensor, idx: torch.Tensor, centers: torch.Tensor,
                 k0: torch.Tensor, b0: torch.Tensor, k1: torch.Tensor,
                 b1: torch.Tensor, table_grad: bool = True,
                 n_valid: torch.Tensor = None) -> torch.Tensor:
    """max_s (relu((table[idx_s] - pad(centers)) @ k0 + b0) @ k1 + b1):
    table (B, N, C) with xyz on channels 0..2, idx (B, M, S), centers
    (B, M, 3), k0 (C, F), k1 (F, G) -> (B, M, G). The chain kernel with two
    layers, differentiable in everything but idx; the backward is the
    PE-backward kernel on the card.

    `table_grad=False` declares the table non-trainable (the body xyz and
    normals): it gets no gradient, and the backward skips the dtable half.
    With `table_grad=True` a table that requires grad gets its gradient
    from that half: each slot's row gradient, scatter-added in a fixed
    order.

    `n_valid` (B,) int, with `table_grad=False` only: the count of real
    leading rows of a sentinel-padded table per frame (JAX's
    `group_pe_max_pallas_nv`). The result is the same as without it; an
    index at or past max(n_valid[b], 1), where the TPU variant stops being
    exact, raises (one host read of a device flag per call)."""
    if n_valid is not None and table_grad:
        raise ValueError("group_pe_max: n_valid requires table_grad=False")
    if not table_grad:
        table = table.detach()
    return _PeMax.apply(table, idx, centers, k0, b0, k1, b1, n_valid)


def group_pe_max_split_frozen(xyz: torch.Tensor, features: torch.Tensor,
                              idx: torch.Tensor, centers: torch.Tensor,
                              k0: torch.Tensor, b0: torch.Tensor,
                              k1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """`group_pe_max` over concat(xyz, features), a frozen table, with the
    first layer split around the gather: the features are projected to F
    once per point (`features @ k0[3:]`, a plain matmul), so the gathered
    table is 3 + F wide, and the first layer becomes concat(k0[:3], I_F).
    The backward runs over the unsplit (3 + C)-wide table, so k0[3:] gets
    its gradient from the gathered raw features; xyz and features get
    none. k0 is the full (3 + C, F) weight."""
    return _PeMaxSplitFrozen.apply(xyz.detach(), features.detach(), idx, centers,
                                   k0, b0, k1, b1)


def _compact_candidates(xyz: torch.Tensor, centers: torch.Tensor,
                        cover_r: float, cap: int, spatial: bool = False):
    """Coverage mask at `cover_r`, then the covered point indices cut to
    `cap`: in ascending order (keys where(cover, iota, 1 << 30), sorted),
    or with `spatial` in Morton order (keys where(cover, morton_codes(xyz),
    1 << 30) over the whole frame's box, a stable sort, so ties keep index
    order). -> (counts (B,) int32, overflow: bool read on the host,
    compact_idx (B, cap) int32; entries past counts[b] are >= N)."""
    B, N, _ = xyz.shape
    cover = covered_mask(xyz, centers, cover_r)
    counts = cover.sum(dim=1, dtype=torch.int32)
    overflow = bool((counts > cap).any())  # the one host read of the call
    if spatial:
        keys = torch.where(cover > 0, morton.morton_codes(xyz),
                           torch.full_like(cover, 1 << 30))
        ordered = torch.sort(keys, dim=1, stable=True)
        # an uncovered row sorts last and reads N (JAX's payload), so that
        # `_gather_candidates` gives it a sentinel
        compact_idx = torch.where(ordered.values < (1 << 30), ordered.indices.to(torch.int32),
                                  torch.full_like(cover, N))
        return counts, overflow, compact_idx[:, :cap]
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
    return [group_pe_max(table, idx, centers, *params, table_grad=False)
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
                         features: torch.Tensor, pe_params: Sequence,
                         spatial: bool = False, candidates: dict = None,
                         reuse_margin: float = 0.0):
    """Multi-radius ball query + PE blocks over concat(xyz, features):
    -> (outs, state). `outs` is a tuple of (B, M, G_i), exactly max_s PE_i over the neighbourhoods of
    `ball_query_multi(radii, nsamples, xyz, new_xyz)[i]`, including the
    no-hit row-0 convention. pe_params[i] = (k0, b0, k1, b1), k0 (3 + C, F).
    (xyz, features) get no gradient through the PE blocks (`group_pe_max`
    with `table_grad=False`): the posed stage's body table is batch data.

    For N >= 1024 with cap < N the query runs over the candidates within
    max(radii) of any center, compacted in index order (so the first-S
    semantics hold) into a `candidate_cap(N)`-row table, unless a frame
    has more than that; the results are the same either way.

    `spatial`: the candidates are compacted in Morton order
    (`_compact_candidates`), so the first-S subset is another, equally
    arbitrary, in-radius sample; smaller tables and the overflow branch
    keep index order, as the JAX package's.

    `reuse_margin` > 0: coverage is taken at max(radii) + reuse_margin,
    so the compacted table holds every point that a center within the
    margin of the build-time centers can hit, and `state` is that table.
    Passed back as `candidates`, it is reused while max ||center -
    center0||^2 <= margin^2 and it did not overflow, and rebuilt otherwise
    (one more host read a call). Reuse is exact in index order; with
    `spatial`, a widened coverage that overflows where max(radii)'s would
    not takes the overflow branch, whose index-order sample differs from
    the Morton-ordered one. The state holds `counts`, `overflow`,
    `centers0` and, unless it overflowed, the compacted table `cxyz`,
    `cpacked`. `state` is None without reuse or where no table is
    compacted (N < 1024 or cap >= N)."""
    reuse = float(reuse_margin) > 0.0
    if candidates is not None and not reuse:
        raise ValueError("query_group_pe_multi: candidates requires reuse_margin > 0")
    B, N, _ = xyz.shape
    S = tuple(int(s) for s in nsamples)
    packed = torch.cat([xyz, features], dim=-1)
    cap = candidate_cap(N)
    if cap >= N or N < 1024:
        outs = tuple(_pe_all(packed, ball_query_multi(radii, S, xyz, new_xyz),
                             new_xyz, pe_params))
        return outs, None
    centers = new_xyz.detach()
    state = candidates
    if state is not None:
        drift = _sqdist(centers, state["centers0"]).max()
        # an overflowed state would pin every reuse to the full-set branch
        stale = bool(drift > _f32(float(reuse_margin) ** 2)) or state["overflow"]
        if stale:
            state = None
    if state is None:
        counts, overflow, compact_idx = _compact_candidates(
            xyz, centers, float(max(radii)) + float(reuse_margin), cap, spatial)
        state = dict(counts=counts, overflow=overflow, centers0=centers)
        if not overflow:
            state["cxyz"], state["cpacked"] = _gather_candidates(xyz, packed, compact_idx)
    if state["overflow"]:
        full = torch.full((B,), N, dtype=torch.int32, device=xyz.device)
        idxs = ball_query_multi(radii, S, xyz, new_xyz, n_valid=full)
        outs = tuple(_pe_all(packed, idxs, new_xyz, pe_params))
    else:
        cxyz, cpacked = state["cxyz"], state["cpacked"]
        idxs = ball_query_multi(radii, S, cxyz, new_xyz, n_valid=state["counts"])
        outs = _pe_all(cpacked, idxs, new_xyz, pe_params)
        d0 = _sqdist(new_xyz, cxyz[:, 0:1, :])
        outs = _no_hit_fix(outs, idxs, radii, packed[:, 0, :], new_xyz, d0, pe_params)
    return outs, (state if reuse else None)
