"""Point-cloud geometry primitives, channel-last, in PyTorch.

Counterpart of `garment4d_tpu/ops/pointcloud.py`. Every function that the
JAX package runs through a Pallas kernel on the TPU dispatches here by the
device of its input: a CPU tensor takes the plain torch version (`_*_plain`),
a CUDA tensor launches the hand-written CUDA kernel (`ops/csrc/`) or raises.
Inside `with plain_ops():` every op runs its plain version on any device:
the oracle that the kernels are held against on the card, entered on
purpose, never as a fallback. A kernel wrapper is forward-only: one whose
input requires grad while autograd records raises, instead of cutting the
gradient off. Gradients go through autograd Functions (here the row
gather, whose backward is the deterministic scatter-add kernel, and
`knn_points`), whose forward runs with grad off and whose backward takes
the forward's choice of kernel or plain version (`dispatch_as`).

Semantics follow the JAX reference bit for bit where it promises that:
distances are diff-form fp32 `dx*dx + dy*dy + dz*dz` summed left to right
(products written out, never `(d*d).sum(-1)`), so FPS, ball-query, coverage
and 3-NN indices are bitwise equal across the JAX package, the plain
versions and the kernels. Index outputs are int32, as in JAX.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional, Sequence

import torch

from garment4d_tpu_torch.ops import _build

# centers per chunk of the plain ball query / queries per chunk of the plain
# 3-NN: bounds the (B, chunk, N) distance temporaries
_CHUNK = 256

_plain_only = contextvars.ContextVar("plain_only", default=False)


@contextlib.contextmanager
def plain_ops():
    """Within the block every op runs its plain torch version, on any
    device (and so launches no kernel)."""
    token = _plain_only.set(True)
    try:
        yield
    finally:
        _plain_only.reset(token)


def use_kernel(t: torch.Tensor) -> bool:
    """True: launch the CUDA kernel. False: run the plain version."""
    if _plain_only.get() or t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain dispatch for device {t.device}")


def dispatch_as(kernel: bool):
    """The context for an autograd Function's backward, given its forward's
    `use_kernel`: autograd runs the backward of CUDA tensors on a worker
    thread, where the caller's `plain_ops()` is not in effect."""
    return contextlib.nullcontext() if kernel else plain_ops()


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., 3) - b (..., 3) broadcast -> diff-form squared distance."""
    d = a - b
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return dx * dx + dy * dy + dz * dz


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, 3), b (..., N, 3) -> (..., M, N) squared distances in
    diff form (the JAX package's `pairwise_sqdist(exact=True)`)."""
    return _sqdist(a[..., :, None, :], b[..., None, :, :])


def _f32(x: float) -> float:
    """The float32 rounding of a Python float (as `jnp.float32(x)`)."""
    return torch.tensor(x, dtype=torch.float32).item()


# ---------------------------------------------------------------------------
# furthest point sampling
# ---------------------------------------------------------------------------


def _fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    B, N, _ = xyz.shape
    out = torch.zeros((B, npoint), dtype=torch.int64, device=xyz.device)
    mindist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    last = torch.zeros((B,), dtype=torch.int64, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    for j in range(1, npoint):
        d2 = _sqdist(xyz, xyz[rows, last][:, None, :])
        mindist = torch.minimum(mindist, d2)
        last = torch.argmax(mindist, dim=-1)  # first index of the max
        out[:, j] = last
    return out.to(torch.int32)


# common.cuh: the Morton cells (kCodes) by which coverage.cu and fps.cu
# order a block's points; their counting sort keeps a count a cell in
# shared memory (the C entries refuse a plan with less)
_MORTON_CELLS = 8
_MORTON_CODES = _MORTON_CELLS ** 3

# fps.cu: points per thread held in registers (template instances) and the
# sets that one warp samples alone (no barrier). `_FPS_PPT`: the points per
# thread where a set takes several warps (more warps shorten a step's
# distance pass, fewer its reduction: 4 measured best at 512-1722 points,
# PERF.md). Sets past one block's registers (`_FPS_ONE_BLOCK`) take the
# cluster kernel, `_FPS_CLUSTERS` blocks a frame of at most
# `_FPS_CLUSTER_THREADS` threads, each a slice of at most `_FPS_SLICE_REGS`
# points in registers (`_FPS_CLUSTER_PPT` a thread) or `_FPS_SLICE_STAGED`
# read from its planes (`_FPS_STAGED_PPT` a thread); `_FPS_MIN_SLICE`: the
# least slice for which more blocks than SMs pay (measured with
# `chip_smoke.py --fps-clusters`, PERF.md). Sets past the largest cluster
# take the wide kernel: `_FPS_WIDE_THREADS` threads, the running distances
# in device memory; `_FPS_MAX_N`: its int offsets into a frame (3 N floats).
_FPS_PPTS = (1, 2, 4, 8)
_FPS_ONE_WARP = 32 * _FPS_PPTS[-1]
_FPS_PPT = 4
_FPS_ONE_BLOCK = 32 * 32 * _FPS_PPTS[-1]
_FPS_CLUSTERS = (4, 8)
_FPS_CLUSTER_THREADS = 512
_FPS_CLUSTER_PPT = 16
_FPS_STAGED_PPT = 32
_FPS_SLICE_REGS = _FPS_CLUSTER_THREADS * _FPS_CLUSTER_PPT
_FPS_SLICE_STAGED = _FPS_CLUSTER_THREADS * _FPS_STAGED_PPT
_FPS_CLUSTER_MAX_N = _FPS_CLUSTERS[-1] * _FPS_SLICE_STAGED
_FPS_MIN_SLICE = 1536
_FPS_WIDE_THREADS = 1024
_FPS_MAX_N = (2 ** 31 - 1) // 3


def _fps_cluster_plan(N: int, cluster: int) -> dict:
    """The cluster kernel's plan for frames of N points on clusters of
    `cluster` blocks: a slice of S = ceil(N / cluster) points a block,
    `_FPS_CLUSTER_PPT` a thread in registers up to `_FPS_SLICE_REGS`
    points, else `_FPS_STAGED_PPT` read from the planes (`staged`); the
    planes take 12 S bytes."""
    if cluster not in _FPS_CLUSTERS or N <= _FPS_ONE_BLOCK or \
            -(-N // cluster) > _FPS_SLICE_STAGED:
        raise ValueError(f"fps: no cluster of {cluster} blocks holds N={N} points "
                         f"({_FPS_ONE_BLOCK} < N, a slice of at most {_FPS_SLICE_STAGED})")
    S = -(-N // cluster)
    staged = S > _FPS_SLICE_REGS
    ppt = _FPS_STAGED_PPT if staged else _FPS_CLUSTER_PPT
    return dict(threads=32 * -(-S // (32 * ppt)), ppt=ppt, cluster=cluster, staged=staged,
                far=False, wide=False, smem=12 * S)


@functools.lru_cache(maxsize=64)
def _fps_plan(B: int, N: int, npoint: int, sms: int) -> dict:
    """The FPS kernel's launch plan on `sms` SMs. Frames of at most
    `_FPS_ONE_BLOCK` points: one block of `threads` per frame, each thread
    owning `ppt` points (t, t + threads, ...) in registers; `far`: the
    kernel that orders the frame and skips warps far from a step's new point
    (sets of 8 points a thread); `smem` dynamic bytes. Larger frames up to
    `_FPS_CLUSTER_MAX_N`: the cluster kernel (`_fps_cluster_plan`;
    `cluster` 0 for the one-block instances), on clusters of 8 blocks a
    frame, unless B x 8 blocks exceed the SMs and a slice of 8 falls under
    `_FPS_MIN_SLICE` points: then 4 (more blocks than SMs run several to an
    SM or in waves, which pays only for slices worth their exchange). A
    cluster of 4 holds every frame up to 65536 points and keeps slices of
    at least 2049, so the rule never needs a smaller one. Past that, `wide`:
    the kernel that reads the coordinates through L1/L2 each step and keeps
    the running distances in a (B, N) scratch array in device memory (`smem`
    0). Any npoint >= 1 (past N the loop runs on: every distance 0, each
    step takes index 0) and 1 <= N <= _FPS_MAX_N; raises ValueError for the
    rest, for B < 0 and sms < 1."""
    if npoint < 1 or B < 0 or sms < 1 or not 1 <= N <= _FPS_MAX_N:
        raise ValueError(f"fps: B={B}, N={N}, npoint={npoint}, sms={sms} (npoint >= 1, "
                         f"B >= 0, sms >= 1, 1 <= N <= {_FPS_MAX_N})")
    if N > _FPS_CLUSTER_MAX_N:
        return dict(threads=_FPS_WIDE_THREADS, ppt=-(-N // _FPS_WIDE_THREADS), cluster=0,
                    staged=False, far=False, wide=True, smem=0)
    if N > _FPS_ONE_BLOCK:
        small, large = _FPS_CLUSTERS
        few = B * large > sms and -(-N // large) < _FPS_MIN_SLICE
        return _fps_cluster_plan(N, small if few else large)
    if N <= _FPS_ONE_WARP:
        ppt = next(p for p in _FPS_PPTS if 32 * p >= N)
    else:
        ppt = max(_FPS_PPT, next(p for p in _FPS_PPTS if 32 * 32 * p >= N))
    # sets of 8 points a thread take the kernel that skips far warps; its
    # sorted frame (float4) also holds the sort's counts (2 KB) at first
    far = ppt == _FPS_PPTS[-1] and N > 32 * 32 * _FPS_PPT
    smem = max(16 * N, 4 * _MORTON_CODES) if far else 12 * N
    return dict(threads=32 * -(-N // (32 * ppt)), ppt=ppt, cluster=0, staged=False, far=far,
                wide=False, smem=smem)


def _fps_kernel(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """The FPS kernel on the card."""
    dev = xyz.device
    _build.require(xyz, "xyz", torch.float32, 3, dev)
    B, N, C = xyz.shape
    if C != 3:
        raise ValueError(f"fps: xyz {tuple(xyz.shape)}, npoint {npoint}")
    plan = _fps_plan(B, N, npoint, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((B, npoint), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    # the wide kernel's running distances
    scratch = torch.empty((B, N), dtype=torch.float32, device=dev) if plan["wide"] else None
    lib = _build.library()
    _build.launch_counts["fps"] += 1
    _build.check(lib.g4d_fps(xyz.data_ptr(), B, N, npoint, plan["threads"], plan["ppt"],
                             int(plan["far"]), int(plan["wide"]), plan["cluster"], plan["smem"],
                             None if scratch is None else scratch.data_ptr(), out.data_ptr(),
                             _build.stream_of(xyz)), "fps")
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative furthest point sampling: xyz (B, N, 3) f32 -> (B, npoint)
    int32. Starts at index 0, running min-distance, argmax each step with
    ties to the lowest index; npoint may exceed N (the JAX package's rule:
    once every point is taken, each further step takes index 0).
    Non-differentiable."""
    xyz = xyz.detach()
    if use_kernel(xyz):
        return _fps_kernel(xyz.contiguous(), int(npoint))
    return _fps_plain(xyz, int(npoint))


# ---------------------------------------------------------------------------
# gather / grouping
# ---------------------------------------------------------------------------


def _gather_rows_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The row gather in torch, with the JAX package's out-of-range rule
    (`gather_points`): the gather of the wrapped index clamped into range,
    its invalid rows then filled with NaN."""
    B, N, C = points.shape
    ix = idx.long()
    ix = torch.where(ix < 0, ix + N, ix)
    valid = (ix >= 0) & (ix < N)
    if N == 0:
        return torch.full((*idx.shape, C), float("nan"), dtype=points.dtype,
                          device=points.device)
    out = torch.gather(points, 1, torch.where(valid, ix, 0)[..., None].expand(*idx.shape, C))
    return out.masked_fill_(~valid[..., None], float("nan"))


_GATHER_THREADS = 256  # gather.cu: kThreads
# slots a thread (gather.cu's instances): 4 float4s; 8 floats of rows of at
# least _GATHER_NARROW floats, 4 of narrower rows (measured best, PERF.md)
_GATHER_NARROW = 32
_GRID_MAX = 2 ** 31 - 1  # blocks of a 1-D grid


def _divider(d: int) -> tuple:
    """(magic, shift) with x // d == x * magic >> shift for 0 <= x < 2^31
    and 1 <= d <= 2^31 (gather.cu: `divide`): shift = 31 + ceil(log2 d),
    magic = ceil(2^shift / d), below 2^32. The rounding error of magic
    adds less than x / 2^shift < 1 / d to x / d, which never reaches the
    next integer."""
    shift = 31 + (d - 1).bit_length()
    return -(-(1 << shift) // d), shift


@functools.lru_cache(maxsize=256)
def _gather_plan(R: int, C: int, aligned: bool) -> dict:
    """The row gather's launch plan for frames of R rows of C floats: V
    floats a slot (4 where C % 4 == 0 and the table and the output are
    16-byte aligned, else 1), `CV` = C / V slots a row, U slots a thread
    (`_GATHER_THREADS` apart: 8 floats of rows of `_GATHER_NARROW` floats
    or more, else 4), `tile` consecutive slots of one frame a block
    and `blocks_per_frame` blocks; slot s is (row s // CV, vector s % CV)
    by the divider (magic, shift), a block's frame by (frame_magic,
    frame_shift) (`_divider`). Raises ValueError for C < 1 or a frame of
    2^31 - tile slots or more."""
    if R < 0 or C < 1:
        raise ValueError(f"gather: R={R}, C={C} (R >= 0, C >= 1)")
    V = 4 if C % 4 == 0 and aligned else 1
    U = 8 if V == 1 and C >= _GATHER_NARROW else 4
    CV, tile = C // V, _GATHER_THREADS * U
    if R * CV + tile > 2 ** 31:
        raise ValueError(f"gather: {R} rows of {C} floats a frame, past the kernel's "
                         f"{2 ** 31 - tile} slots of {V} floats")
    bpf = -(-R * CV // tile)
    (magic, shift), (frame_magic, frame_shift) = _divider(CV), _divider(max(bpf, 1))
    return dict(V=V, U=U, CV=CV, tile=tile, blocks_per_frame=bpf, magic=magic, shift=shift,
                frame_magic=frame_magic, frame_shift=frame_shift)


def _gather_rows_kernel(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gather kernel (`csrc/gather.cu`) on CUDA tensors, with
    `gather_points`' out-of-range rule; forward-only."""
    _build.refuse_grad("gather_rows", points)
    dev = points.device
    _build.require(points, "points", torch.float32, 3, dev)
    _build.require(idx, "idx", torch.int32, 2, dev)
    B, N, C = points.shape
    if idx.shape[0] != B:
        raise ValueError(f"gather: batch mismatch {tuple(points.shape)} vs {tuple(idx.shape)}")
    R = idx.shape[1]
    out = torch.empty((B, R, C), dtype=torch.float32, device=dev)
    if B == 0 or R == 0 or C == 0:
        return out
    plan = _gather_plan(R, C, points.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    if B * plan["blocks_per_frame"] > _GRID_MAX:
        raise ValueError(f"gather: {B} frames of {plan['blocks_per_frame']} blocks, past "
                         f"a grid's {_GRID_MAX}")
    lib = _build.library()
    _build.launch_counts["gather_rows"] += 1
    _build.check(lib.g4d_gather_rows(
        points.data_ptr(), idx.data_ptr(), B, N, C, R, plan["V"], plan["U"],
        plan["blocks_per_frame"], plan["magic"], plan["shift"], plan["frame_magic"],
        plan["frame_shift"], out.data_ptr(), _build.stream_of(points)), "gather_rows")
    return out


_SCATTER_MAX_C = 1024
_SCATTER_SORT_WARPS = 16  # warps of a sort block (scatter_add.cu: kWarps)


def _scatter_plan(C: int, aligned: bool) -> tuple:
    """(V, J, lanes) of the scatter-add's segmented sum for C channels:
    V floats per load (4 where C % 4 == 0 and the pointers are 16-byte
    aligned, else 1), J loads per lane per chunk of channels, and `lanes`
    lanes (a power of two up to a warp) owning one output row, the fewest
    that cover C in one chunk where J allows."""
    if not 0 <= C <= _SCATTER_MAX_C:
        raise ValueError(f"scatter_add: C={C} outside [0, {_SCATTER_MAX_C}]")
    V = 4 if C % 4 == 0 and C > 0 and aligned else 1
    slots = max(1, C // V)
    J = 1
    while J < (2 if V == 4 else 8) and slots > 32 * J:
        J *= 2
    lanes = 1
    while lanes < 32 and lanes * J < slots:
        lanes *= 2
    return V, J, lanes


def _scatter_hist_in_shared(n: int) -> bool:
    """Whether the sort's (n, 16) counts fit the shared memory of a block;
    else the wrapper gives the kernel scratch for them."""
    return n * _SCATTER_SORT_WARPS * 4 <= _build.SMEM_LIMIT - 1024


def _scatter_add_rows_plain(grads: torch.Tensor, idx: torch.Tensor,
                            n: int, wrap: bool = False) -> torch.Tensor:
    """`index_add_` on the flattened rows; indices outside [0, n) (after
    `wrap` adds n to the negative ones) go to a spare row that is dropped.
    On the CPU it adds in index order, from 0.0, the order the kernel keeps;
    on the card it uses atomics."""
    B, R, C = grads.shape
    if wrap:
        idx = torch.where(idx < 0, idx + n, idx)
    flat = idx.long() + n * torch.arange(B, device=idx.device)[:, None]
    valid = (idx >= 0) & (idx < n)
    flat = torch.where(valid, flat, torch.full_like(flat, B * n))
    out = torch.zeros((B * n + 1, C), dtype=grads.dtype, device=grads.device)
    out.index_add_(0, flat.reshape(-1), grads.reshape(B * R, C))
    return out[:B * n].reshape(B, n, C)


def _scatter_add_rows_kernel(grads: torch.Tensor, idx: torch.Tensor,
                             n: int, wrap: bool = False) -> torch.Tensor:
    _build.refuse_grad("scatter_add", grads)
    dev = grads.device
    _build.require(grads, "grads", torch.float32, 3, dev)
    _build.require(idx, "idx", torch.int32, 2, dev)
    B, R, C = grads.shape
    if tuple(idx.shape) != (B, R) or n < 0 or C > _SCATTER_MAX_C:
        raise ValueError(f"scatter_add: grads {tuple(grads.shape)}, idx "
                         f"{tuple(idx.shape)}, n {n} (C <= {_SCATTER_MAX_C})")
    out = torch.empty((B, n, C), dtype=torch.float32, device=dev)
    V, J, lanes = _scatter_plan(C, grads.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    # the sort's scratch: each frame's slots in ascending (row, r) order,
    # each row's first slot, and the counts where shared memory is too small
    order = torch.empty((B, R), dtype=torch.int32, device=dev)
    start = torch.empty((B, n + 1), dtype=torch.int32, device=dev)
    hist = (None if _scatter_hist_in_shared(n) else
            torch.empty((B, n * _SCATTER_SORT_WARPS), dtype=torch.int32, device=dev))
    lib = _build.library()
    _build.launch_counts["scatter_add"] += 1
    _build.check(lib.g4d_scatter_add(
        grads.data_ptr(), idx.data_ptr(), B, R, C, n, int(wrap), V, J, lanes, order.data_ptr(),
        start.data_ptr(), None if hist is None else hist.data_ptr(), out.data_ptr(),
        _build.stream_of(grads)), "scatter_add")
    return out


def scatter_add_rows(grads: torch.Tensor, idx: torch.Tensor, n: int,
                     wrap: bool = False) -> torch.Tensor:
    """grads (B, R, C), idx (B, R) int -> (B, n, C): out[b, i] = the sum of
    grads[b, r] over the r with idx[b, r] == i, in ascending r from 0.0;
    indices outside [0, n) are dropped, as the Pallas scatter-add drops
    them. With `wrap` an index in [-n, 0) adds into row idx + n first: the
    backward of a row gather, as JAX's `_gather_rows` VJP. The kernel is
    bitwise the CPU's sum and repeats bitwise; the plain version on the
    card (atomics) does not."""
    if use_kernel(grads):
        return _scatter_add_rows_kernel(grads.contiguous(),
                                        idx.to(torch.int32).contiguous(), int(n), wrap)
    return _scatter_add_rows_plain(grads, idx, int(n), wrap)


class _GatherRows(torch.autograd.Function):
    """The row gather with the scatter-add as its backward (JAX's
    `_gather_rows` custom VJP): the gather kernel and the scatter-add
    kernel on the card, their plain versions elsewhere."""

    @staticmethod
    def forward(ctx, points, idx):
        ctx.kernel = use_kernel(points)
        ctx.n = points.shape[1]
        ctx.save_for_backward(idx)
        if ctx.kernel:
            return _gather_rows_kernel(points.contiguous(),
                                       idx.to(torch.int32).contiguous())
        return _gather_rows_plain(points, idx)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        idx, = ctx.saved_tensors
        with dispatch_as(ctx.kernel):
            return scatter_add_rows(g, idx, ctx.n, wrap=True), None


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M) int -> (B, M, C): out[b, m] =
    points[b, idx[b, m]]. Out of range, the JAX package's `_gather_rows`
    rule on every path: an index in [-N, 0) reads row idx + N, any other
    index outside [0, N) gives a row of NaN (the Pallas kernel promises
    [0, N) and gives zero rows outside it). Differentiable in `points`: the
    backward is `scatter_add_rows` with `wrap` (the deterministic
    scatter-add kernel on the card), which sends a wrapped index's
    cotangent to row idx + N and drops the others, as JAX's VJP.

    A half-precision table (bf16 features under `--bf16`; of the port's
    paths only `three_interpolate` gathers one) goes through the kernel as
    fp32 and its rows come back in the table's dtype, as the JAX package's
    `take_along_axis` gives them (a gather is exact, so the values are the
    table's). The backward thus rounds each row's cotangent to that dtype
    before the fp32 scatter-add and casts the sum once, as the JAX
    package's backward on the TPU does (on the CPU it sums in bf16)."""
    if points.dtype in (torch.bfloat16, torch.float16):
        return _GatherRows.apply(points.float(), idx).to(points.dtype)
    return _GatherRows.apply(points, idx)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M, S) int -> (B, M, S, C), as
    `gather_points` (its out-of-range rule included)."""
    B, M, S = idx.shape
    flat = gather_points(points, idx.reshape(B, M * S))
    return flat.reshape(B, M, S, points.shape[-1])


# ---------------------------------------------------------------------------
# ball query
# ---------------------------------------------------------------------------


def _ball_query_plain(radius: float, nsample: int, xyz: torch.Tensor,
                      new_xyz: torch.Tensor,
                      n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, M, _ = new_xyz.shape
    r2 = _f32(radius * radius)
    targets = torch.arange(1, nsample + 1, dtype=torch.int32,
                           device=xyz.device)
    scanned = None  # (B, 1, N): rows at or past n_valid[b] are never hits
    if n_valid is not None:
        rows = torch.arange(xyz.shape[1], device=xyz.device)
        scanned = (rows[None, :] < n_valid.to(xyz.device)[:, None])[:, None, :]
    outs = []
    for m0 in range(0, M, _CHUNK):
        centers = new_xyz[:, m0:m0 + _CHUNK]
        d2 = _sqdist(centers[:, :, None, :], xyz[:, None, :, :])  # (B, Cm, N)
        hit = d2 < r2
        if scanned is not None:
            hit = hit & scanned
        cum = torch.cumsum(hit.to(torch.int32), dim=-1, dtype=torch.int32)
        # index of the (s+1)-th hit = #{cum < s+1} on the monotone count
        idx = torch.searchsorted(
            cum, targets.expand(*cum.shape[:2], nsample).contiguous()
        ).to(torch.int32)
        cnt = cum[..., -1:]
        first = torch.where(cnt > 0, idx[..., :1], torch.zeros_like(idx[..., :1]))
        # slots past the hit count copy the first hit; no hit -> 0
        outs.append(torch.where(targets <= cnt, idx, first))
    return torch.cat(outs, dim=1)


# ball_query.cu's flat query: points a box (a lane each), bitmap words a
# lane reads a walk step (a radius's bitmap is a multiple of them), frames of
# at most _FLAT_UNSORTED points served a lane per center in index order
# without the sort pre-pass (the model's small tables are FPS samples, which
# no box culls, and the pre-pass would cost more than it saves), the warps
# a block tried in turn while the layout does not fit, the radii one launch
# serves, and threads resident on an SM at most
_FLAT_TILE = 32
_FLAT_WALK_WORDS = 4
_FLAT_UNSORTED = 512
_FLAT_WARPS = (32, 16, 8)
_FLAT_LANE_WARPS = 4  # a lane per center: small blocks, many of them (all
# 128 threads stage the frame, also where a frame has fewer centers)
_FLAT_MAX_RADII = 3
_SM_THREADS = 2048


@functools.lru_cache(maxsize=64)
def _flat_plan(B: int, N: int, M: int, R: int, sms: int) -> dict:
    """The flat query's launch plan for R radii on `sms` SMs. `sort`: the
    pre-pass orders each frame along the Morton curve into `tiles` of 32
    points with boxes, and a box per 32 tiles (`supers`), for frames past
    _FLAT_UNSORTED points (or past 65535 frames), served a warp per center
    (smaller frames: a lane per center, in index order); `staged`: each
    frame (sorted points and boxes, or the unsorted frame) is staged in
    shared memory, else the pre-pass's output is read through L1; `warps`
    a block (the most of _FLAT_WARPS whose layout fits); `words` bitmap
    words a radius and warp of a sorted frame (its indices, or windows of
    32 x words of them where even the smallest block's bitmaps would not
    fit); `smem` dynamic bytes (the staged points, 16 x 32 bytes a tile,
    and boxes, 32 bytes each, then the bitmaps; unsorted, 16 bytes a
    point); `blocks`: enough for the SMs' resident blocks, no more than
    gives each warp a center; a lane per center takes `blocks` a frame of
    _FLAT_LANE_WARPS warps. Raises ValueError for what the kernel does not
    take."""
    if not 1 <= R <= _FLAT_MAX_RADII or min(B, N, M) < 0 or sms < 1:
        raise ValueError(f"ball_query: B={B}, N={N}, M={M}, R={R} (1..{_FLAT_MAX_RADII} "
                         f"radii a launch)")
    tiles = -(-N // _FLAT_TILE)
    sort = N > _FLAT_UNSORTED or B > 65535  # a lane per center: frames on the grid's y
    supers = -(-tiles // 32) if sort else 0
    words = max(1, -(-tiles // _FLAT_WALK_WORDS)) * _FLAT_WALK_WORDS if sort else 0
    frame = 16 * _FLAT_TILE * tiles + 32 * (tiles + supers) if sort else 16 * N
    fits = [w for w in _FLAT_WARPS if frame + 4 * w * R * words <= _build.SMEM_LIMIT]
    staged = bool(fits)
    if staged:
        warps, smem = fits[0], frame + 4 * fits[0] * R * words
    else:
        fits = [w for w in _FLAT_WARPS if 4 * w * R * words <= _build.SMEM_LIMIT]
        warps = fits[0] if fits else _FLAT_WARPS[-1]
        if not fits:  # windows of the index range
            words = _build.SMEM_LIMIT // (4 * warps * R) // _FLAT_WALK_WORDS * _FLAT_WALK_WORDS
        smem = 4 * warps * R * words
    resident = max(1, min(_SM_THREADS // (32 * warps),
                          (_build.SMEM_LIMIT + 1024) // (smem + 1024)))
    if not sort:  # `blocks` a frame, a lane per center
        warps = _FLAT_LANE_WARPS
        blocks = max(1, -(-M // (32 * warps)))
    else:
        blocks = max(1, min(sms * resident, -(-B * M // warps)))
    return dict(sort=sort, staged=staged, warps=warps, words=words, tiles=tiles, supers=supers,
                blocks=blocks, smem=smem)


@functools.lru_cache(maxsize=256)
def _r2(radius: float) -> float:
    """The float32 r^2 that membership compares with (d^2 < r^2)."""
    return _f32(radius * radius)


def _ball_query_kernel(radii, nsamples, xyz: torch.Tensor,
                       new_xyz: torch.Tensor):
    dev = xyz.device
    _build.require(xyz, "xyz", torch.float32, 3, dev)
    _build.require(new_xyz, "new_xyz", torch.float32, 3, dev)
    B, N, C = xyz.shape
    M = new_xyz.shape[1]
    if C != 3 or new_xyz.shape[0] != B or new_xyz.shape[2] != 3 or len(radii) != len(nsamples):
        raise ValueError(f"ball_query: xyz {tuple(xyz.shape)}, new_xyz "
                         f"{tuple(new_xyz.shape)}, radii {radii}, nsamples {nsamples}")
    if any(s < 1 for s in nsamples):
        raise ValueError(f"ball_query: nsamples {nsamples}")
    outs = [torch.empty((B, M, s), dtype=torch.int32, device=dev) for s in nsamples]
    if B == 0 or M == 0:
        return tuple(outs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = _build.library()
    # one distance pass serves up to three radii
    for i in range(0, len(radii), _FLAT_MAX_RADII):
        rs, ss, os_ = (radii[i:i + _FLAT_MAX_RADII], nsamples[i:i + _FLAT_MAX_RADII],
                       outs[i:i + _FLAT_MAX_RADII])
        plan = _flat_plan(B, N, M, len(rs), sms)
        args = []
        for k in range(_FLAT_MAX_RADII):
            args += [_r2(rs[k]), ss[k], os_[k].data_ptr()] if k < len(rs) else [0.0, 0, None]
        sorted_ptr = boxes_ptr = None
        if plan["sort"]:  # the pre-pass's sorted frames, then their boxes
            rows = _FLAT_TILE * plan["tiles"]
            scratch = torch.empty((B, rows + 2 * (plan["tiles"] + plan["supers"]), 4),
                                  dtype=torch.float32, device=dev)
            sorted_ptr = scratch.data_ptr()
            boxes_ptr = sorted_ptr + 16 * B * rows
            _build.launch_counts["ball_query_sort"] += 1
        _build.launch_counts["ball_query"] += 1
        _build.check(lib.g4d_ball_query(
            xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, len(rs), *args, int(plan["sort"]),
            int(plan["staged"]), plan["warps"], plan["words"], plan["blocks"], plan["smem"],
            sorted_ptr, boxes_ptr, _build.stream_of(xyz)), "ball_query")
    return tuple(outs)


_MAX_GROUPED_RADII = 3
# ball_query.cu's grouped kernel: warps per block (one center each at a
# time), rows a warp tests per step, rows staged in shared memory at most
# (two blocks' share of an SM, as float4s; later rows are read through
# L1), waves of two blocks per SM aimed at
_GROUPED_WARPS = 16
_GROUPED_STEP = 128
_GROUPED_ROWS = _build.SMEM_TWO_BLOCKS // 16
_GROUPED_WAVES = 4


@functools.lru_cache(maxsize=64)
def _grouped_plan(B: int, N: int, M: int, nsamples: tuple, sms: int) -> dict:
    """The grouped query's launch plan on `sms` SMs; raises ValueError for
    radius counts the kernel does not take. `blocks` per frame, enough for
    _GROUPED_WAVES waves of two blocks per SM over the B frames but no more
    than gives each warp a center, each walking the frame's centers
    blocks apart; `rows` rows staged (N rounded up to whole steps of
    _GROUPED_STEP rows, at most _GROUPED_ROWS; smem bytes)."""
    if not 1 <= len(nsamples) <= _MAX_GROUPED_RADII or any(s < 1 for s in nsamples):
        raise ValueError(f"ball_query_grouped: nsamples {nsamples} (1..{_MAX_GROUPED_RADII} "
                         f"radii)")
    rows = min(-(-N // _GROUPED_STEP) * _GROUPED_STEP, _GROUPED_ROWS)
    blocks = max(1, min(-(-_GROUPED_WAVES * 2 * sms // max(B, 1)), -(-M // _GROUPED_WARPS)))
    return dict(warps=_GROUPED_WARPS, rows=rows, smem=16 * rows, blocks=blocks)


def _ball_query_grouped_kernel(radii, nsamples, xyz: torch.Tensor,
                               new_xyz: torch.Tensor, n_valid: torch.Tensor):
    dev = xyz.device
    _build.require(xyz, "xyz", torch.float32, 3, dev)
    _build.require(new_xyz, "new_xyz", torch.float32, 3, dev)
    _build.require(n_valid, "n_valid", torch.int32, 1, dev)
    B, N, C = xyz.shape
    M = new_xyz.shape[1]
    if C != 3 or new_xyz.shape[0] != B or new_xyz.shape[2] != 3 or n_valid.shape[0] != B:
        raise ValueError(f"ball_query_grouped: xyz {tuple(xyz.shape)}, new_xyz "
                         f"{tuple(new_xyz.shape)}, n_valid {tuple(n_valid.shape)}")
    R = len(radii)
    if len(nsamples) != R:
        raise ValueError(f"ball_query_grouped: radii {radii}, nsamples {nsamples}")
    plan = _grouped_plan(B, N, M, tuple(nsamples),
                         torch.cuda.get_device_properties(dev).multi_processor_count)
    outs = [torch.empty((B, M, s), dtype=torch.int32, device=dev) for s in nsamples]
    args = []
    for i in range(_MAX_GROUPED_RADII):
        if i < R:
            args += [_f32(radii[i] * radii[i]), nsamples[i], outs[i].data_ptr()]
        else:
            args += [0.0, 0, None]
    lib = _build.library()
    _build.launch_counts["ball_query_grouped"] += 1
    _build.check(lib.g4d_ball_query_grouped(
        xyz.data_ptr(), new_xyz.data_ptr(), n_valid.data_ptr(), B, N, M, R,
        *args, plan["blocks"], plan["warps"], plan["rows"], _build.stream_of(xyz)),
        "ball_query_grouped")
    return tuple(outs)


def ball_query_multi(radii: Sequence[float], nsamples: Sequence[int],
                     xyz: torch.Tensor, new_xyz: torch.Tensor,
                     n_valid: Optional[torch.Tensor] = None) -> tuple:
    """Several ball queries over the same (xyz, new_xyz): a tuple of
    (B, M, nsample_i) int32. Per center: the first nsample in-radius point
    indices (d^2 < r^2) in index order, tail slots copying the first hit,
    no hit -> all 0. Non-differentiable.

    `n_valid` (B,) int, optional: only the leading n_valid[b] rows of frame
    b are scanned (a compacted table padded with far sentinels; the count
    stays on the device). With it, the kernel is the grouped query;
    without it, the flat query. Each serves up to three radii in one
    distance pass."""
    radii = tuple(float(r) for r in radii)
    nsamples = tuple(int(s) for s in nsamples)
    xyz, new_xyz = xyz.detach(), new_xyz.detach()
    if use_kernel(xyz):
        if n_valid is not None:
            return _ball_query_grouped_kernel(
                radii, nsamples, xyz.contiguous(), new_xyz.contiguous(),
                n_valid.to(torch.int32).contiguous())
        return _ball_query_kernel(radii, nsamples, xyz.contiguous(),
                                  new_xyz.contiguous())
    return tuple(_ball_query_plain(r, s, xyz, new_xyz, n_valid)
                 for r, s in zip(radii, nsamples))


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """xyz (B, N, 3), new_xyz (B, M, 3) -> idx (B, M, nsample) int32."""
    return ball_query_multi((radius,), (nsample,), xyz, new_xyz)[0]


def query_and_group(radius: float, nsample: int, xyz: torch.Tensor,
                    new_xyz: torch.Tensor,
                    features: Optional[torch.Tensor] = None,
                    use_xyz: bool = True) -> torch.Tensor:
    """Ball query then group: (B, M, S, 3 + C) centred xyz (+ features)."""
    idx = ball_query(radius, nsample, xyz, new_xyz)
    if features is not None:
        if use_xyz:
            packed = torch.cat([xyz, features], dim=-1)
            grouped = group_points(packed, idx)
            centred = grouped[..., :3] - new_xyz[:, :, None, :]
            return torch.cat([centred, grouped[..., 3:]], dim=-1)
        return group_points(features, idx)
    if not use_xyz:
        raise ValueError("cannot have no features and not use xyz")
    return group_points(xyz, idx) - new_xyz[:, :, None, :]


def group_all(xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
              use_xyz: bool = True) -> torch.Tensor:
    """The whole set as one neighbourhood: (B, 1, N, 3 + C)."""
    grouped = xyz[:, None]
    if features is not None:
        feats = features[:, None]
        return torch.cat([grouped, feats], dim=-1) if use_xyz else feats
    return grouped


# ---------------------------------------------------------------------------
# coverage mask
# ---------------------------------------------------------------------------


def _covered_mask_plain(xyz: torch.Tensor, centers: torch.Tensor,
                        radius: float) -> torch.Tensor:
    r2 = _f32(radius * radius)
    outs = []
    for p0 in range(0, xyz.shape[1], _CHUNK):
        d2 = _sqdist(xyz[:, p0:p0 + _CHUNK, None, :], centers[:, None, :, :])
        outs.append((d2 < r2).any(dim=-1))
    return torch.cat(outs, dim=1).to(torch.int32)


# coverage.cu: centers per box (a warp's lanes; the C entry refuses
# another), the most staged at a time (64 KB), threads per block (a point
# each), and the tiles more of a warp's points need than this are tested a
# point a lane, the others a center a lane
_COVERAGE_TILE = 32
_COVERAGE_MAX_CHUNK = 4096
_COVERAGE_THREADS = 512
_COVERAGE_DENSE = 16


@functools.lru_cache(maxsize=64)
def _coverage_plan(B: int, N: int, M: int) -> dict:
    """The coverage kernel's launch plan: `blocks` per frame of `threads`
    threads (a point each), `chunk` centers staged at a time in whole
    `tile`s, `dense` (a tile that more of a warp's open points need is
    tested a point a lane), `smem` dynamic bytes (the chunk, its boxes, the
    block's points and the sort's counts). Raises ValueError for what the
    kernel does not take (negative sizes, B past the grid's y)."""
    if min(B, N, M) < 0 or B > 65535:
        raise ValueError(f"covered_mask: B={B}, N={N}, M={M} (B <= 65535)")
    threads, tile = _COVERAGE_THREADS, _COVERAGE_TILE
    chunk = min(max(-(-M // tile) * tile, tile), _COVERAGE_MAX_CHUNK)
    smem = 16 * chunk + 32 * (chunk // tile) + 16 * threads + 4 * _MORTON_CODES
    return dict(threads=threads, blocks=-(-N // threads), tile=tile, chunk=chunk,
                dense=_COVERAGE_DENSE, smem=smem)


def _box_lower_bound(p: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The box culls' lower bound (coverage.cu, fps.cu) on the squared
    distance from points p (..., 3) to every point in the box [lo, hi]
    (..., 3), float32 as the kernels compute it (`common.cuh: box_gap`): per
    axis the gap max(max(lo
    - p, p - hi), 0), NaN where p is NaN, then the gaps' squares summed as
    `_sqdist` sums (the kernel skips a tile of centers where it is >= r^2,
    never where it is NaN)."""
    g = torch.maximum(torch.maximum(lo - p, p - hi), torch.zeros((), dtype=p.dtype))
    gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]
    return gx * gx + gy * gy + gz * gz


def _covered_mask_kernel(xyz: torch.Tensor, centers: torch.Tensor,
                         radius: float) -> torch.Tensor:
    dev = xyz.device
    _build.require(xyz, "xyz", torch.float32, 3, dev)
    _build.require(centers, "centers", torch.float32, 3, dev)
    B, N, C = xyz.shape
    M = centers.shape[1]
    if C != 3 or centers.shape[0] != B or centers.shape[2] != 3:
        raise ValueError(f"covered_mask: xyz {tuple(xyz.shape)}, "
                         f"centers {tuple(centers.shape)}")
    plan = _coverage_plan(B, N, M)
    out = torch.empty((B, N), dtype=torch.int32, device=dev)
    if B == 0 or N == 0:
        return out
    lib = _build.library()
    _build.launch_counts["coverage"] += 1
    _build.check(lib.g4d_coverage(
        xyz.data_ptr(), centers.data_ptr(), B, N, M, _f32(radius * radius), plan["threads"],
        plan["blocks"], plan["tile"], plan["chunk"], plan["dense"], plan["smem"],
        out.data_ptr(), _build.stream_of(xyz)), "coverage")
    return out


def covered_mask(xyz: torch.Tensor, centers: torch.Tensor,
                 radius: float) -> torch.Tensor:
    """xyz (B, N, 3), centers (B, M, 3) -> (B, N) int32: 1 iff the point
    lies at d^2 < r^2 of at least one center. Non-differentiable."""
    xyz, centers = xyz.detach(), centers.detach()
    if use_kernel(xyz):
        return _covered_mask_kernel(xyz.contiguous(), centers.contiguous(),
                                    float(radius))
    return _covered_mask_plain(xyz, centers, float(radius))


# ---------------------------------------------------------------------------
# three-NN interpolation
# ---------------------------------------------------------------------------


def _finite_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`_sqdist` with NaN read as +inf: the nearest-neighbour searches never
    take a NaN distance (a NaN point or query), as their kernels do not."""
    d2 = _sqdist(a, b)
    return torch.where(d2.isnan(), torch.inf, d2)


def _three_nn_plain(unknown: torch.Tensor, known: torch.Tensor):
    """Squared distances and indices of the 3 nearest, by three rounds of
    min + lowest index attaining it (no topk: its tie order is not fixed).
    NaN and infinite distances are never taken: a slot that no finite
    distance fills holds (+inf, 0), as in the kernel (`g4d::Nearest`). The
    JAX package's paths disagree on NaN input (its XLA path skips NaN
    points, as here)."""
    m = known.shape[1]
    iota = torch.arange(m, device=known.device)
    dists, idxs = [], []
    for q0 in range(0, unknown.shape[1], _CHUNK):
        # a round that finds no finite distance takes index 0 (every entry
        # is +inf there), so the scatter never reads past m
        d2 = _finite_sqdist(unknown[:, q0:q0 + _CHUNK, None, :], known[:, None, :, :])
        ds, ix = [], []
        for _ in range(3):
            best = d2.min(dim=-1, keepdim=True).values
            bidx = torch.where(d2 <= best, iota, m).min(dim=-1, keepdim=True).values
            ds.append(best)
            ix.append(bidx)
            d2 = d2.scatter(-1, bidx, float("inf"))
        dists.append(torch.cat(ds, dim=-1))
        idxs.append(torch.cat(ix, dim=-1))
    return torch.cat(dists, dim=1), torch.cat(idxs, dim=1).to(torch.int32)


# three_nn.cu and nn1.cu (common.cuh's `nearest_query`): known points a box
# (the C entries refuse another), warps a block (a query a lane), and known
# sets of at most _NEAREST_UNSORTED points scanned whole by each query in
# index order, in blocks of _NEAREST_SCAN_WARPS warps (the sort pre-pass and
# the culls would cost more than they save). 3-NN stages the known points
# in shared memory where two blocks' share of an SM holds them (with their
# boxes), else reads them through L1; 1-NN's rule is at `_nn1_plan`
_NEAREST_TILE = 8
_NEAREST_WARPS = 8
_NEAREST_SCAN_WARPS = 4
_NEAREST_UNSORTED = 256


@functools.lru_cache(maxsize=64)
def _three_nn_plan(B: int, n: int, m: int) -> dict:
    """The 3-NN kernel's launch plan: `tile` known points a box, `tiles` of
    them; `sort`: the pre-pass orders the known points and the queries
    along the Morton curve and the walk culls tiles (known sets past
    _NEAREST_UNSORTED points; smaller ones are scanned whole); blocks of
    `warps` warps over each frame's queries; `staged`: the known points
    (16 x tile bytes a tile) and, sorted, their boxes (32 bytes a tile;
    `smem` in all) in shared memory when two blocks' share of an SM holds
    them, else read through L1. Raises ValueError for what the kernel does
    not take (m < 3, B past the grid's y)."""
    if m < 3 or n < 0 or not 0 <= B <= 65535:
        raise ValueError(f"three_nn: B={B}, n={n}, m={m} (m >= 3, B <= 65535)")
    tiles = -(-m // _NEAREST_TILE)
    sort = m > _NEAREST_UNSORTED
    smem = 16 * (_NEAREST_TILE + (2 if sort else 0)) * tiles
    staged = smem <= _build.SMEM_TWO_BLOCKS
    return dict(tile=_NEAREST_TILE, tiles=tiles, sort=sort,
                warps=_NEAREST_WARPS if sort else _NEAREST_SCAN_WARPS, staged=staged,
                smem=smem if staged else 0)


def _nearest_kernel(name: str, K: int, plan: dict, unknown: torch.Tensor,
                    known: torch.Tensor):
    """Launch `name`'s nearest-neighbour search (`three_nn.cu`, `nn1.cu`:
    common.cuh's `launch_nearest`) under `plan`: squared distances and
    indices of each query's K nearest, (B, n, K), or (B, n) for K = 1.
    Counts `name`, and `name`_sort where the plan runs the pre-pass."""
    dev = unknown.device
    B, n, _ = unknown.shape
    shape = (B, n, K) if K > 1 else (B, n)
    dist2 = torch.empty(shape, dtype=torch.float32, device=dev)
    idx = torch.empty(shape, dtype=torch.int32, device=dev)
    if B == 0 or n == 0:
        return dist2, idx
    sorted_k = boxes = sorted_q = own = None
    if plan["sort"]:  # the pre-pass's sorted known points, their boxes,
        # the sorted queries (float4 each), then each query's own tile (int32)
        rows = plan["tile"] * plan["tiles"]
        scratch = torch.empty(B * (4 * (rows + 2 * plan["tiles"] + n) + n), dtype=torch.float32,
                              device=dev)
        sorted_k = scratch.data_ptr()
        boxes = sorted_k + 16 * B * rows
        sorted_q = boxes + 32 * B * plan["tiles"]
        own = sorted_q + 16 * B * n
    lib = _build.library()
    _build.launch_counts[name] += 1
    if plan["sort"]:
        _build.launch_counts[name + "_sort"] += 1
    _build.check(getattr(lib, "g4d_" + name)(
        unknown.data_ptr(), known.data_ptr(), B, n, known.shape[1], plan["tile"],
        int(plan["sort"]), plan["warps"], int(plan["staged"]), plan["smem"], sorted_k, boxes,
        sorted_q, own, dist2.data_ptr(), idx.data_ptr(), _build.stream_of(unknown)), name)
    return dist2, idx


def _three_nn_kernel(unknown: torch.Tensor, known: torch.Tensor):
    dev = unknown.device
    _build.require(unknown, "unknown", torch.float32, 3, dev)
    _build.require(known, "known", torch.float32, 3, dev)
    B, n, _ = unknown.shape
    m = known.shape[1]
    if unknown.shape[2] != 3 or known.shape[0] != B or known.shape[2] != 3 or m < 3:
        raise ValueError(f"three_nn: unknown {tuple(unknown.shape)}, "
                         f"known {tuple(known.shape)}")
    return _nearest_kernel("three_nn", 3, _three_nn_plan(B, n, m), unknown, known)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """Exact 3 nearest neighbours of `unknown` (B, N, 3) in `known`
    (B, M, 3) -> (dist (B, N, 3) EUCLIDEAN distances ascending, idx (B, N, 3)
    int32, ties to the lower index). Non-differentiable."""
    unknown, known = unknown.detach(), known.detach()
    if use_kernel(unknown):
        dist2, idx = _three_nn_kernel(unknown.contiguous(), known.contiguous())
    else:
        dist2, idx = _three_nn_plain(unknown, known)
    return torch.sqrt(dist2), idx


# ---------------------------------------------------------------------------
# k nearest neighbours
# ---------------------------------------------------------------------------


def _nn1_plain(query: torch.Tensor, points: torch.Tensor):
    """Squared distance to and index of the nearest point: the min, then the
    lowest index attaining it (ties to the lower index). NaN and infinite
    distances are never taken: a query with no finite distance (a NaN
    query, or only NaN points) gets (+inf, 0), bitwise the kernel's
    (`g4d::Nearest`). The JAX package's paths disagree there (`nn1_pallas`
    gives NaN and an index past N, its XLA path NaN and the NaN point's
    index)."""
    n = points.shape[1]
    iota = torch.arange(n, device=points.device)
    dists, idxs = [], []
    for q0 in range(0, query.shape[1], _CHUNK):
        d2 = _finite_sqdist(query[:, q0:q0 + _CHUNK, None, :], points[:, None, :, :])
        best = d2.min(dim=-1, keepdim=True).values
        dists.append(best[..., 0])
        idxs.append(torch.where(d2 <= best, iota, n).min(dim=-1).values)
    return torch.cat(dists, dim=1), torch.cat(idxs, dim=1).to(torch.int32)


# nn1.cu stages the sorted points and boxes in shared memory where
# _NN1_STAGE_LIMIT bytes hold them (one block an SM), with blocks wide
# enough that B frames' blocks fit on the SMs; else they are read through
# L1. Staging the body won on an H100 80GB HBM3 at 700 W: the posed train
# step's (40, 2000) vs 6890 in 0.0585 ms staged against 0.0693 through L1
# (3-NN's limit of two blocks an SM), `chip_smoke.py --time-kernels`.
_NN1_STAGE_LIMIT = _build.SMEM_LIMIT


@functools.lru_cache(maxsize=64)
def _nn1_plan(B: int, M: int, N: int, sms: int) -> dict:
    """The 1-NN kernel's launch plan on `sms` SMs: `tile` points a box,
    `tiles` of them; `sort`: the pre-pass orders the points and the queries
    along the Morton curve and the walk culls tiles (sets past
    _NEAREST_UNSORTED points; smaller ones are scanned whole in index
    order); blocks of `warps` warps over each frame's queries (staged and
    sorted: the fewest that keep B frames' blocks on the SMs at one a SM,
    8 at least, 32 at most); `staged`: the points (16 x tile bytes a tile)
    and, sorted, their boxes (32 bytes a tile; `smem` in all) in shared
    memory when _NN1_STAGE_LIMIT bytes hold them, else read through L1.
    Takes any N >= 1, M >= 0 and B up to the grid's 65535; raises
    ValueError for the rest."""
    if N < 1 or M < 0 or not 0 <= B <= 65535:
        raise ValueError(f"nn1: B={B}, M={M}, N={N} (N >= 1, B <= 65535)")
    tiles = -(-N // _NEAREST_TILE)
    sort = N > _NEAREST_UNSORTED
    smem = 16 * (_NEAREST_TILE + (2 if sort else 0)) * tiles
    staged = smem <= _NN1_STAGE_LIMIT
    if not sort:
        warps = _NEAREST_SCAN_WARPS
    elif staged:  # a block a SM: as few frames' blocks as the SMs hold
        per_frame = max(1, -(-M // 32))
        warps = min(32, max(_NEAREST_WARPS, -(-per_frame // max(1, sms // max(B, 1)))))
    else:
        warps = _NEAREST_WARPS
    return dict(tile=_NEAREST_TILE, tiles=tiles, sort=sort, warps=warps, staged=staged,
                smem=smem if staged else 0)


def _nn1_kernel(query: torch.Tensor, points: torch.Tensor):
    _build.refuse_grad("nn1", query, points)
    dev = query.device
    _build.require(query, "query", torch.float32, 3, dev)
    _build.require(points, "points", torch.float32, 3, dev)
    B, M, _ = query.shape
    N = points.shape[1]
    if query.shape[2] != 3 or points.shape[0] != B or points.shape[2] != 3 or N < 1:
        raise ValueError(f"nn1: query {tuple(query.shape)}, points {tuple(points.shape)}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _nearest_kernel("nn1", 1, _nn1_plan(B, M, N, sms), query, points)


class _NN1(torch.autograd.Function):
    """1-NN squared distance and index; the gradient of the distance is
    2 (q - p[idx]) for the query and its negation, scattered, for the
    points (JAX's `_nn1_bwd`, plain torch on every device)."""

    @staticmethod
    def forward(ctx, query, points):
        if use_kernel(query):  # the backward is plain torch on every path
            d2, idx = _nn1_kernel(query.contiguous(), points.contiguous())
        else:
            d2, idx = _nn1_plain(query, points)
        ctx.save_for_backward(query, points, idx)
        ctx.mark_non_differentiable(idx)
        return d2, idx

    @staticmethod
    def backward(ctx, g, _g_idx):
        query, points, idx = ctx.saved_tensors
        dq = 2.0 * (query - _gather_rows_plain(points, idx)) * g[..., None]
        dp = None
        if ctx.needs_input_grad[1]:
            B, N, _ = points.shape
            flat = (idx.long() + N * torch.arange(B, device=idx.device)[:, None]).reshape(-1)
            dp = torch.zeros_like(points).reshape(B * N, 3).index_add_(
                0, flat, -dq.reshape(-1, 3)).reshape(B, N, 3)
        return (dq if ctx.needs_input_grad[0] else None), dp


def knn_points(query: torch.Tensor, points: torch.Tensor, K: int = 1):
    """K nearest neighbours of `query` (B, M, 3) in `points` (B, N, 3) ->
    (dists (B, M, K) SQUARED distances ascending, idx (B, M, K) int32).
    Differentiable in the distances. K=1 is the 1-NN kernel on the card
    (counters `nn1` and, past _NEAREST_UNSORTED points, `nn1_sort`; diff-form
    fp32, ties to the lower index, NaN distances never taken, any N); K > 1
    is plain `pairwise_sqdist` and a stable sort, ties to the lower index
    (as XLA's top-k)."""
    if K == 1:
        d2, idx = _NN1.apply(query, points)
        return d2[..., None], idx[..., None]
    d2, idx = torch.sort(pairwise_sqdist(query, points), dim=-1, stable=True)
    return d2[..., :K], idx[..., :K].to(torch.int32)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted 3-NN interpolation: features (B, M, C), idx (B, N, 3),
    weight (B, N, 3) -> (B, N, C). The row gather is the kernel; the
    weighted sum is written out in neighbour order."""
    g = group_points(features, idx)  # (B, N, 3, C)
    w = weight[..., None]
    return g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1] + g[:, :, 2] * w[:, :, 2]


def interp_weights_from_dists(dist: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights, normalised over the last axis."""
    recip = 1.0 / (dist + eps)
    return recip / recip.sum(dim=-1, keepdim=True)
