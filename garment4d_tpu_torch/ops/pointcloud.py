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


def _fps_kernel(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    dev = xyz.device
    _build.require(xyz, "xyz", torch.float32, 3, dev)
    B, N, C = xyz.shape
    if C != 3 or not 1 <= npoint <= N:
        raise ValueError(f"fps: xyz {tuple(xyz.shape)}, npoint {npoint}")
    if 16 * N > 232448:
        raise ValueError(f"fps: N={N} exceeds the kernel's shared memory")
    out = torch.empty((B, npoint), dtype=torch.int32, device=dev)
    lib = _build.library()
    _build.launch_counts["fps"] += 1
    _build.check(lib.g4d_fps(xyz.data_ptr(), B, N, npoint, out.data_ptr(),
                             _build.stream_of(xyz)), "fps")
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative furthest point sampling: xyz (B, N, 3) f32 -> (B, npoint)
    int32. Starts at index 0, running min-distance, argmax each step with
    ties to the lowest index. Non-differentiable."""
    xyz = xyz.detach()
    if use_kernel(xyz):
        return _fps_kernel(xyz.contiguous(), int(npoint))
    return _fps_plain(xyz, int(npoint))


# ---------------------------------------------------------------------------
# gather / grouping
# ---------------------------------------------------------------------------


def _gather_rows_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    C = points.shape[-1]
    ix = idx.long()[..., None].expand(*idx.shape, C)
    return torch.gather(points, 1, ix)


def _gather_rows_kernel(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _build.refuse_grad("gather_rows", points)
    dev = points.device
    _build.require(points, "points", torch.float32, 3, dev)
    _build.require(idx, "idx", torch.int32, 2, dev)
    B, N, C = points.shape
    if idx.shape[0] != B:
        raise ValueError(f"gather: batch mismatch {tuple(points.shape)} vs {tuple(idx.shape)}")
    R = idx.shape[1]
    out = torch.empty((B, R, C), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.launch_counts["gather_rows"] += 1
    _build.check(lib.g4d_gather_rows(points.data_ptr(), idx.data_ptr(), B, N,
                                     C, R, out.data_ptr(),
                                     _build.stream_of(points)), "gather_rows")
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
                            n: int) -> torch.Tensor:
    """`index_add_` on the flattened rows; indices outside [0, n) go to a
    spare row that is dropped. On the CPU it adds in index order, from 0.0,
    the order the kernel keeps; on the card it uses atomics."""
    B, R, C = grads.shape
    flat = idx.long() + n * torch.arange(B, device=idx.device)[:, None]
    valid = (idx >= 0) & (idx < n)
    flat = torch.where(valid, flat, torch.full_like(flat, B * n))
    out = torch.zeros((B * n + 1, C), dtype=grads.dtype, device=grads.device)
    out.index_add_(0, flat.reshape(-1), grads.reshape(B * R, C))
    return out[:B * n].reshape(B, n, C)


def _scatter_add_rows_kernel(grads: torch.Tensor, idx: torch.Tensor,
                             n: int) -> torch.Tensor:
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
        grads.data_ptr(), idx.data_ptr(), B, R, C, n, V, J, lanes, order.data_ptr(),
        start.data_ptr(), None if hist is None else hist.data_ptr(), out.data_ptr(),
        _build.stream_of(grads)), "scatter_add")
    return out


def scatter_add_rows(grads: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """grads (B, R, C), idx (B, R) int -> (B, n, C): out[b, i] = the sum of
    grads[b, r] over the r with idx[b, r] == i, in ascending r from 0.0;
    indices outside [0, n) are dropped (the backward of a row gather, as
    JAX's `_gather_rows` VJP). The kernel is bitwise the CPU's sum and
    repeats bitwise; the plain version on the card (atomics) does not."""
    if use_kernel(grads):
        return _scatter_add_rows_kernel(grads.contiguous(),
                                        idx.to(torch.int32).contiguous(), int(n))
    return _scatter_add_rows_plain(grads, idx, int(n))


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
            return scatter_add_rows(g, idx, ctx.n), None


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M) int -> (B, M, C): out[b, m] =
    points[b, idx[b, m]]. Differentiable in `points`: the backward is
    `scatter_add_rows`, the deterministic scatter-add kernel on the card."""
    return _GatherRows.apply(points, idx)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M, S) int -> (B, M, S, C)."""
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


def _ball_query_kernel(radii, nsamples, xyz: torch.Tensor,
                       new_xyz: torch.Tensor):
    dev = xyz.device
    _build.require(xyz, "xyz", torch.float32, 3, dev)
    _build.require(new_xyz, "new_xyz", torch.float32, 3, dev)
    B, N, C = xyz.shape
    M = new_xyz.shape[1]
    if C != 3 or new_xyz.shape[0] != B or new_xyz.shape[2] != 3:
        raise ValueError(f"ball_query: xyz {tuple(xyz.shape)}, "
                         f"new_xyz {tuple(new_xyz.shape)}")
    if any(s < 1 for s in nsamples):
        raise ValueError(f"ball_query: nsamples {nsamples}")
    lib = _build.library()
    outs = [torch.empty((B, M, s), dtype=torch.int32, device=dev)
            for s in nsamples]
    # one distance pass serves two radii
    for i in range(0, len(radii), 2):
        ra, sa, oa = _f32(radii[i] * radii[i]), nsamples[i], outs[i]
        if i + 1 < len(radii):
            rb, sb, ob = (_f32(radii[i + 1] * radii[i + 1]), nsamples[i + 1],
                          outs[i + 1].data_ptr())
        else:
            rb, sb, ob = 0.0, 0, None
        _build.launch_counts["ball_query"] += 1
        _build.check(lib.g4d_ball_query(
            xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, ra, sa,
            oa.data_ptr(), rb, sb, ob, _build.stream_of(xyz)), "ball_query")
    return tuple(outs)


_MAX_GROUPED_RADII = 3


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
    if not 1 <= R <= _MAX_GROUPED_RADII or any(s < 1 for s in nsamples):
        raise ValueError(f"ball_query_grouped: radii {radii}, nsamples {nsamples} "
                         f"(1..{_MAX_GROUPED_RADII} radii)")
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
        *args, _build.stream_of(xyz)), "ball_query_grouped")
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
    stays on the device). With it, the kernel is the grouped query, which
    serves up to three radii in one distance pass; without it, the flat
    query, which shares each pass between two radii."""
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
    out = torch.empty((B, N), dtype=torch.int32, device=dev)
    lib = _build.library()
    _build.launch_counts["coverage"] += 1
    _build.check(lib.g4d_coverage(xyz.data_ptr(), centers.data_ptr(), B, N, M,
                                  _f32(radius * radius), out.data_ptr(),
                                  _build.stream_of(xyz)), "coverage")
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


def _three_nn_plain(unknown: torch.Tensor, known: torch.Tensor):
    """Squared distances and indices of the 3 nearest, by three rounds of
    min + lowest index attaining it (no topk: its tie order is not fixed)."""
    m = known.shape[1]
    iota = torch.arange(m, device=known.device)
    dists, idxs = [], []
    for q0 in range(0, unknown.shape[1], _CHUNK):
        d2 = _sqdist(unknown[:, q0:q0 + _CHUNK, None, :], known[:, None, :, :])
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


def _three_nn_kernel(unknown: torch.Tensor, known: torch.Tensor):
    dev = unknown.device
    _build.require(unknown, "unknown", torch.float32, 3, dev)
    _build.require(known, "known", torch.float32, 3, dev)
    B, n, _ = unknown.shape
    m = known.shape[1]
    if unknown.shape[2] != 3 or known.shape[0] != B or known.shape[2] != 3 or m < 3:
        raise ValueError(f"three_nn: unknown {tuple(unknown.shape)}, "
                         f"known {tuple(known.shape)}")
    dist2 = torch.empty((B, n, 3), dtype=torch.float32, device=dev)
    idx = torch.empty((B, n, 3), dtype=torch.int32, device=dev)
    lib = _build.library()
    _build.launch_counts["three_nn"] += 1
    _build.check(lib.g4d_three_nn(unknown.data_ptr(), known.data_ptr(), B, n,
                                  m, dist2.data_ptr(), idx.data_ptr(),
                                  _build.stream_of(unknown)), "three_nn")
    return dist2, idx


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
    lowest index attaining it (ties to the lower index)."""
    n = points.shape[1]
    iota = torch.arange(n, device=points.device)
    dists, idxs = [], []
    for q0 in range(0, query.shape[1], _CHUNK):
        d2 = _sqdist(query[:, q0:q0 + _CHUNK, None, :], points[:, None, :, :])
        best = d2.min(dim=-1, keepdim=True).values
        dists.append(best[..., 0])
        idxs.append(torch.where(d2 <= best, iota, n).min(dim=-1).values)
    return torch.cat(dists, dim=1), torch.cat(idxs, dim=1).to(torch.int32)


def _nn1_kernel(query: torch.Tensor, points: torch.Tensor):
    _build.refuse_grad("nn1", query, points)
    dev = query.device
    _build.require(query, "query", torch.float32, 3, dev)
    _build.require(points, "points", torch.float32, 3, dev)
    B, M, _ = query.shape
    N = points.shape[1]
    if query.shape[2] != 3 or points.shape[0] != B or points.shape[2] != 3 or N < 1:
        raise ValueError(f"nn1: query {tuple(query.shape)}, points {tuple(points.shape)}")
    d2 = torch.empty((B, M), dtype=torch.float32, device=dev)
    idx = torch.empty((B, M), dtype=torch.int32, device=dev)
    lib = _build.library()
    _build.launch_counts["nn1"] += 1
    _build.check(lib.g4d_nn1(query.data_ptr(), points.data_ptr(), B, M, N,
                             d2.data_ptr(), idx.data_ptr(), _build.stream_of(query)),
                 "nn1")
    return d2, idx


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
    (counter `nn1`; diff-form fp32, ties to the lower index, any N); K > 1
    is plain `pairwise_sqdist` + top-k."""
    if K == 1:
        d2, idx = _NN1.apply(query, points)
        return d2[..., None], idx[..., None]
    neg, idx = torch.topk(-pairwise_sqdist(query, points), K, dim=-1)
    return -neg, idx.to(torch.int32)


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
