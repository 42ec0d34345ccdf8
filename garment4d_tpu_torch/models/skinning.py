"""Interpolated linear blend skinning of the canonical garment.

Counterpart of `garment4d_tpu/models/skinning.py` (reference
`modules/mesh_encoder.py:312-410`): the body's skinning weights are carried
to every garment vertex by a 1/d^2-weighted average over its K nearest
T-pose body vertices, the garment is un-posed to the zero pose and re-posed
to every frame; the 100-step weight smoothing is one precomputed dense
operator.

The K-NN weight transfer is one op: a CUDA tensor launches the kernel
`ops/csrc/knn_transfer.cu` (a radix select per vertex, planned by
`_knn_plan`); a CPU tensor (or any tensor inside
`ops.plain_ops()`) runs `_knn_transfer_plain`, the JAX package's XLA
formulation (a K-th-smallest threshold by bisection on the f32 bit
patterns, index-ordered ties, a masked matmul).

`lbs_garment_single_nn` is the MGN variant's skinning (K = 1, per-frame
garments): the 1-NN kernel picks each garment vertex's nearest T-pose body
vertex and the row-gather kernel takes that vertex's 4x4 transforms.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from garment4d_tpu_torch.ops import _build
from garment4d_tpu_torch.ops.pointcloud import (
    group_points,
    knn_points,
    pairwise_sqdist,
    use_kernel,
)
from garment4d_tpu_torch.smpl.lbs import (
    batch_rigid_transform,
    batch_rodrigues,
    vertices2joints_b,
)


class LbsResult(NamedTuple):
    posed_garment: torch.Tensor      # (B, T, Vg, 3)
    nn_idx: torch.Tensor             # (B, Vg, 1) int32 nearest body vertex
    unposed_garment: torch.Tensor    # (B, T, Vg, 3) zero-pose garment


def _inverse_template_pose(batch: int, device) -> torch.Tensor:
    """The inverse of the dataset's template pose: root x-rot -pi/2, hips
    +/-0.15 about y. (batch, 24, 3)."""
    pose = torch.zeros((batch, 24, 3), device=device)
    pose[:, 0, 0] = -np.pi / 2
    pose[:, 1, 1] = 0.15
    pose[:, 2, 1] = -0.15
    return pose


def _normalize_inf_zeroed(w: torch.Tensor) -> torch.Tensor:
    """The reference's weight inf handling: zero infs, normalise over the
    last axis, zero infs."""
    w = torch.where(torch.isinf(w), torch.zeros_like(w), w)
    w = w / w.sum(dim=-1, keepdim=True)
    return torch.where(torch.isinf(w), torch.zeros_like(w), w)


def _kth_smallest_bits(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row k-th smallest of non-negative f32 bit patterns (int32) by a
    31-step bisection on the value: (..., N) -> (..., 1)."""
    lo = torch.zeros((*bits.shape[:-1], 1), dtype=torch.int32, device=bits.device)
    hi = torch.full_like(lo, 0x7F7FFFFF)  # f32 max
    for _ in range(31):
        mid = lo + (hi - lo) // 2
        found = (bits <= mid).sum(dim=-1, keepdim=True) >= k
        lo, hi = torch.where(found, lo, mid + 1), torch.where(found, mid, hi)
    return lo


def _masked_weight_transfer(d2: torch.Tensor, w0: torch.Tensor, k: int) -> torch.Tensor:
    """d2 (B, Vg, N) squared distances, w0 (B, N, J) -> (B, Vg, J): the
    normalised 1/d^2 average of w0 over each row's exact k nearest, ties at
    the k-th distance to the lower index."""
    d2 = d2.clamp_min(0.0)
    bits = d2.view(torch.int32)
    t = _kth_smallest_bits(bits, k)
    below = bits < t
    tie = bits == t
    extra = k - below.sum(dim=-1, keepdim=True)
    cum_tie = torch.cumsum(tie.to(torch.int32), dim=-1)
    sel = below | (tie & (cum_tie <= extra))
    w = _normalize_inf_zeroed(torch.where(sel, 1.0 / d2, torch.zeros_like(d2)))
    return torch.einsum("bvn,bnj->bvj", w, w0)


def _knn_transfer_plain(garment, body, w0, k: int, k64: int):
    d2 = pairwise_sqdist(garment, body)
    nn1_idx = torch.argmin(d2, dim=-1, keepdim=True).to(torch.int32)
    nn_w_k = _masked_weight_transfer(d2, w0, k)
    nn_w_64 = nn_w_k if k64 == k else _masked_weight_transfer(d2, w0, k64)
    return nn_w_k, nn_w_64, nn1_idx


# knn_transfer.cu's constants: bits resolved per radix pass, bins of a
# warp histogram, smallest distances each lane keeps in the first pass
_KNN_DIGIT_BITS = 8
_KNN_BINS = 1 << _KNN_DIGIT_BITS
_KNN_TOP = 8
_KNN_HEAD = 16                  # the block's vertex counter, one float4
_KNN_HIST = 2 * _KNN_BINS * 4   # two histograms per warp, bytes
_KNN_WARPS = 32
_KNN_MIN_STAGED_WARPS = 8
# the sizes the op takes: N + 2k <= 58112, one block's shared memory in
# floats (the kernel's 16-bit list indices need N < 65536)
_KNN_MAX_ROW = _build.SMEM_LIMIT // 4


@functools.lru_cache(maxsize=64)
def _knn_plan(B: int, Vg: int, N: int, J: int, k: int, k64: int, sms: int) -> dict:
    """The launch plan of knn_transfer.cu on `sms` SMs; raises ValueError
    for shapes the kernel does not take. The body is staged in shared
    memory (16 bytes a point) where that leaves room for at least
    _KNN_MIN_STAGED_WARPS warps, each with its two histograms and a
    candidate list of at least min(N, 2k) 16-bit indices; else it is read
    through L1 by 32 warps. The rest of the shared memory lengthens the
    lists (`cap` entries, a multiple of 32). One block per SM: `per_b`
    blocks per batch element, each over `chunk` consecutive garment
    vertices. `passes` is the most histogram passes a threshold takes."""
    if not 1 <= k64 <= k <= N or not 1 <= J <= 32:
        raise ValueError(f"knn_transfer: need 1 <= k64 <= k <= N and J <= 32 "
                         f"(k={k}, k64={k64}, N={N}, J={J})")
    if N + 2 * k > _KNN_MAX_ROW:
        raise ValueError(f"knn_transfer: N={N}, k={k} exceed the kernel's limit "
                         f"N + 2k <= {_KNN_MAX_ROW}")
    want = -(-min(N, 2 * k) // 32) * 32
    avail = _build.SMEM_LIMIT - _KNN_HEAD - 16 * N
    warps = min(_KNN_WARPS, max(0, avail) // (_KNN_HIST + 2 * want))
    staged = warps >= _KNN_MIN_STAGED_WARPS
    if not staged:
        avail, warps = _build.SMEM_LIMIT - _KNN_HEAD, _KNN_WARPS
    cap = min((avail // warps - _KNN_HIST) // 2 // 32 * 32, -(-N // 32) * 32)
    per_b = max(1, min(sms // max(B, 1), -(-Vg // warps)))
    chunk = -(-Vg // per_b)
    return dict(staged=staged, warps=warps, cap=cap, chunk=chunk, per_b=-(-Vg // chunk),
                smem=_KNN_HEAD + (16 * N if staged else 0) + warps * (_KNN_HIST + 2 * cap),
                bins=_KNN_BINS, passes=-(-31 // _KNN_DIGIT_BITS))


def _knn_transfer_kernel(garment, body, w0, k: int, k64: int):
    _build.refuse_grad("knn_transfer", garment, body, w0)
    dev = garment.device
    _build.require(garment, "garment", torch.float32, 3, dev)
    _build.require(body, "body", torch.float32, 3, dev)
    _build.require(w0, "w0", torch.float32, 3, dev)
    B, Vg, _ = garment.shape
    N, J = body.shape[1], w0.shape[2]
    if (garment.shape[2] != 3 or body.shape[0] != B or body.shape[2] != 3
            or w0.shape[:2] != (B, N)):
        raise ValueError(f"knn_transfer: garment {tuple(garment.shape)}, body "
                         f"{tuple(body.shape)}, w0 {tuple(w0.shape)}")
    plan = _knn_plan(B, Vg, N, J, k, k64,
                     torch.cuda.get_device_properties(dev).multi_processor_count)
    outk = torch.empty((B, Vg, J), dtype=torch.float32, device=dev)
    out64 = torch.empty((B, Vg, J), dtype=torch.float32, device=dev)
    nn1 = torch.empty((B, Vg, 1), dtype=torch.int32, device=dev)
    lib = _build.library()
    _build.launch_counts["knn_transfer"] += 1
    _build.check(lib.g4d_knn_transfer(
        garment.data_ptr(), body.data_ptr(), w0.data_ptr(), B, Vg, N, J, k,
        k64, int(plan["staged"]), plan["warps"], plan["cap"], plan["chunk"], plan["smem"],
        outk.data_ptr(), out64.data_ptr(), nn1.data_ptr(), _build.stream_of(garment)),
        "knn_transfer")
    return outk, out64, nn1


def knn_transfer(garment: torch.Tensor, body: torch.Tensor, w0: torch.Tensor,
                 k: int, k64: int):
    """garment (B, Vg, 3), body (B, N, 3), w0 (B, N, J) -> (nn_W_k
    (B, Vg, J), nn_W_k64 (B, Vg, J), nn1_idx (B, Vg, 1) int32): the
    normalised 1/d^2-weighted averages of w0 over each garment vertex's k
    and k64 nearest body points, and its nearest body point (ties to the
    lower index). The kernel path is forward-only."""
    if use_kernel(garment):
        return _knn_transfer_kernel(garment.contiguous(), body.contiguous(),
                                    w0.contiguous(), int(k), int(k64))
    return _knn_transfer_plain(garment, body, w0, int(k), int(k64))


def lbs_garment_interpolation(
    pred_template_garment_v: torch.Tensor,   # (B, Vg, 3)
    tpose_vertices: torch.Tensor,            # (B, Nb, 3)
    tpose_root_joints: torch.Tensor,         # (B, 3)
    zeropose_vertices: torch.Tensor,         # (B, T, Nb, 3)
    gt_pose: torch.Tensor,                   # (B, T, 72) axis-angle
    T_J_regressor: torch.Tensor,             # (B, T, 24, Nb)
    T_lbs_weights: torch.Tensor,             # (B, T, Nb, 24)
    parents: np.ndarray,                     # (24,)
    smooth_op: torch.Tensor,                 # (Vg, Vg)
    K: int,
) -> LbsResult:
    """Skin the canonical garment to every frame. The K-NN selection and
    the weights are frame-independent, so the transfer and the smoothing
    run once per sequence and each frame costs one product with its joint
    transforms."""
    B, Vg, _ = pred_template_garment_v.shape
    T = gt_pose.shape[1]
    J = T_J_regressor.shape[2]
    BT = B * T

    pose_mat = batch_rodrigues(gt_pose.reshape(BT, J, 3))
    root_garment = pred_template_garment_v + tpose_root_joints[:, None, :]
    K64 = min(64, K)
    nn_W, inv_nn_W, nn1_idx = knn_transfer(
        root_garment, tpose_vertices, T_lbs_weights[:, 0], K, K64)

    # un-pose: invert the fixed template pose
    inv_pose_mat = batch_rodrigues(
        _inverse_template_pose(B, pred_template_garment_v.device))
    inv_J = vertices2joints_b(T_J_regressor[:, 0], tpose_vertices)
    _, inv_A = batch_rigid_transform(inv_pose_mat, inv_J, parents)
    inv_T = torch.einsum("bvj,bjpq->bvpq", inv_nn_W, inv_A)
    unposed = (torch.einsum("bvpq,bvq->bvp", inv_T[:, :, :3, :3], root_garment)
               + inv_T[:, :, :3, 3])  # (B, Vg, 3)

    # re-pose to every frame
    zero_v = zeropose_vertices.reshape(BT, -1, 3)
    J_pos = vertices2joints_b(T_J_regressor.reshape(BT, J, -1), zero_v)
    _, A = batch_rigid_transform(pose_mat, J_pos, parents)
    if K > 1:
        nn_W = torch.einsum("vw,bwj->bvj", smooth_op, nn_W)
    A_bt = A.reshape(B, T, J, 16)
    T_mat = torch.einsum("bvj,btjq->btvq", nn_W, A_bt).reshape(B, T, Vg, 4, 4)
    posed = (torch.einsum("btvpq,bvq->btvp", T_mat[..., :3, :3], unposed)
             + T_mat[..., :3, 3])
    return LbsResult(posed_garment=posed, nn_idx=nn1_idx,
                     unposed_garment=unposed[:, None].expand(B, T, Vg, 3))


def lbs_garment_single_nn(
    pred_garment_v: torch.Tensor,            # (B, T, Vg, 3) canonical + displacement
    tpose_vertices: torch.Tensor,            # (B, Nb, 3)
    tpose_root_joints: torch.Tensor,         # (B, 3)
    zeropose_vertices: torch.Tensor,         # (B, T, Nb, 3)
    gt_pose: torch.Tensor,                   # (B, T, 72) axis-angle
    T_J_regressor: torch.Tensor,             # (B, T, 24, Nb)
    T_lbs_weights: torch.Tensor,             # (B, T, Nb, 24)
    parents: np.ndarray,                     # (24,)
) -> LbsResult:
    """The MGN variant's skinning (reference `mesh_encoder.py:529-585`):
    each garment vertex of each frame takes the transforms of its single
    nearest T-pose body vertex (`knn_points(K=1)`, the 1-NN kernel on the
    card), with no interpolation and no smoothing; un-pose to the zero
    pose, re-pose to the frame. The 4x4 transforms of every body vertex
    (`inv_T_all`, `T_all`) are formed first and each garment vertex's row
    is gathered by `group_points` (16-float rows, the row-gather kernel on
    the card), in the JAX package's order. `nn_idx` is (B*T, Vg, 1)."""
    B, T, Vg, _ = pred_garment_v.shape
    J = T_J_regressor.shape[2]
    BT = B * T

    pose_mat = batch_rodrigues(gt_pose.reshape(BT, J, 3))
    root_garment = (pred_garment_v + tpose_root_joints[:, None, None, :]).reshape(BT, Vg, 3)
    tpose_bt = tpose_vertices[:, None].expand(B, T, *tpose_vertices.shape[1:]).reshape(BT, -1, 3)
    _, nn_idx = knn_points(root_garment, tpose_bt, K=1)

    inv_pose_mat = batch_rodrigues(_inverse_template_pose(BT, pred_garment_v.device))
    inv_J = vertices2joints_b(T_J_regressor.reshape(BT, J, -1), tpose_bt)
    _, inv_A = batch_rigid_transform(inv_pose_mat, inv_J, parents)

    w_bt = T_lbs_weights.reshape(BT, -1, J)
    inv_T_all = torch.einsum("bvj,bjpq->bvpq", w_bt, inv_A)  # (BT, Nb, 4, 4)
    inv_T = group_points(inv_T_all.reshape(BT, -1, 16), nn_idx).reshape(BT, Vg, 4, 4)
    unposed = (torch.einsum("bvpq,bvq->bvp", inv_T[:, :, :3, :3], root_garment)
               + inv_T[:, :, :3, 3])

    zero_v = zeropose_vertices.reshape(BT, -1, 3)
    J_pos = vertices2joints_b(T_J_regressor.reshape(BT, J, -1), zero_v)
    _, A = batch_rigid_transform(pose_mat, J_pos, parents)
    T_all = torch.einsum("bvj,bjpq->bvpq", w_bt, A)
    T_nn = group_points(T_all.reshape(BT, -1, 16), nn_idx).reshape(BT, Vg, 4, 4)
    posed = torch.einsum("bvpq,bvq->bvp", T_nn[:, :, :3, :3], unposed) + T_nn[:, :, :3, 3]
    return LbsResult(posed_garment=posed.reshape(B, T, Vg, 3), nn_idx=nn_idx,
                     unposed_garment=unposed.reshape(B, T, Vg, 3))
