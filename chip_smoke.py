#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Run from the repo root. It builds the hand-written CUDA kernels from
`garment4d_tpu_torch/ops/csrc/` (nvcc, sm_90a, one process per source),
then:

1. card: prints the GPU's name and power limit (nvidia-smi) and the build
   time;
2. kernels: calls each kernel's wrapper at the shapes of the posed forward
   (80 frames: B=8 sequences x T=10) and holds it against its plain torch
   version on the same inputs on the card. Canonical-stage kernels: FPS,
   ball-query and 3-NN indices and gathered rows equal, 3-NN squared
   distances equal, the fused SA chain within rtol 1e-4 / atol 1e-5.
   Posed-stage kernels, on inputs captured from one posed forward: the
   coverage mask and the grouped ball query's indices equal, the PE blocks
   on the chain kernel (body S=32, garment pe2) within rtol 1e-4 /
   atol 1e-5, the K-NN transfer's 1-NN indices equal and weights within
   rtol 1e-4 / atol 1e-6, the GCN stack (195- and 323-wide iterations)
   within rtol 1e-4 / atol 1e-5 on `out` and `hidden`. Each is timed with
   CUDA events beside its plain version, its bound (the larger of the bytes
   it must move over 3.35 TB/s and its operations, counted for this run's
   data where the work depends on it, over 67 TFLOP/s of fp32) and, where
   one PyTorch call computes the same function (`index_select` on the
   flattened table for the row gather), that call's time;
3. canonical path: builds the batch with the port's `make_batch` (ring
   garment Vg=2000, 6890-vertex synthetic body, B=8, T=10, N=6890), loads
   the whole `ckpt_synth/posed_synth.npz`, zeroes the launch counters, runs
   `GarmentReconstructor.canonical` once and requires each of its five
   kernels to have launched; times it (median of 3 after a warm-up),
   profiles it (torch.profiler: device ms per kernel, idle share) and times
   its plain path on the card (inside `ops.plain_ops()`);
4. posed path: zeroes the counters, runs `GarmentReconstructor.posed` once
   and requires all ten kernels to have launched; prints the counts and
   whether a body query took the overflow branch; times it (median of 5
   after a warm-up) and profiles it; times the plain path on the card and
   compares one sequence (B=1, T=10) of both paths with the port's plain
   path on the CPU: labels agree on >= 99.9% of points, `tpose_garment`
   within 1e-3, the LBS result within 1e-4, every iteration's vertices no
   further from the CPU than the card's plain path's are (fp32 rounding
   flips radius-boundary memberships, which the refinement iterations
   amplify), and, fed the card's own inputs of each iteration, the CPU's
   vertex offsets and hidden features within 1e-5 of the card's, every
   element;
5. prints a JSON line of the kernels, then the card line, then as the last
   line `{"ok": true, "device": {...}}`.

Any failure raises, so the script exits non-zero without the last line; so
it does when no CUDA device is visible or when the repo is not beside it.
"""

from __future__ import annotations

import collections
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
B, T, N = 8, 10, 6890
RINGS, RING_SIZE = 125, 16  # the ring garment template, Vg = 2000
VG = RINGS * RING_SIZE
F = B * T
CHAIN_TOL = dict(rtol=1e-4, atol=1e-5)
KNN_TOL = dict(rtol=1e-4, atol=1e-6)
FORCED_TOL = 1e-5  # teacher-forced refinement, card vs CPU, every element
PEAK_FP32 = 67e12   # FLOP/s, H100 SXM fp32 outside the tensor cores
PEAK_HBM = 3.35e12  # bytes/s
CSRC = "garment4d_tpu_torch/ops/csrc/"
PALLAS = "garment4d_tpu/ops/pallas/"
# kernel: (source, the TPU kernel it replaces, main path it serves)
KERNELS = {
    "fps": ("fps.cu", "fps.py:65", "canonical"),
    "ball_query": ("ball_query.cu", "ball_query.py:466", "canonical"),
    "fused_chain": ("fused_chain.cu", "fusedpe.py:128", "canonical"),
    "three_nn": ("three_nn.cu", "three_nn.py:67", "canonical"),
    "gather_rows": ("gather.cu", "gather.py:70", "canonical"),
    "coverage": ("coverage.cu", "coverage.py:45", "posed"),
    "ball_query_grouped": ("ball_query.cu", "ball_query.py:401", "posed"),
    "group_pe_max": ("fused_chain.cu", "fusedpe.py:198", "posed"),
    "knn_transfer": ("knn_transfer.cu", "knn_transfer.py:142", "posed"),
    "gcn_stack": ("gcn_stack.cu", "gcnstack.py:111", "posed"),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls, after one
    warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(fn, runs: int = 5) -> float:
    """Median wall time of `fn` (synchronised) over `runs` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def profile_device(fn, runs: int = 3):
    """Device time of `fn` by kernel, from torch.profiler's CUDA activity
    over `runs` calls after a warm-up: (rows of (ms per call, launches per
    call, kernel name), largest first; device ms per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name][0] += e.time_range.elapsed_us() / 1e3 / runs
            per_kernel[e.name][1] += 1
    rows = sorted(((ms, n / runs, name) for name, (ms, n) in per_kernel.items()),
                  reverse=True)
    return rows, sum(r[0] for r in rows)


def print_profile(label, rows, device_ms, wall_ms, top=15):
    idle = 1 - device_ms / wall_ms
    print(f"{label}: device time per forward (torch.profiler) {device_ms:.3f} ms "
          f"in {sum(r[1] for r in rows):.0f} launches; idle share of the "
          f"{wall_ms:.2f} ms wall: {idle:.3f}")
    for ms, n, name in rows[:top]:
        print(f"  {ms:8.3f} ms {n:6.1f} x  {name[:100]}")
    return idle


def capture_inputs(model, names):
    """Forward pre-hooks that record the positional inputs of submodules."""
    got, handles = {}, []
    for name in names:
        def hook(_mod, args, name=name):
            got[name] = args
        handles.append(model.get_submodule(name).register_forward_pre_hook(hook))
    return got, handles


@contextlib.contextmanager
def recording(owner, name):
    """Record the arguments and result of every call of `owner.name` (a
    module's function or an object's method)."""
    calls = []
    fn = getattr(owner, name)
    own = name in vars(owner)

    def wrapper(*args, **kwargs):
        result = fn(*args, **kwargs)
        calls.append((args, kwargs, result))
        return result

    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        if own:
            setattr(owner, name, fn)
        else:
            delattr(owner, name)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_HBM, n_ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def scan_tests(outs, n_scan) -> int:
    """Distance tests that an early-exit ball query needs on this data: a
    center scans up to its S-th hit of every radius (slots strictly rising
    at S-1 mean S hits were found), else the whole scanned prefix."""
    need = None
    for out in outs:
        S = out.shape[-1]
        full = n_scan.to(torch.int64)[:, None].expand(out.shape[:2])
        if S >= 2:
            found = out[..., S - 1] > out[..., S - 2]
            n = torch.where(found, out[..., S - 1].to(torch.int64) + 1, full)
        else:
            n = full
        need = n if need is None else torch.maximum(need, n)
    return int(need.sum())


def coverage_tests(xyz, centers, radius) -> int:
    """Distance tests the coverage scan needs: each point up to its first
    center within `radius`, else all centers."""
    from garment4d_tpu_torch.ops.pointcloud import _f32, _sqdist

    r2, M, total = _f32(radius * radius), centers.shape[1], 0
    for p0 in range(0, xyz.shape[1], 256):
        hit = _sqdist(xyz[:, p0:p0 + 256, None, :], centers[:, None, :, :]) < r2
        first = torch.where(hit.any(-1), hit.to(torch.int8).argmax(-1) + 1,
                            torch.full(hit.shape[:2], M, device=hit.device))
        total += int(first.sum())
    return total


def chain_ops(idx, table, weights) -> float:
    Bc, M, S = idx.shape
    widths = [table.shape[-1]] + [w.shape[1] for w in weights]
    return 2.0 * Bc * M * S * sum(a * b for a, b in zip(widths, widths[1:]))


class Results:
    def __init__(self):
        self.cases = {k: [] for k in KERNELS}

    def record(self, kernel, case, err, fn_k, fn_p, n_bytes, n_ops,
               reps_k=20, reps_p=3, library=None):
        b_ms, b_by = bound(n_bytes, n_ops)
        row = dict(case=case, max_abs_err=float(err), ms=cuda_ms(fn_k, reps_k),
                   plain_ms=cuda_ms(fn_p, reps_p), bound_ms=b_ms, bound_by=b_by,
                   library_ms=None if library is None else cuda_ms(library, reps_k))
        self.cases[kernel].append(row)
        lib = "" if library is None else f" library_ms={row['library_ms']:.4f}"
        print(f"kernel {kernel:18s} {case:52s} max_abs_err={err:.3e} "
              f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}){lib}", flush=True)


@torch.inference_mode()
def check_kernels(recon, pcd, res: Results):
    """The canonical stage's kernels against their plain versions."""
    from garment4d_tpu_torch.ops import pemax, pointcloud as pc

    model = recon.canonical_model
    got, handles = capture_inputs(
        model, ["pointnet.sa3", "pointnet.fp1", "garment_sa2"])
    recon.run(pcd)
    for h in handles:
        h.remove()
    torch.cuda.synchronize()
    xyz0 = pcd.reshape(F, N, 3).contiguous()

    # FPS, sa1: 80 x 6890 -> 1024 (per step: 8-op distance, min, argmax)
    k = pc._fps_kernel(xyz0, 1024)
    require(torch.equal(k, pc._fps_plain(xyz0, 1024)), "fps indices differ from the plain version")
    res.record("fps", f"sa1 ({F}, {N}) -> 1024", 0,
               lambda: pc._fps_kernel(xyz0, 1024), lambda: pc._fps_plain(xyz0, 1024),
               nbytes(xyz0, k), 10.0 * F * N * 1023, reps_k=5, reps_p=1)

    def gather_case(case, table, idx):
        out = pc._gather_rows_kernel(table, idx)
        require(torch.equal(out, pc._gather_rows_plain(table, idx)),
                f"gather {case} differs from the plain version")
        # library: one index_select on the flattened (B*N, C) table
        Bt, Nt, C = table.shape
        flat = table.reshape(Bt * Nt, C)
        flat_idx = (idx.long() + Nt * torch.arange(Bt, device=idx.device)[:, None]).reshape(-1)
        res.record("gather_rows", case, 0, lambda: pc._gather_rows_kernel(table, idx),
                   lambda: pc._gather_rows_plain(table, idx), nbytes(table, idx, out), 0,
                   library=lambda: flat.index_select(0, flat_idx))
        return out

    centers = gather_case(f"sa1 centers ({F}, {N}, 3) x 1024", xyz0, k)

    # ball query, sa1: radii 0.05 / 0.1, S 16 / 32, 1024 centers, 6890 points
    radii, ns = (0.05, 0.1), (16, 32)
    qk = pc._ball_query_kernel(radii, ns, xyz0, centers)
    for a, r, s in zip(qk, radii, ns):
        require(torch.equal(a, pc._ball_query_plain(r, s, xyz0, centers)),
                "ball query indices differ from the plain version")
    full = torch.full((F,), N, device=xyz0.device)
    res.record("ball_query", f"sa1 ({F}, {N}) x 1024, r .05/.1, S 16/32", 0,
               lambda: pc._ball_query_kernel(radii, ns, xyz0, centers),
               lambda: [pc._ball_query_plain(r, s, xyz0, centers) for r, s in zip(radii, ns)],
               nbytes(xyz0, centers, *qk), 10.0 * scan_tests(qk, full))

    # 3-NN, fp1: 6890 unknown vs 1024 known
    unknown, known, _, known_feats = got["pointnet.fp1"]
    dk, ik = pc._three_nn_kernel(unknown, known)
    dp, ip = pc._three_nn_plain(unknown, known)
    require(torch.equal(ik, ip), "3-NN indices differ from the plain version")
    require(torch.equal(dk, dp), "3-NN squared distances differ from the plain version")
    res.record("three_nn", f"fp1 ({F}, {N}) vs 1024", 0,
               lambda: pc._three_nn_kernel(unknown, known),
               lambda: pc._three_nn_plain(unknown, known),
               nbytes(unknown, known, dk, ik), 9.0 * F * N * known.shape[1])

    feats = known_feats.contiguous()
    gather_case(f"fp1 interp {tuple(feats.shape)} x {N * 3}", feats,
                ik.reshape(F, -1).contiguous())

    # fused chain: sa1 mlp1, sa3 mlp1, garment_sa2 mlp1 with folded weights
    def chain_case(name, sa, xyz, features, scale):
        xyz = xyz.contiguous()
        ctr = pc._gather_rows_kernel(xyz, pc._fps_kernel(xyz, sa.npoint))
        idx = pc._ball_query_kernel((sa.radii[scale],), (sa.nsamples[scale],), xyz, ctr)[0]
        table = (torch.cat([xyz, features], -1) if features is not None else xyz).contiguous()
        ws, bs = getattr(sa, f"mlp{scale}").folded()
        relus = (True,) * len(ws)
        out_k = pemax._chain_kernel(table, idx, ctr, ws, bs, relus)
        out_p = pemax._chain_reference(table, idx, ctr, ws, bs, relus)
        err = (out_k - out_p).abs().max().item()
        require(torch.allclose(out_k, out_p, **CHAIN_TOL),
                f"fused chain {name}: max abs err {err} beyond {CHAIN_TOL}")
        widths = [table.shape[-1]] + [w.shape[1] for w in ws]
        res.record("fused_chain", f"{name} {tuple(idx.shape)} widths {widths}", err,
                   lambda: pemax._chain_kernel(table, idx, ctr, ws, bs, relus),
                   lambda: pemax._chain_reference(table, idx, ctr, ws, bs, relus),
                   nbytes(table, idx, ctr, out_k, *ws, *bs), chain_ops(idx, table, ws))

    chain_case("sa1.mlp1", model.pointnet.sa1, xyz0, None, 1)
    sa3_xyz, sa3_feat = got["pointnet.sa3"][:2]
    chain_case("sa3.mlp1", model.pointnet.sa3, sa3_xyz, sa3_feat, 1)
    g_xyz, g_feat = got["garment_sa2"][:2]
    chain_case("garment_sa2.mlp1", model.garment_sa2, g_xyz, g_feat, 1)


@torch.inference_mode()
def check_posed_kernels(recon, pcd, body_in, res: Results):
    """The posed stage's kernels against their plain versions, on inputs
    captured from one posed forward."""
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.models import skinning
    from garment4d_tpu_torch.ops import graph, pemax, pointcloud as pc

    with recording(ops, "query_group_pe_multi") as qcalls, \
            recording(ops, "gcn_stack") as gcalls, \
            recording(skinning, "knn_transfer") as kcalls:
        got, handles = capture_inputs(recon.model, ["garment_pe2"])
        recon.posed(pcd, body_in)
        for h in handles:
            h.remove()
    torch.cuda.synchronize()

    # coverage: body (80, 6890) x the 2000 garment vertices, r = 0.4
    radii, nsamples, xyz, centers, feats, pe_params = qcalls[0][0]
    xyz, centers = xyz.contiguous(), centers.contiguous()
    r = max(radii)
    M = centers.shape[1]
    ck = pc._covered_mask_kernel(xyz, centers, r)
    require(torch.equal(ck, pc._covered_mask_plain(xyz, centers, r)),
            "coverage mask differs from the plain version")
    res.record("coverage", f"body ({F}, {N}) x {M} centers, r {r}", 0,
               lambda: pc._covered_mask_kernel(xyz, centers, r),
               lambda: pc._covered_mask_plain(xyz, centers, r),
               nbytes(xyz, centers, ck), 9.0 * coverage_tests(xyz, centers, r))

    # grouped ball query over the compacted table of iteration 0
    cap = pemax.candidate_cap(xyz.shape[1])
    counts, overflow, cidx = pemax._compact_candidates(xyz, centers, r, cap)
    packed = torch.cat([xyz, feats], -1)
    if overflow:
        table, cpacked = xyz, packed
        counts = torch.full((F,), N, dtype=torch.int32, device=xyz.device)
    else:
        table, cpacked = pemax._gather_candidates(xyz, packed, cidx)
    print(f"iteration-0 body query: cap {cap}, covered points per frame "
          f"min {int(counts.min())} max {int(counts.max())}, overflow {overflow}")
    qk = pc._ball_query_grouped_kernel(radii, nsamples, table, centers, counts)
    for a, rr, s in zip(qk, radii, nsamples):
        require(torch.equal(a, pc._ball_query_plain(rr, s, table, centers, counts)),
                "grouped ball query indices differ from the plain version")
    res.record("ball_query_grouped",
               f"body ({F}, {table.shape[1]} compacted) x {M}, r .1/.2/.4, S 8/16/32", 0,
               lambda: pc._ball_query_grouped_kernel(radii, nsamples, table, centers, counts),
               lambda: [pc._ball_query_plain(rr, s, table, centers, counts)
                        for rr, s in zip(radii, nsamples)],
               nbytes(table, centers, counts, *qk),
               (8.0 + len(radii)) * scan_tests(qk, counts))

    # PE blocks on the chain kernel: body pe2 (S=32), garment pe2 (split)
    def pe_case(case, tbl, idx, ctr, k0, b0, k1, b1):
        ws, bs, relus = [k0.contiguous(), k1.contiguous()], [b0, b1], (True, False)
        out_k = pemax._chain_kernel(tbl, idx, ctr, ws, bs, relus, name="group_pe_max")
        out_p = pemax._chain_reference(tbl, idx, ctr, ws, bs, relus)
        err = (out_k - out_p).abs().max().item()
        require(torch.allclose(out_k, out_p, **CHAIN_TOL),
                f"group_pe_max {case}: max abs err {err} beyond {CHAIN_TOL}")
        res.record("group_pe_max", f"{case} {tuple(idx.shape)} widths "
                   f"{[tbl.shape[-1], k0.shape[1], k1.shape[1]]}", err,
                   lambda: pemax._chain_kernel(tbl, idx, ctr, ws, bs, relus, name="group_pe_max"),
                   lambda: pemax._chain_reference(tbl, idx, ctr, ws, bs, relus),
                   nbytes(tbl, idx, ctr, out_k, *ws, *bs), chain_ops(idx, tbl, ws))

    pe_case("body pe2", cpacked.contiguous(), qk[2], centers, *pe_params[2])
    g_xyz, g_ctr, g_feat = got["garment_pe2"]
    gpe = recon.model.garment_pe2
    g_idx = pc.ball_query(gpe.radius, gpe.nsample, g_xyz, g_ctr)
    k0, b0, k1, b1 = gpe.kb()
    g_tbl = torch.cat([g_xyz, g_feat @ k0[3:]], -1).contiguous()
    kfull = torch.cat([k0[:3], torch.eye(k0.shape[1], device=k0.device)], 0)
    pe_case("garment pe2 (split)", g_tbl, g_idx, g_ctr.contiguous(), kfull, b0, k1, b1)

    # K-NN transfer: 8 x 2000 garment vertices vs 6890 T-pose body points
    garment, body, w0, k, k64 = (a.contiguous() if torch.is_tensor(a) else a
                                 for a in kcalls[0][0])
    kk, k6, ki = skinning._knn_transfer_kernel(garment, body, w0, k, k64)
    pk, p6, pi = skinning._knn_transfer_plain(garment, body, w0, k, k64)
    require(torch.equal(ki, pi), "K-NN 1-NN indices differ from the plain version")
    err = max((kk - pk).abs().max().item(), (k6 - p6).abs().max().item())
    require(torch.allclose(kk, pk, **KNN_TOL) and torch.allclose(k6, p6, **KNN_TOL),
            f"K-NN transfer weights: max abs err {err} beyond {KNN_TOL}")
    Bk, Vg, _ = garment.shape
    J = w0.shape[-1]
    res.record("knn_transfer", f"({Bk}, {Vg}) vs {body.shape[1]}, K={k}, K64={k64}, J={J}", err,
               lambda: skinning._knn_transfer_kernel(garment, body, w0, k, k64),
               lambda: skinning._knn_transfer_plain(garment, body, w0, k, k64),
               nbytes(garment, body, w0, kk, k6, ki),
               10.0 * Bk * Vg * body.shape[1] + 2.0 * Bk * Vg * (k + k64) * J)

    # GCN stack: iteration 0 (195 wide) and iteration 1 (323 wide)
    for args, _, _ in gcalls[:2]:
        xs, ws, bs, adj, offsets, relus, hidden_layer = args
        xs = [x.contiguous() for x in xs]
        ws = [w.contiguous() for w in ws]
        vals = graph.diagonal_values(adj, offsets).contiguous()
        ko, kh = graph._gcn_stack_kernel(xs, ws, bs, vals, offsets, relus, hidden_layer)
        po, ph = graph._gcn_stack_ref(xs, ws, bs, adj, offsets, relus, hidden_layer)
        err = max((ko - po).abs().max().item(), (kh - ph).abs().max().item())
        require(torch.allclose(ko, po, **CHAIN_TOL) and torch.allclose(kh, ph, **CHAIN_TOL),
                f"gcn stack: max abs err {err} beyond {CHAIN_TOL}")
        K0 = sum(x.shape[-1] for x in xs)
        V = xs[0].shape[1]
        ops_ = sum(2.0 * F * V * (w.shape[0] * w.shape[1] + len(offsets) * w.shape[0])
                   for w in ws)
        res.record("gcn_stack", f"({F}, {V}) widths {[K0] + [w.shape[1] for w in ws]}, "
                   f"{len(offsets)} diagonals", err,
                   lambda: graph._gcn_stack_kernel(xs, ws, bs, vals, offsets, relus,
                                                   hidden_layer),
                   lambda: graph._gcn_stack_ref(xs, ws, bs, adj, offsets, relus,
                                                hidden_layer),
                   nbytes(*xs, *ws, *bs, vals, ko, kh), ops_)


def counted(label, fn, names):
    """Run the main path `fn` once with the launch counters at 0 before it;
    require each kernel in `names` to have launched."""
    from garment4d_tpu_torch import ops

    ops.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)
    print(f"{label} main-path launches: {launches}", flush=True)
    for name in names:
        require(launches.get(name, 0) > 0, f"kernel {name} did not launch on the {label} path")
    return out, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.api import GarmentReconstructor
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.models import BodyInputs, GarmentAssets
    from garment4d_tpu_torch.ops import _build, pemax
    from garment4d_tpu_torch.smpl import synthetic_smpl
    from garment4d_tpu_torch.train.step import body_inputs_from_batch

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; {card}", flush=True)

    # ---- 1. build -----------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s (nvcc {_build.build_seconds})", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())

    # ---- the batch and the weights ---------------------------------------
    dev = torch.device("cuda")
    assets = GarmentAssets.synthetic(num_rings=RINGS, ring_size=RING_SIZE)
    body = synthetic_smpl(num_verts=N, device=dev)
    batch = make_batch(assets, body, batch_size=B, T=T, npoints=N, device=dev)
    pcd = batch["pcd"]
    body_in = body_inputs_from_batch(batch)
    weights = str(REPO / "ckpt_synth" / "posed_synth.npz")
    recon = GarmentReconstructor.from_npz(assets, body, weights, device=dev)

    # ---- 2. per kernel -----------------------------------------------------
    res = Results()
    check_kernels(recon, pcd, res)
    check_posed_kernels(recon, pcd, body_in, res)

    # ---- 3. canonical path -------------------------------------------------
    canonical_names = [k for k, v in KERNELS.items() if v[2] == "canonical"]
    out_c, canon_launches = counted("canonical", lambda: recon.run(pcd), canonical_names)
    require(tuple(out_c.tpose_garment.shape) == (B, VG, 3), "tpose shape")
    require(bool(torch.isfinite(out_c.tpose_garment).all()), "non-finite tpose_garment")
    canon_s = wall_s(lambda: recon.canonical(pcd), runs=3)
    print(f"canonical forward, kernel path: {F / canon_s:.2f} frames/s "
          f"({canon_s * 1e3:.2f} ms per {F} frames)", flush=True)
    rows, canon_dev_ms = profile_device(lambda: recon.canonical(pcd), runs=2)
    canon_idle = print_profile("canonical", rows, canon_dev_ms, canon_s * 1e3, top=8)
    with ops.plain_ops():
        canon_plain_s = wall_s(lambda: recon.canonical(pcd), runs=2)
    print(f"canonical forward, plain path on the card: {F / canon_plain_s:.2f} "
          f"frames/s ({canon_plain_s * 1e3:.2f} ms)", flush=True)

    # ---- 4. posed path -----------------------------------------------------
    with recording(pemax, "_compact_candidates") as compactions, \
            recording(recon.model, "refine") as steps:
        out, launches = counted("posed", lambda: recon.posed(pcd, body_in, return_all=True),
                                list(KERNELS))
    overflows = [c[2][1] for c in compactions]
    print(f"body queries: {len(overflows)}, overflow branch taken: {overflows} "
          f"(one host read each)", flush=True)
    last = out.iter_garment_v[-1]
    require(len(out.iter_garment_v) == 3, "three refinement iterations")
    require(tuple(last.shape) == (B, T, VG, 3), f"posed shape {tuple(last.shape)}")
    require(all(bool(torch.isfinite(v).all()) for v in out.iter_garment_v),
            "non-finite posed garment")

    posed_s = wall_s(lambda: recon.posed(pcd, body_in))
    print(f"posed forward, kernel path: {F / posed_s:.2f} frames/s "
          f"({posed_s * 1e3:.2f} ms per {F} frames)", flush=True)
    rows, posed_dev_ms = profile_device(lambda: recon.posed(pcd, body_in), runs=2)
    posed_idle = print_profile("posed", rows, posed_dev_ms, posed_s * 1e3, top=20)

    # one sequence against the plain path on the CPU; the plain path on the
    # card beside it shows how far fp32 rounding alone moves the result
    with ops.plain_ops():
        out_plain = recon.posed(pcd, body_in, return_all=True)
        posed_plain_s = wall_s(lambda: recon.posed(pcd, body_in), runs=3)
    print(f"posed forward, plain path on the card: {F / posed_plain_s:.2f} frames/s "
          f"({posed_plain_s * 1e3:.2f} ms); kernel path {F / posed_s:.2f} frames/s",
          flush=True)
    recon_cpu = GarmentReconstructor.from_npz(assets, body, weights, device="cpu")
    body_1 = BodyInputs(**{k: getattr(body_in, k)[:1].cpu() for k in body_in.__dataclass_fields__})
    t0 = time.perf_counter()
    out_cpu = recon_cpu.posed(pcd[:1].cpu(), body_1, return_all=True)
    cpu_s = time.perf_counter() - t0
    agreement = {}
    for label, gpu in (("kernel", out), ("plain", out_plain)):
        rows = []
        for it, (c, g) in enumerate(zip(out_cpu.iter_garment_v, gpu.iter_garment_v)):
            diff = (c[0] - g[0].cpu()).abs().amax(-1)  # (T, Vg) per-vertex max
            rows.append(dict(iteration=it, within_1e3=(diff <= 1e-3).float().mean().item(),
                             within_1e4=(diff <= 1e-4).float().mean().item(),
                             max_abs=diff.max().item()))
            print(f"GPU {label} path vs CPU plain path, seq 0, iteration {it}: vertices "
                  f"within 1e-3 {rows[-1]['within_1e3']:.6f}, within 1e-4 "
                  f"{rows[-1]['within_1e4']:.6f}, max abs diff {rows[-1]['max_abs']:.3e}")
        agreement[label] = rows
    lbs_err = (out_cpu.lbs.posed_garment[0] - out.lbs.posed_garment[0].cpu()).abs().max().item()
    labels_gpu = out.canonical.backbone.sem_logits.argmax(-1)[:T].cpu()
    agree = (out_cpu.canonical.backbone.sem_logits.argmax(-1) == labels_gpu).float().mean().item()
    tpose_err = (out_cpu.canonical.tpose_garment[0] - out.canonical.tpose_garment[0].cpu()
                 ).abs().max().item()
    print(f"CPU plain path {cpu_s:.1f} s; label agreement {agree:.6f}, tpose_garment max "
          f"abs diff {tpose_err:.3e}, LBS posed garment max abs diff {lbs_err:.3e}",
          flush=True)
    # teacher-forced: each refinement iteration of the CPU plain path fed
    # the card's own inputs for it (same centers: no boundary flips); its
    # vertex offsets and hidden features are held to FORCED_TOL everywhere
    forced = []
    with torch.inference_mode():
        for args, _, (h_gpu, hid_gpu) in steps:
            it, cur, hidden, g_xyz, g_feat, b_v, b_vn = args[:7]

            def seq0(t):
                return None if t is None else t[:T].cpu()

            h_cpu, hid_cpu = recon_cpu.model.refine(
                it, seq0(cur), seq0(hidden), [seq0(t) for t in g_xyz],
                [seq0(t) for t in g_feat], seq0(b_v), seq0(b_vn), 1, T)
            diff = (h_cpu - h_gpu[:T].cpu()).abs().amax(-1)
            forced.append(dict(iteration=it, within_1e3=(diff <= 1e-3).float().mean().item(),
                               max_abs=diff.max().item(),
                               hidden_max_abs=(hid_cpu - hid_gpu[:T].cpu()).abs().max().item()))
            print(f"teacher-forced iteration {it}: offsets within 1e-3 "
                  f"{forced[-1]['within_1e3']:.6f}, max abs diff {forced[-1]['max_abs']:.3e}, "
                  f"hidden max abs diff {forced[-1]['hidden_max_abs']:.3e}", flush=True)
            for key in ("max_abs", "hidden_max_abs"):
                require(forced[-1][key] <= FORCED_TOL,
                        f"teacher-forced iteration {it}: {key} {forced[-1][key]} "
                        f"> {FORCED_TOL}")
    require(agree >= 0.999, f"label agreement {agree} < 0.999")
    require(tpose_err <= 1e-3, f"tpose_garment diff {tpose_err} > 1e-3")
    require(lbs_err <= 1e-4, f"LBS posed garment diff {lbs_err} > 1e-4")
    # The refinement loop moves the query centers, so fp32 rounding flips a
    # few radius-boundary memberships and the iterations amplify them: the
    # plain path on the card, which launches no kernel of ours, differs from
    # the CPU as much, and by how much moves from host to host (98.7-99.2% of
    # the last iteration's vertices within 1e-3 on H100 hosts). Each
    # iteration of the kernel path is held to the plain path's agreement less
    # 0.2% of the vertices (and 97% at least), and to twice its largest
    # difference plus 1e-3.
    for k_row, p_row in zip(agreement["kernel"], agreement["plain"]):
        it = k_row["iteration"]
        require(k_row["within_1e3"] >= max(0.97, p_row["within_1e3"] - 0.002),
                f"iteration {it}: {k_row['within_1e3']} of the vertices within 1e-3 "
                f"against {p_row['within_1e3']} on the plain path")
        require(k_row["max_abs"] <= 2 * p_row["max_abs"] + 1e-3,
                f"iteration {it}: max abs diff {k_row['max_abs']} against "
                f"{p_row['max_abs']} on the plain path")

    # ---- 5. results --------------------------------------------------------
    all_launches = dict(canon_launches)
    kernels = []
    for name, cases in res.cases.items():
        source, replaces, path = KERNELS[name]
        main_case = max(cases, key=lambda c: c["plain_ms"])
        kernels.append(dict(
            name=name, route="cuda", source=CSRC + source, replaces=PALLAS + replaces,
            launches=launches[name], launches_canonical=all_launches.get(name, 0),
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"], case=main_case["case"], cases=cases))
    print(json.dumps({
        "kernels": kernels,
        "posed_frames_per_sec": F / posed_s,
        "posed_plain_frames_per_sec": F / posed_plain_s,
        "posed_device_ms_per_forward": posed_dev_ms, "posed_idle_share": posed_idle,
        "canonical_frames_per_sec": F / canon_s,
        "canonical_plain_frames_per_sec": F / canon_plain_s,
        "canonical_device_ms_per_forward": canon_dev_ms, "canonical_idle_share": canon_idle,
        "body_query_overflows": overflows, "gpu_vs_cpu": agreement, "gpu_vs_cpu_forced": forced, "build_s": build_s,
        "total_s": time.perf_counter() - t_start}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
