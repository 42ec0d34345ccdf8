"""Tracing and profiling: torch.profiler sessions, step timers, summaries.

Counterpart of `garment4d_tpu/utils/profiling.py`: a trace session that
writes a Chrome/TensorBoard trace (`device_trace`), a wall-clock step timer
that forces completion with a one-element host copy (`StepTimer`), and a
summary of a trace's device time per kernel name (`summarize_trace`). Beside
them, `profile_device`: the device time of a call by kernel, held against
the port's launch counters (`ops.launch_counts`), which `chip_smoke.py` and
`tools/profile_posed.py` share.

This module imports only torch, numpy and the standard library at import
time, so a script may load it by file path beside another checkout of the
package (`chip_smoke.py --ab`); `profile_device` reads the launch counters
of whichever package is imported as `garment4d_tpu_torch`.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A torch.profiler session over the block (CPU ops, and the card's
    kernels when CUDA is available) whose trace, `*.pt.trace.json`, is
    written into `log_dir` when the block ends. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _first_tensor(x) -> Optional[torch.Tensor]:
    """The first tensor of a (nested) tuple, list, dict or NamedTuple."""
    if torch.is_tensor(x):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


class StepTimer:
    """Wall-clock step timer. Kernels run asynchronously, so a step is
    complete only once one of its outputs is on the host: `measure` copies
    one element of the tensor given to its `sync` (or of `sync_array`) to
    the host before it reads the clock."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self, sync_array=None):
        t0 = time.perf_counter()
        holder = {}

        def sync(x):
            holder["x"] = x

        yield sync
        leaf = _first_tensor(holder.get("x", sync_array))
        if leaf is not None:
            leaf.reshape(-1)[0].item()
        self.times.append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        arr = np.asarray(self.times[1:] or self.times)  # the first step warms up
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps": len(self.times),
        }


def summarize_trace(log_dir: str, top: int = 15) -> Dict[str, float]:
    """Time (ms) per event name of the newest trace `device_trace` wrote
    into `log_dir`, the `top` largest: the card's kernel events, or, in a
    trace without any (a CPU run), the CPU operators (an operator's time
    includes the operators it calls)."""
    paths = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    if not paths:
        return {}
    with open(max(paths, key=os.path.getmtime)) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("dur")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    groups = collections.Counter()
    for e in kernels or [e for e in events if e.get("cat") == "cpu_op"]:
        groups[e["name"]] += e["dur"] / 1e3
    return dict(groups.most_common(top))


# Each launch counter of the port (`ops.launch_counts`): the names under
# which torch.profiler lists its CUDA kernels, the counters that launch
# them, and the kernels one counted launch runs (the PE backward: its pass
# and its ordered sum; the scatter-add: its sort and its segmented sum; the
# flat query's, the 3-NN's and the 1-NN's sort pre-passes count under
# `ball_query_sort`, `three_nn_sort` and `nn1_sort`, where their plans run
# them); the names of an earlier design stay listed, for a parent checkout
# measured beside this one
PROFILED = {
    "fused_chain": (("fused_chain_kernel",), ("fused_chain", "group_pe_max", "group_pe_max_nv"),
                    1),
    "gcn_stack": (("gcn_tile_kernel", "gcn_narrow_kernel"), ("gcn_stack",), 1),
    "knn_transfer": (("knn_transfer_kernel",), ("knn_transfer",), 1),
    "ball_query_grouped": (("ball_query_grouped_kernel",), ("ball_query_grouped",), 1),
    "ball_query": (("ball_query_flat_kernel", "ball_query_lane_kernel", "flat_sort_kernel",
                    "ball_query_kernel<"), ("ball_query", "ball_query_sort"), 1),
    "fps": (("fps_kernel", "fps_far_kernel", "fps_cluster_kernel", "fps_wide_kernel"),
            ("fps",), 1),
    "coverage": (("coverage_kernel",), ("coverage",), 1),
    "three_nn": (("three_nn_kernel", "three_nn_sort_kernel"), ("three_nn", "three_nn_sort"), 1),
    "gather_rows": (("gather_rows_kernel",), ("gather_rows",), 1),
    "pe_bwd": (("pe_bwd_kernel", "pe_bwd_reduce_kernel"), ("pe_bwd",), 2),
    "banded": (("banded_kernel",), ("banded",), 1),
    "nn1": (("nn1_kernel", "nn1_nearest_kernel", "nn1_sort_kernel"), ("nn1", "nn1_sort"), 1),
    "scatter_add": (("scatter_sort_kernel", "segment_sum_kernel"), ("scatter_add",), 2),
}


PROFILE_TRIES = 3


def profile_device(fn, runs: int = 3, device="cuda"):
    """Device time of `fn` by kernel, from torch.profiler's CUDA activity
    over `runs` calls after a warm-up call inside the session (a session
    without one lost the first kernel events of its first call): (rows of
    (ms per call, launches per call, kernel name), largest first; device
    ms per call). A session whose kernel events of the port differ from
    the launch counters (`ops.launch_counts` of the imported
    `garment4d_tpu_torch`; `PROFILED` maps them to kernel names) is
    profiled again, up to PROFILE_TRIES sessions; then it raises
    RuntimeError.

    With `device` the CPU: the CPU operators by self time (an operator's
    own time, without the operators it calls), for a run of the plain
    versions; no kernel launches, so no counter check."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from garment4d_tpu_torch import ops

    cuda = torch.device(device).type == "cuda"
    counts = ops.launch_counts

    def sync():
        if cuda:
            torch.cuda.synchronize()

    fn()
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    short = {}
    for attempt in range(PROFILE_TRIES):
        traces = []
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: traces.append(p.events())) as prof:
            fn()  # the warm-up step: tracing starts, its events are not kept
            sync()
            prof.step()
            before = collections.Counter(counts)
            for _ in range(runs):
                fn()
            sync()
            prof.step()
        counted = collections.Counter(counts)
        counted.subtract(before)
        per_kernel = collections.defaultdict(lambda: [0.0, 0])
        for e in traces[0]:
            # the step's own range is no kernel
            if e.name.startswith("ProfilerStep"):
                continue
            if cuda and e.device_type == DeviceType.CUDA:
                per_kernel[e.name][0] += e.time_range.elapsed_us() / 1e3 / runs
                per_kernel[e.name][1] += 1
            elif not cuda and e.device_type == DeviceType.CPU:
                per_kernel[e.name][0] += e.self_cpu_time_total / 1e3 / runs
                per_kernel[e.name][1] += 1
        short = {}
        for key, (names, counters, per_launch) in PROFILED.items():
            want = per_launch * sum(counted[c] for c in counters)
            got = sum(n for name, (_, n) in per_kernel.items() if any(k in name for k in names))
            if cuda and got != want:
                short[key] = (got, want)
        if not short:
            rows = sorted(((ms, n / runs, name) for name, (ms, n) in per_kernel.items()),
                          reverse=True)
            return rows, sum(r[0] for r in rows)
        print(f"profile: kernel events (profiled, counted) {short} in session "
              f"{attempt + 1} of {PROFILE_TRIES}", flush=True)
    raise RuntimeError(f"profile_device: the profiler recorded other kernel launches than "
                       f"the counters in {PROFILE_TRIES} sessions: {short}")


def print_profile(label, rows, device_ms, wall_ms, top=15, cpu=False):
    """Print a `profile_device` result: the device ms and launches per
    call (with `cpu`, the CPU operators' self ms and calls), the idle share
    of the wall time `wall_ms`, the `top` rows. Returns the idle share."""
    idle = 1 - device_ms / wall_ms
    what, calls = ("CPU operator self time", "operator calls") if cpu else ("device time",
                                                                           "launches")
    print(f"{label}: {what} per call (torch.profiler) {device_ms:.3f} ms "
          f"in {sum(r[1] for r in rows):.0f} {calls}; idle share of the "
          f"{wall_ms:.2f} ms wall: {idle:.3f}")
    for ms, n, name in rows[:top]:
        print(f"  {ms:8.3f} ms {n:6.1f} x  {name[:100]}")
    return idle
