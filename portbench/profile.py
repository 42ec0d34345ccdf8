"""Device time of a few steps by kernel, from torch.profiler's CUDA
activity, held against the port's launch counters; the busy union, the
idle gaps and what the host did in them.

A frozen copy of the port's `utils/profiling.py:profile_device` logic and
its `PROFILED` map, so that a later change to the program's tracing tools
cannot change how the benchmark reads the trace.
"""

from __future__ import annotations

import collections
import sys
import time
from typing import Callable, Dict, List


# Each launch counter of the port: the names under which torch.profiler
# lists its CUDA kernels, the counters that launch them, and the kernels
# one counted launch runs.
PROFILED = {
    "fused_chain": (("fused_chain_kernel",), ("fused_chain", "group_pe_max", "group_pe_max_nv"),
                    1),
    "gcn_stack": (("gcn_tile_kernel", "gcn_narrow_kernel"), ("gcn_stack",), 1),
    "knn_transfer": (("knn_transfer_kernel",), ("knn_transfer",), 1),
    "ball_query_grouped": (("ball_query_grouped_kernel",), ("ball_query_grouped",), 1),
    "ball_query": (("ball_query_flat_kernel", "ball_query_lane_kernel", "flat_sort_kernel"),
                   ("ball_query", "ball_query_sort"), 1),
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
TRIES = 3


def family_of(kernel_name: str):
    """The port's kernel family of a device event, or None for work
    outside the port's kernels."""
    for fam, (names, _, _) in PROFILED.items():
        if any(k in kernel_name for k in names):
            return fam
    return None


def _union(intervals: List[tuple]) -> List[tuple]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def profile_steps(step: Callable[[], None], runs: int, counts) -> Dict:
    """Profile `runs` calls of `step` (each ends with a host copy) after
    one call inside the session that is not kept. -> {"rows": [(ms a
    step, launches a step, kernel name)], "busy_s", "window_s",
    "steps", "idle_gaps": [(host activity, seconds)]}. A session whose kernel
    events of the port differ from the launch counters (`counts`, the
    port's live Counter) is profiled again, up to TRIES sessions; then it
    raises RuntimeError."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    short = {}
    for attempt in range(TRIES):
        traces = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: traces.append(p.events())) as prof:
            step()
            prof.step()
            before = collections.Counter(counts)
            t0 = time.perf_counter()
            for _ in range(runs):
                step()
            window_s = time.perf_counter() - t0
            prof.step()
        counted = collections.Counter(counts)
        counted.subtract(before)
        per_kernel = collections.defaultdict(lambda: [0.0, 0])
        intervals, host = [], []
        for e in traces[0]:
            if e.name.startswith("ProfilerStep"):
                continue
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                per_kernel[e.name][0] += (b - a) / 1e3 / runs
                per_kernel[e.name][1] += 1
                intervals.append((a, b))
            else:
                host.append((a, b, e.name))
        short = {}
        for fam, (names, counters, per_launch) in PROFILED.items():
            want = per_launch * sum(counted[c] for c in counters)
            got = sum(n for name, (_, n) in per_kernel.items() if any(k in name for k in names))
            if got != want:
                short[fam] = (got, want)
        if short:
            print(f"profile: kernel events (profiled, counted) {short} in session "
                  f"{attempt + 1} of {TRIES}", file=sys.stderr, flush=True)
            continue
        busy = _union(intervals)
        gaps = collections.Counter()
        host.sort()
        active, h = [], 0
        # a sweep over the gaps' midpoints: the host events that contain
        # one, the innermost naming what the host was doing
        for (_, b0), (a1, _) in zip(busy[:-1], busy[1:]):
            mid = (b0 + a1) / 2
            while h < len(host) and host[h][0] <= mid:
                active.append(host[h])
                h += 1
            active = [e for e in active if e[1] >= mid]
            what = (min(active, key=lambda e: e[1] - e[0])[2] if active
                    else "host, no operator")
            gaps[what] += (a1 - b0) / 1e6
        rows = sorted(((ms, n / runs, name) for name, (ms, n) in per_kernel.items()),
                      reverse=True)
        return dict(rows=rows, busy_s=sum(b - a for a, b in busy) / 1e6, window_s=window_s,
                    steps=runs, idle_gaps=gaps.most_common(10))
    raise RuntimeError(f"profile: the profiler recorded other kernel launches than the "
                       f"counters in {TRIES} sessions: {short}")
