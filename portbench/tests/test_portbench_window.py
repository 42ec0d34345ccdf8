"""The window's rate and tail arithmetic: over every call and all the time
of the window, so a stall inside it shows."""

import statistics
import time

import pytest

from portbench import harness


def reader(name):
    return harness.reader(name)


def ctx(calls, kind="reconstruct", frames=80):
    return harness.Context(cell=None, kind=kind, frames=frames, calls=calls, setup_s=1.5,
                           peak_bytes=3 * 2 ** 30)


def steady(n, dt=0.05, start=0.0):
    return [(start + i * dt, start + (i + 1) * dt) for i in range(n)]


def test_rate_is_all_frames_over_all_the_window():
    calls = steady(100)
    assert reader("reconstruct_frames_per_s")(ctx(calls), "reconstruct_frames_per_s") == \
        pytest.approx(80 * 100 / 5.0)


def test_a_stall_inside_the_window_lowers_the_rate_and_shows_in_the_tail():
    calls = steady(50)
    stall_end = calls[-1][1] + 2.0
    calls.append((calls[-1][1], stall_end))
    calls += steady(49, start=stall_end)
    rate = reader("reconstruct_frames_per_s")(ctx(calls), "reconstruct_frames_per_s")
    assert rate == pytest.approx(80 * 100 / (99 * 0.05 + 2.0))
    # a median of pieces would not see the stall
    assert statistics.median(b - a for a, b in calls) == pytest.approx(0.05)
    assert rate < 0.75 * 80 / 0.05
    # five stalls in a hundred calls reach the 95th percentile
    calls = steady(95) + [(10.0 + i, 11.0 + i) for i in range(5)]
    p95 = reader("reconstruct_p95_ms")(ctx(calls), "reconstruct_p95_ms")
    assert p95 > 50.0


def test_p95_is_python_inclusive_quantile():
    lat = [0.01 * (i + 1) for i in range(200)]
    calls = [(0.0, x) for x in lat]
    assert reader("reconstruct_p95_ms")(ctx(calls), "reconstruct_p95_ms") == pytest.approx(
        1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94])


def test_train_rate_and_kinds():
    calls = steady(10, dt=0.4)
    c = ctx(calls, kind="train", frames=200)
    assert reader("train_frames_per_s")(c, "train_frames_per_s") == pytest.approx(500.0)
    assert reader("reconstruct_frames_per_s")(c, "reconstruct_frames_per_s") is None
    assert reader("peak_mem_gib")(c, "peak_mem_gib") == pytest.approx(3.0)
    assert reader("setup_s")(c, "setup_s") == 1.5


def test_window_loop_runs_until_the_time_is_up_and_counts_failures():
    seen = []

    def step(i):
        seen.append(i)
        time.sleep(0.01)
        return i % 3 != 0

    w = harness.window(step, 0.1, first=3)
    assert seen[0] == 3 and w["next"] == seen[-1] + 1
    assert w["calls"][-1][1] - w["calls"][0][0] >= 0.1
    assert w["failed"] == sum(1 for i in seen if i % 3 == 0)


def test_layer_readers_read_nothing_without_a_trace_or_of_another_kind():
    c = ctx(steady(10))
    for name in ("mfu_fp32.reconstruct", "kernels_ms.reconstruct", "kernels_roofline.train",
                 "device_idle_share.reconstruct", "other_device_ms.reconstruct"):
        assert reader(name)(c, name) is None
