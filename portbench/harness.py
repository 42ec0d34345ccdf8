"""One run of one cell: set-up, the measured window, the traced steps, the
check against the reference, the result line.

Everything that belongs to one cell, configuration, traffic mix or metric
sits in a file of its own, found by the names in `BENCHMARK.json`:
`configs/<config>.json`, `traffic/<traffic>.json` (whose `path` names
`paths/<path>.py`), `limits/<cell>.json` and `metrics/<metric>.py` (or
the reader of the part of the name before its first dot).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional

import torch

from portbench import counts, inputs
from portbench.profile import profile_steps

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "garment4d_tpu")
PROFILED_STEPS = 3


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload of `BENCHMARK.json` with its configuration, traffic mix
    and limits, and the raw template and body its configuration fixes."""

    name: str
    entry: dict
    config: dict
    workload: dict
    limits: dict
    template: dict
    body: dict
    weights: str

    @property
    def sizes(self) -> dict:
        c = self.config
        return {k: c[k] for k in ("lbs_k", "garment_radius", "garment_nsample",
                                  "body_radius", "body_nsample")}

    @property
    def shapes(self) -> counts.Shapes:
        return counts.Shapes.of(self.config, self.workload, self.template["faces"])


def load_cell(name: str, manifest: Optional[dict] = None, overrides: Optional[dict] = None,
              config_overrides: Optional[dict] = None) -> Cell:
    """The cell `name` of the manifest (`BENCHMARK.json` by default);
    `overrides` and `config_overrides` replace traffic and configuration
    parameters (a test's small sizes)."""
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    config = dict(load_json(ROOT / conf["file"]), **(config_overrides or {}))
    workload = dict(load_json(HERE / "traffic" / f"{entry['traffic']}.json"), **(overrides or {}))
    limits_file = HERE / "limits" / f"{name}.json"
    limits = load_json(limits_file) if limits_file.exists() else {}
    t = config["template"]
    return Cell(name=name, entry=entry, config=config, workload=workload, limits=limits,
                template=inputs.ring_template(t["num_rings"], t["ring_size"], config["pca_dim"]),
                body=inputs.synthetic_body(config["body_vertices"]),
                weights=str(ROOT / config["weights"]))


def reader(metric: str) -> Callable:
    """The reader of a metric: `metrics/<metric>.py`, else the one of the
    name's part before its first dot. Its `read(ctx, name)` returns the
    value, or None where this run has nothing to read."""
    for stem in (metric, metric.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"portbench.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise KeyError(f"no reader for metric {metric!r}")


def metrics_of(cell: Cell, manifest: dict, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics
    (trace 1): those listing the cell, or listing no cells."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell.name in m.get("workloads", [cell.name])]


def window(step: Callable[[int], bool], seconds: float, first: int) -> dict:
    """Call `step(i)` back to back (each call ends with a host copy, so
    the loop is closed: the next starts when the last has finished) until
    `seconds` have passed. -> the calls' (start, end) times, the count of
    calls whose outputs were not finite, the index after the last."""
    calls, failed, i = [], 0, first
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        ok = step(i)
        b = time.perf_counter()
        calls.append((a, b))
        failed += not ok
        i += 1
        if b - t0 >= seconds:
            break
    return dict(calls=calls, failed=failed, next=i)


def quantile(values: List[float], q: int) -> float:
    """The q-th percentile (Python's inclusive quantiles)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


@dataclasses.dataclass
class Context:
    """What the metric readers read."""

    cell: Cell
    kind: str                 # the path's KIND: "reconstruct" or "train"
    frames: int               # frames a call
    calls: List[tuple]        # the window's (start, end) a call
    setup_s: float
    peak_bytes: int
    profile: Optional[dict] = None   # `profile.profile_steps`' result (trace 1)

    @property
    def window_s(self) -> float:
        return self.calls[-1][1] - self.calls[0][0]

    @property
    def step_s(self) -> float:
        return self.window_s / len(self.calls)


def short_name(kernel: str) -> str:
    """A kernel's name without its argument list and anonymous namespaces,
    at most 120 characters."""
    name = kernel.replace("(anonymous namespace)::", "")
    return name.split("(")[0][:120]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda", fault=None,
        t_start: Optional[float] = None, manifest: Optional[dict] = None):
    """One run of `cell`. -> (the result: `correct`, `attempted`, `failed`,
    `metrics`, `device`, with `trace` `breakdown`, then `compared`; notes
    on the comparison, such as the worst leaf)."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    path = importlib.import_module(f"portbench.paths.{cell.workload['path']}")
    job = path.Job(cell, seed, dev, fault)
    job.warmup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    w = window(job.step, seconds, job.first_window_step)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    ctx = Context(cell=cell, kind=path.KIND, frames=job.frames, calls=w["calls"],
                  setup_s=setup_s, peak_bytes=peak)
    breakdown = None
    if trace:
        from portbench.program import launch_counts

        i = iter(range(w["next"], w["next"] + 10 * PROFILED_STEPS))
        ctx.profile = profile_steps(lambda: job.step(next(i)), PROFILED_STEPS, launch_counts())
        breakdown = {"device_ops": [[short_name(n), ms * PROFILED_STEPS / 1e3]
                                    for ms, _, n in ctx.profile["rows"][:10]],
                     "idle_gaps": [[n, s] for n, s in ctx.profile["idle_gaps"]]}

    metrics = {}
    for m in metrics_of(cell, manifest, trace):
        value = reader(m["name"])(ctx, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    job.release()
    numbers, _ = job.check()
    limits = cell.limits
    compared = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()
                if not k.startswith("_")}
    notes = {k[1:]: v for k, v in numbers.items() if k.startswith("_")}
    correct = (w["failed"] == 0 and bool(limits)
               and all(k in numbers and numbers[k] <= lim for k, lim in limits.items()))
    result = {"correct": correct, "attempted": len(w["calls"]), "failed": w["failed"],
              "metrics": metrics,
              "device": device_info(dev, max(setup_peak, peak), ctx if trace else None)}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result, notes


def device_info(dev: torch.device, peak: int, ctx: Optional[Context]) -> dict:
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if ctx is not None:
        info["busy_s"] = ctx.profile["busy_s"]
        info["window_s"] = ctx.profile["window_s"]
    return info
