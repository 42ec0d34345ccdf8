"""The readings that the limits of `limits/<cell>.json` are set from.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 [--seconds 2]
        [--control tf32|ulp] [--faults half_batch,altered] [--fault-seeds 3] [--out FILE]

In one process, for each seed: the cell's set-up and a short window at
its own load, then the comparison with the reference (the lower reading:
sound runs of the program); with `--control tf32` the reference computed
with TF32 products in the program's place (the upper reading), with
`--control ulp` the reference started one ulp off (the train cells: how
far rounding alone carries a reading); with
`--faults` the program run with each fault planted, on the first
`--fault-seeds` seeds. One JSON line a reading, to standard output and
to `--out`.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from portbench import harness


def reading(cell, seed, seconds, control, fault=None) -> dict:
    path = importlib.import_module(f"portbench.paths.{cell.workload['path']}")
    t0 = time.perf_counter()
    job = path.Job(cell, seed, "cuda", fault)
    job.warmup()
    w = harness.window(job.step, seconds, job.first_window_step)
    job.release()
    t1 = time.perf_counter()
    numbers, low = job.check(control)
    out = {"cell": cell.name, "seed": seed, "fault": fault, "calls": len(w["calls"]),
           "failed": w["failed"], "numbers": numbers, "control": low,
           "setup_and_window_s": t1 - t0, "check_s": time.perf_counter() - t1}
    del job
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", choices=("tf32", "ulp"), default=None)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    sink = open(args.out, "a") if args.out else None
    try:
        runs = [(s, None, args.control) for s in seeds]
        runs += [(s, f, None) for f in faults for s in seeds[:args.fault_seeds]]
        for seed, fault, control in runs:
            line = json.dumps(reading(cell, seed, args.seconds, control, fault))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
