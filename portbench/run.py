"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cells are those of `BENCHMARK.json`.
Set-up (imports, the CUDA library, the model and its weights, the pool of
batches, the warm-up steps) is timed from the process's start; then the
cell's work runs back to back for `--seconds`; with `--trace 1` a few more
steps run under torch.profiler; then the program's state is freed and its
outputs are compared with the plain reference. The last line of standard
output is the result as JSON; the last lines of standard error give each
compared number beside its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.load_cell(args.workload, manifest)
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is false; the benchmark runs on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"portbench: {cell.name} needs {cell.entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    # the configuration's precision: float32 products, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    result, notes = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                                t_start=T_START, manifest=manifest)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: modules loaded that the port may not use: {loaded}",
              file=sys.stderr)
        return 3
    for k, v in notes.items():
        print(f"note {k}: {v}", file=sys.stderr)
    for k, c in result["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
