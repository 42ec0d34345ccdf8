"""The port's kernels' share of their roofline, in %: the summed bound
(`counts.kernel_ops`: the larger of the least bytes at 3.35 TB/s and the
least arithmetic at 67 TFLOP/s) of the step's work whose kernel family ran
in the trace, over the device time of all the port's kernel launches."""

from portbench import counts
from portbench.metrics._layer import applies, split_ms


def read(ctx, name):
    if not applies(ctx, name):
        return None
    port, _ = split_ms(ctx)
    if not port:
        return None
    ops = counts.kernel_ops(ctx.cell.workload["path"], ctx.cell.shapes)
    bound_ms = 1e3 * sum(op.bound_s for op in ops if op.family in port)
    return 100.0 * bound_ms / sum(port.values())
