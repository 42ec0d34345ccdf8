"""The whole step's share of the card's float32 peak outside the tensor
cores (67 TFLOP/s): the model's arithmetic of the window's steps
(`counts.model_flops`) over the window's wall time, in %."""

from portbench import counts
from portbench.metrics._layer import applies


def read(ctx, name):
    if not applies(ctx, name):
        return None
    flops = counts.model_flops(ctx.cell.workload["path"], ctx.cell.shapes)
    return 100.0 * flops / ctx.step_s / counts.PEAK_FP32
