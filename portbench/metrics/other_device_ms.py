"""Device ms a step outside the port's kernels: cuBLAS products,
elementwise work, BatchNorm, copies (the device trace)."""

from portbench.metrics._layer import applies, split_ms


def read(ctx, name):
    if not applies(ctx, name):
        return None
    return split_ms(ctx)[1]
