"""The device's idle share, in %: 1 - (busy time a step, the union of the
device's event intervals over the traced steps) / (wall time a step in the
run's measured window)."""

from portbench.metrics._layer import applies


def read(ctx, name):
    if not applies(ctx, name):
        return None
    busy_step = ctx.profile["busy_s"] / ctx.profile["steps"]
    return 100.0 * (1.0 - busy_step / ctx.step_s)
