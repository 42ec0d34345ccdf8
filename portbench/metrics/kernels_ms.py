"""Device ms a step in the port's own kernels (the device trace's events
of `profile.PROFILED`), over the traced steps."""

from portbench.metrics._layer import applies, split_ms


def read(ctx, name):
    if not applies(ctx, name):
        return None
    port, _ = split_ms(ctx)
    return sum(port.values()) if port else None
