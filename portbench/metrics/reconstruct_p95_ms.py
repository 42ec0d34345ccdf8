"""The 95th percentile, over every batch of the window, of the time from
its dispatch to its garment on the host, in ms (host clock)."""

from portbench.harness import quantile


def read(ctx, name):
    if ctx.kind != "reconstruct":
        return None
    return 1e3 * quantile([b - a for a, b in ctx.calls], 95)
