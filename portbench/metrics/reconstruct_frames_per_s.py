"""Frames reconstructed a second: every batch of the window over the
window's wall time, from the first call's start to the last's end (host
clock)."""


def read(ctx, name):
    if ctx.kind != "reconstruct":
        return None
    return ctx.frames * len(ctx.calls) / ctx.window_s
