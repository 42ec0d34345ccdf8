"""Frames trained a second: the frames of every step of the window over
the window's wall time (host clock)."""


def read(ctx, name):
    if ctx.kind != "train":
        return None
    return ctx.frames * len(ctx.calls) / ctx.window_s
