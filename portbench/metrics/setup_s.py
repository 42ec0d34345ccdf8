"""Seconds from the process's start to the first timed call: imports, the
CUDA library, the model and its weights, the pool of batches, the warm-up
calls (host clock)."""


def read(ctx, name):
    return ctx.setup_s
