"""The most device memory the window allocated at once
(`torch.cuda.max_memory_allocated`, reset at the window's start), GiB."""


def read(ctx, name):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
