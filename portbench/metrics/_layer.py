"""What the per-layer readers share: the suffix of a metric's name names
the kind of path it reads ("reconstruct" or "train"), and the device
trace's rows split into the port's kernels and the rest."""

from portbench.profile import family_of


def applies(ctx, name) -> bool:
    return ctx.profile is not None and name.partition(".")[2] == ctx.kind


def split_ms(ctx):
    """(ms a step in the port's kernels by family, ms a step elsewhere)."""
    port, other = {}, 0.0
    for ms, _, kernel in ctx.profile["rows"]:
        fam = family_of(kernel)
        if fam is None:
            other += ms
        else:
            port[fam] = port.get(fam, 0.0) + ms
    return port, other
