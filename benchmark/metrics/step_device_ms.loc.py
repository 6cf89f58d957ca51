"""Device milliseconds a localisation step: the card's kernels, copies and
memsets in the traced stretch, summed, over the steps it ran."""


def read(ctx):
    seconds, count = ctx["trace"].kernel_seconds()
    if not count or not ctx.get("steps"):
        return None
    return seconds / ctx["steps"] * 1e3
