"""The share of a traced training epoch in which the card ran nothing:
1 - the union of its kernels, copies and sets / the epoch's span."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    s = ctx["slice"]
    return 100.0 * (1.0 - s.busy_s / s.window_s)
