"""The share of a traced run of decode requests in which the card ran
nothing: 1 - the union of its kernels, copies and sets / the requests'
span."""


def read(ctx):
    if ctx.get("kind") != "decode":
        return None
    s = ctx["slice"]
    return 100.0 * (1.0 - s.busy_s / s.window_s)
