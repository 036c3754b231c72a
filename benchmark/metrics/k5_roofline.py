"""K5's share of its roofline: the least time the card needs for
its calls of a step (worked out from their shapes, ``harness/arith.py``) over
their device ms in the traced slice."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["bounds"].get("K5"):
        return None
    ms = ctx["slice"].group_s.get("K5", 0.0) * 1e3 / ctx["steps"]
    return 100.0 * ctx["bounds"]["K5"] / ms if ms > 0 else None
