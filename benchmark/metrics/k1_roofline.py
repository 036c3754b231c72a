"""K1's share of its roofline: the least time the card needs for
its calls of a request's batch (worked out from their shapes, ``harness/arith.py``) over
their device ms in the traced slice."""


def read(ctx):
    if ctx.get("kind") != "decode" or not ctx["bounds"].get("K1"):
        return None
    ms = ctx["slice"].group_s.get("K1/K3", 0.0) * 1e3 / ctx["batches"]
    return 100.0 * ctx["bounds"]["K1"] / ms if ms > 0 else None
