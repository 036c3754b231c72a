"""Seconds of one val sweep with its capture (``evaluate`` through
``make_eval_step``, then ``release``), on the host's clock."""


def read(ctx):
    return ctx["sweep_s"] if ctx.get("kind") == "train" else None
