"""Device ms a training step in the VJP of the ERB branches' fusion (span
``reparam.fuse_vjp``, inside ``step.backward``: the fusion kernels'
backward launches)."""

from harness.spans import device_s, per


def read(ctx):
    return per(ctx, "train", device_s("reparam.fuse_vjp"))
