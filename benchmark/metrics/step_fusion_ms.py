"""Device ms a training step in the ERB branches' fusion (span
``reparam.fuse``: ``Generator.forward``, ``NeRVBlock.forward``), its
backward in ``step.backward`` not included."""

from harness.spans import device_s, per


def read(ctx):
    return per(ctx, "train", device_s("reparam.fuse"))
