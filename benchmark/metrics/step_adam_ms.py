"""Device ms a training step in the update (span ``step.adam``:
``apply_update``, the prune masks and Adam)."""

from harness.spans import device_s, per


def read(ctx):
    return per(ctx, "train", device_s("step.adam"))
