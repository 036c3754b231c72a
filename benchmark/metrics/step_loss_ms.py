"""Device ms a training step in the loss (span ``step.loss``: the
targets' pooling and ``multi_scale_loss``, K5 included)."""

from harness.spans import device_s, per


def read(ctx):
    return per(ctx, "train", device_s("step.loss"))
