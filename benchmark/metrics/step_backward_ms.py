"""Device ms a training step in the backward (span ``step.backward``:
``zero_grad`` and ``loss.backward()``, K4 and cuDNN's dX / dW included)."""

from harness.spans import device_s, per


def read(ctx):
    return per(ctx, "train", device_s("step.backward"))
