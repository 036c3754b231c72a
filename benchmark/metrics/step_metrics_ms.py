"""Device ms a training step in the per-step metrics (span
``step.metrics``: PSNR and MS-SSIM of the outputs and their copies into the
step's buffers)."""

from harness.spans import device_s, per


def read(ctx):
    return per(ctx, "train", device_s("step.metrics"))
