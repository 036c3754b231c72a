"""Device ms a training step in packing the fused stages' weights
for K3 (span ``train_tail.pack_weights`` in ``kernels/train_tail.py``)."""

from harness.spans import device_s, per


def read(ctx):
    return per(ctx, "train", device_s("train_tail.pack_weights"))
