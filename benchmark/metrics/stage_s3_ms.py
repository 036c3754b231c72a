"""Device ms a training step charged to the stride-3 fused stage, forward
and backward (span ``stage.s3``: in ``Generator.forward`` the block's branch
fusion, its weights' packing and K3; in the step's backward K4, the
library's dX / dW and the weight gradient's gather)."""

from harness.spans import device_s, per


def read(ctx):
    return per(ctx, "train", device_s("stage.s3"))
