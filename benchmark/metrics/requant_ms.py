"""Device ms a request's batch in quantising the first int8 block's
input (span ``int8.quantize_act`` around ``quantize_act_int8``)."""

from harness.spans import device_s, per


def read(ctx):
    return per(ctx, "decode", device_s("int8.quantize_act"))
