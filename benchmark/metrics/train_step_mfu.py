"""The training step's share of the card's bf16 peak: 3 x the fused
forward's FLOPs a frame (forward, dX, dW) x the frames of an untraced epoch
over its seconds on the host's clock, over 989e12."""

PEAK = 989e12


def read(ctx):
    if ctx.get("kind") != "train" or ctx["epoch_s"] <= 0:
        return None
    return 100.0 * 3 * ctx["flops_per_frame"] * ctx["frames"] / ctx["epoch_s"] / PEAK
