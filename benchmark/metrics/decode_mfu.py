"""The decode's share of the card's peak: each stage's operations over
its unit's peak (bf16 989e12, int8 1,979e12 for the int8 stages), summed
over the frames of untraced requests, over their seconds on the host's
clock."""


def read(ctx):
    if ctx.get("kind") != "decode" or ctx["seconds"] <= 0:
        return None
    return 100.0 * ctx["frame_s_at_peak"] * ctx["frames"] / ctx["seconds"]
