"""Device ms a training step of the kernels that no group claims
(elementwise work, the SSIM maps, the stem, the branch fusion)."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return ctx["slice"].group_s.get("other", 0.0) * 1e3 / ctx["steps"]
