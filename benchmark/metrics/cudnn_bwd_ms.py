"""Device ms a training step of the library's conv and matmul kernels:
the dX / dW of every block, block 0's forward and the stem."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return ctx["slice"].group_s.get("library conv", 0.0) * 1e3 / ctx["steps"]
