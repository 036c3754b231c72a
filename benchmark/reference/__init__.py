"""The plain PyTorch reference that decides `correct`: it imports nothing
of the program (`repnerv_tpu_torch`) and nothing of JAX."""
