"""PyTorch / CUDA port of repnerv_tpu, for NVIDIA Hopper (sm_90a).

The package mirrors the module names of ``repnerv_tpu`` so each counterpart
is easy to find.  It imports ``torch`` and never ``jax``, and nothing of
``repnerv_tpu``: it keeps its own copies of the stdlib / numpy-only modules
(``config``, ``cli/args``, the codecs under ``compress``).  Tensors are NHWC at the public functions, as in the JAX
package; parameters carry the reference's PyTorch names and OIHW layout.
"""
