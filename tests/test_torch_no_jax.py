"""The port imports no JAX.  A subprocess is needed: conftest.py imports jax
into the test process itself."""

import os
import subprocess
import sys

_PROBE = """
import importlib, pkgutil, sys
import repnerv_tpu_torch
names = [m.name for m in pkgutil.walk_packages(repnerv_tpu_torch.__path__, "repnerv_tpu_torch.")]
for name in names:
    importlib.import_module(name)
jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
print(len(names), jax_mods)
assert not jax_mods, jax_mods
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=root, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 15  # every module of the package was imported
