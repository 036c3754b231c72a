"""The port imports no JAX and nothing of the JAX package.  A subprocess is
needed: conftest.py imports jax into the test process itself."""

import glob
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import repnerv_tpu_torch
names = [m.name for m in pkgutil.walk_packages(repnerv_tpu_torch.__path__, "repnerv_tpu_torch.")]
for name in names:
    importlib.import_module(name)
jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
pkg_mods = sorted(m for m in sys.modules if m == "repnerv_tpu" or m.startswith("repnerv_tpu."))
print(len(names), jax_mods, pkg_mods)
assert not jax_mods, jax_mods
assert not pkg_mods, pkg_mods
"""

# an import statement of the JAX package (docstrings that name a counterpart
# and chip_smoke.py's "replaces" strings are not imports)
_IMPORT = re.compile(r"^\s*(from|import)\s+repnerv_tpu(\.|\s|$)", re.MULTILINE)


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 36  # every module of the package was imported


def test_port_sources_name_no_jax_package_import():
    sources = glob.glob(os.path.join(ROOT, "repnerv_tpu_torch", "**", "*.py"), recursive=True)
    sources.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(sources) >= 40
    offenders = []
    for path in sources:
        with open(path) as f:
            text = f.read()
        offenders += [f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}"
                      for m in _IMPORT.finditer(text)]
    assert not offenders, offenders
    assert _IMPORT.search("    from repnerv_tpu.config import ModelConfig\n")  # the pattern bites
    assert not _IMPORT.search("from repnerv_tpu_torch.config import ModelConfig\n")
