"""What the benchmark's processes load: the harness (with the program it
drives) no JAX and not the JAX package; the reference nothing of the
program either.  Top-level module names are compared whole: the port's
``repnerv_tpu_torch`` begins with ``repnerv_tpu`` and is not it."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE)]

from harness.cell import FORBIDDEN  # noqa: E402


def loaded_by(*modules: str) -> set:
    """The top-level names in ``sys.modules`` of a fresh interpreter after
    importing ``modules`` with the benchmark's own path."""
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(HERE)!r}, {str(HERE.parent)!r}]\n"
        f"for m in {list(modules)!r}:\n"
        "    __import__(m)\n"
        "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True, cwd=HERE.parent).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_the_harness_and_the_program_load_no_jax():
    names = loaded_by("harness.cell", "drivers.train", "drivers.decode")
    assert "repnerv_tpu_torch" in names  # the program is what it drives
    assert not names.intersection(FORBIDDEN), sorted(names.intersection(FORBIDDEN))


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_by("reference.model", "reference.loss", "reference.train")
    assert not names.intersection({*FORBIDDEN, "repnerv_tpu_torch", "harness"})


@pytest.mark.parametrize("name, hit", [("repnerv_tpu_torch", False), ("repnerv_tpu", True),
                                       ("repnerv_tpu.models", True), ("jaxtyping", False),
                                       ("jax.numpy", True)])
def test_names_are_compared_whole(name, hit, monkeypatch):
    from harness import cell

    monkeypatch.setitem(sys.modules, name, sys.modules["json"])
    assert (name.split(".")[0] in cell.forbidden_modules()) is hit
