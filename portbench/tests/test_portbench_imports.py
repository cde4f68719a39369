"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.__file__.rsplit(os.sep, 2)[0]
BENCH = os.path.join(ROOT, "portbench")
SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(BENCH)
                 for f in fs if f.endswith(".py"))


def top_level_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_nor_the_jax_package(path):
    assert not set(top_level_imports(path)) & harness.FORBIDDEN
    if path != __file__:    # the JAX package's benchmark folder is not read
        assert "benchmarks/" not in open(path).read()


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if os.sep + "reference" + os.sep in p],
                         ids=os.path.basename)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(top_level_imports(path))


@pytest.mark.parametrize("names, found", [
    (["repro_torch", "repro_torch.train", "jaxtyping", "flax_like.x"], []),
    (["repro_torch", "repro.nn"], ["repro"]),
    (["jax._src.core", "jaxlib", "flax.linen"], ["flax", "jax", "jaxlib"]),
])
def test_names_are_compared_whole(names, found):
    assert harness.forbidden_modules(names) == found


def test_a_run_loads_neither():
    """Import every module a run imports, the program included, in a
    fresh process, and look at what is loaded."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'src')!r}]\n"
        "import portbench.harness as h, portbench.drivers.train, "
        "portbench.calibrate\n"
        "import portbench.reference.steps, portbench.trace\n"
        "import repro_torch.train, repro_torch.configs\n"
        "import pkgutil, importlib, portbench.metrics as m\n"
        "for i in pkgutil.iter_modules(m.__path__):\n"
        "    importlib.import_module('portbench.metrics.' + i.name)\n"
        "print(h.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
