"""The port stands alone: ``repro_torch`` loads neither jax nor any module
of the JAX package ``repro`` (whose ``__init__`` loads jax)."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")

SUBPACKAGES = ["repro_torch", "repro_torch.configs", "repro_torch.kernels",
               "repro_torch.kernels.ops", "repro_torch.kernels._build",
               "repro_torch.nn", "repro_torch.models",
               "repro_torch.models.convert", "repro_torch.serve",
               "repro_torch.launch.serve", "repro_torch.optim",
               "repro_torch.data", "repro_torch.ckpt", "repro_torch.train",
               "repro_torch.utils", "repro_torch.launch.train",
               "repro_torch.core", "repro_torch.sched",
               "repro_torch.launch.specs", "repro_torch.launch.optimize"]


def test_import_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for name in {SUBPACKAGES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_file_imports_jax_or_repro():
    """Every module of the port, and chip_smoke.py, which drives it."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = [f"{os.path.relpath(path, ROOT)}: {mod}" for path in paths
                 for mod in _imported_roots(path)
                 if mod in ("jax", "jaxlib", "repro")]
    assert len(paths) > 20 and not offenders, offenders
