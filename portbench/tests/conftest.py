"""The benchmark's own tests: ``python -m pytest -q portbench/tests`` from
the root of the checkout.  Tests marked ``card`` need a CUDA device and
skip without one (decided inside the test)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips on the CPU)")
