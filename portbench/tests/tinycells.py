"""Tiny stand-ins of the cells for the CPU tests: every width shrunk to
its model type's ``TINY``, float32, a few short rows."""

import copy
import json
import os
import shutil

from portbench.reference import model

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def shrink_config(c):
    """``c`` at its model type's stand-in sizes: the ``TINY`` dict of its
    module under ``portbench/reference/``."""
    family = model.family(c)
    if not hasattr(family, "TINY"):
        raise LookupError(f"{family.__name__} gives no TINY: the CPU "
                          f"tests' stand-in sizes of model type "
                          f"{c['model_type']!r}")
    c = copy.deepcopy(c)
    c.update(family.TINY)
    c["port"]["set"]["dtype"] = "float32"
    return c


def shrink_mix(mix):
    return dict(mix, seq_len=32, batch=max(2, mix["batch"] // 2))


def tiny_root(tmp):
    """A checkout at ``tmp`` whose BENCHMARK.json and portbench/ are the
    real ones with every configuration and mix shrunk."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(tmp, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for sub, fix in (("configs", shrink_config), ("mixes", shrink_mix)):
        d = os.path.join(tmp, "portbench", sub)
        for name in os.listdir(d):
            path = os.path.join(d, name)
            with open(path) as f:
                data = fix(json.load(f))
            with open(path, "w") as f:
                json.dump(data, f)
    return tmp
