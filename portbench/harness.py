"""One run of one cell: find its files by name, run its driver, read its
metrics, print the result.

Everything a cell needs is found from ``BENCHMARK.json`` by name:

* the workload names its ``config`` (whose ``file`` the manifest gives)
  and its ``traffic``, ``portbench/mixes/<traffic>.json``;
* the mix names its ``driver``, ``portbench/drivers/<driver>.py``;
* the cell's limits are ``portbench/limits/<workload>.json``;
* each metric is read by ``portbench/metrics/<metric>.py``'s ``read``,
  which returns a number or None where it finds nothing to read; the
  run reports the cell's end-to-end metrics with ``--trace 0`` and its
  per-layer metrics with ``--trace 1`` (a metric with a ``workloads``
  key only in the cells it lists).

A new cell, mix, metric or driver is new files and manifest entries.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
from typing import Callable, Dict, List, Optional

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "repro"))


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


class Bench:
    """The manifest at ``root`` and the files it names."""

    def __init__(self, root: str):
        self.root = root
        self.manifest = load_json(os.path.join(root, "BENCHMARK.json"))
        self.dir = os.path.join(root, "portbench")

    def workload(self, name: str) -> Dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> Dict:
        return load_json(os.path.join(self.dir, "mixes", name + ".json"))

    def limits(self, workload: str) -> Dict:
        return load_json(os.path.join(self.dir, "limits", workload + ".json"))

    def metrics(self, workload: str, traced: bool) -> List[Dict]:
        """The metrics a run of ``workload`` reports."""
        group = self.manifest["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]


def reader(name: str) -> Callable:
    return importlib.import_module(f"portbench.metrics.{name}").read


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


@dataclasses.dataclass
class Run:
    """What a driver is given."""
    workload: str
    config: Dict
    mix: Dict
    limits: Dict
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float                     # wall clock at the process's start
    fault: Optional[str] = None        # a fault planted by the tests
    after_window: Callable[[], None] = lambda: None
    log: Callable[[str], None] = log


@dataclasses.dataclass
class Record:
    """What a driver hands back: what the metric readers read."""
    run: Run
    setup_s: float
    steps: List[tuple]                 # (start, end), perf_counter
    tokens_per_step: int
    input_s: List[float]
    model_flops_per_step: float
    dtype: str
    peak_bytes: Optional[int]
    trace: object                      # portbench.trace.Trace or None
    checks: List                       # portbench.check.Check
    attempted: int
    failed: int

    @property
    def window_s(self) -> float:
        return self.steps[-1][1] - self.steps[0][0]

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(c.ok for c in self.checks)


def forbidden_modules(names=None) -> List[str]:
    """Of the modules loaded (or of ``names``), the top-level names that
    are JAX's or the JAX package's, compared whole: ``repro_torch`` is
    not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


class Refused(RuntimeError):
    pass


def _guard() -> None:
    found = forbidden_modules()
    if found:
        raise Refused(f"loaded in this process: {', '.join(found)}")


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(bench: Bench, args, started: float, device: str,
            fault: Optional[str] = None) -> Record:
    """Run the cell with its driver: the part of a run past the look for
    the chip (the tests call it on the CPU)."""
    w = bench.workload(args.workload)
    mix = bench.mix(w["traffic"])
    ctx = Run(workload=w["name"], config=bench.config(w["config"]), mix=mix,
              limits=bench.limits(w["name"]), seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), device=device,
              started=started, fault=fault, after_window=_guard)
    return driver(mix["driver"]).run(ctx)


def result(bench: Bench, rec: Record, device_info: Dict) -> Dict:
    traced = rec.run.trace
    metrics = {}
    for m in bench.metrics(rec.run.workload, traced):
        value = reader(m["name"])(rec)
        if value is None:
            log(f"metric {m['name']}: nothing to read; left out")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": rec.correct, "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": device_info}
    if traced and rec.trace is not None:
        out["device"] = dict(device_info, busy_s=rec.trace.busy_s,
                             window_s=rec.trace.window_s)
        out["breakdown"] = {"device_ops": rec.trace.top_device_ops(),
                            "idle_gaps": rec.trace.idle_gaps()}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in rec.checks}
    return out


def main(argv, started: float, root: str) -> int:
    args = parse(argv)
    bench = Bench(root)
    chips = bench.workload(args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        rec = execute(bench, args, started, "cuda")
        _guard()
    except Refused as e:
        log(str(e))
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": rec.peak_bytes}
    out = result(bench, rec, info)
    for c in rec.checks:
        log(f"check {c.name} {c.value!r} limit {c.limit!r} "
            f"({'ok' if c.ok else 'FAILED'}; worst: {c.worst})")
    print(json.dumps(out), flush=True)
    return 0
