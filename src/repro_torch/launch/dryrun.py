"""Multi-pod dry run: every (arch × shape) cell's step traced on the
production meshes without a card, proving the distribution config is
coherent and extracting its roofline terms.

Port of ``repro/launch/dryrun.py``, on the host and on no card:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --mesh both --out results/dryrun.json

The reference lowers and compiles each cell's global program over 512
host devices.  The port runs the step of one rank, rank 0 of a fake
process group (``torch.testing._internal.distributed.fake_pg``: every
collective returns at once) of the mesh's 256 (512) ranks, on fake
tensors (``FakeTensorMode``: shapes and types, no storage), so nothing
is allocated, computed or launched, and the model's kernels take their
plain versions, as CPU tensors do (``kernels/ops.py``).  While it runs,
:mod:`repro_torch.launch.jcost` counts flops and bytes,
``roofline.count_collectives`` the collectives and
``torch.utils.flop_counter.FlopCounterMode`` the library's flops.

The record is the reference's, except: ``trace_s`` (the seconds the
cell's step took to run) replaces ``lower_s``/``compile_s``, as there is
nothing to compile; ``memory`` is this rank's fake arguments and
outputs, and ``temp_bytes`` the high water of fake storage made during
the step (``torch.distributed._tools.mem_tracker.MemTracker``); the
roofline's collective term takes each collective's link rate from its
group (``roofline.link_bw``), and its global figures are one rank's
times the rank count.  The reference's ``collect_hlo`` argument has no
counterpart (there is no HLO) and is dropped.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import jcost
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh, production_mesh_shape
from repro_torch.launch.specs import lowerable


def model_flops(cfg, shape_name: str) -> float:
    seq, batch, kind = SHAPES[shape_name]
    n_active = cfg.n_active_params()
    if kind == "train":
        return 6.0 * n_active * seq * batch
    if kind == "prefill":
        return 2.0 * n_active * seq * batch
    return 2.0 * n_active * batch   # decode: one token per sequence


def fake_process_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks, this process rank 0
    (kept where one of that size is up; one of another size is
    destroyed first)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch.testing._internal.distributed.fake_pg "
            "(a fake process group), which this torch lacks") from e
    if dist.is_initialized():
        if dist.get_world_size() == world_size and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _nbytes(tree) -> int:
    return int(sum(t.numel() * t.element_size()
                   for t in jcost.tensors(tree)))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             fused_attn: bool = False, cfg_overrides: dict = None) -> dict:
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    where = {"arch": arch, "shape": shape_name,
             "mesh": "multi" if multi_pod else "single"}
    if shape_name not in cfg.supported_shapes:
        return {**where, "status": "skip",
                "reason": cfg.shape_skips.get(shape_name, "n/a")}
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed._tools.mem_tracker import MemTracker
        from torch.utils.flop_counter import FlopCounterMode
        shape, _ = production_mesh_shape(multi_pod=multi_pod)
        fake_process_group(math.prod(shape))
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        chips = dist.get_world_size()
        with FakeTensorMode(allow_non_fake_inputs=True):
            fn, args = lowerable(cfg, shape_name, mesh)
            tracker = MemTracker()
            flop_counter = FlopCounterMode(display=False)
            t0 = time.time()
            with rl.count_collectives() as coll, flop_counter, tracker, \
                    jcost.counting(fused_attn) as cost_mode:
                out = fn(*args)
            trace_s = time.time() - t0
            cost = cost_mode.cost
            cost.bytes_fused += _nbytes(args)
            arg_bytes, out_bytes = _nbytes(args), _nbytes(out)
            temp = int(sum(v.get("Total", 0) for v in
                           tracker.get_tracker_snapshot("peak").values()))
        roof = rl.analyze(cost.as_dict(), chips,
                          model_flops=model_flops(cfg, shape_name),
                          coll=coll,
                          torch_flops=flop_counter.get_total_flops())
        return {
            **where, "chips": chips, "status": "ok",
            "trace_s": round(trace_s, 1),
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": out_bytes,
                       "temp_bytes": temp,
                       "peak_bytes": temp + arg_bytes},
            "roofline": roof.as_dict(),
        }
    except Exception as e:  # a failing cell is a bug; record it loudly
        return {**where, "status": "FAIL",
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCHS} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {tuple(SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                r = run_cell(arch, shape_name, multi)
                results.append(r)
                tag = f"{arch:>22s} {shape_name:<12s} " \
                      f"{'multi ' if multi else 'single'}"
                if r["status"] == "ok":
                    roof = r["roofline"]
                    print(f"[dryrun] {tag} OK  trace={r['trace_s']:.0f}s "
                          f"flops={roof['flops_global']:.3e} "
                          f"coll={roof['coll_bytes_global']:.3e}B "
                          f"dom={roof['dominant']}", flush=True)
                elif r["status"] == "skip":
                    print(f"[dryrun] {tag} SKIP ({r['reason']})", flush=True)
                else:
                    print(f"[dryrun] {tag} FAIL {r['error']}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {args.out}")
    n_fail = sum(1 for r in results if r["status"] == "FAIL")
    print(f"[dryrun] {len(results)} cells, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
