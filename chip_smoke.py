#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py                  # the five phases below
    python3 chip_smoke.py --profile DIR    # also: a torch.profiler
                                           # breakdown of main-path passes,
                                           # written to DIR

Phases, each printed on lines of its own:

1. card — ``nvidia-smi`` name and power limit; build the kernel library
   from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a) and time it;
2. kernels — each hand-written kernel against its plain PyTorch version
   on the card, bf16 and f32, at the serving path's shapes and one ragged
   shape, with CUDA-event times of the kernel, the plain version and a
   library yardstick, then one ``{"kernels": [...]}`` line;
3. device against host — full-width qwen1.5-4b cut to 2 layers, f32, the
   same seeded weights on the card and on the CPU: decode logits agree;
4. main path — qwen1.5-4b at full width, bf16, seeded random weights,
   16 loadgen requests from 2 tenants through the paged ``ServeEngine``
   (8 lanes); every request completes with in-vocab tokens, and the
   kernels' launch counts equal engine passes x 81 (rmsnorm) and x 40
   (fused_ff);
5. the last line: ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line.  No phase catches its
own failure, and nothing falls back to the CPU or to a plain version.
Needs the repository's ``src/`` beside this file; imports nothing of the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 and compute by type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# Serving path shapes at qwen1.5-4b full width with 8 lanes.
LANES, D_MODEL, D_FF = 8, 2560, 6912


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def event_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Median CUDA-event time of one call of ``fn`` (ms)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_close(name, got, want, atol, rtol):
    import torch
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
    print(f"  {name}: max|d| {err:.3e} (atol {atol:g}, rtol {rtol:g}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def kernel_phase():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_ff as ff_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms_mod

    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    # Tolerances: bf16 outputs may differ by one bf16 rounding (2^-7
    # relative) where f32 sums in another order land on either side of a
    # rounding boundary; f32 rmsnorm by rsqrtf's 2 ulp, f32 fused_ff by
    # 2560-term dot products summed in another order.
    tol = {("rmsnorm", "bfloat16"): (1e-5, 2 ** -7),
           ("rmsnorm", "float32"): (1e-5, 1e-5),
           ("fused_ff", "bfloat16"): (1e-4, 2 ** -7),
           ("fused_ff", "float32"): (1e-5, 1e-4)}
    entries = {}
    for dname, dt in dtypes.items():
        for rows, cols in ((LANES, D_MODEL), (13, 1001)):
            x = (torch.randn(rows, cols, device="cuda", generator=gen)
                 * 0.5).to(dt)
            g = (torch.randn(cols, device="cuda", generator=gen) * 0.5
                 + 1.0).to(dt)
            err = check_close(f"rmsnorm {dname} {rows}x{cols}",
                              rms_mod.rmsnorm(x, g),
                              ops.rmsnorm(x, g, impl="ref"),
                              *tol[("rmsnorm", dname)])
            if (rows, cols) != (LANES, D_MODEL):
                continue
            el = x.element_size()
            t_bound, by = bound((2 * rows * cols + cols) * el,
                                4 * rows * cols, dname)
            lib = (event_ms(lambda: F.rms_norm(x, (cols,), g, eps=1e-6))
                   if hasattr(F, "rms_norm") else None)
            entries[("rmsnorm", dname)] = dict(
                name="rmsnorm", route="cuda",
                source="src/repro_torch/kernels/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/rmsnorm.py:26",
                max_abs_err=err, ms=event_ms(lambda: rms_mod.rmsnorm(x, g)),
                plain_ms=event_ms(lambda: ops.rmsnorm(x, g, impl="ref")),
                bound_ms=t_bound, bound_by=by, library_ms=lib,
                shape=f"{rows}x{cols} {dname}")
        for m, k, n in ((LANES, D_MODEL, D_FF), (3, 1001, 777)):
            x = (torch.randn(m, k, device="cuda", generator=gen)
                 * 0.5).to(dt)
            # Four weight pairs in rotation (283 MB in bf16): each call finds
            # its weights out of the 50 MB L2, as a decode pass does.
            ws = [tuple((torch.randn(k, n, device="cuda", generator=gen)
                         * k ** -0.5).to(dt) for _ in range(2))
                  for _ in range(4 if (m, k, n) == (LANES, D_MODEL, D_FF)
                                 else 1)]
            wg, wu = ws[0]
            err = check_close(f"fused_ff {dname} {m}x{k}x{n}",
                              ff_mod.fused_ff(x, wg, wu),
                              ops.fused_ff(x, wg, wu, impl="ref"),
                              *tol[("fused_ff", dname)])
            if (m, k, n) != (LANES, D_MODEL, D_FF):
                continue
            turn = [0]

            def rotate(fn):
                def call():
                    turn[0] = (turn[0] + 1) % len(ws)
                    return fn(*ws[turn[0]])
                return call

            def composite(a, b):
                return F.silu(x @ a) * (x @ b)

            el = x.element_size()
            t_bound, by = bound((m * k + 2 * k * n + m * n) * el,
                                4 * m * k * n + 4 * m * n, dname)
            entries[("fused_ff", dname)] = dict(
                name="fused_ff", route="cuda",
                source="src/repro_torch/kernels/csrc/fused_ff.cu",
                replaces="src/repro/kernels/fused_ff.py:40",
                max_abs_err=err,
                ms=event_ms(rotate(lambda a, b: ff_mod.fused_ff(x, a, b))),
                plain_ms=event_ms(rotate(
                    lambda a, b: ops.fused_ff(x, a, b, impl="ref"))),
                bound_ms=t_bound, bound_by=by,
                # no single PyTorch call computes silu(x@Wg)*(x@Wu)
                library_ms=None,
                library_composite_ms=event_ms(rotate(composite)),
                shape=f"{m}x{k}x{n} {dname}")
            del ws
    for (name, dname), e in sorted(entries.items()):
        extra = (f"  cuBLAS composite x@Wg, x@Wu, silu*u "
                 f"{e['library_composite_ms']:.4f} ms"
                 if "library_composite_ms" in e else
                 f"  F.rms_norm {e['library_ms']:.4f} ms"
                 if e["library_ms"] is not None else "")
        print(f"  time {name} {e['shape']}: kernel {e['ms']:.4f} ms  plain "
              f"{e['plain_ms']:.4f} ms  bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']}){extra}", flush=True)
    return entries


# ---------------------------------------------------------------------------
# phase 3: the same decode on the card and on the host
# ---------------------------------------------------------------------------

def device_host_phase():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import init_paged_caches, paged_decode_step

    cfg = get_config("qwen1.5-4b").replace(n_layers=2, dtype="float32")
    params = lm.init_model(cfg, torch.Generator().manual_seed(0))
    to_cuda = (lambda t: {k: to_cuda(v) for k, v in t.items()}
               if isinstance(t, dict) else t.to("cuda"))
    dparams = to_cuda(params)
    B, bs, steps = LANES, 16, 4
    rng = np.random.default_rng(0)
    table = torch.from_numpy(
        rng.permutation(B * 2).reshape(B, 2).astype(np.int64))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (steps, B, 1)))
    host = init_paged_caches(cfg, B * 2, bs, B)
    dev = init_paged_caches(cfg, B * 2, bs, B, "cuda")
    wmask = torch.ones(B, dtype=torch.bool)
    worst = 0.0
    for t in range(steps):
        pos = torch.full((B,), t)
        h_logits, host = paged_decode_step(params, host, table, toks[t], pos,
                                           wmask, cfg, 2 * bs)
        d_logits, dev = paged_decode_step(dparams, dev, table, toks[t], pos,
                                          wmask, cfg, 2 * bs)
        err = (d_logits.cpu() - h_logits).abs().max().item()
        scale = h_logits.abs().max().item()
        worst = max(worst, err / scale)
        print(f"  pass {t}: max|d| {err:.3e} of max|logit| {scale:.1f}",
              flush=True)
    # f32 dot products over 2560-6912 terms, summed in other orders on the
    # two devices (no TF32): a relative bound on the logit scale.
    print(f"  worst max|d| / max|logit| {worst:.3e} (bound 1e-5)", flush=True)
    if not worst <= 1e-5:
        fail("device and host decode logits disagree")


# ---------------------------------------------------------------------------
# phase 4: the main path — full-width qwen1.5-4b through ServeEngine
# ---------------------------------------------------------------------------

def main_path_phase(profile_dir):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_ff as ff_mod
    from repro_torch.kernels import rmsnorm as rms_mod
    from repro_torch.serve import ServeEngine, Tenant, TrafficConfig, run_load

    cfg = get_config("qwen1.5-4b")
    t0 = time.perf_counter()
    engine = ServeEngine.from_config(
        cfg, max_batch=LANES, max_seq=256, block_size=16, paged=True,
        tenants=[Tenant("t0"), Tenant("t1")], rng_seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(engine.params))
    print(f"  {cfg.name}: {n_params / 1e9:.3f} B parameters in bf16, made "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    engine.generate([1, 2, 3], 2, tenant="t0")      # warm-up: cuBLAS etc.
    engine.finished.clear()
    traffic = TrafficConfig(qps=4.0, n_requests=16, n_tenants=2,
                            prompt_len=(64, 128), output_len=(32, 64),
                            vocab=cfg.vocab, seed=0)

    passes0 = engine.counters["passes"]
    torch.cuda.reset_peak_memory_stats()
    rms_mod.launches = 0
    ff_mod.launches = 0
    report = run_load(engine, traffic)
    torch.cuda.synchronize()
    launches = {"rmsnorm": rms_mod.launches, "fused_ff": ff_mod.launches}
    passes = engine.counters["passes"] - passes0

    reqs = engine.finished
    bad = [r.id for r in reqs if r.truncated or len(r.output)
           != r.max_new_tokens or not all(0 <= t < cfg.vocab
                                          for t in r.output)]
    print(f"  requests completed {report['completed']}/"
          f"{report['n_requests']}, tokens {report['tokens']}", flush=True)
    if report["completed"] != traffic.n_requests or len(reqs) \
            != traffic.n_requests or bad:
        fail(f"requests incomplete or out of vocab: {bad}")
    want = {"rmsnorm": passes * (2 * cfg.n_layers + 1),
            "fused_ff": passes * cfg.n_layers}
    print(f"  passes {passes}; launches {launches}; expected {want}",
          flush=True)
    if launches != want or passes == 0:
        fail("the main path did not go through the kernels once per site")
    stats = {
        "tokens_per_s": report["tokens_per_s"],
        "latency_p50_s": report["latency_p50_s"],
        "latency_p99_s": report["latency_p99_s"],
        "ttft_p50_s": report["ttft_p50_s"],
        "ttft_p99_s": report["ttft_p99_s"],
        "wall_s": report["wall_s"], "passes": passes,
        "ms_per_pass": report["wall_s"] * 1e3 / passes,
        "lane_utilization": report["stats"]["engine"]["lane_utilization"],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("  main path " + json.dumps(stats), flush=True)
    if profile_dir:
        profile_passes(engine, cfg, profile_dir)
    return launches


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def profile_passes(engine, cfg, out_dir: str, n_passes: int = 8):
    """torch.profiler over steady decode passes: device busy share and
    time by kernel, written to ``out_dir``/profile_main_path.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rng_prompt = list(range(1, 97))
    for i in range(LANES):
        engine.submit([(t + i) % cfg.vocab for t in rng_prompt], 64,
                      tenant="t0")
    while any(s.in_prefill for s in engine._active) or not engine._active:
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        before = engine.counters["passes"]
        while engine.counters["passes"] - before < n_passes:
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    done = engine.counters["passes"] - before
    # Device time from the kernels themselves (an op's row in
    # key_averages() repeats the time of the kernels it launched).
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    by_name = {}
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + stop - start)
    lines = [f"{t / 1e3:10.3f} ms {n:6d} x {t / n:9.2f} us  {name[:90]}"
             for name, (n, t) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][1])]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_main_path.txt"), "w") as f:
        f.write("\n".join(lines) + "\n\n")
        f.write(prof.key_averages().table(row_limit=60))
    print(f"  profile: {done} passes in {wall * 1e3:.1f} ms wall (profiler "
          f"on), device busy {busy_us / 1e3:.1f} ms = {busy_us / 1e6 / wall:.1%}"
          f" of wall; kernel time by name:", flush=True)
    print("\n".join("    " + line for line in lines[:20]), flush=True)
    engine.run()


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile main-path passes with torch.profiler "
                         "and write the tables to DIR")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"  kernel library: built in {_build.build_seconds} s "
          f"(None: found built), loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    phase("2 kernels")
    entries = kernel_phase()

    phase("3 device against host")
    device_host_phase()

    phase("4 main path")
    launches = main_path_phase(args.profile)

    kernels = []
    for name in ("rmsnorm", "fused_ff"):
        e = dict(entries[(name, "bfloat16")])
        e["launches"] = launches[name]
        kernels.append(e)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
