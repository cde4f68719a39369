"""Serving launcher:
``python -m repro_torch.launch.serve --arch qwen1.5-4b --full --qps 8``.

Spins up :class:`repro_torch.serve.engine.ServeEngine` on ``--device``
(the card by default; it refuses to start when there is none), replays a
seeded Poisson-arrival trace at ``--qps`` across ``--tenants`` weighted
tenants, and reports p50/p99 latency, TTFT, tokens/s and the per-tenant
fairness table.  Without ``--qps`` it runs the one-shot static-batch
:func:`repro_torch.serve.generate` path.  Weights are seeded random (seed
0, as the reference's ``PRNGKey(0)``).  The reference's ``--schedule-cache`` and
``--strict-schedules`` wait for the port's ``sched`` slice.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import for_config
from repro_torch.serve import (ServeEngine, Tenant, TrafficConfig, generate,
                               run_load)
from repro_torch.serve.engine import resolve_device


def _print_fairness(engine) -> None:
    rows = engine.scheduler.fairness_table()
    cols = ["tenant", "weight", "token_budget", "admitted", "served_tokens",
            "in_flight_tokens", "queued", "vtime"]
    widths = {c: max(len(c), *(len(str(r[c])) for r in rows)) for c in cols}
    print("[serve] tenant fairness:")
    print("[serve]   " + "  ".join(c.ljust(widths[c]) for c in cols))
    for r in rows:
        print("[serve]   " + "  ".join(str(r[c]).ljust(widths[c])
                                       for c in cols))


def _engine_mode(args, cfg, params, device) -> None:
    weights = ([float(w) for w in args.tenant_weights.split(",")]
               if args.tenant_weights else [1.0] * args.tenants)
    if len(weights) != args.tenants:
        raise SystemExit(f"--tenant-weights needs {args.tenants} values")
    tenants = [Tenant(f"t{i}", weight=w) for i, w in enumerate(weights)]
    max_seq = args.max_seq or (args.prompt_len + args.new_tokens + 8)
    engine = ServeEngine.from_config(
        cfg, params=params, max_batch=args.max_batch, max_seq=max_seq,
        block_size=args.block_size, kv_blocks=args.kv_blocks,
        tenants=tenants, paged=args.paged,
        debug_invariants=args.debug_invariants, device=device)
    traffic = TrafficConfig(
        qps=args.qps, n_requests=args.requests, n_tenants=args.tenants,
        prompt_len=(max(2, args.prompt_len // 2), args.prompt_len),
        output_len=(max(1, args.new_tokens // 2), args.new_tokens),
        vocab=cfg.vocab, seed=0,
        prefix_tokens=args.prefix_tokens, prefix_groups=args.prefix_groups)
    print(f"[serve] {args.arch} on {device}: {args.requests} requests @ "
          f"{args.qps} qps, {args.tenants} tenants, "
          f"max_batch={args.max_batch}, max_seq={max_seq}, "
          f"kv_blocks={engine.pool.num_blocks}, "
          f"kv={'paged' if engine.paged else 'dense slots'}"
          + (f", shared prefix {args.prefix_tokens} tokens x "
             f"{args.prefix_groups} groups" if args.prefix_tokens else ""))
    report = run_load(engine, traffic)
    print(f"[serve] tokens/s {report['tokens_per_s']:.1f}  "
          f"p50 {report['latency_p50_s'] * 1e3:.1f}ms  "
          f"p99 {report['latency_p99_s'] * 1e3:.1f}ms  "
          f"ttft p50 {report['ttft_p50_s'] * 1e3:.1f}ms  "
          f"completed {report['completed']}/{report['n_requests']} "
          f"(truncated {report['truncated']})")
    eng = report["stats"]["engine"]
    print(f"[serve] engine: {eng['passes']} passes, lane utilization "
          f"{eng['lane_utilization']:.2f}, {eng['stalls']} stalls, "
          f"{eng['preemptions']} preemptions")
    if engine.paged:
        pool = report["stats"]["pool"]
        print(f"[serve] paged kv: max_active {eng['max_active']}, "
              f"prefix hits {eng['prefix_hits']} "
              f"({pool['shared_tokens_reused']} tokens reused), "
              f"cow forks {eng['cow_forks']}, "
              f"spills {eng['preempt_spills']}, "
              f"high water {pool['high_water_blocks']}/"
              f"{engine.pool.num_blocks} blocks, "
              f"peak kv {engine.peak_kv_bytes() / 1e6:.1f} MB")
    _print_fairness(engine)


def _static_mode(args, cfg, params) -> None:
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                          dtype=np.int64)
    t0 = time.perf_counter()
    out = generate(params, cfg, prompt, args.new_tokens)
    out = out.cpu()          # waits for the device
    dt = time.perf_counter() - t0
    toks = args.batch * args.new_tokens
    print(f"[serve] {args.arch}: generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s)")
    print("[serve] sample:", out[0, :24].tolist())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b", choices=list(ARCHS))
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the reduced config)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    # engine mode
    ap.add_argument("--qps", type=float, default=None,
                    help="offered Poisson arrival rate; enables the "
                         "continuous-batching engine")
    ap.add_argument("--tenants", type=int, default=2,
                    help="number of weighted-fair tenants")
    ap.add_argument("--tenant-weights", default=None, metavar="W1,W2,...",
                    help="per-tenant WFQ weights (default: all 1.0)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="engine slots (concurrent requests per pass)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="KV pool blocks; below slots*blocks_per_slot "
                         "oversubscribes the pool (stall/preempt pressure)")
    ap.add_argument("--max-seq", type=int, default=None,
                    help="cache positions per slot")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV pool block granularity (tokens)")
    ap.add_argument("--requests", type=int, default=32,
                    help="trace length for the load generator")
    ap.add_argument("--paged", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="paged KV: block-table indirection with prefix "
                         "sharing and copy-free preemption (default on; "
                         "--no-paged uses the dense per-slot cache)")
    ap.add_argument("--prefix-tokens", type=int, default=0,
                    help="prepend a shared system prompt of this many tokens "
                         "to every request (Zipf-distributed over "
                         "--prefix-groups distinct prefixes)")
    ap.add_argument("--prefix-groups", type=int, default=4,
                    help="distinct shared prefixes for --prefix-tokens")
    ap.add_argument("--debug-invariants", action="store_true",
                    help="run KVBlockPool.check() every engine tick")
    # shared with the static mode
    ap.add_argument("--batch", type=int, default=4,
                    help="[static path] batch rows")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=not args.full)
    device = resolve_device(args.device)
    model = for_config(cfg)
    params = model.init_model(
        cfg, torch.Generator(device=device).manual_seed(0))
    if args.qps is not None:
        _engine_mode(args, cfg, params, device)
    else:
        _static_mode(args, cfg, params)


if __name__ == "__main__":
    main()
