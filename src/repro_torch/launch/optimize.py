"""Schedule-optimizer launcher: run a kernel fleet through the session API.

    PYTHONPATH=src python -m repro_torch.launch.optimize matmul_leakyrelu \
        bmm --strategy greedy --backend fast

    # fleet campaign: scenarios × targets product, resumable per bucket
    PYTHONPATH=src python -m repro_torch.launch.optimize matmul_leakyrelu \
        bmm --strategy greedy --scenarios 8x4096,64x32768xbf16xhalf \
        --targets tpu-tsass-v1,tpu-tsass-v2

    # deploy-time lookup only (no search, no autotune — §4.2 split)
    PYTHONPATH=src python -m repro_torch.launch.optimize bmm --deploy

Port of ``repro/launch/optimize.py``, with the reference's flags and
defaults.  The search runs on the host, as in the reference: the
simulated TSASS machine is the measurement, so there is no ``--device``.
The registry holds the §5.7 pair (``matmul_leakyrelu``, ``bmm``); the
default ``--strategy ppo`` and the ``beam``/``lookahead`` strategies
raise ``NotImplementedError`` until they are ported (ROADMAP A7, A11),
and ``--arch`` fails on the first fleet kernel whose spec is not ported
yet (ROADMAP A10).

Sibling of ``launch.train`` / ``launch.serve``: one session shares the
per-target stall tables and the cross-kernel measurement memo across the
whole campaign, and finished artifacts land in the scenario-keyed
schedule-cache index the serving launcher reads back.  Re-running the
same campaign without ``--force`` resumes: every already-tuned
(kernel, target, scenario bucket) cell is a cache hit and only the
missing cells search.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence, Tuple

from repro_torch.sched import (OptimizationSession, OptimizeRequest,
                               make_budgeted_strategy)
from repro_torch.sched.backends import BACKENDS, make_backend, warm_start_memo
from repro_torch.sched.cache import DEFAULT_CACHE_DIR
from repro_torch.sched.resilience import FailureLedger, ResilientBackend
from repro_torch.sched.scenario import (DEFAULT_BUCKET, TARGETS,
                                        MachineTarget, Scenario, bucket_of,
                                        require_target)
from repro_torch.sched.session import STRATEGIES

MEMO_FILENAME = "measure_memo.pkl"
LEDGER_FILENAME = "campaign_state.json"

FleetUnit = Tuple[str, Optional[Scenario]]


def parse_scenarios(spec: str) -> List[Scenario]:
    """Comma-separated ``BATCHxSEQ[xDTYPE[xOCC]]`` list -> Scenarios."""
    return [Scenario.parse(tok) for tok in spec.split(",") if tok.strip()]


def parse_targets(spec: str) -> List[MachineTarget]:
    """Comma-separated target names -> registered MachineTargets.

    Raises ``KeyError`` (listing the registered names) on an unknown name
    — a campaign aimed at a machine model that does not exist must fail
    before any search work starts, not tune against a silent default.
    """
    return [require_target(tok.strip()) for tok in spec.split(",")
            if tok.strip()]


def campaign_requests(units: Sequence[FleetUnit],
                      targets: Optional[Sequence[MachineTarget]] = None,
                      force: bool = False,
                      verbose: bool = False) -> List[OptimizeRequest]:
    """The deduplicated scenarios × targets product as OptimizeRequests.

    One request per distinct (kernel, scenario bucket, target) cell —
    overlapping units (e.g. positional kernel names that also appear in
    an ``--arch`` fleet, or two scenarios that fall in the same bucket)
    collapse to a single search.  Order is first-seen, so positional
    kernels keep their CLI position.
    """
    tgts: Sequence[Optional[MachineTarget]] = targets or [None]
    reqs: List[OptimizeRequest] = []
    seen = set()
    for name, scen in units:
        for tgt in tgts:
            key = (name, bucket_of(scen),
                   tgt.name if tgt is not None else None)
            if key in seen:
                continue
            seen.add(key)
            reqs.append(OptimizeRequest(kernel=name, scenario=scen,
                                        target=tgt, force=force,
                                        verbose=verbose))
    return reqs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("kernels", nargs="*",
                    help="registry kernel names (see "
                         "repro_torch.kernels.KERNELS);"
                         " may be combined with --arch")
    ap.add_argument("--arch", default=None,
                    help="optimize the kernel fleet of this architecture "
                         "at its derived workload points "
                         "(launch.specs.kernel_fleet)")
    ap.add_argument("--scenarios", default=None, metavar="LIST",
                    help="comma-separated workload points "
                         "BATCHxSEQ[xDTYPE[xOCC]], e.g. "
                         "'8x4096,64x32768xbf16xhalf': tune every kernel "
                         "at every point (overrides the --arch-derived "
                         "points).  Default: --arch derives points from "
                         "the config's shapes; bare kernel names tune the "
                         "single default bucket")
    ap.add_argument("--targets", default=None, metavar="LIST",
                    help="comma-separated machine-target names; the "
                         "campaign covers the full scenarios × targets "
                         "product.  Registered: " + ", ".join(sorted(TARGETS)))
    ap.add_argument("--strategy", default="ppo", choices=sorted(STRATEGIES))
    ap.add_argument("--backend", default="fast", choices=sorted(BACKENDS))
    ap.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR)
    ap.add_argument("--memo-dir", default=None,
                    help="persist the cross-kernel measurement memo here "
                         f"({MEMO_FILENAME}): campaigns warm-start from "
                         "prior measurements and save back on completion; "
                         "concurrent campaigns merge on save "
                         "(fast/pooled backends)")
    ap.add_argument("--workers", type=int, default=1,
                    help="fleet threads for optimize_many (1 = serial)")
    ap.add_argument("--timesteps", type=int, default=8192)
    ap.add_argument("--episode-length", type=int, default=32)
    ap.add_argument("--force", action="store_true",
                    help="re-search even when a cached artifact exists")
    ap.add_argument("--deploy", action="store_true",
                    help="index lookup only; fails if not optimized yet")
    ap.add_argument("--resilient", action="store_true",
                    help="wrap the backend in ResilientBackend (per-measure "
                         "retries, robust timing, circuit breaker)")
    ap.add_argument("--max-retries", type=int, default=2, metavar="N",
                    help="per-cell retry budget across resumable passes; a "
                         "cell failing more than N+1 times total is skipped "
                         "and stays in the failure ledger (default 2)")
    ap.add_argument("--retry-backoff", type=float, default=0.0, metavar="S",
                    help="base backoff before re-running a previously "
                         "failed cell (doubles per prior failure)")
    ap.add_argument("--strict", action="store_true",
                    help="legacy fail-fast: the first failing cell aborts "
                         "the campaign (no failure ledger, no supervision)")
    ap.add_argument("--memo-stats", action="store_true",
                    help="print the shared memo's full counters "
                         "(entries/hits/misses/cross-kernel/evictions) in "
                         "the end-of-campaign output — the cost-model "
                         "corpus growth per run")
    ap.add_argument("--strict-memo", action="store_true",
                    help="die on a corrupt --memo-dir payload instead of "
                         "quarantining it and warm-starting empty")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()

    units: List[FleetUnit] = [(n, None) for n in args.kernels]
    if args.arch:
        from repro_torch.configs import get_config
        from repro_torch.launch.specs import kernel_fleet
        units += kernel_fleet(get_config(args.arch, reduced=True))
    if not units:
        ap.error("give kernel names and/or --arch")
    if args.scenarios:
        # explicit workload points win: every named kernel at every point
        points = parse_scenarios(args.scenarios)
        names = list(dict.fromkeys(n for n, _ in units))
        units = [(n, sc) for n in names for sc in points]
    targets: Optional[List[MachineTarget]] = None
    if args.targets:
        try:
            targets = parse_targets(args.targets)
        except KeyError as e:
            ap.error(str(e).strip('"\''))

    from repro_torch.kernels import get_kernel
    for name in dict.fromkeys(n for n, _ in units):
        get_kernel(name)               # fail fast on unknown names

    backend = make_backend(args.backend)
    if args.resilient and not isinstance(backend, ResilientBackend):
        backend = ResilientBackend(backend)
    memo_path = None
    if args.memo_dir:
        memo = getattr(backend, "memo", None)
        if memo is None:
            print(f"[optimize] --memo-dir ignored: backend "
                  f"{args.backend!r} shares no measurement memo")
        else:
            os.makedirs(args.memo_dir, exist_ok=True)
            memo_path = os.path.join(args.memo_dir, MEMO_FILENAME)
            if os.path.exists(memo_path):
                # corrupt / version-mismatched payloads are quarantined
                # with a warning and the campaign warm-starts empty;
                # --strict-memo keeps the loud pre-search MemoVersionError
                n = warm_start_memo(memo, memo_path,
                                    strict=args.strict_memo)
                print(f"[optimize] warm-started memo from {memo_path}: "
                      f"{n} entries")

    session = OptimizationSession(
        backend=backend,
        strategy=make_budgeted_strategy(args.strategy,
                                        timesteps=args.timesteps,
                                        episode_length=args.episode_length),
        cache_dir=args.cache_dir)

    def label(kernel: str, bucket: Optional[str],
              target: Optional[str]) -> str:
        out = kernel
        if bucket not in (None, DEFAULT_BUCKET):
            out += f"@{bucket}"
        if target is not None and (targets or target != session.target.name):
            out += f" [{target}]"
        return out

    if args.deploy:
        for name, scen in units:
            for tgt in (targets or [None]):
                art = session.deploy(name, scenario=scen, target=tgt)
                print(f"[optimize] {label(name, art.bucket, art.target)}: "
                      f"cached config {art.config} "
                      f"{art.baseline_cycles:.0f} -> "
                      f"{art.optimized_cycles:.0f} "
                      f"cycles ({art.speedup:.3f}x)")
        return

    reqs = campaign_requests(units, targets, force=args.force,
                             verbose=args.verbose)
    ledger = None
    if not args.strict:
        # supervised campaign: per-cell fault isolation, failures land in
        # the persistent ledger and re-running the same command retries
        # exactly the failed cells (healthy ones are cache hits)
        ledger = FailureLedger(os.path.join(args.cache_dir, LEDGER_FILENAME))
        if len(ledger):
            print(f"[optimize] resuming: {len(ledger)} failed cell(s) in "
                  f"{ledger.path}")
    results = session.optimize_many(reqs, max_workers=args.workers,
                                    ledger=ledger,
                                    max_retries=args.max_retries,
                                    retry_backoff=args.retry_backoff)
    ok = [r for r in results if r is not None and r.ok]
    failed = [r for r in results if r is not None and not r.ok]
    degraded = [r for r in ok if getattr(r, "degraded", False)]
    for res in ok:
        art = res.artifact
        tag = "cache" if res.from_cache else res.strategy
        if res.degraded:
            tag += ", DEGRADED"
        print(f"[optimize] {label(res.kernel, res.scenario, res.target)}: "
              f"{art.baseline_cycles:.0f} -> {art.optimized_cycles:.0f} "
              f"cycles ({art.speedup:.3f}x, {tag}, {res.seconds:.1f}s)")
    for res in failed:
        state = "skipped (retry budget spent)" if res.skipped else "FAILED"
        print(f"[optimize] {label(res.kernel, res.scenario, res.target)}: "
              f"{state} after {res.attempts} attempt(s): "
              f"{res.error_type}: {res.error}")
    if ledger is not None:
        print(f"[optimize] campaign: {len(ok)} succeeded "
              f"({len(degraded)} degraded), {len(failed)} failed; "
              f"ledger: {ledger.path} ({len(ledger)} open cell(s))")
    health = getattr(session.backend, "summary", None)
    if callable(health) and isinstance(session.backend, ResilientBackend):
        print(f"[optimize] backend health: {session.backend.summary()}")
    if session.memo is not None:
        print(f"[optimize] shared memo: {session.memo.summary()}")
        if args.memo_stats:
            s = session.memo.stats()
            print(f"[optimize] memo stats: {s['entries']} entries over "
                  f"{s['programs']} programs, {s['hits']} hits / "
                  f"{s['misses']} misses, {s['cross_kernel_hits']} "
                  f"cross-kernel hits, {s['evictions']} evictions")
        if memo_path is not None:
            n = session.memo.save(memo_path)
            print(f"[optimize] saved memo to {memo_path} ({n} entries)")
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
