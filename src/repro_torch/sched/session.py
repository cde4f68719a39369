"""The optimization session — backend-pluggable, fleet-scale successor of
the monolithic ``CuAsmRL`` class (paper §4 "transparent integration",
re-architected around three small protocols):

* :class:`repro_torch.sched.backends.MeasureBackend` — how schedules are timed
  (dataflow oracle / timing-only fast path / fast path + worker pool), and
  the cross-kernel measurement memo;
* :class:`SearchStrategy` — how the schedule space is searched (PPO over
  the assembly game, plus cheap greedy-swap and random-search baselines for
  A/B tests and CI; the port runs the greedy and random strategies, PPO
  and the cost-model-guided ones raise until they are ported);
* :class:`OptimizeRequest` / :class:`OptimizeResult` — declarative inputs
  and outputs replacing the old tangle of constructor kwargs.

:class:`OptimizationSession` owns the per-target stall table (Table 1,
built once and shared by every kernel), the shared memo (via its backend)
and a versioned :class:`repro_torch.sched.cache.ScheduleCache`, and exposes

    session = OptimizationSession(strategy="greedy")
    res  = session.optimize(OptimizeRequest(kernel="bmm"))
    fleet = session.optimize_many(["matmul_leakyrelu", "bmm"])
    art  = session.deploy("bmm")            # index lookup; no autotune,
                                            # no machine execution

``optimize_many`` runs a whole kernel fleet through one session — serially
by default (exact memo statistics), or concurrently with ``max_workers`` —
while every kernel reuses the same stall table and measurement memo.
Kernel names resolve through the ``@register_kernel`` registry in
:mod:`repro_torch.kernels`.

Port of ``repro/sched/session.py``; the port's :class:`KernelDef` holds
the kernel's hand-written Hopper callable where the reference holds its
Pallas one.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import (Dict, Iterable, List, Optional, Protocol, Sequence,
                    Union, runtime_checkable)

import numpy as np

from repro_torch.core.env import AssemblyGame
from repro_torch.core.isa import Instruction
from repro_torch.core.microbench import build_stall_table
from repro_torch.sched import autotune as autotune_mod
from repro_torch.sched import baseline, lowering, verify
from repro_torch.sched.backends import (FastTimingBackend, MeasureBackend,
                                        make_backend)
from repro_torch.sched.cache import (DEFAULT_CACHE_DIR, TARGET, Artifact,
                                     ScheduleCache)
from repro_torch.sched.scenario import (MachineTarget, Scenario, bucket_of,
                                        build_spec, get_target)
from repro_torch.sched.spec import KernelSpec


@dataclasses.dataclass
class KernelDef:
    """One optimizable kernel: its kernel/plain callables plus the schedule
    spec constructor and the autotuner's configuration space.

    ``kernel_fn`` is the hand-written Hopper kernel's wrapper, called as
    ``kernel_fn(*tensors, **config)`` with a config the optimizer deploys;
    it stands where the reference's ``KernelDef.pallas_fn`` holds the
    Pallas TPU kernel.  ``ref_fn`` is the plain PyTorch version."""
    name: str
    make_spec: "callable"
    configs: List[Dict]
    kernel_fn: Optional["callable"] = None
    ref_fn: Optional["callable"] = None


# ---------------------------------------------------------------------------
# requests / results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OptimizeRequest:
    """Declarative description of one kernel optimization.

    ``kernel`` is a registry name or a :class:`KernelDef`; ``config=None``
    autotunes the kernel's config grid first (§3.1 hierarchical search),
    a pinned config skips autotune.  ``strategy`` overrides the session
    default (a name from :data:`STRATEGIES` or a strategy instance).
    The reference's ``ppo`` field (the PPO strategy's config) arrives
    with the PPO strategy (ROADMAP A7).

    ``scenario`` tunes the kernel for one workload point — the scenario
    flows into autotune and spec construction, and the artifact lands in
    the scenario's bucket of the cache index (``None`` keeps the legacy
    single-point behaviour bit-exactly: default bucket, identical spec).
    ``target`` overrides the session's machine target for this request —
    a campaign can sweep targets through one session, each measured on its
    own machine against its own stall table.
    """
    kernel: Union[str, KernelDef]
    config: Optional[Dict] = None
    strategy: Optional[Union[str, "SearchStrategy"]] = None
    verify_seeds: Optional[int] = None
    force: bool = False
    verbose: bool = False
    scenario: Optional[Scenario] = None
    target: Optional[Union[str, MachineTarget]] = None

    @property
    def kernel_name(self) -> str:
        return self.kernel if isinstance(self.kernel, str) else self.kernel.name


@dataclasses.dataclass
class OptimizeResult:
    kernel: str
    artifact: Artifact
    config: Dict
    from_cache: bool
    strategy: str
    backend: str
    stats: List[Dict]                       # per-update / per-step search rows
    tune: Optional[autotune_mod.TuneResult] = None
    seconds: float = 0.0
    scenario: Optional[str] = None          # bucket key (None = default)
    target: str = TARGET
    degraded: bool = False                  # measured with an open breaker

    @property
    def speedup(self) -> float:
        return self.artifact.speedup

    @property
    def ok(self) -> bool:
        return True


@dataclasses.dataclass
class OptimizeFailure:
    """One cell's captured failure from a supervised ``optimize_many``
    (``on_error="collect"``): the fleet keeps going, the error rides
    along.  ``attempts`` counts this cell's failures across resumable
    campaign passes (from the
    :class:`repro_torch.sched.resilience.FailureLedger`
    when one is attached); ``skipped=True`` marks a cell whose retry
    budget was already exhausted, so this pass did not re-run it."""
    kernel: str
    error: str
    error_type: str
    attempts: int = 1
    scenario: Optional[str] = None          # bucket key (None = default)
    target: str = TARGET
    request: Optional[OptimizeRequest] = None
    seconds: float = 0.0
    skipped: bool = False

    @property
    def ok(self) -> bool:
        return False


# ---------------------------------------------------------------------------
# search strategies
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SearchOutcome:
    """What any strategy must produce from one program's search."""
    best_program: List[Instruction]
    best_cycles: float
    baseline_cycles: float
    stats: List[Dict]


@runtime_checkable
class SearchStrategy(Protocol):
    name: str

    def search(self, program: Sequence[Instruction], *,
               stall_db: Dict[str, int], backend: MeasureBackend,
               owner: str = "", verbose: bool = False) -> SearchOutcome:
        ...


def _not_ported(name: str, needs: str, item: str):
    def make(*args, **kwargs):
        raise NotImplementedError(
            f"the {name!r} search strategy needs {needs}, which the port "
            f"does not have yet (ROADMAP {item}); the port runs the "
            f"'greedy' and 'random' strategies")
    return make


class PPOStrategy:
    """The paper's assembly game: PPO over vectorized envs (the
    reference's ``repro.core.game.train_on_program``).  Not ported yet:
    constructing it raises, naming ROADMAP A7."""

    name = "ppo"

    def __init__(self):
        _not_ported("ppo", "core/ppo.py and core/game.py", "A7")()


def _strategy_env(program, stall_db, backend, owner, episode_length):
    return AssemblyGame(program, stall_db=stall_db,
                        machine=backend.new_machine(),
                        episode_length=episode_length,
                        use_fast_measure=backend.fast_measure,
                        measure_cache=backend.memo_view(program, owner))


class GreedySwapStrategy:
    """Steepest-descent baseline: evaluate every currently-legal swap
    (probe / revert — adjacent swaps are self-inverse), take the best
    strictly-improving one, stop when none improves or the step budget
    runs out.  Deterministic; useful for A/B against PPO and in CI."""

    name = "greedy"

    def __init__(self, max_steps: int = 64):
        self.max_steps = int(max_steps)

    def search(self, program, *, stall_db, backend, owner="", verbose=False):
        env = _strategy_env(program, stall_db, backend, owner,
                            episode_length=self.max_steps + 1)
        env.reset()
        stats: List[Dict] = []
        for step in range(self.max_steps):
            actions = env.valid_actions()
            best_a, best_c = None, env.prev_cycles
            for a in actions:
                c = env.probe_swap(env.action_swap_pos(a))
                if c < best_c:
                    best_a, best_c = a, c
            if best_a is None:
                break
            env.step(best_a)
            stats.append({"step": step, "cycles": best_c,
                          "candidates": len(actions), "time": time.time()})
            if verbose:
                print(f"[greedy] step={step} cycles={best_c:.0f} "
                      f"(of {len(actions)} candidates)")
        return SearchOutcome(
            best_program=[ins.copy() for ins in env.best_program],
            best_cycles=env.best_cycles, baseline_cycles=env.t0, stats=stats)


class RandomSearchStrategy:
    """Uniform random masked walks with episode restarts — the sanity floor
    any learned policy must beat."""

    name = "random"

    def __init__(self, episodes: int = 8, episode_length: int = 32,
                 seed: int = 0):
        self.episodes = int(episodes)
        self.episode_length = int(episode_length)
        self.seed = int(seed)

    def search(self, program, *, stall_db, backend, owner="", verbose=False):
        env = _strategy_env(program, stall_db, backend, owner,
                            episode_length=self.episode_length)
        rng = np.random.default_rng(self.seed)
        stats: List[Dict] = []
        for ep in range(self.episodes):
            env.reset()
            for _ in range(self.episode_length):
                actions = env.valid_actions()
                if not actions:
                    break
                _, _, done, _ = env.step(int(rng.choice(actions)))
                if done:
                    break
            stats.append({"episode": ep, "best_cycles": env.best_cycles,
                          "time": time.time()})
            if verbose:
                print(f"[random] ep={ep} best={env.best_cycles:.0f}")
        return SearchOutcome(
            best_program=[ins.copy() for ins in env.best_program],
            best_cycles=env.best_cycles, baseline_cycles=env.t0, stats=stats)


# the reference's names, so the launcher takes the same --strategy values;
# the cost-model-guided strategies (repro/costmodel/search.py) are not
# ported yet and raise when built
STRATEGIES = {
    "ppo": PPOStrategy,
    "greedy": GreedySwapStrategy,
    "random": RandomSearchStrategy,
    "beam": _not_ported("beam", "the cost model (costmodel/)", "A11"),
    "lookahead": _not_ported("lookahead", "the cost model (costmodel/)",
                             "A11"),
}


def make_strategy(name: str, **kwargs) -> SearchStrategy:
    try:
        cls = STRATEGIES[name]
    except KeyError:
        raise KeyError(f"unknown strategy {name!r}; one of {sorted(STRATEGIES)}")
    return cls(**kwargs)


def make_budgeted_strategy(name: str, timesteps: int = 8192,
                           episode_length: int = 32) -> SearchStrategy:
    """A strategy instance whose search budget honours the launcher-style
    ``--timesteps`` / ``--episode-length`` flags, for every strategy.  One
    definition so the CLI and the tests stay in lockstep: greedy applies
    up to one episode of steepest-descent moves; random search spends the
    timestep budget across restarts; the strategies not ported yet raise
    (their budgets arrive with them)."""
    if name == "greedy":
        return GreedySwapStrategy(max_steps=episode_length)
    if name == "random":
        return RandomSearchStrategy(
            episodes=max(1, timesteps // max(episode_length, 1)),
            episode_length=episode_length)
    return make_strategy(name)


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

class OptimizationSession:
    """Fleet-scale optimization front end over pluggable backend + strategy.

    One session amortizes the expensive per-target state across every
    kernel it optimizes: the microbenchmarked stall table is built once,
    measurements flow through the backend's shared memo (identical
    schedules — across envs, autotune/training phases and even kernels —
    are timed once), and finished artifacts land in a spec-hash-indexed
    :class:`ScheduleCache` so deployment is pure lookup.
    """

    def __init__(self, backend: Union[str, MeasureBackend, None] = None,
                 strategy: Union[str, SearchStrategy] = "ppo",
                 cache_dir: str = DEFAULT_CACHE_DIR,
                 target: Union[str, MachineTarget] = TARGET,
                 stall_db: Optional[Dict[str, int]] = None,
                 verify_seeds: int = 4,
                 cache: Optional[ScheduleCache] = None):
        if backend is None:
            backend = FastTimingBackend()
        elif isinstance(backend, str):
            backend = make_backend(backend)
        self.backend = backend
        self.strategy = strategy
        self.target = get_target(target)
        self.verify_seeds = verify_seeds
        self.cache = cache if cache is not None else \
            ScheduleCache(cache_dir, self.target)
        self._stall_tables: Dict[MachineTarget, Dict[str, int]] = {}
        if stall_db is not None:
            self._stall_tables[self.target] = stall_db
        self._stall_lock = threading.Lock()
        self._backend_lock = threading.Lock()
        self._target_backends: Dict[MachineTarget, MeasureBackend] = {}

    # -- shared per-target state ---------------------------------------------

    @property
    def memo(self):
        """The backend's cross-kernel measurement memo (``None`` for
        backends that do not share measurements)."""
        return getattr(self.backend, "memo", None)

    def stall_table(self, target: Union[str, MachineTarget, None] = None
                    ) -> Dict[str, int]:
        """Table 1 for ``target``, microbenchmarked once per session on
        the target's own machine (tables are keyed by the
        :class:`MachineTarget` itself, so a campaign over several targets
        never mixes their stall counts)."""
        target = get_target(target) if target is not None else self.target
        with self._stall_lock:
            db = self._stall_tables.get(target)
            if db is None:
                db = build_stall_table(
                    machine=self.backend_for(target).new_machine())
                self._stall_tables[target] = db
            return db

    def backend_for(self, target: Union[str, MachineTarget, None]
                    ) -> MeasureBackend:
        """The measurement backend for ``target``: the session backend for
        the session's own target (legacy path, including custom machine
        factories), a memo-sharing sibling re-pointed at the target's
        machine for every other — so one campaign's measurements all flow
        through one memo while never mixing machines."""
        target = get_target(target) if target is not None else self.target
        if target == self.target:
            return self.backend
        with self._backend_lock:
            be = self._target_backends.get(target)
            if be is None:
                for_target = getattr(self.backend, "for_target", None)
                if for_target is None:
                    raise TypeError(
                        f"backend {self.backend.name!r} cannot re-point at "
                        f"target {target.name!r}: it defines no "
                        f"for_target(machine_factory) (see "
                        f"repro_torch.sched.backends.MeasureBackend)")
                be = for_target(target.new_machine)
                self._target_backends[target] = be
            return be

    # -- resolution -----------------------------------------------------------

    @staticmethod
    def _resolve_kernel(kernel: Union[str, KernelDef]) -> KernelDef:
        if isinstance(kernel, KernelDef):
            return kernel
        from repro_torch import kernels as kernels_mod   # registry; import cycle
        return kernels_mod.get_kernel(kernel)

    def _resolve_strategy(self, req: OptimizeRequest) -> SearchStrategy:
        s = req.strategy if req.strategy is not None else self.strategy
        return make_strategy(s) if isinstance(s, str) else s

    # -- §4.2 Listing 5: invoke optimization ----------------------------------

    def optimize(self, request: Union[OptimizeRequest, str, KernelDef]
                 ) -> OptimizeResult:
        if not isinstance(request, OptimizeRequest):
            request = OptimizeRequest(kernel=request)
        t_start = time.time()
        kdef = self._resolve_kernel(request.kernel)
        strategy = self._resolve_strategy(request)
        scenario = request.scenario
        bucket = scenario.bucket if scenario is not None else None
        target = (get_target(request.target) if request.target is not None
                  else self.target)
        backend = self.backend_for(target)

        tune = None
        if request.config is not None:
            cfg = dict(request.config)
        else:
            # §3.1 stage 1 — grid timings flow through the shared memo, so
            # a fleet re-times each distinct candidate schedule only once;
            # the scenario shapes the specs, so each bucket scores the
            # grid on its own workload point
            tune = autotune_mod.autotune(
                kdef.make_spec, kdef.configs,
                time_fn=backend.autotune_time_fn(kdef.name),
                scenario=scenario)
            cfg = tune.best.config

        if not request.force:
            art = self.cache.lookup(kdef.name, cfg, scenario=scenario,
                                    target=target)
            if art is not None:
                return OptimizeResult(
                    kernel=kdef.name, artifact=art, config=cfg,
                    from_cache=True, strategy=strategy.name,
                    backend=backend.name, stats=[], tune=tune,
                    seconds=time.time() - t_start,
                    scenario=bucket, target=target.name,
                    degraded=bool(getattr(backend, "circuit_open", False)))

        spec: KernelSpec = build_spec(kdef.make_spec, cfg, scenario)
        o3 = baseline.schedule(lowering.lower(spec))
        outcome = strategy.search(o3, stall_db=self.stall_table(target),
                                  backend=backend, owner=kdef.name,
                                  verbose=request.verbose)

        n_seeds = (request.verify_seeds if request.verify_seeds is not None
                   else self.verify_seeds)
        check = verify.probabilistic_test(o3, outcome.best_program,
                                          n_seeds=n_seeds,
                                          machine=backend.new_machine())
        if not check.ok:
            raise RuntimeError(
                f"probabilistic testing FAILED for {kdef.name}: "
                f"seeds {check.failures} — masking bug, refusing to cache")

        art = Artifact(
            kernel=kdef.name, target=target.name, config=cfg,
            program=outcome.best_program,
            baseline_cycles=outcome.baseline_cycles,
            optimized_cycles=outcome.best_cycles,
            scenario=bucket,
            meta={
                "autotune": ([dataclasses.asdict(e) for e in tune.entries]
                             if tune is not None else []),
                "improvement": ((outcome.baseline_cycles - outcome.best_cycles)
                                / outcome.baseline_cycles),
                "ppo_updates": len(outcome.stats),
                "verify_seeds": check.n_seeds,
                "strategy": strategy.name,
                "backend": backend.name,
                "scenario": (dataclasses.asdict(scenario)
                             if scenario is not None else {}),
            })
        # a pinned config is an entry, not necessarily the bucket's chosen
        # deploy config; autotuned runs define (or refresh) the index best
        self.cache.put(art, best=(request.config is None))
        return OptimizeResult(
            kernel=kdef.name, artifact=art, config=cfg, from_cache=False,
            strategy=strategy.name, backend=backend.name,
            stats=outcome.stats, tune=tune,
            seconds=time.time() - t_start, scenario=bucket,
            target=target.name,
            degraded=bool(getattr(backend, "circuit_open", False)))

    def _cell_key(self, req: OptimizeRequest) -> str:
        """The request's campaign-cell id (``kernel@bucket@target``) —
        the key failure ledgers track retries under."""
        from repro_torch.sched.resilience import cell_key
        target = (get_target(req.target) if req.target is not None
                  else self.target)
        return cell_key(req.kernel_name, req.scenario, target)

    def _optimize_isolated(self, req: OptimizeRequest, ledger,
                           max_retries: Optional[int],
                           retry_backoff: float
                           ) -> Union[OptimizeResult, "OptimizeFailure"]:
        """One supervised cell: run ``optimize``, capture any failure
        (verify refusal, backend exhaustion, hard fault, ...) instead of
        letting it kill the fleet; consult/update the ledger so resumable
        passes retry exactly the still-failing cells with backoff."""
        bucket = req.scenario.bucket if req.scenario is not None else None
        target = (get_target(req.target) if req.target is not None
                  else self.target)
        cell = self._cell_key(req)
        prior, backoff = 0, 0.0
        if ledger is not None:
            prior = ledger.attempts(cell)
            if not ledger.should_attempt(cell, max_retries):
                entry = ledger.failed_cells().get(cell, {})
                return OptimizeFailure(
                    kernel=req.kernel_name,
                    error=entry.get("error", "retry budget exhausted"),
                    error_type=entry.get("error_type", "Skipped"),
                    attempts=prior, scenario=bucket, target=target.name,
                    request=req, skipped=True)
            if prior and retry_backoff > 0:
                backoff = retry_backoff * (2.0 ** (prior - 1))
                time.sleep(backoff)
        t0 = time.time()
        try:
            res = self.optimize(req)
        except Exception as e:
            if ledger is not None:
                ledger.record_failure(cell, e, backoff=backoff)
            return OptimizeFailure(
                kernel=req.kernel_name, error=str(e),
                error_type=type(e).__name__, attempts=prior + 1,
                scenario=bucket, target=target.name, request=req,
                seconds=time.time() - t0)
        if ledger is not None:
            ledger.record_success(cell)
        return res

    def optimize_many(self,
                      requests: Iterable[Union[OptimizeRequest, str, KernelDef]],
                      max_workers: Optional[int] = None,
                      on_error: str = "raise",
                      ledger=None,
                      max_retries: Optional[int] = None,
                      retry_backoff: float = 0.0
                      ) -> List[Union[OptimizeResult, "OptimizeFailure"]]:
        """Optimize a fleet of kernels through the shared session state.

        Serial by default (memo statistics stay exact); ``max_workers > 1``
        fans kernels out over a thread pool — measured values are
        deterministic either way (the memo is bit-exact), only the
        hit/miss attribution can shift under concurrency.

        ``on_error="raise"`` (default) keeps the legacy contract: the
        first failing cell's exception propagates — but the threaded path
        now lets every sibling finish first instead of discarding their
        work mid-flight.  ``on_error="collect"`` supervises the fleet:
        each cell's failure is captured as an :class:`OptimizeFailure` in
        the returned list (same order as the requests) and the campaign
        keeps going.  Attaching a
        :class:`repro_torch.sched.resilience.FailureLedger` (implies collect)
        makes the campaign *resumable*: failures persist with attempt
        counts, a later identical ``optimize_many`` retries only the
        still-failed cells (after ``retry_backoff * 2**(attempts-1)``
        seconds), and cells past ``max_retries`` failures come back as
        ``skipped`` failures without re-running.
        """
        if on_error not in ("raise", "collect"):
            raise ValueError(
                f"on_error must be 'raise' or 'collect', got {on_error!r}")
        collect = on_error == "collect" or ledger is not None
        reqs = [r if isinstance(r, OptimizeRequest) else OptimizeRequest(kernel=r)
                for r in requests]

        def run_one(r: OptimizeRequest):
            if collect:
                return self._optimize_isolated(r, ledger, max_retries,
                                               retry_backoff)
            return self.optimize(r)

        if max_workers is not None and max_workers > 1 and len(reqs) > 1:
            # build each target's stall table once, not racing in the pool
            for tgt in {get_target(r.target) if r.target is not None
                        else self.target for r in reqs}:
                self.stall_table(tgt)
            with ThreadPoolExecutor(max_workers=max_workers) as pool:
                futures = [pool.submit(run_one, r) for r in reqs]
                outcomes, first_err = [], None
                for f in futures:     # gather ALL siblings before raising
                    try:
                        outcomes.append(f.result())
                    except Exception as e:
                        outcomes.append(None)
                        if first_err is None:
                            first_err = e
                if first_err is not None:
                    raise first_err
                return outcomes
        return [run_one(r) for r in reqs]

    # -- §4.2 Listing 5: deployment lookup ------------------------------------

    def deploy(self, kernel: Union[str, KernelDef],
               config: Optional[Dict] = None,
               scenario: Optional[Union[Scenario, str]] = None,
               target: Optional[Union[str, MachineTarget]] = None
               ) -> Artifact:
        """Deploy-time lookup: resolve the kernel's chosen config through
        the cache index and return the artifact — **no** autotune, no
        machine execution (the paper's search/deploy split, minus the
        legacy bug of re-running the grid search per lookup).

        With a ``scenario``, the request shape dispatches to the *nearest*
        tuned bucket (still a pure index read); without one, the default
        bucket resolves exactly as before the scenario axis existed."""
        name = kernel if isinstance(kernel, str) else kernel.name
        if config is not None:
            art = self.cache.lookup(name, config, scenario=scenario,
                                    target=target)
        elif scenario is not None:
            art = self.cache.dispatch(name, scenario, target=target)
        else:
            art = self.cache.lookup_best(name, target=target)
        if art is None:
            raise FileNotFoundError(
                f"no cached schedule for {name}"
                + (f" (scenario {bucket_of(scenario)})"
                   if scenario is not None else "")
                + "; run optimize() offline first (the paper's "
                  "search/deploy split)")
        return art
