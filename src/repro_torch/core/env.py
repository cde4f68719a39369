"""The assembly game (paper §3.3–§3.6).

The environment holds a TSASS program (the state), exposes the action space
"pick a schedulable memory instruction, swap it with the instruction above or
below" (§3.5), computes a dynamic action mask from register / barrier /
stall-count / heuristic dependencies (§3.5 + Algorithm 1), and rewards with
the measured runtime delta ``R_i = (T_{i-1} - T_i) / T_0 * 100`` (§3.6).

Two masking implementations:

* :func:`can_swap` — the reference, a literal transcription of §3.5 +
  Algorithm 1 over instruction lists;
* the environment's fast path — identical semantics, O(1) amortized per
  action.  It exploits an invariant of masked games: the *relations*
  (nearest definition, consumers-before-redefinition, basic-block
  membership) cannot change under masked swaps — only positions do — so
  they are precomputed once and stall accumulations become prefix-sum
  lookups.  A property test drives thousands of random games asserting the
  two paths agree exactly.

The masking rules guarantee (and property tests verify) that any sequence of
masked actions preserves the observable dataflow semantics of the program on
the machine model.

Reward measurement has the same two-path structure as masking: the dataflow
oracle ``Machine.run`` stays the reference, while the default fast path
measures through :class:`repro_torch.core.timing.ScheduleTimer` (timing-only
scoreboard, checkpointed so an adjacent swap re-times only the program
suffix) behind a schedule->cycles memo keyed by the position->identity
permutation — shareable across the vectorized training envs, with hit/miss
counters surfaced into ``GameResult.stats``.  The fast path is bit-exact
(property-tested in ``tests/test_timing_fast.py``), and ``step`` splits
into ``begin_step`` / ``prime_measure`` / ``finish_step`` so a caller can
batch one step's measurements for all envs through the shared memo.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import analysis as analysis_mod
from repro_torch.core import embedding
from repro_torch.core.isa import Instruction, OpClass, is_fixed_latency
from repro_torch.core.machine import Machine
from repro_torch.core.parser import block_id_vector, memory_effects
from repro_torch.core.timing import ScheduleTimer

EPISODE_LENGTH = 32  # §5.7: sufficient for the paper's kernels


def _cells_alias(a: tuple, b: tuple) -> bool:
    if a == b:
        return True
    if a == ("addr", "?") or b == ("addr", "?"):
        return True
    if a[0] == "tile" and b[0] == "tile" and a[1] == b[1]:
        return a[2] == -1 or b[2] == -1 or a[2] == b[2]
    return False


def _sems_set(ins: Instruction) -> frozenset:
    s = set()
    if ins.ctrl.read_bar is not None:
        s.add(ins.ctrl.read_bar)
    if ins.ctrl.write_bar is not None:
        s.add(ins.ctrl.write_bar)
    return frozenset(s)


# ---------------------------------------------------------------------------
# reference masking (literal §3.5 + Algorithm 1)
# ---------------------------------------------------------------------------

def can_swap(program: Sequence[Instruction], p: int,
             stall_table: Dict[str, int],
             blocks: Optional[List[int]] = None) -> bool:
    """May positions ``p-1`` and ``p`` be exchanged?

    Implements every dependency class of §3.5: register, barrier, stall count
    (Algorithm 1, both the moving instruction's producers and the displaced
    neighbour's consumers), and the hard-coded heuristics (no crossing basic
    blocks / synchronization; consecutive-DMA groups keep their order).
    Unknown stall counts mask conservatively.
    """
    if p <= 0 or p >= len(program):
        return False
    a, b = program[p - 1], program[p]
    if blocks is None:
        blocks = block_id_vector(program)
    if blocks[p - 1] != blocks[p]:
        return False
    if a.klass is OpClass.SYNC or b.klass is OpClass.SYNC:
        return False

    # --- heuristic: consecutive-DMA group order is pinned (§3.5) ------------
    if a.group is not None and a.group == b.group:
        return False

    # --- register dependencies ----------------------------------------------
    a_defs, a_uses = a.defs or frozenset(), a.uses or frozenset()
    b_defs, b_uses = b.defs or frozenset(), b.uses or frozenset()
    if (a_defs & b_uses) or (a_uses & b_defs) or (a_defs & b_defs):
        return False

    # --- memory aliasing -----------------------------------------------------
    for cell_a, wa in memory_effects(a):
        for cell_b, wb in memory_effects(b):
            if (wa or wb) and _cells_alias(cell_a, cell_b):
                return False

    # --- barrier dependencies: a waiter never moves above its setter ---------
    if _sems_set(a) & b.ctrl.wait_mask:
        return False

    # --- stall-count dependencies (Algorithm 1, both directions) -------------
    if not _stall_ok_after_swap_up(program, blocks, p, b, stall_table):
        return False
    if is_fixed_latency(a.opcode) and a_defs:
        if not _stall_ok_neighbor_down(program, blocks, p, a, b, stall_table):
            return False
    return True


def _stall_ok_after_swap_up(program, blocks, p, b, stall_table) -> bool:
    """Algorithm 1 of the paper, evaluated in the post-swap order: walk
    upward from the moved instruction accumulating stall counts; on reaching
    a defining fixed-latency instruction, the accumulation must reach its
    minimum stall count."""
    b_uses = b.uses or frozenset()
    if not b_uses:
        return True
    blk = blocks[p]
    for reg in b_uses:
        if reg.startswith("UR"):
            continue  # uniform registers: prologue constants
        accum = 0
        for j in range(p - 2, -1, -1):       # post-swap predecessors of b
            ins = program[j]
            if blocks[j] != blk:
                break
            accum += max(1, ins.ctrl.stall)
            if reg in (ins.defs or ()):
                if is_fixed_latency(ins.opcode):
                    min_st = stall_table.get(ins.opcode)
                    if min_st is None or accum < min_st:
                        return False
                break  # nearest definition decides
    return True


def _stall_ok_neighbor_down(program, blocks, p, a, b, stall_table) -> bool:
    """The displaced neighbour ``a`` (fixed-latency) moves one slot down:
    its consumers below must still see enough accumulated stall."""
    min_st = stall_table.get(a.opcode)
    blk = blocks[p - 1]
    for reg in a.defs or ():
        accum = max(1, a.ctrl.stall)         # post-swap: a sits at p
        for j in range(p + 1, len(program)):
            ins = program[j]
            if blocks[j] != blk:
                break
            if reg in (ins.uses or ()):
                if min_st is None or accum < min_st:
                    return False
                break  # first use is binding (later uses accumulate more)
            if reg in (ins.defs or ()):
                break  # redefined: liveness ends
            accum += max(1, ins.ctrl.stall)
    return True


# ---------------------------------------------------------------------------
# fast masking: precomputed invariant relations + prefix sums
# ---------------------------------------------------------------------------

class _FastDeps:
    """Per-instruction-identity facts that are invariant under masked swaps."""

    def __init__(self, program: Sequence[Instruction],
                 stall_table: Dict[str, int], blocks: List[int]):
        n = len(program)
        self.n = n
        self.block = list(blocks)
        self.sync = [ins.klass is OpClass.SYNC for ins in program]
        self.stall = np.array([max(1, ins.ctrl.stall) for ins in program],
                              np.int64)
        self.stall_list = self.stall.tolist()   # plain ints for hot loops
        self.defs = [ins.defs or frozenset() for ins in program]
        self.uses = [ins.uses or frozenset() for ins in program]
        self.sems = [_sems_set(ins) for ins in program]
        self.wait = [ins.ctrl.wait_mask for ins in program]
        self.group = [ins.group for ins in program]
        self.effects = [memory_effects(ins) for ins in program]
        self.fixed = [is_fixed_latency(ins.opcode) for ins in program]
        self.min_st = [stall_table.get(ins.opcode) if self.fixed[i] else None
                       for i, ins in enumerate(program)]

        # nearest in-block fixed-latency producer per use register
        last_def: Dict[str, int] = {}
        self.producers: List[List[Tuple[int, Optional[int]]]] = \
            [[] for _ in range(n)]
        consumers: List[List[int]] = [[] for _ in range(n)]
        for i, ins in enumerate(program):
            if self.sync[i]:
                last_def.clear()
                continue
            for reg in self.uses[i]:
                if reg.startswith("UR"):
                    continue
                j = last_def.get(reg)
                if j is not None and self.fixed[j]:
                    self.producers[i].append((j, self.min_st[j]))
                    consumers[j].append(i)
            for reg in self.defs[i]:
                last_def[reg] = i
        # consumers of fixed-latency defs (before redefinition, same block)
        self.consumers = consumers

    def alias(self, ia: int, ib: int) -> bool:
        for cell_a, wa in self.effects[ia]:
            for cell_b, wb in self.effects[ib]:
                if (wa or wb) and _cells_alias(cell_a, cell_b):
                    return True
        return False


@dataclasses.dataclass
class StepRecord:
    slot: int
    direction: int           # 0 = up, 1 = down
    position: int            # position of the instruction before the move
    cycles_before: float
    cycles_after: float
    moved: Instruction = None
    hops: int = 1            # micro-swaps applied (macro-move option)


class AssemblyGame:
    """Gym-style interface (reset/step) for one kernel's schedule."""

    def __init__(self, program: Sequence[Instruction],
                 stall_db: Optional[Dict[str, int]] = None,
                 machine: Optional[Machine] = None,
                 episode_length: int = EPISODE_LENGTH,
                 input_seed: int = 0,
                 use_fast_mask: bool = True,
                 warm_start: bool = False,
                 hop_sizes: Tuple[int, ...] = (1,),
                 use_fast_measure: bool = True,
                 measure_cache: Optional[Dict[bytes, float]] = None,
                 checkpoint_every: int = 16):
        # warm_start: BEYOND-PAPER option (EXPERIMENTS.md §Perf): episodes
        # restart from the incumbent best schedule instead of the -O3
        # baseline (iterated-local-search flavor); the paper's vanilla game
        # always restarts from the baseline.
        # hop_sizes: BEYOND-PAPER option: action (slot, dir, hop) applies up
        # to ``hop`` consecutive single-slot swaps to the same instruction,
        # each individually masked (safety is inherited); the paper's game
        # is hop_sizes=(1,).
        # use_fast_measure: measure rewards through the timing-only
        # incremental executor plus a permutation-keyed memo instead of the
        # dataflow oracle.  Bit-exact (see repro_torch.core.timing), so on by
        # default; auto-disabled for noisy machines (the memo would freeze
        # one noise draw) and for Machine subclasses that override run.
        # measure_cache: share a schedule -> cycles memo across games over
        # the *same* instruction list (train_on_program's vectorized envs
        # all measure the same baseline and early-episode schedules).  A
        # session backend passes a SharedMeasureMemo view here, which
        # namespaces the permutation keys by program fingerprint so the
        # memo is additionally shared across kernels and autotune phases.
        self.original = [ins.copy() for ins in program]
        self.machine = machine or Machine()
        self.episode_length = episode_length
        self.input_seed = input_seed
        self.use_fast_mask = use_fast_mask
        self.warm_start = warm_start
        self.hop_sizes = tuple(hop_sizes)
        self.analysis = analysis_mod.analyze(self.original, stall_db)
        self.blocks = list(self.analysis.blocks)
        self.n = len(self.original)
        self.slots = list(self.analysis.mem_slots)  # slot -> original index
        self.m = len(self.slots)
        self.num_actions = 2 * self.m * len(self.hop_sizes)
        self.feature_dim = embedding.feature_dim(self.analysis)
        self.deps = _FastDeps(self.original, self.analysis.stall_table,
                              self.blocks)
        self._swap_ok: Dict[int, bool] = {}  # ordered-pair static-mask memo
        # instruction content is immutable; only order changes -> embed once
        self._emb = embedding.embed_program(self.original, self.analysis,
                                            n_rows=self.n)
        # run-global best (survives episode resets — §4.2: "the best
        # optimized cubin found throughout the assembly game")
        self.best_cycles = float("inf")
        self.best_program = list(self.original)
        # fast measurement path: timing-only incremental executor + memo.
        # Bit-exactness only holds for the stock noise-free Machine.
        self._fast_measure = (use_fast_measure and self.machine.noise == 0
                              and type(self.machine).run is Machine.run)
        self._timer = (ScheduleTimer(self.original, checkpoint_every)
                       if self._fast_measure else None)
        self._memo: Dict[bytes, float] = \
            measure_cache if measure_cache is not None else {}
        self._prefetched: set = set()
        self._pending = None
        self.measure_calls = 0
        self.memo_hits = 0
        self.memo_misses = 0
        self._reset_state()

    # -- bookkeeping ----------------------------------------------------------

    def _reset_state(self):
        # instructions are immutable during the game (only order changes):
        # share objects so machine-side exec caches persist across episodes
        start = (self.best_program if self.warm_start
                 and getattr(self, "best_program", None) is not None
                 and not np.isinf(getattr(self, "best_cycles", np.inf))
                 else self.original)
        self.program = list(start)
        index_of = {id(ins): i for i, ins in enumerate(self.original)}
        ids = np.array([index_of[id(ins)] for ins in self.program])
        self.id_at = ids                          # position -> identity
        self._ids = ids.tolist()                  # plain-int mirror of id_at
        self.pos_of = np.argsort(ids).tolist()    # identity -> position
        self.slot_pos = {k: self.pos_of[idx]
                         for k, idx in enumerate(self.slots)}
        self.slot_at = [-1] * self.n              # position -> slot (or -1)
        for k, pos in self.slot_pos.items():
            self.slot_at[pos] = k
        # Algorithm-1 prefix sums (S[x] = stalls of positions < x), kept
        # incrementally: an adjacent swap at q only changes S[q]
        self._prefix = \
            [0] + np.cumsum(self.deps.stall[self.id_at]).tolist()
        self.t = 0
        self._mask_cache: Optional[np.ndarray] = None
        # incremental masking: per-position swap-ok cache (-1 = dirty).
        # A swap at q can only change the checks enumerated in _swap, so
        # everything else survives across steps instead of being recomputed
        # row-by-row (ROADMAP "incremental mask").
        self._ok_at = np.full(self.n + 1, -1, np.int8)
        start_cycles = self._measure()
        if not hasattr(self, "t0"):
            self.t0 = start_cycles       # Eq. 3's T_0: pinned to the -O3
                                         # baseline even under warm starts
        self.prev_cycles = start_cycles
        if start_cycles < self.best_cycles:
            self.best_cycles = start_cycles
            self.best_program = list(self.program)
        self.history: List[StepRecord] = []

    def _measure(self) -> float:
        self.measure_calls += 1
        if self._timer is None:
            return self.machine.run(self.program,
                                    input_seed=self.input_seed).cycles
        key = self.id_at.tobytes()
        cached = self._memo.get(key)
        if cached is not None:
            if key in self._prefetched:        # this env computed it in
                self._prefetched.discard(key)  # prime_measure: count a miss
                self.memo_misses += 1
            else:
                self.memo_hits += 1
            return cached
        self.memo_misses += 1
        cycles = self._timer.time_ids(self.id_at)
        self._memo[key] = cycles
        return cycles

    # -- gym interface ----------------------------------------------------------

    def reset(self) -> Dict[str, np.ndarray]:
        self._reset_state()
        return self._obs()

    def _obs(self) -> Dict[str, np.ndarray]:
        return {"state": self._emb[self.id_at], "mask": self.action_mask()}

    def write_obs(self, state_out: np.ndarray,
                  mask_out: Optional[np.ndarray] = None) -> None:
        """Fill preallocated observation buffers in place (the vectorized
        rollout path: no per-step (n, feat) allocation).  ``mask_out`` may
        be wider than ``num_actions``; the excess is zeroed."""
        np.take(self._emb, self.id_at, axis=0, out=state_out)
        if mask_out is not None:
            m = self.action_mask()
            mask_out[:m.shape[0]] = m
            mask_out[m.shape[0]:] = 0.0

    # -- masking ----------------------------------------------------------------

    def _pair_static_ok(self, ia: int, ib: int) -> bool:
        """Position-independent §3.5 checks for "``ia`` directly above
        ``ib`` may swap": basic-block/sync membership, DMA-group pinning,
        register dependencies, memory aliasing, barrier waits.  These are
        functions of the ordered identity *pair* only — invariant under
        masked swaps — so :meth:`_can_swap_fast` memoizes them."""
        d = self.deps
        if d.block[ia] != d.block[ib] or d.sync[ia] or d.sync[ib]:
            return False
        if d.group[ia] is not None and d.group[ia] == d.group[ib]:
            return False
        if (d.defs[ia] & d.uses[ib]) or (d.uses[ia] & d.defs[ib]) \
                or (d.defs[ia] & d.defs[ib]):
            return False
        if d.alias(ia, ib):
            return False
        if d.sems[ia] & d.wait[ib]:
            return False
        return True

    def _swap_ok_at(self, p: int) -> bool:
        """Cached "may positions p-1, p swap?" with incremental
        invalidation: entries survive across steps and only the positions
        :meth:`_swap` dirties are recomputed."""
        if p <= 0 or p >= self.n:
            return False
        v = self._ok_at[p]
        if v < 0:
            v = 1 if self._can_swap_fast(p, self._prefix) else 0
            self._ok_at[p] = v
        return bool(v)

    def _can_swap_fast(self, p: int, prefix) -> bool:
        if p <= 0 or p >= self.n:
            return False
        ids = self._ids
        ia, ib = ids[p - 1], ids[p]
        key = ia * self.n + ib
        ok = self._swap_ok.get(key)
        if ok is None:
            ok = self._pair_static_ok(ia, ib)
            self._swap_ok[key] = ok
        if not ok:
            return False
        d = self.deps
        pos_of = self.pos_of
        # Algorithm 1 via prefix sums: S[x] = sum of stalls of positions <x
        for (pid, mst) in d.producers[ib]:
            jpos = pos_of[pid]
            if jpos >= p - 1:
                continue  # adjacent producer: already masked by reg dep
            if mst is None or prefix[p - 1] - prefix[jpos] < mst:
                return False
        if d.fixed[ia] and d.consumers[ia]:
            mst = d.min_st[ia]
            base = d.stall_list[ia] - prefix[p + 1]
            for cid in d.consumers[ia]:
                cpos = pos_of[cid]
                if cpos <= p:
                    continue
                if mst is None or base + prefix[cpos] < mst:
                    return False
        return True

    def action_mask(self) -> np.ndarray:
        if self._mask_cache is not None:
            return self._mask_cache
        nh = len(self.hop_sizes)
        base = np.zeros(2 * self.m, dtype=np.float32)
        if self.use_fast_mask:
            for k in range(self.m):
                p = self.slot_pos[k]
                if self._swap_ok_at(p):
                    base[2 * k] = 1.0
                if self._swap_ok_at(p + 1):
                    base[2 * k + 1] = 1.0
        else:
            for k in range(self.m):
                p = self.slot_pos[k]
                if can_swap(self.program, p, self.analysis.stall_table,
                            self._position_blocks()):
                    base[2 * k] = 1.0
                if can_swap(self.program, p + 1, self.analysis.stall_table,
                            self._position_blocks()):
                    base[2 * k + 1] = 1.0
        mask = np.repeat(base.reshape(self.m, 2), nh, axis=1).reshape(-1) \
            if nh > 1 else base
        self._mask_cache = mask
        return mask

    def _position_blocks(self) -> List[int]:
        """Block ids in current position order (for the reference path)."""
        return [self.deps.block[int(i)] for i in self.id_at]

    # -- stepping ----------------------------------------------------------------

    def step(self, action: int):
        mask = self.action_mask()
        if not mask.any():
            # "If no actions are available, the episode is terminated" (§3.5)
            return self._obs(), 0.0, True, {"cycles": self.prev_cycles,
                                            "terminated": "no_actions"}
        self.begin_step(action)
        return self.finish_step()

    def begin_step(self, action: int) -> Optional[bytes]:
        """Apply the action's swap(s) without measuring (the batched
        rollout path: the rollout loop collects measurement requests from every
        env, serves distinct cache misses once through the shared memo,
        then calls :meth:`finish_step`).

        Returns the memo key of the resulting schedule when a fast-path
        measurement is still needed, else ``None`` (memo hit / oracle
        path).  The caller must have handled the empty-mask termination.
        """
        mask = self.action_mask()
        if not (0 <= action < self.num_actions) or mask[action] == 0.0:
            raise ValueError(f"invalid (masked) action {action}")
        nh = len(self.hop_sizes)
        k, rem = divmod(int(action), 2 * nh)
        direction, hop_idx = divmod(rem, nh)
        hops = self.hop_sizes[hop_idx]
        p = self.slot_pos[k]
        hops_done = 0
        for h in range(hops):
            pos = self.slot_pos[k]
            q = pos if direction == 0 else pos + 1
            if h > 0 and not self._can_swap_fast(q, self._prefix):
                break
            self._swap(q)
            hops_done += 1
        self._pending = (k, direction, p, self.prev_cycles, hops_done)
        if self._timer is not None:
            key = self.id_at.tobytes()
            if key not in self._memo:
                return key
        return None

    def prime_measure(self) -> None:
        """Compute and publish the pending schedule's cycles into the
        shared memo (called once per distinct ``begin_step`` key by the
        batched caller, possibly from a worker pool — each env owns its
        timer, so distinct envs prime concurrently without contention)."""
        key = self.id_at.tobytes()
        if key not in self._memo:
            self._memo[key] = self._timer.time_ids(self.id_at)
            self._prefetched.add(key)

    def publish_measure(self, cycles: float) -> None:
        """Publish an externally timed result for the pending schedule
        (the batched caller re-times one step's distinct misses through a
        single :class:`~repro_torch.core.timing.ScheduleTimer` pass —
        ``ScheduleTimer.time_many`` — and hands each owner env its
        cycles).  Accounting matches :meth:`prime_measure`: the owner's
        later :meth:`_measure` read counts as the miss it caused."""
        key = self.id_at.tobytes()
        if key not in self._memo:
            self._memo[key] = cycles
            self._prefetched.add(key)

    def finish_step(self, want_obs: bool = True):
        """Measure the pending schedule and close out the step begun by
        :meth:`begin_step`.  ``want_obs=False`` skips building the
        observation dict (the vectorized caller reads it later through
        :meth:`write_obs` into preallocated buffers)."""
        k, direction, p, before, hops_done = self._pending
        self._pending = None
        cycles = self._measure()
        reward = (before - cycles) / self.t0 * 100.0  # Eq. (3)
        self.prev_cycles = cycles
        if cycles < self.best_cycles:
            self.best_cycles = cycles
            self.best_program = list(self.program)
        self.t += 1
        done = self.t >= self.episode_length
        moved = self.program[self.slot_pos[k]]
        self.history.append(StepRecord(k, direction, p, before, cycles,
                                       moved, hops_done))
        obs = self._obs() if want_obs else None
        return obs, float(reward), done, {"cycles": cycles,
                                          "best": self.best_cycles}

    def _swap(self, q: int) -> None:
        self.program[q - 1], self.program[q] = self.program[q], self.program[q - 1]
        ids = self._ids
        ia, ib = ids[q - 1], ids[q]
        ids[q - 1], ids[q] = ib, ia
        self.id_at[q - 1], self.id_at[q] = ib, ia
        self.pos_of[ia], self.pos_of[ib] = q, q - 1
        sa, sb = self.slot_at[q - 1], self.slot_at[q]
        self.slot_at[q - 1], self.slot_at[q] = sb, sa
        if sb >= 0:
            self.slot_pos[sb] = q - 1
        if sa >= 0:
            self.slot_pos[sa] = q
        # only S[q] depends on the relative order of positions q-1 and q
        self._prefix[q] = self._prefix[q - 1] + self.deps.stall_list[ib]
        self._mask_cache = None
        # Incremental invalidation of the per-position swap-ok cache.
        # A check at position p reads: the identity pair (p-1, p) — changed
        # only at q-1/q/q+1; prefix sums at p-1, p+1 and at its
        # producer/consumer positions — an adjacent swap changes only
        # S[q] (interval sums spanning q are permutation-invariant), which
        # those checks read iff p ∈ {q-1, q+1} or the producer/consumer
        # sits exactly at q, i.e. is one of the two moved identities; and
        # pos_of of its Algorithm-1 producers/consumers — changed only for
        # the moved identities.  So the dirty set is the three positions
        # around q plus every check anchored to a moved identity's
        # dependency partners.
        ok = self._ok_at
        n = self.n
        for p in (q - 1, q, q + 1):
            if 0 < p < n:
                ok[p] = -1
        d = self.deps
        pos_of = self.pos_of
        for x in (ia, ib):
            for cid in d.consumers[x]:          # checks where x is producer
                pp = pos_of[cid]
                if 0 < pp < n:
                    ok[pp] = -1
            for pid, _ in d.producers[x]:       # checks where x is consumer
                pp = pos_of[pid] + 1
                if 0 < pp < n:
                    ok[pp] = -1

    # -- utilities ----------------------------------------------------------------

    def probe_swap(self, q: int) -> float:
        """Cycles of the schedule with positions ``q-1``/``q`` exchanged,
        leaving the game state untouched (adjacent swaps are self-inverse).
        The measurement goes through the normal path (timer + memo, or the
        oracle), so strategies can candidate-evaluate without stepping."""
        self._swap(q)
        try:
            return self._measure()
        finally:
            self._swap(q)

    def set_order(self, ids: Sequence[int]) -> None:
        """Teleport the game to an arbitrary schedule given as a
        position -> identity permutation (the same encoding as ``id_at``),
        rebuilding every incremental structure from scratch.

        The beam / lookahead strategies use this to jump between candidate
        schedules instead of replaying swap sequences.  The caller is
        responsible for only supplying orders *reachable by masked swaps*
        (e.g. produced by expanding ``valid_actions`` from another reached
        order) — legality is not re-checked here, exactly like
        ``begin_step`` trusts its mask.
        """
        ids = np.asarray(ids, dtype=np.int64)
        if sorted(ids.tolist()) != list(range(self.n)):
            raise ValueError("set_order wants a permutation of "
                             f"range({self.n})")
        self.program = [self.original[i] for i in ids]
        self.id_at = ids.copy()
        self._ids = ids.tolist()
        self.pos_of = np.argsort(ids).tolist()
        self.slot_pos = {k: self.pos_of[idx]
                         for k, idx in enumerate(self.slots)}
        self.slot_at = [-1] * self.n
        for k, pos in self.slot_pos.items():
            self.slot_at[pos] = k
        self._prefix = \
            [0] + np.cumsum(self.deps.stall[self.id_at]).tolist()
        self._mask_cache = None
        self._ok_at[:] = -1
        self._pending = None

    def measure_schedule(self) -> float:
        """Measure the current schedule through the normal path (timer +
        memo, or the oracle), updating the run-global best.  The verified
        measurement the guided-search strategies route their top-k
        candidates through — never a model prediction."""
        cycles = self._measure()
        self.prev_cycles = cycles
        if cycles < self.best_cycles:
            self.best_cycles = cycles
            self.best_program = list(self.program)
        return cycles

    def action_swap_pos(self, action: int) -> int:
        """The swap boundary the action's *first* hop exchanges (positions
        ``pos-1``/``pos``), decoded exactly as :meth:`begin_step` does."""
        nh = len(self.hop_sizes)
        k, rem = divmod(int(action), 2 * nh)
        direction, _ = divmod(rem, nh)
        p = self.slot_pos[k]
        return p if direction == 0 else p + 1

    def valid_actions(self) -> List[int]:
        return [a for a, v in enumerate(self.action_mask()) if v > 0]

    def improvement(self) -> float:
        """Relative improvement of the best schedule over the -O3 start."""
        return (self.t0 - self.best_cycles) / self.t0
