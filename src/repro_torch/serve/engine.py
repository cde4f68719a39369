"""Serve engine: continuous batching over a slot-pooled KV cache.

:class:`ServeEngine` is the serving path.  It owns ``max_batch`` cache
rows (*slots*) plus one scratch row, a
:class:`~repro_torch.serve.pool.KVBlockPool` accounting for the cache
positions those rows hold, and a
:class:`~repro_torch.serve.scheduler.FairScheduler` deciding which
tenant's request gets the next free slot.  Every engine step:

1. **evict** — finished slots release their pool blocks and stamp
   latency/TTFT on their :class:`~repro_torch.serve.scheduler.Request`;
2. **admit** — the fair scheduler fills freed slots (chunked prefill:
   new prompts are teacher-forced through the same decode step, so
   admission needs no separate prefill kernel and a long prompt never
   blocks the running decodes);
3. **advance** — every live slot that the pool can grow moves one
   position through ONE fixed-width decode pass (idle lanes pad onto the
   scratch row, so every pass has ``max_batch`` lanes);
4. **preempt** — if nothing could advance (pool exhausted), the
   youngest request is returned to its tenant queue: dense mode
   teacher-forces its generated tokens on resume, paged mode spills its
   pages (and its recurrent slot rows) to host memory and uploads them
   again.

Cache entries are of two kinds (:func:`~repro_torch.serve.decode.
paged_cache_kinds`): ``"slot"`` rows (every entry in dense mode; the
recurrent SSM/conv state of the ssm and hybrid families in paged mode)
are gathered by slot for a pass, scattered back after it and zeroed on
admission, so no request's state leaks into the next; ``"paged"`` K/V
pages are addressed in place through the block table.

Kernel schedules come from the cache index via
:func:`repro_torch.sched.lowering.schedule_plan` (re-exported here) —
nearest-bucket pure lookups at construction time, **zero**
autotune/``Machine.run`` on the serve path.  The plan is informational,
as in the reference: the kernels' tiling on the card is not driven from
it.

The module-level :func:`generate` is the one-shot static-batch
convenience wrapper over the same ``decode_step``; under greedy decoding
the engine matches it token for token per request.

The engine runs on the card unless ``device`` says otherwise.  With
``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`; every rank builds the
engine and runs its host side identically — scheduler, pool, block
tables, spills, prefix sharing) each rank holds its block of every
parameter (``param_shardings``) and of the pool (``kv_pool_shardings``),
gathers and scatters slot rows, copies pages and spills and uploads them
block by block, and the only exchange between ranks is the decode
step's own collectives (:mod:`repro_torch.serve.decode`) and, where
the slot rows divide over the data axes, the assembly of a pass's lanes
from the ranks that hold their rows (a sum over those axes: a lane's
row may be any slot's, so the lanes are whole there for the pass, on
their blocks of ``model``; each stepped row is written back by its
holder).
:func:`generate` takes a mesh too, and shards the prompt's batch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as col
from repro_torch.dist import sharding as shd
from repro_torch.sched.cache import ScheduleCache
# schedule_plan is re-exported here: the serve-facing API
from repro_torch.sched.lowering import schedule_plan
from repro_torch.serve.batching import SlotState, assemble, assemble_paged
from repro_torch.serve.decode import (decode_step, init_caches,
                                      init_paged_caches, paged_cache_kinds,
                                      paged_decode_step)
from repro_torch.serve.pool import KVBlockPool, PoolCapacityError
from repro_torch.serve.scheduler import (DEFAULT_TENANT, FairScheduler,
                                         Request, Tenant)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass
class _Spill:
    """Host-side copy of a preempted request's KV pages (and recurrent
    slot rows) — the payload of copy-free preemption.  Travels on
    ``Request.spill`` through the scheduler queue; re-admission allocates
    ``n_blocks`` fresh blocks and uploads ``data`` into them (the slot
    rows into its new slot), so decoding resumes at ``pos`` bit-exactly
    with zero recompute."""
    tokens: List[int]
    pos: int
    prompt_len: int
    target_len: int
    n_blocks: int
    data: List


class ServeEngine:
    """Continuous-batching multi-tenant serving over ``decode_step``.

    Construct through :meth:`from_config`::

        engine = ServeEngine.from_config(cfg, schedule_cache=cache,
                                         max_batch=8, max_seq=256,
                                         paged=True)
        req = engine.submit(prompt_tokens, max_new_tokens=64, tenant="a")
        engine.run()            # or engine.step() per tick under a loadgen
        req.output              # generated tokens; req.ttft / req.latency

    ``params`` defaults to seeded random weights (``rng_seed``) made on
    ``device``.  ``admission="gang"`` degrades the engine to static
    batching (admit only into an idle engine, wait for the whole gang to
    finish).  ``mesh``: ``params`` (the global tree) is placed on the
    ranks and the pool made in blocks (see the module docstring); the
    device is the mesh's.
    """

    def __init__(self, cfg: ModelConfig, *, params: Optional[Dict] = None,
                 max_batch: int = 8, max_seq: int = 128,
                 block_size: int = 16, kv_blocks: Optional[int] = None,
                 tenants: Optional[Sequence[Tenant]] = None,
                 starvation_bound: int = 8, prefill_chunk: int = 4,
                 admission: str = "continuous",
                 paged: bool = False, share_prefix: bool = True,
                 debug_invariants: bool = False,
                 schedule_cache: Optional[Union[ScheduleCache, str]] = None,
                 on_missing: str = "baseline", rng_seed: int = 0,
                 device=None, mesh=None):
        if cfg.family == "encdec":
            raise ValueError("ServeEngine serves decoder-only families")
        if admission not in ("continuous", "gang"):
            raise ValueError(f"admission must be 'continuous' or 'gang', "
                             f"got {admission!r}")
        if max_batch < 1 or prefill_chunk < 0:
            raise ValueError("need max_batch >= 1 and prefill_chunk >= 0")
        self.mesh = mesh
        if mesh is not None:
            from repro_torch.launch.mesh import require_group
            require_group()
            device = mesh.device
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.max_seq = int(max_seq)
        self.scratch_slot = self.max_batch          # extra padded cache row
        self.admission = admission
        self.prefill_chunk = int(prefill_chunk)
        self.paged = bool(paged)
        self.debug_invariants = bool(debug_invariants)
        # Prefix sharing needs the cache content at a position to be a pure
        # function of the token prefix — true for attention pages, false
        # for recurrent state (ssm/hybrid carry per-request rows).
        self.share_prefix = (self.paged and bool(share_prefix)
                             and cfg.family in ("dense", "moe"))

        self.pool = KVBlockPool(self.max_batch, self.max_seq,
                                block_size=block_size, num_blocks=kv_blocks)
        self.scheduler = FairScheduler(tenants,
                                       starvation_bound=starvation_bound)

        if params is None:
            from repro_torch.models import lm
            gen = torch.Generator(device=self.device).manual_seed(rng_seed)
            params = lm.init_model(cfg, gen)
        self.params = params
        where = "meta" if mesh is not None else self.device
        if self.paged:
            self.caches = init_paged_caches(cfg, self.pool.num_blocks,
                                            self.pool.block_size,
                                            self.max_batch, where)
            self._kinds = paged_cache_kinds(cfg)
        else:
            self.caches = init_caches(cfg, self.max_batch + 1, self.max_seq,
                                      where)
            self._kinds = ["slot"] * len(self.caches)
        self._specs = self._step_specs = self._row_block = None
        if mesh is not None:
            self.params = _place(params, cfg, mesh)
            self._specs = shd.kv_pool_shardings(
                cfg, self.caches, mesh,
                kinds=self._kinds if self.paged else None)
            self._step_specs = list(self._specs)
            for i in self._entries("slot"):
                row = next(iter(self._specs[i].values()))[0]
                axes = shd.live_axes(mesh, row)
                if axes:
                    # slot rows divide over the data axes: a pass's lanes
                    # are assembled whole there (see _take_rows)
                    at, n = shd.block_index(mesh, row)
                    rows = (self.max_batch + 1) // n
                    self._row_block = (at * rows, rows, axes)
                self._step_specs[i] = {
                    k: shd.P(None, *tuple(sp)[1:])
                    for k, sp in self._specs[i].items()}
            self.caches = shd.shard_zeros(self.caches, self._specs, mesh,
                                          self.device)

        if isinstance(schedule_cache, str):
            schedule_cache = ScheduleCache(schedule_cache)
        self.schedule_cache = schedule_cache
        if schedule_cache is not None:
            # Lazy import, as in the reference (whose launch.specs imports
            # serve at module load): importing serve loads no launcher.
            from repro_torch.launch.specs import kernel_fleet
            # on_missing="baseline" (default): kernels with missing/corrupt
            # cached schedules degrade to the -O3 baseline (None plan
            # entries, counted below); "raise" refuses to start degraded
            self.plan = schedule_plan(kernel_fleet(cfg), cache=schedule_cache,
                                      on_missing=on_missing)
        else:
            self.plan = {}

        self._active: List[SlotState] = []
        self.finished: List[Request] = []
        self.counters = {"engine_steps": 0, "passes": 0, "lane_tokens": 0,
                         "admissions": 0, "stalls": 0, "preemptions": 0,
                         "truncations": 0, "max_active": 0,
                         "prefix_hits": 0, "cow_forks": 0,
                         "preempt_spills": 0, "resume_uploads": 0,
                         "schedule_fallbacks": sum(
                             1 for art in self.plan.values() if art is None)}

    @classmethod
    def from_config(cls, cfg: ModelConfig, **kwargs) -> "ServeEngine":
        """The one constructor path (see class docstring for the knobs)."""
        return cls(cfg, **kwargs)

    # -- request intake ------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               tenant: str = DEFAULT_TENANT) -> Request:
        """Queue a request.  Raises :class:`PoolCapacityError` immediately
        when the prompt can never be served (``len(prompt) >= max_seq``
        leaves no cache position for even one generated token)."""
        prompt = [int(t) for t in prompt]
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not self.pool.fits(len(prompt)):
            raise PoolCapacityError(
                f"prompt of {len(prompt)} tokens can never be admitted: "
                f"max_seq={self.max_seq} needs len(prompt) < max_seq so the "
                f"first generated token has a cache position")
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      tenant=tenant)
        budget = next((t.token_budget for t in self.scheduler.tenants
                       if t.name == tenant), None)
        if budget is not None and req.cost > budget:
            raise ValueError(
                f"request cost {req.cost} exceeds tenant {tenant!r} token "
                f"budget {budget}; it could never be admitted")
        return self.scheduler.submit(req)

    # -- the serve loop ------------------------------------------------------

    def step(self) -> int:
        """One engine tick: evict, admit, advance, preempt-on-stall.
        Returns the number of slot advances made.

        Prefill is folded into the decode passes (chunked admission): a
        tick runs one full-width pass, plus up to ``prefill_chunk`` more
        while any slot is still teacher-forcing its prompt."""
        self._evict()
        self._admit()
        self.counters["max_active"] = max(self.counters["max_active"],
                                          len(self._active))
        for s in self._active:
            s.stalled = False
        advanced = 0
        for _ in range(1 + self.prefill_chunk):
            n = self._pass()
            advanced += n
            if n == 0 or not any(s.in_prefill and not s.done
                                 and not s.stalled for s in self._active):
                break
        self._evict()
        if advanced == 0 and self._active:
            self._preempt_youngest()
        self.counters["engine_steps"] += 1
        if self.debug_invariants:
            self.pool.check()
        return advanced

    def run(self, max_steps: int = 1_000_000) -> List[Request]:
        """Drain every queued/active request; returns finished requests
        in completion order."""
        while self._active or self.scheduler.pending():
            if max_steps <= 0:
                raise RuntimeError(
                    f"serve loop did not drain: {len(self._active)} active, "
                    f"{self.scheduler.pending()} pending")
            self.step()
            max_steps -= 1
        return list(self.finished)

    def generate(self, prompt: Sequence[int], max_new_tokens: int,
                 tenant: str = DEFAULT_TENANT) -> List[int]:
        """One-shot convenience over the engine: submit, drain, return
        ``prompt + generated``."""
        req = self.submit(prompt, max_new_tokens, tenant)
        self.run()
        return list(req.prompt) + list(req.output)

    # -- internals -----------------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.long).to(self.device)

    def _entries(self, kind: str) -> List[int]:
        return [i for i, k in enumerate(self._kinds) if k == kind]

    def _own(self, slots: np.ndarray):
        """(lanes whose slot row this rank holds, their rows in its
        block) of the slots ``slots``."""
        if self._row_block is None:
            return np.arange(len(slots)), slots
        lo, n, _ = self._row_block
        mine = np.flatnonzero((slots >= lo) & (slots < lo + n))
        return mine, slots[mine] - lo

    def _take_rows(self, a: torch.Tensor, slots: np.ndarray) -> torch.Tensor:
        """The rows of ``a`` (a ``"slot"`` leaf) at ``slots``.  Where the
        rows divide over the data axes, each row's holder contributes it
        and the rest zeros, summed over those axes (exact): every rank
        gets the rows whole there, on its blocks of the other axes."""
        mine, local = self._own(slots)
        if self._row_block is None:
            return a.index_select(0, self._tensor(local))
        out = a.new_zeros((len(slots),) + tuple(a.shape[1:]))
        out[self._tensor(mine)] = a.index_select(0, self._tensor(local))
        return col.psum(out, self._row_block[2])

    def _put_rows(self, a: torch.Tensor, slots: np.ndarray,
                  rows: torch.Tensor) -> None:
        """Write ``rows`` (whole over the data axes) at ``slots`` of
        ``a``, each on the rank that holds its slot; the scratch row is
        not written (the reference's out-of-range ``mode="drop"``)."""
        mine, local = self._own(slots)
        keep = slots[mine] != self.scratch_slot
        mine, local = mine[keep], local[keep]
        a.index_copy_(0, self._tensor(local),
                      rows[self._tensor(mine)].to(a.dtype))

    @torch.inference_mode()
    def _step_rows(self, idx: np.ndarray, step) -> np.ndarray:
        """Gather the ``"slot"`` entries' rows of the lanes ``idx``, run
        ``step(caches)`` (the ``"paged"`` entries passed whole), scatter
        the stepped rows back and return the lanes' greedy tokens.  Idle
        lanes (gathered from the scratch row) are not written back."""
        slots = self._entries("slot")
        caches = list(self.caches)
        for i in slots:
            caches[i] = {k: self._take_rows(a, idx)
                         for k, a in caches[i].items()}
        logits, new = step(caches)
        for i in slots:
            for k, a in self.caches[i].items():
                self._put_rows(a, idx, new[i][k])
        for i in self._entries("paged"):     # written in place
            self.caches[i] = new[i]
        return logits.argmax(dim=-1).cpu().numpy()

    def _dense_step(self, idx: np.ndarray, tok: np.ndarray,
                    pos: np.ndarray) -> np.ndarray:
        """Step the advancing rows at their own positions."""
        return self._step_rows(idx, lambda caches: decode_step(
            self.params, caches, self._tensor(tok)[:, None],
            self._tensor(pos), self.cfg, mesh=self.mesh,
            specs=self._step_specs))

    def _paged_step(self, idx: np.ndarray, table: np.ndarray,
                    tok: np.ndarray, pos: np.ndarray,
                    wstart: np.ndarray) -> np.ndarray:
        """Every lane reads and writes the page arrays in place through
        its block-table row; idle lanes write nothing (``wstart`` is
        ``NEVER_WRITE`` there)."""
        return self._step_rows(idx, lambda caches: paged_decode_step(
            self.params, caches, self._tensor(table),
            self._tensor(tok)[:, None], self._tensor(pos), pos >= wstart,
            self.cfg, self.max_seq, mesh=self.mesh, specs=self._step_specs))

    @torch.inference_mode()
    def _reset_rows(self, idx: List[int]) -> None:
        # Zero the slot rows of newly admitted requests: recurrent SSM/conv
        # state would otherwise leak across requests.  Attention masks
        # hide a previous occupant's KV already; zeroing keeps the dense
        # cache a pure function of the live requests, as the reference
        # does.  Page contents are never read unmasked before being
        # written, so pages are not reset.
        rows = self._tensor(self._own(np.asarray(idx))[1])
        for i in self._entries("slot"):
            for a in self.caches[i].values():
                a.index_fill_(0, rows, 0)

    def _admissible(self, req: Request) -> bool:
        if not self.paged:
            return self.pool.can_admit(
                len(req.prompt) + len(req.resume_tokens))
        if req.spill is not None:
            # Re-granting just the spilled pages is not enough: the request
            # must also be able to grow into its next write position, or a
            # resume under pressure re-creates the stall that spilled it.
            return self.pool.can_resume(
                self.pool.blocks_for(req.spill.pos + 1))
        if self.share_prefix:
            return self.pool.can_admit_shared(req.prompt)
        return self.pool.can_admit(len(req.prompt))

    def _admit(self) -> None:
        if self.admission == "gang" and self._active:
            return           # static batching: wait for the gang to finish
        fresh: List[int] = []
        resumed = []
        while len(self._active) < self.max_batch:
            req = self.scheduler.admit_next(predicate=self._admissible)
            if req is None:
                break
            if self.paged and req.spill is not None:
                table = self.pool.alloc_resume(req.id, req.spill.n_blocks)
                self._active.append(SlotState.resume(
                    table.slot, req, tokens=req.spill.tokens,
                    pos=req.spill.pos, prompt_len=req.spill.prompt_len,
                    target_len=req.spill.target_len))
                resumed.append((table, req.spill))
                req.spill = None
            elif self.paged and self.share_prefix:
                table = self.pool.alloc_shared(req.id, req.prompt)
                if table.shared_tokens:
                    self.counters["prefix_hits"] += 1
                self._active.append(SlotState.admit(
                    table.slot, req, shared_tokens=table.shared_tokens))
            elif self.paged:
                table = self.pool.alloc(req.id, len(req.prompt))
                self._active.append(SlotState.admit(table.slot, req))
            else:
                table = self.pool.alloc(
                    req.id, len(req.prompt) + len(req.resume_tokens))
                self._active.append(SlotState.admit(table.slot, req))
            fresh.append(table.slot)
            self.counters["admissions"] += 1
        if fresh:
            self._reset_rows(fresh)
        for table, spill in resumed:
            self._upload_spill(table, spill)
            self.counters["resume_uploads"] += 1

    def _pass(self) -> int:
        cand: List[SlotState] = []
        forks: List = []
        for s in self._active:
            if s.done or s.stalled:
                continue
            if self.paged:
                write = s.pos >= s.write_start
                if self.pool.can_advance(s.request.id, s.pos, write=write):
                    pair = self.pool.advance(s.request.id, s.pos, write=write)
                    if pair is not None:
                        forks.append(pair)
                    cand.append(s)
                else:
                    s.stalled = True
                    self.counters["stalls"] += 1
            elif self.pool.can_ensure(s.request.id, s.needs_tokens()):
                self.pool.ensure(s.request.id, s.needs_tokens())
                cand.append(s)
            else:
                s.stalled = True
                self.counters["stalls"] += 1
        if forks:
            self._copy_blocks(forks)
        if self.paged:
            asm = assemble_paged(
                cand, self.max_batch, self.scratch_slot,
                self.pool.blocks_per_slot,
                lambda s: self.pool.table(s.request.id).blocks)
            if asm is None:
                return 0
            idx, table, tok, pos, wstart, stepped = asm
            nxt = self._paged_step(idx, table, tok, pos, wstart)
        else:
            asm = assemble(cand, self.max_batch, self.scratch_slot)
            if asm is None:
                return 0
            idx, tok, pos, stepped = asm
            nxt = self._dense_step(idx, tok, pos)
        now = time.monotonic()
        for lane, s in enumerate(stepped):
            appended = s.apply(int(nxt[lane]), self.max_seq)
            if appended and s.request.first_token_time is None:
                s.request.first_token_time = now
            if s.request.truncated:
                self.counters["truncations"] += 1
            if self.share_prefix:
                self.pool.commit(s.request.id, s.tokens, s.pos,
                                 prompt_len=s.prompt_len)
        self.counters["passes"] += 1
        self.counters["lane_tokens"] += len(stepped)
        return len(stepped)

    @torch.inference_mode()
    def _copy_blocks(self, forks: List) -> None:
        """Apply copy-on-write forks: copy each ``src`` page onto its
        ``dst`` (in place, on the device) before this pass writes into
        it."""
        src = self._tensor(np.asarray([a for a, _ in forks]))
        dst = self._tensor(np.asarray([b for _, b in forks]))
        for i in self._entries("paged"):
            for a in self.caches[i].values():
                a.index_copy_(0, dst, a.index_select(0, src))
        self.counters["cow_forks"] += len(forks)

    @torch.inference_mode()
    def _spill(self, victim: SlotState) -> "_Spill":
        """Copy the victim's pages (and recurrent slot rows) to host
        memory so preemption frees its device blocks without losing the
        computed KV — resume is a remap + upload, not a recompute."""
        t = self.pool.table(victim.request.id)
        ids = self._tensor(np.asarray(t.blocks))
        slot = np.asarray([victim.slot])
        data = [{k: (a.index_select(0, ids) if kind == "paged"
                     else self._take_rows(a, slot)[0]).to("cpu", copy=True)
                 for k, a in c.items()}
                for c, kind in zip(self.caches, self._kinds)]
        return _Spill(tokens=list(victim.tokens), pos=victim.pos,
                      prompt_len=victim.prompt_len,
                      target_len=victim.target_len,
                      n_blocks=t.num_blocks, data=data)

    @torch.inference_mode()
    def _upload_spill(self, table, spill: "_Spill") -> None:
        ids = self._tensor(np.asarray(table.blocks))
        for c, d, kind in zip(self.caches, spill.data, self._kinds):
            for k, a in c.items():
                h = d[k].to(device=a.device, dtype=a.dtype)
                if kind == "paged":
                    a.index_copy_(0, ids, h)
                else:
                    self._put_rows(a, np.asarray([table.slot]), h[None])

    def _evict(self) -> None:
        done = [s for s in self._active if s.done]
        if not done:
            return
        now = time.monotonic()
        for s in done:
            req = s.request
            req.output = list(s.generated)
            req.finish_time = now
            self.scheduler.release(req, served_tokens=s.num_generated)
            self.pool.free(req.id)
            self._active.remove(s)
            self.finished.append(req)

    def _finish_truncated(self, victim: SlotState, generated: List[int]):
        # It could never advance even owning the whole pool / cache:
        # finish it truncated rather than starve the queue.
        req = victim.request
        req.truncated = True
        req.output = generated
        req.finish_time = time.monotonic()
        self.scheduler.release(req, served_tokens=len(generated))
        self.finished.append(req)
        self.counters["truncations"] += 1

    def _preempt_youngest(self) -> None:
        victim = max(self._active,
                     key=lambda s: (s.request.submit_time, s.request.id))
        req = victim.request
        generated = list(victim.generated)
        if self.paged:
            if self.pool.blocks_for(victim.pos + 1) > self.pool.num_blocks:
                self._active.remove(victim)
                self.pool.free(req.id)
                self._finish_truncated(victim, generated)
                return
            # Copy-free preemption: spill the pages, free the device
            # blocks, resume later by remap + upload.
            req.spill = self._spill(victim)
            self._active.remove(victim)
            self.pool.free(req.id)
            req.preemptions += 1
            self.scheduler.release(req, served_tokens=0)
            self.scheduler.requeue_front(req)
            self.counters["preemptions"] += 1
            self.counters["preempt_spills"] += 1
            return
        self._active.remove(victim)
        self.pool.free(req.id)
        if len(req.prompt) + len(generated) >= self.max_seq:
            self._finish_truncated(victim, generated)
            return
        req.resume_tokens = generated
        req.preemptions += 1
        self.scheduler.release(req, served_tokens=0)
        self.scheduler.requeue_front(req)
        self.counters["preemptions"] += 1

    # -- reporting -----------------------------------------------------------

    @property
    def active(self) -> int:
        return len(self._active)

    def _bytes(self, kind: str) -> int:
        return sum(a.numel() * a.element_size()
                   for i in self._entries(kind)
                   for a in self.caches[i].values())

    def kv_bytes_allocated(self) -> int:
        """Device bytes backing the KV cache (on a mesh, this rank's
        blocks).  Paged mode scales with ``kv_blocks × block_size``;
        dense mode with ``(max_batch + 1) × max_seq`` regardless of
        occupancy."""
        return self._bytes("slot") + self._bytes("paged")

    def peak_kv_bytes(self) -> int:
        """High-water KV footprint actually addressed: paged mode scales
        the page bytes by the pool's high-water block count (slot rows
        are pinned from construction); dense mode pins the full
        allocation from construction."""
        frac = self.pool.high_water_blocks / max(1, self.pool.num_blocks)
        return int(self._bytes("paged") * frac + self._bytes("slot"))

    def stats(self) -> Dict[str, object]:
        c = dict(self.counters)
        c["lane_utilization"] = (
            c["lane_tokens"] / (c["passes"] * self.max_batch)
            if c["passes"] else 0.0)
        c["kv_bytes_allocated"] = self.kv_bytes_allocated()
        c["peak_kv_bytes"] = self.peak_kv_bytes()
        return {"engine": c, "pool": self.pool.stats(),
                "tenants": self.scheduler.fairness_table()}

    def plan_summary(self) -> List[str]:
        """``kernel@bucket [target]: state`` lines for the resolved plan."""
        lines = []
        for key, art in sorted(self.plan.items(), key=str):
            name, bucket = key if isinstance(key, tuple) else (key, "default")
            label = name if bucket == "default" else f"{name}@{bucket}"
            if art is not None:
                target = art.target or "-"
                lines.append(f"{label} [{target}]: {art.speedup:.3f}x "
                             f"({art.optimized_cycles:.0f} cycles)")
            else:
                lines.append(f"{label}: not optimized (-O3 baseline)")
        return lines


@torch.inference_mode()
def generate(params: Dict, cfg: ModelConfig, prompt, max_new_tokens: int,
             max_seq: Optional[int] = None, mesh=None) -> torch.Tensor:
    """One-shot static-batch convenience: (B, P) int prompt ->
    (B, P + max_new_tokens) greedy tokens, one ``decode_step`` per
    position on the parameters' device.

    For "run these B prompts to completion, nothing else going on" —
    tests and benchmark cells.  Anything resembling a service belongs on
    :class:`ServeEngine`, which drives the *same* decode step per row and
    matches this function token for token under greedy decoding (pass
    the engine's ``max_seq`` here so the cache geometry — and hence the
    float summation order — is identical).  An encoder-decoder decodes
    over its caches' cross keys and values, zeros here, as in the
    reference; the engine refuses it.

    With ``mesh`` (run by every rank) ``params`` is the global tree: each
    rank places its blocks by ``param_shardings``, makes its blocks of
    the caches by ``decode_cache_shardings`` and decodes its block of the
    prompt's batch (``batch_spec``); every rank returns the whole
    tokens."""
    prompt = torch.as_tensor(prompt, dtype=torch.long)
    B, P = prompt.shape
    total = P + max_new_tokens
    specs = None
    if mesh is None:
        device = params["embed"]["table"].device
        caches = init_caches(cfg, B, max_seq or total, device)
    else:
        from repro_torch.launch.mesh import require_group
        require_group()
        device = mesh.device
        params = _place(params, cfg, mesh)
        meta = init_caches(cfg, B, max_seq or total, "meta")
        specs = shd.decode_cache_shardings(cfg, meta, mesh)
        caches = shd.shard_zeros(meta, specs, mesh, device)
        prompt = shd.shard_leaf(prompt, shd.batch_spec(mesh, B), mesh)
    tokens = torch.zeros((prompt.shape[0], total), dtype=torch.long,
                         device=device)
    tokens[:, :P] = prompt
    for pos in range(total - 1):
        logits, caches = decode_step(params, caches, tokens[:, pos:pos + 1],
                                     pos, cfg, mesh=mesh, specs=specs)
        if pos + 1 >= P:    # teacher-force inside the prompt
            tokens[:, pos + 1] = logits.argmax(dim=-1)
    if mesh is not None:
        tokens = shd.gather_leaf(tokens, shd.batch_spec(mesh, B), mesh)
    return tokens


def _place(params: Dict, cfg: ModelConfig, mesh) -> Dict:
    """This rank's blocks of the global ``params`` by ``param_shardings``,
    on the mesh's device."""
    from repro_torch.models import for_config
    specs = shd.param_shardings(for_config(cfg).model_spec(cfg), mesh)
    return tree_map(lambda x, s: shd.NamedSharding(mesh, s).shard(x),
                    params, specs)
