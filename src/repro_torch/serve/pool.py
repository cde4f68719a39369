"""KV-cache block pool: the serve engine's memory manager.

In **paged** mode (the production path) the pool's blocks ARE the
physical KV storage: the cache arrays are block-major
``(num_blocks, block_size, ...)`` pages (see
:func:`repro_torch.serve.decode.init_paged_caches`) and each request addresses
its sequence through its :class:`BlockTable` — a list of physical block
ids.  That turns the pool from accounting into a real memory manager:

* **refcounts** — a physical block may appear in several tables.  It is
  freed only when the last table drops it.
* **prefix sharing** — completed blocks are *registered* under the exact
  token prefix they hold (``tuple(tokens[:end])`` — chained content keys,
  collision-free).  Admission walks the new prompt block-by-block through
  the registry and maps matching resident blocks instead of recomputing
  their K/V; the final *partial* prompt block is registered too (once its
  prefill completes), so even prompts that are not block-multiples share
  fully.
* **copy-on-write** — a decode write into a block with refcount > 1 forks
  it first: :meth:`advance` remaps the writer's table entry onto a fresh
  block and reports the ``(src, dst)`` pair for the engine to device-copy
  before the pass.
* **spill accounting** — preemption frees the victim's blocks (its page
  contents travel to the host with the request); re-admission through
  :meth:`alloc_resume` grants fresh private blocks to upload into —
  copy-free resume, no teacher-forced recompute.

In **dense** mode (``serve.engine`` with ``paged=False``) the same pool
runs with every refcount at 1 and no registry — the original
accounting-only behavior over slot-major cache rows.

Blocks are ``block_size`` tokens each and come from one global free list
(``num_blocks`` total).  ``num_blocks`` may be *smaller* than
``num_slots × blocks_per_slot`` — oversubscription: more concurrent slots
than worst-case full-length sequences, the standard serving trade.  With
sharing, capacity math changes: admission needs free blocks only for the
prompt blocks **not** found in the registry, so a shared-prefix workload
admits far more concurrent sequences at the same ``num_blocks`` budget.

Capacity errors are **typed and loud**: a request whose prompt already
fills every cache position (``prompt_len >= max_seq`` — no position left
for even one generated token) raises :class:`PoolCapacityError` at
admission instead of silently letting ``decode_step`` clamp its cache
write into the last position (the old out-of-range bug).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple


class PoolError(RuntimeError):
    """Caller bug against the pool protocol (double alloc, double free,
    unknown request) — deliberately not a capacity signal."""


class PoolCapacityError(PoolError):
    """The request can not be granted the cache positions it needs —
    either ever (prompt fills the whole cache) or right now (free list
    exhausted and the caller asked for a hard allocation)."""


@dataclasses.dataclass
class BlockTable:
    """One request's allocation: its slot plus the granted block ids."""
    request_id: object
    slot: int
    blocks: List[int]
    tokens: int                       # cache positions covered by `blocks`
    shared_tokens: int = 0            # prompt positions mapped from registry
    registered_full: int = 0          # full blocks already registered

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)


class KVBlockPool:
    """Refcounted fixed-size-block free list with prefix sharing.

    ``num_slots`` is the concurrency bound (batch rows), ``max_seq`` the
    per-slot position capacity, ``block_size`` the grant granularity, and
    ``num_blocks`` the global token-memory budget (defaults to the
    un-oversubscribed ``num_slots * ceil(max_seq / block_size)``).
    """

    def __init__(self, num_slots: int, max_seq: int, block_size: int = 16,
                 num_blocks: Optional[int] = None):
        if num_slots < 1 or max_seq < 2 or block_size < 1:
            raise ValueError(
                f"need num_slots >= 1, max_seq >= 2, block_size >= 1; got "
                f"{num_slots}/{max_seq}/{block_size}")
        self.num_slots = int(num_slots)
        self.max_seq = int(max_seq)
        self.block_size = int(block_size)
        self.blocks_per_slot = math.ceil(self.max_seq / self.block_size)
        self.num_blocks = (int(num_blocks) if num_blocks is not None
                           else self.num_slots * self.blocks_per_slot)
        if self.num_blocks < self.blocks_per_slot:
            raise ValueError(
                f"num_blocks={self.num_blocks} cannot hold even one "
                f"full-length request ({self.blocks_per_slot} blocks)")
        self._free_slots: List[int] = list(range(self.num_slots))
        self._free_blocks: List[int] = list(range(self.num_blocks))
        self._tables: Dict[object, BlockTable] = {}
        self._refcount: Dict[int, int] = {}
        # content-keyed prefix registry: exact token tuple -> block id,
        # plus the reverse map for O(keys-per-block) cleanup on release
        self._registry: Dict[Tuple[int, ...], int] = {}
        self._block_keys: Dict[int, List[Tuple[int, ...]]] = {}
        # lifetime stats (bench / fairness table surfacing)
        self.allocs = 0
        self.frees = 0
        self.high_water_blocks = 0
        self.shared_hits = 0          # admissions that mapped >= 1 block
        self.shared_tokens_reused = 0
        self.cow_forks = 0

    # -- capacity queries ----------------------------------------------------

    def blocks_for(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.block_size))

    def fits(self, prompt_len: int) -> bool:
        """Whether a prompt can *ever* be served: it must leave at least
        one cache position for the first generated token's KV write."""
        return 1 <= prompt_len < self.max_seq

    @property
    def free_slot_count(self) -> int:
        return len(self._free_slots)

    @property
    def free_block_count(self) -> int:
        return len(self._free_blocks)

    @property
    def used_block_count(self) -> int:
        return self.num_blocks - len(self._free_blocks)

    def can_admit(self, prompt_len: int) -> bool:
        """Admission predicate: a free slot and enough free blocks to
        cover the prompt (decode growth is granted block-by-block)."""
        return (self.fits(prompt_len) and bool(self._free_slots)
                and len(self._free_blocks) >= self.blocks_for(prompt_len))

    def can_admit_shared(self, prompt: Sequence[int]) -> bool:
        """Admission predicate under prefix sharing: free blocks are only
        needed for the prompt blocks the registry cannot map."""
        if not (self.fits(len(prompt)) and self._free_slots):
            return False
        shared_blocks, _ = self.match_prefix(prompt)
        fresh = self.blocks_for(len(prompt)) - len(shared_blocks)
        return fresh <= len(self._free_blocks)

    def can_ensure(self, request_id, tokens: int) -> bool:
        """Whether ``ensure`` for this coverage would succeed right now."""
        t = self._tables.get(request_id)
        if t is None or tokens > self.max_seq:
            return False
        need = self.blocks_for(tokens) - t.num_blocks
        return need <= len(self._free_blocks)

    def can_resume(self, n_blocks: int) -> bool:
        """Whether a spilled request's pages could be re-granted now."""
        return bool(self._free_slots) and n_blocks <= len(self._free_blocks)

    # -- prefix registry -----------------------------------------------------

    def match_prefix(self, prompt: Sequence[int]
                     ) -> Tuple[List[int], int]:
        """Longest registered prefix of ``prompt``: the resident block ids
        covering it, and the number of prompt positions they hold.

        Full blocks chain by exact ``tuple(prompt[:(i+1)*block_size])``
        keys; after the chain breaks, an exact whole-prompt key may map
        the final partial block too (registered when its donor's prefill
        completed)."""
        prompt = tuple(int(t) for t in prompt)
        bs = self.block_size
        blocks: List[int] = []
        covered = 0
        while covered + bs <= len(prompt):
            b = self._registry.get(prompt[:covered + bs])
            if b is None:
                break
            blocks.append(b)
            covered += bs
        if 0 < len(prompt) - covered < bs:
            b = self._registry.get(prompt)
            if b is not None and b not in blocks:
                blocks.append(b)
                covered = len(prompt)
        return blocks, covered

    def commit(self, request_id, tokens: Sequence[int], complete: int,
               prompt_len: int = 0) -> None:
        """Register this request's finished block contents for sharing.

        ``complete`` is the number of leading positions whose K/V writes
        are final (a pass at ``pos`` completes position ``pos``, so the
        engine passes ``slot.pos`` after advancing).  Every fully covered
        block is registered under its exact token-prefix key; when the
        prompt does not end on a block boundary, the partial prompt-tail
        block is registered once under the whole-prompt key as soon as
        prefill completes (``complete >= prompt_len``) — positions past
        the prompt inside that block belong to this request's generation
        and are overwritten-before-read by any sharer."""
        t = self.table(request_id)
        bs = self.block_size
        nfull = min(complete // bs, t.num_blocks)
        for i in range(t.registered_full, nfull):
            key = tuple(int(x) for x in tokens[:(i + 1) * bs])
            self._register(key, t.blocks[i])
        t.registered_full = max(t.registered_full, nfull)
        if prompt_len % bs and complete >= prompt_len \
                and prompt_len // bs < t.num_blocks:
            key = tuple(int(x) for x in tokens[:prompt_len])
            self._register(key, t.blocks[prompt_len // bs])

    def _register(self, key: Tuple[int, ...], block: int) -> None:
        if key in self._registry:
            return                    # first donor wins; content identical
        self._registry[key] = block
        self._block_keys.setdefault(block, []).append(key)

    def _release_block(self, block: int) -> bool:
        """Drop one reference; on the last one, unregister and free.
        Returns True when the block actually returned to the free list."""
        n = self._refcount.get(block)
        if n is None:
            raise PoolError(f"release of untracked block {block}")
        if n > 1:
            self._refcount[block] = n - 1
            return False
        del self._refcount[block]
        for key in self._block_keys.pop(block, []):
            self._registry.pop(key, None)
        self._free_blocks.append(block)
        return True

    # -- allocation ----------------------------------------------------------

    def _claim_fresh(self, n: int) -> List[int]:
        blocks = [self._free_blocks.pop(0) for _ in range(n)]
        for b in blocks:
            self._refcount[b] = 1
        return blocks

    def alloc(self, request_id, prompt_len: int) -> BlockTable:
        """Admit a request: claim a slot and the prompt's blocks
        (no sharing — every block private).

        Raises :class:`PoolCapacityError` when the prompt can never fit
        (``prompt_len >= max_seq`` leaves no position for generation) or
        the free list cannot cover it now; :class:`PoolError` on protocol
        misuse (already-allocated id, no free slot)."""
        if request_id in self._tables:
            raise PoolError(f"request {request_id!r} is already allocated")
        if not self.fits(prompt_len):
            raise PoolCapacityError(
                f"prompt of {prompt_len} tokens cannot be admitted into a "
                f"{self.max_seq}-position cache: at least one position must "
                f"remain for the first generated token")
        if not self._free_slots:
            raise PoolError("no free slot (call can_admit() before alloc())")
        need = self.blocks_for(prompt_len)
        if need > len(self._free_blocks):
            raise PoolCapacityError(
                f"pool out of blocks: need {need}, "
                f"free {len(self._free_blocks)}")
        slot = self._free_slots.pop(0)
        table = BlockTable(request_id=request_id, slot=slot,
                           blocks=self._claim_fresh(need),
                           tokens=need * self.block_size)
        self._tables[request_id] = table
        self.allocs += 1
        self.high_water_blocks = max(self.high_water_blocks,
                                     self.used_block_count)
        return table

    def alloc_shared(self, request_id, prompt: Sequence[int]) -> BlockTable:
        """Admit a request, mapping every registry-matched prompt block
        instead of claiming fresh ones.  The returned table's
        ``shared_tokens`` tells the engine how much prefill to skip."""
        prompt = [int(t) for t in prompt]
        if request_id in self._tables:
            raise PoolError(f"request {request_id!r} is already allocated")
        if not self.fits(len(prompt)):
            raise PoolCapacityError(
                f"prompt of {len(prompt)} tokens cannot be admitted into a "
                f"{self.max_seq}-position cache: at least one position must "
                f"remain for the first generated token")
        if not self._free_slots:
            raise PoolError("no free slot (call can_admit_shared() first)")
        shared_blocks, shared_tokens = self.match_prefix(prompt)
        fresh = self.blocks_for(len(prompt)) - len(shared_blocks)
        if fresh > len(self._free_blocks):
            raise PoolCapacityError(
                f"pool out of blocks: need {fresh} fresh "
                f"(+{len(shared_blocks)} shared), "
                f"free {len(self._free_blocks)}")
        slot = self._free_slots.pop(0)
        for b in shared_blocks:
            self._refcount[b] += 1
        blocks = shared_blocks + self._claim_fresh(fresh)
        table = BlockTable(request_id=request_id, slot=slot, blocks=blocks,
                           tokens=len(blocks) * self.block_size,
                           shared_tokens=shared_tokens,
                           registered_full=shared_tokens // self.block_size)
        self._tables[request_id] = table
        self.allocs += 1
        if shared_blocks:
            self.shared_hits += 1
            self.shared_tokens_reused += shared_tokens
        self.high_water_blocks = max(self.high_water_blocks,
                                     self.used_block_count)
        return table

    def alloc_resume(self, request_id, n_blocks: int) -> BlockTable:
        """Re-admit a spilled request: a slot plus ``n_blocks`` fresh
        *private* blocks for the engine to upload the spilled pages into
        (uploaded content diverges from any registered prefix, so shared
        mapping is not safe here)."""
        if request_id in self._tables:
            raise PoolError(f"request {request_id!r} is already allocated")
        if not self._free_slots:
            raise PoolError("no free slot (call can_resume() first)")
        if n_blocks > len(self._free_blocks):
            raise PoolCapacityError(
                f"pool out of blocks resuming request {request_id!r}: need "
                f"{n_blocks}, free {len(self._free_blocks)}")
        slot = self._free_slots.pop(0)
        table = BlockTable(request_id=request_id, slot=slot,
                           blocks=self._claim_fresh(n_blocks),
                           tokens=n_blocks * self.block_size)
        self._tables[request_id] = table
        self.allocs += 1
        self.high_water_blocks = max(self.high_water_blocks,
                                     self.used_block_count)
        return table

    def ensure(self, request_id, tokens: int) -> BlockTable:
        """Grow the request's grant to cover ``tokens`` cache positions
        (a decode step about to write position ``p`` needs ``p + 1``).
        No-op when already covered."""
        t = self._tables.get(request_id)
        if t is None:
            raise PoolError(f"unknown request {request_id!r}")
        if tokens > self.max_seq:
            raise PoolCapacityError(
                f"request {request_id!r} needs {tokens} positions but the "
                f"cache holds {self.max_seq}")
        need = self.blocks_for(tokens) - t.num_blocks
        if need <= 0:
            return t
        if need > len(self._free_blocks):
            raise PoolCapacityError(
                f"pool out of blocks growing request {request_id!r}: need "
                f"{need}, free {len(self._free_blocks)}")
        t.blocks.extend(self._claim_fresh(need))
        t.tokens = t.num_blocks * self.block_size
        self.high_water_blocks = max(self.high_water_blocks,
                                     self.used_block_count)
        return t

    # -- decode-step granting (coverage growth + copy-on-write) --------------

    def _advance_needs(self, t: BlockTable, pos: int,
                       write: bool) -> Tuple[int, bool]:
        """(fresh blocks needed, whether the write needs a CoW fork) for a
        pass writing position ``pos``.  A grow covers ``pos`` with a fresh
        private block, so grow and fork are mutually exclusive."""
        grow = max(0, self.blocks_for(pos + 1) - t.num_blocks)
        if grow or not write:
            return grow, False
        fork = self._refcount[t.blocks[pos // self.block_size]] > 1
        return (1 if fork else 0), fork

    def can_advance(self, request_id, pos: int, write: bool = True) -> bool:
        """Whether a pass writing position ``pos`` can be granted now
        (coverage growth plus a possible copy-on-write fork)."""
        t = self._tables.get(request_id)
        if t is None or pos + 1 > self.max_seq:
            return False
        need, _ = self._advance_needs(t, pos, write)
        return need <= len(self._free_blocks)

    def advance(self, request_id, pos: int,
                write: bool = True) -> Optional[Tuple[int, int]]:
        """Grant everything a pass writing position ``pos`` needs: grow
        coverage to ``pos + 1`` and copy-on-write-fork the target block if
        it is shared.  Returns the ``(src, dst)`` block pair when a fork
        happened (the engine device-copies the page before the pass),
        else None.  Raises :class:`PoolCapacityError` when the free list
        cannot cover it."""
        t = self.table(request_id)
        if pos + 1 > self.max_seq:
            raise PoolCapacityError(
                f"request {request_id!r} needs position {pos} but the "
                f"cache holds {self.max_seq}")
        need, fork = self._advance_needs(t, pos, write)
        if need > len(self._free_blocks):
            raise PoolCapacityError(
                f"pool out of blocks advancing request {request_id!r}: "
                f"need {need}, free {len(self._free_blocks)}")
        if fork:
            i = pos // self.block_size
            src = t.blocks[i]
            dst = self._claim_fresh(1)[0]
            self._release_block(src)
            t.blocks[i] = dst
            self.cow_forks += 1
            self.high_water_blocks = max(self.high_water_blocks,
                                         self.used_block_count)
            return src, dst
        if need:
            self.ensure(request_id, pos + 1)
        return None

    # -- release -------------------------------------------------------------

    def free(self, request_id) -> int:
        """Release the request's slot and drop one reference on each of
        its blocks; returns how many blocks actually returned to the free
        list (shared blocks survive under their other tables).  A second
        free of the same id raises (double-free guard)."""
        t = self._tables.pop(request_id, None)
        if t is None:
            raise PoolError(f"double free / unknown request {request_id!r}")
        self._free_slots.append(t.slot)
        self._free_slots.sort()
        freed = sum(self._release_block(b) for b in t.blocks)
        self.frees += 1
        return freed

    def table(self, request_id) -> BlockTable:
        try:
            return self._tables[request_id]
        except KeyError:
            raise PoolError(f"unknown request {request_id!r}") from None

    # -- invariants ----------------------------------------------------------

    def check(self) -> None:
        """Assert the pool invariants (the engine runs this every tick
        under ``debug_invariants``; tests call it after churn):

        * free-list conservation — every block is either granted (to >= 1
          table) or free, never both, never duplicated in the free list;
        * refcount exactness — a mapped block's refcount equals the
          number of tables holding it and is >= 1;
        * no double-grant — a block appears at most once per table, a
          slot in at most one table;
        * registry hygiene — registered keys point only at live granted
          blocks, consistent with the reverse map."""
        granted: Dict[int, int] = {}
        for t in self._tables.values():
            assert len(set(t.blocks)) == len(t.blocks), \
                f"table {t.request_id!r} holds a block twice"
            for b in t.blocks:
                granted[b] = granted.get(b, 0) + 1
        assert len(set(self._free_blocks)) == len(self._free_blocks), \
            "double-free: duplicate block in free list"
        assert not (set(granted) & set(self._free_blocks)), \
            "block simultaneously granted and free"
        assert len(granted) + len(self._free_blocks) == self.num_blocks, \
            "block leak: granted + free != total"
        assert granted == self._refcount, \
            f"refcount drift: {self._refcount} vs tables {granted}"
        assert all(n >= 1 for n in granted.values()), \
            "mapped block with refcount < 1"
        for key, b in self._registry.items():
            assert b in granted, f"registry key maps freed block {b}"
            assert key in self._block_keys.get(b, []), \
                "registry/reverse-map drift"
        for b, keys in self._block_keys.items():
            for key in keys:
                assert self._registry.get(key) == b, \
                    "reverse-map/registry drift"
        slots = [t.slot for t in self._tables.values()]
        assert len(slots) + len(self._free_slots) == self.num_slots, \
            "slot leak/duplication"
        assert len(set(slots)) == len(slots), "slot double-grant"

    def stats(self) -> Dict[str, int]:
        return {"num_slots": self.num_slots, "num_blocks": self.num_blocks,
                "free_slots": len(self._free_slots),
                "free_blocks": len(self._free_blocks),
                "used_blocks": self.used_block_count,
                "allocs": self.allocs, "frees": self.frees,
                "high_water_blocks": self.high_water_blocks,
                "shared_hits": self.shared_hits,
                "shared_tokens_reused": self.shared_tokens_reused,
                "cow_forks": self.cow_forks,
                "registered_prefixes": len(self._registry)}
