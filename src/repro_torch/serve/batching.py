"""Continuous-batching slot state and padded batch assembly.

The engine owns ``max_batch`` cache rows (*slots*) plus one scratch row.
Each active request occupies one slot; at every engine step the set of
slots that should advance is gathered into a fixed-width ``(idx, tokens,
pos)`` triple — inactive lanes padded onto the scratch row — so every
decode pass has the same lane count (and hence the same per-lane
arithmetic) regardless of how many requests are in flight.

A slot's lifecycle is position-driven.  ``tokens`` holds the prompt plus
everything generated (or teacher-forced on resume); ``pos`` is the next
cache position to process.  A pass at position ``p`` feeds ``tokens[p]``,
writes the KV cache at ``p``, and yields the model's prediction for
``p + 1``:

* ``p + 1 < prompt_len`` → **prefill**: the prediction is discarded,
  the next prompt token is teacher-forced.  (Resume tokens from a
  preemption extend this teacher-forced region past the prompt.)
* otherwise → **decode**: the prediction is appended — the pass at
  ``p = prompt_len - 1`` emits the request's first generated token,
  which is what TTFT clocks.

A request finishes when it has ``max_new_tokens`` generated tokens, or is
*truncated* when its next write would need cache position ``max_seq``
(the pool's :meth:`~repro_torch.serve.pool.KVBlockPool.fits` admission check
guarantees at least one generated token before this can trigger).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.scheduler import Request


# write_start sentinel for idle lanes: no position ever reaches it, so the
# paged step's masked scatter drops every idle-lane write.
NEVER_WRITE = 1 << 30


@dataclasses.dataclass
class SlotState:
    """One admitted request bound to a cache row."""
    slot: int
    request: Request
    tokens: List[int]                 # prompt + teacher-forced + generated
    prompt_len: int                   # teacher-forced prefix length
    target_len: int                   # len == done (prompt + max_new)
    pos: int = 0                      # next cache position to process
    stalled: bool = False             # pool couldn't grow this step
    # Paged prefix sharing: cache writes at pos < write_start are
    # suppressed — those positions live in blocks shared with the donor
    # request and already hold bit-identical K/V.
    write_start: int = 0
    # Paged prefix registration bookkeeping (engine-owned).
    registered_partial: bool = False

    @classmethod
    def admit(cls, slot: int, request: Request,
              shared_tokens: int = 0) -> "SlotState":
        forced = list(request.prompt) + list(request.resume_tokens)
        # With `shared_tokens` prompt positions mapped from already-resident
        # blocks, prefill skips to re-running only the last shared position
        # (recovering its logits without re-writing its KV) — the pass at
        # pos = shared_tokens - 1 behaves exactly as it would have in a
        # from-scratch prefill, so the stream stays bit-exact.
        shared = max(0, min(int(shared_tokens), len(forced)))
        return cls(slot=slot, request=request, tokens=list(forced),
                   prompt_len=len(forced),
                   target_len=len(request.prompt) + request.max_new_tokens,
                   pos=max(0, shared - 1), write_start=shared)

    @classmethod
    def resume(cls, slot: int, request: Request, *, tokens: Sequence[int],
               pos: int, prompt_len: int, target_len: int) -> "SlotState":
        """Rebind a spill-preempted request: its pages were re-uploaded, so
        decoding continues from the exact position it stopped at — no
        teacher-forced recompute."""
        return cls(slot=slot, request=request, tokens=list(tokens),
                   prompt_len=prompt_len, target_len=target_len, pos=pos)

    @property
    def in_prefill(self) -> bool:
        return self.pos < self.prompt_len - 1

    @property
    def generated(self) -> List[int]:
        return self.tokens[len(self.request.prompt):]

    @property
    def num_generated(self) -> int:
        return len(self.tokens) - len(self.request.prompt)

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.target_len

    def needs_tokens(self) -> int:
        """Cache positions a pass at the current ``pos`` requires."""
        return self.pos + 1

    def apply(self, next_token: int, max_seq: int) -> bool:
        """Account one completed pass at ``self.pos``; True when the pass
        emitted (appended) a generated token — the first such pass per
        request is what TTFT clocks."""
        appended = False
        if self.pos + 1 >= self.prompt_len and len(self.tokens) < self.target_len:
            self.tokens.append(int(next_token))
            appended = True
        self.pos += 1
        if not self.done and self.pos >= max_seq:
            # No cache position left for the next write: hard stop.
            self.request.truncated = True
            self.target_len = len(self.tokens)
        return appended


def assemble(slots: Sequence[SlotState], max_batch: int,
             scratch_slot: int) -> Optional[Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, List[SlotState]]]:
    """Build the fixed-width step arrays for the slots that advance now.

    Returns ``(idx, tokens, pos, stepped)`` with all arrays of length
    ``max_batch`` — unused lanes point at ``scratch_slot`` (duplicate
    scatter writes there are benign: every lane writes the same garbage
    row) — or None when nothing advances this step.
    """
    stepped = [s for s in slots if not s.done and not s.stalled]
    if not stepped:
        return None
    idx = np.full((max_batch,), scratch_slot, dtype=np.int32)
    tok = np.zeros((max_batch,), dtype=np.int32)
    pos = np.zeros((max_batch,), dtype=np.int32)
    for lane, s in enumerate(stepped):
        idx[lane] = s.slot
        tok[lane] = s.tokens[s.pos]
        pos[lane] = s.pos
    return idx, tok, pos, stepped


def assemble_paged(slots: Sequence[SlotState], max_batch: int,
                   scratch_slot: int, blocks_per_slot: int, blocks_of
                   ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                       np.ndarray, np.ndarray,
                                       List[SlotState]]]:
    """The paged analogue of :func:`assemble`: adds the padded fixed-width
    block-table array and the per-lane first writable position.

    Returns ``(idx, table, tok, pos, write_start, stepped)`` — ``idx``
    still points idle lanes at the scratch row (the *gather* of slot-major
    recurrent rows must stay in bounds; the engine's scatter drops them),
    ``table`` is (max_batch, blocks_per_slot) physical block ids padded
    with 0 (idle lanes and positions past a request's grant are masked
    reads / suppressed writes), and ``write_start`` is ``NEVER_WRITE`` on
    idle lanes so the single masked page scatter drops them."""
    stepped = [s for s in slots if not s.done and not s.stalled]
    if not stepped:
        return None
    idx = np.full((max_batch,), scratch_slot, dtype=np.int32)
    table = np.zeros((max_batch, blocks_per_slot), dtype=np.int32)
    tok = np.zeros((max_batch,), dtype=np.int32)
    pos = np.zeros((max_batch,), dtype=np.int32)
    wstart = np.full((max_batch,), NEVER_WRITE, dtype=np.int32)
    for lane, s in enumerate(stepped):
        idx[lane] = s.slot
        blocks = blocks_of(s)
        table[lane, :len(blocks)] = blocks
        tok[lane] = s.tokens[s.pos]
        pos[lane] = s.pos
        wstart[lane] = s.write_start
    return idx, table, tok, pos, wstart, stepped
