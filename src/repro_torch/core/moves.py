"""Tracing and rendering discovered optimization moves (paper §5.7).

Port of ``repro/core/moves.py`` (numpy and the port's ``AssemblyGame``;
no framework).

The inference episode is deterministic and seedable; this module ranks its
steps by single-step reward and renders before/after windows like the
paper's Fig. 9 (HMMA scheduled before LDGSTS) and Fig. 13 (LDGSTS hoisted
above predicated-off LDS slots).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from repro_torch.core.env import AssemblyGame, StepRecord
from repro_torch.core.isa import Instruction


@dataclasses.dataclass
class Move:
    step: int
    record: StepRecord
    gain_pct: float               # single-step runtime reduction, % of T0
    window_before: List[str]
    window_after: List[str]
    kind: str

    def render(self) -> str:
        arrow = "↑" if self.record.direction == 0 else "↓"
        lines = [f"move #{self.step}: {self.record.moved.opcode} {arrow} "
                 f"({self.gain_pct:+.2f}% of T0)  [{self.kind}]"]
        lines.append("  before:")
        lines += [f"    {ln}" for ln in self.window_before]
        lines.append("  after:")
        lines += [f"    {ln}" for ln in self.window_after]
        return "\n".join(lines)


def _window(program: Sequence[Instruction], pos: int, radius: int = 2):
    lo = max(0, pos - radius)
    hi = min(len(program), pos + radius + 1)
    return [f"{program[i].opcode:<12} {', '.join(map(str, program[i].operands))}"
            + ("  " + program[i].pred if program[i].pred else "")
            for i in range(lo, hi)]


def classify_move(env: AssemblyGame, rec: StepRecord) -> str:
    """Heuristic labels matching the paper's discovered move classes."""
    moved = rec.moved
    p = rec.position
    neighbor_idx = p - 1 if rec.direction == 0 else p + 1
    neighbor = env.original[min(max(neighbor_idx, 0), env.n - 1)]
    if moved.base == "MXM" or neighbor.base == "MXM":
        return "mxu/dma interleave (reuse-cache class, §5.7.1)"
    if neighbor.predicated_off() or moved.predicated_off():
        return "hoist past predicated-off slot (§5.7.2)"
    if moved.base in ("CPYIN", "CPYOUT"):
        return "dma latency hiding"
    return "ilp interleave"


def top_moves(env: AssemblyGame, k: int = 5, radius: int = 2) -> List[Move]:
    """Rank the episode's steps by realized gain; reconstruct windows by
    replaying the recorded swaps on a fresh copy of the original program."""
    program = [ins for ins in env.original]
    slot_pos = {i: idx for i, idx in enumerate(env.slots)}
    moves: List[Move] = []
    for step, rec in enumerate(env.history):
        p = slot_pos[rec.slot]
        q0 = p if rec.direction == 0 else p + 1
        before = _window(program, q0 - 1, radius)
        for _ in range(max(rec.hops, 1)):
            pos = slot_pos[rec.slot]
            q = pos if rec.direction == 0 else pos + 1
            program[q - 1], program[q] = program[q], program[q - 1]
            for s, sp in slot_pos.items():
                if sp == q - 1:
                    slot_pos[s] = q
                elif sp == q:
                    slot_pos[s] = q - 1
        after = _window(program, q - 1, radius)
        gain = (rec.cycles_before - rec.cycles_after) / env.t0 * 100.0
        moves.append(Move(step, rec, gain, before, after,
                          classify_move(env, rec)))
    moves.sort(key=lambda m: -m.gain_pct)
    return moves[:k]


def lingering_fraction(env: AssemblyGame) -> float:
    """The paper observes the agent 'lingering' — repeatedly moving an
    instruction up then down after exhausting useful moves (§5.7.2).
    Fraction of consecutive step pairs that undo each other."""
    h = env.history
    if len(h) < 2:
        return 0.0
    undo = sum(1 for a, b in zip(h, h[1:])
               if a.slot == b.slot and a.direction != b.direction)
    return undo / (len(h) - 1)
