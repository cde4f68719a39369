"""Pre-game static analysis (paper §3.2).

Three passes over the disassembled TSASS program:

1. **Stall-count resolution.**  For every memory instruction that consumes
   the output of a fixed-latency instruction *in the same basic block*, walk
   its preceding instructions looking for the defining instruction.  The
   accumulated stall count between the use-def pair is a safe (exact or
   over-) estimate of the producer's latency, because the original -O3
   schedule is always valid.  Each dependency is classified as

     * ``db``      — producer opcode present in the microbenchmarked stall
                      table (paper Table 1 / §4.3),
     * ``infer``   — resolved by this pass,
     * ``denylist``— the defining instruction was not found before a label /
                      block boundary: the memory instruction is denylisted
                      permanently masked out of the action space.

   (These three fractions are exactly what the paper's Figure 7 reports.)

2. **Embedding tables** (§3.4): register->int and memory-operand->int maps,
   and the maximum operand count (shorter instructions get -1 padding).

3. **Action space**: indices of schedulable memory instructions minus the
   denylist (§3.5).

The analysis never touches :mod:`repro_torch.core.machine` internals — it sees the
program text only, exactly like the paper's optimizer facing undocumented
SASS.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.core.isa import Instruction, OpClass, is_fixed_latency
from repro_torch.core.parser import block_id_vector


@dataclasses.dataclass
class Analysis:
    stall_table: Dict[str, int]             # full opcode -> min stall count
    resolution: Dict[Tuple[int, int], str]  # (mem_idx, def_idx) -> db|infer|denylist
    denylist: FrozenSet[int]                # memory instruction indices
    mem_slots: List[int]                    # action-space instruction indices
    reg_table: Dict[str, int]
    mem_table: Dict[str, int]
    max_operands: int
    blocks: List[int]

    def resolution_fractions(self) -> Dict[str, float]:
        """Fractions for the Figure-7 reproduction."""
        total = max(len(self.resolution), 1)
        out = {"db": 0, "infer": 0, "denylist": 0}
        for v in self.resolution.values():
            out[v] += 1
        return {k: v / total for k, v in out.items()}


def _defining_index(program: Sequence[Instruction], blocks: List[int],
                    idx: int, reg: str) -> Optional[int]:
    """Nearest preceding definition of ``reg`` inside the same basic block;
    None if a block boundary is reached first (paper: 'If a label is
    encountered first, the analysis pass aborts')."""
    blk = blocks[idx]
    for j in range(idx - 1, -1, -1):
        if blocks[j] != blk:
            return None
        if reg in (program[j].defs or ()):
            return j
    return None


def accumulated_stall(program: Sequence[Instruction], lo: int, hi: int) -> int:
    """Sum of issue-slot stalls from ``lo`` (inclusive) to ``hi`` (exclusive):
    a lower bound on the cycle distance between the two issues."""
    return sum(max(1, program[k].ctrl.stall) for k in range(lo, hi))


def analyze(program: Sequence[Instruction],
            stall_db: Optional[Dict[str, int]] = None) -> Analysis:
    """Run all pre-game passes.  ``stall_db`` is the microbenchmarked table
    (:func:`repro_torch.core.microbench.build_stall_table`)."""
    stall_db = dict(stall_db or {})
    blocks = block_id_vector(program)

    stall_table: Dict[str, int] = dict(stall_db)
    resolution: Dict[Tuple[int, int], str] = {}
    denylist = set()

    # ---- pass 1: stall-count resolution over memory instructions ----------
    for i, ins in enumerate(program):
        if ins.klass is not OpClass.MEM:
            continue
        for reg in sorted(ins.uses or ()):
            if reg.startswith("UR"):
                # uniform/descriptor registers are written once in the
                # prologue and constant thereafter: not a scheduling hazard
                continue
            j = _defining_index(program, blocks, i, reg)
            if j is None:
                # defined across a label (or a kernel parameter): cannot be
                # reasoned about without control-flow analysis -> denylist.
                resolution[(i, reg)] = "denylist"
                denylist.add(i)
                continue
            producer = program[j]
            if not is_fixed_latency(producer.opcode):
                continue  # variable-latency producers sync via semaphores
            if producer.opcode in stall_db:
                resolution[(i, j)] = "db"
                continue
            inferred = accumulated_stall(program, j, i)
            prev = stall_table.get(producer.opcode)
            stall_table[producer.opcode] = (inferred if prev is None
                                            else min(prev, inferred))
            resolution[(i, j)] = "infer"

    # a memory instruction with any unresolved producer is denylisted; all
    # others are schedulable (§3.5)
    mem_slots = [i for i, ins in enumerate(program)
                 if ins.is_schedulable() and i not in denylist]

    # ---- pass 2: embedding tables ------------------------------------------
    reg_table: Dict[str, int] = {}
    mem_table: Dict[str, int] = {}
    max_operands = 0
    for ins in program:
        max_operands = max(max_operands, len(ins.operands))
        for r in sorted((ins.defs or frozenset()) | (ins.uses or frozenset())):
            reg_table.setdefault(r, len(reg_table))
        for op in ins.operands:
            if op.startswith("[") or "desc[" in op:
                mem_table.setdefault(op, len(mem_table))

    return Analysis(
        stall_table=stall_table,
        resolution=resolution,
        denylist=frozenset(denylist),
        mem_slots=mem_slots,
        reg_table=reg_table,
        mem_table=mem_table,
        max_operands=max_operands,
        blocks=blocks,
    )


def min_stall(analysis: Analysis, opcode: str) -> Optional[int]:
    """Known minimum stall count for a fixed-latency opcode (db ∪ inferred);
    None = unknown (consumers of it must stay denylisted/masked)."""
    return analysis.stall_table.get(opcode)
