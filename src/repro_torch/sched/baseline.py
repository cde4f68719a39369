"""Baseline schedule generator: the ``ptxas -O3`` stand-in (DESIGN.md §2.2).

The assembly game must start from "a -O3 optimized SASS schedule" (paper
§1/§3).  This module provides it: a classical critical-path list scheduler
with full knowledge of the machine's fixed latencies (the vendor compiler
knows its hardware — unlike the RL optimizer, which must infer them).  Like
real ptxas, it does NOT model the dynamic second-order effects the RL agent
can exploit: DMA queue depth, VMEM port contention, and operand-reuse buffer
invalidation (§5.7.1) are absent from its cost model.

After ordering it assigns SASS-style control codes:
  * write barriers on variable-latency loads (CPYIN/LDV) and read barriers
    on stores (CPYOUT/STV), with consumer wait masks;
  * ``.reuse`` hints on back-to-back MXM bursts sharing an operand;
  * stall counts sufficient for every fixed-latency use-def pair.

The result is always valid on the machine (verified against the dataflow
reference by tests) and is the T_0 of the reward function.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.isa import (Control, Instruction, OpClass,
                                  is_fixed_latency)
from repro_torch.core.machine import true_fixed_latency  # vendor knowledge
from repro_torch.core.parser import memory_effects
from repro_torch.sched.lowering import LoweredKernel


def _vendor_latency(ins: Instruction) -> float:
    base = ins.base
    if base in ("CPYIN", "CPYOUT"):
        nbytes = 16
        for part in ins.opcode.split(".")[1:]:
            if part.isdigit():
                nbytes = int(part)
        return 48.0 + nbytes / 32.0
    if base == "LDV":
        return 12.0
    if base == "STV":
        return 4.0
    lat = true_fixed_latency(ins.opcode)
    return float(lat) if lat is not None else 1.0


def build_dependencies(block: Sequence[Instruction]) -> List[List[int]]:
    """Successor lists for one basic block: register RAW/WAR/WAW, memory
    aliasing, and same-group order pinning."""
    n = len(block)
    succs: List[List[int]] = [[] for _ in range(n)]
    last_writer: Dict[str, int] = {}
    readers: Dict[str, List[int]] = {}
    cell_writer: Dict[tuple, int] = {}
    cell_readers: Dict[tuple, List[int]] = {}
    last_in_group: Dict[int, int] = {}

    def edge(a: int, b: int):
        if a != b:
            succs[a].append(b)

    for i, ins in enumerate(block):
        for r in sorted(ins.uses or ()):
            if r in last_writer:
                edge(last_writer[r], i)          # RAW
            readers.setdefault(r, []).append(i)
        for r in sorted(ins.defs or ()):
            if r in last_writer:
                edge(last_writer[r], i)          # WAW
            for j in readers.get(r, ()):  # WAR
                edge(j, i)
            readers[r] = []
            last_writer[r] = i
        for cell, is_write in memory_effects(ins):
            if is_write:
                if cell in cell_writer:
                    edge(cell_writer[cell], i)
                for j in cell_readers.get(cell, ()):
                    edge(j, i)
                cell_readers[cell] = []
                cell_writer[cell] = i
            else:
                if cell in cell_writer:
                    edge(cell_writer[cell], i)
                cell_readers.setdefault(cell, []).append(i)
        if ins.group is not None:
            if ins.group in last_in_group:
                edge(last_in_group[ins.group], i)
            last_in_group[ins.group] = i
    return succs


DEFAULT_WINDOW = 16


def _list_schedule(block: List[Instruction],
                   window: Optional[int] = DEFAULT_WINDOW
                   ) -> List[Instruction]:
    """Critical-path list scheduling with a bounded code-motion window.

    Real compilers schedule *before/during* register allocation, so they
    bound how far instructions may move to control register pressure (ptxas
    included).  ``window`` models that: candidates are drawn from the ready
    set restricted to the ``window`` lowest original indices among
    unscheduled instructions.  CuAsmRL operates *after* allocation (the
    register assignment is fixed; WAR/WAW dependencies keep it correct), so
    the RL agent legitimately enjoys code-motion freedom the vendor
    scheduler did not — which is precisely the slack the paper harvests.
    ``window=None`` gives the unbounded global scheduler (reported in the
    benchmarks as the classical upper baseline).
    """
    n = len(block)
    succs = build_dependencies(block)
    npreds = [0] * n
    for i in range(n):
        for j in succs[i]:
            npreds[j] += 1
    # critical-path priority (vendor latencies)
    prio = [0.0] * n
    for i in range(n - 1, -1, -1):
        lat = _vendor_latency(block[i])
        prio[i] = lat + max((prio[j] for j in succs[i]), default=0.0)
    ready = set(i for i in range(n) if npreds[i] == 0)
    scheduled = [False] * n
    horizon = 0
    order: List[int] = []
    while ready:
        if window is not None:
            while horizon < n and scheduled[horizon]:
                horizon += 1
            candidates = [i for i in ready if i < horizon + window]
            if not candidates:
                candidates = list(ready)
        else:
            candidates = list(ready)
        i = max(candidates, key=lambda x: (prio[x], -x))
        ready.discard(i)
        scheduled[i] = True
        order.append(i)
        for j in succs[i]:
            npreds[j] -= 1
            if npreds[j] == 0:
                ready.add(j)
    assert len(order) == n, "cyclic dependencies in block"
    return [block[i] for i in order]


def _assign_reuse(program: List[Instruction]) -> None:
    """ptxas-style operand-cache hints: within a back-to-back MXM pair
    sharing a source register, flag the shared operand of the second."""
    prev: Optional[Instruction] = None
    for ins in program:
        for k, op in enumerate(ins.operands):
            if op.endswith(".reuse"):
                ins.operands[k] = op[: -len(".reuse")]
        if ins.base == "MXM" and prev is not None and prev.base == "MXM":
            shared = (ins.uses or frozenset()) & (prev.uses or frozenset())
            for k, op in enumerate(ins.operands[1:], start=1):
                if op.split(".")[0] in shared:
                    ins.operands[k] = op + ".reuse"
                    break
        prev = ins if ins.base == "MXM" else None


def _assign_barriers(program: List[Instruction]) -> None:
    """Round-robin semaphores 0..5; every dataflow consumer of a
    variable-latency instruction waits on its barrier (paper §2.3)."""
    sem_rr = 0
    setters_reg: Dict[str, Tuple[int, int]] = {}    # reg -> (pos, sem)
    setters_cell: Dict[tuple, Tuple[int, int]] = {}
    addr_read_bar: Dict[str, Tuple[int, int]] = {}  # reg read by DMA -> sem

    for i, ins in enumerate(program):
        wait = set(ins.ctrl.wait_mask)
        for r in sorted(ins.uses or ()):
            if r in setters_reg:
                wait.add(setters_reg[r][1])
        for cell, is_write in memory_effects(ins):
            if not is_write and cell in setters_cell:
                wait.add(setters_cell[cell][1])
            if is_write and cell in setters_cell:
                wait.add(setters_cell[cell][1])  # WAW on a DMA'd cell
        for r in sorted(ins.defs or ()):
            if r in addr_read_bar:   # WAR: redefining a DMA's source reg
                wait.add(addr_read_bar[r][1])
                del addr_read_bar[r]

        base = ins.base
        if base in ("CPYIN", "LDV"):
            sem = sem_rr
            sem_rr = (sem_rr + 1) % 6
            ins.ctrl = Control(frozenset(wait), None, sem, False,
                               ins.ctrl.stall)
            for cell, is_write in memory_effects(ins):
                if is_write:
                    setters_cell[cell] = (i, sem)
            for r in sorted(ins.defs or ()):
                setters_reg[r] = (i, sem)
            if base == "CPYIN":
                rsem = sem_rr
                sem_rr = (sem_rr + 1) % 6
                ins.ctrl = Control(frozenset(wait), rsem, sem, False,
                                   ins.ctrl.stall)
                for r in sorted(ins.uses or ()):
                    addr_read_bar[r] = (i, rsem)
        elif base in ("CPYOUT", "STV"):
            sem = sem_rr
            sem_rr = (sem_rr + 1) % 6
            ins.ctrl = Control(frozenset(wait), sem, None, False,
                               ins.ctrl.stall)
            for cell, is_write in memory_effects(ins):
                if not is_write:
                    # WAR protection for the VMEM tile being drained
                    setters_cell.setdefault(cell, (i, sem))
        else:
            ins.ctrl = Control(frozenset(wait), ins.ctrl.read_bar,
                               ins.ctrl.write_bar, ins.ctrl.yield_flag,
                               ins.ctrl.stall)
        # register overwrite by a fixed op ends the setter's relevance
        if base not in ("CPYIN", "LDV"):
            for r in sorted(ins.defs or ()):
                setters_reg.pop(r, None)


def _assign_stalls(program: List[Instruction]) -> None:
    """Forward fix-up: every fixed-latency use-def pair gets enough
    accumulated stall (the property the paper's Algorithm 1 preserves)."""
    for ins in program:
        ins.ctrl.stall = 1
    # MXM issue interval is a structural stall the vendor compiler encodes
    for i, ins in enumerate(program):
        if ins.base == "MXM":
            ins.ctrl.stall = max(ins.ctrl.stall, 2)

    def_pos: Dict[str, int] = {}
    for i, ins in enumerate(program):
        if ins.klass is OpClass.SYNC:
            def_pos.clear()
            continue
        for r in sorted(ins.uses or ()):
            j = def_pos.get(r)
            if j is None:
                continue
            producer = program[j]
            if not is_fixed_latency(producer.opcode):
                continue
            need = true_fixed_latency(producer.opcode) or 4
            accum = sum(max(1, program[k].ctrl.stall) for k in range(j, i))
            if accum < need:
                program[i - 1].ctrl.stall += need - accum
        for r in sorted(ins.defs or ()):
            def_pos[r] = i


def schedule(lowered: LoweredKernel,
             window: Optional[int] = DEFAULT_WINDOW) -> List[Instruction]:
    """Produce the -O3 baseline: list-schedule each basic block (bounded
    code-motion window = the ptxas stand-in; ``window=None`` = unbounded
    global scheduler), then assign reuse hints, barriers and stall counts."""
    program: List[Instruction] = []
    block: List[Instruction] = []
    for ins in lowered.program:
        if ins.klass is OpClass.SYNC:
            program.extend(_list_schedule(block, window))
            block = []
            program.append(ins.copy())
        else:
            block.append(ins.copy())
    program.extend(_list_schedule(block, window))

    _assign_reuse(program)
    _assign_barriers(program)
    _assign_stalls(program)
    return program


def naive_schedule(lowered: LoweredKernel) -> List[Instruction]:
    """Dataflow order with conservative control codes — the 'no scheduler'
    lower bound used by the benchmarks."""
    program = [ins.copy() for ins in lowered.program]
    _assign_reuse(program)
    _assign_barriers(program)
    _assign_stalls(program)
    return program
