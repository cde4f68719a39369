"""Dependency-based micro-benchmarking of fixed-latency stall counts (§4.3).

The machine's latency table is undocumented (private), so — exactly like the
paper does against real Ampere silicon — we construct use-definition TSASS
instruction pairs and *gradually lower the producer's stall count until the
consumer observes a stale value*.  The minimum stall count that still yields
the expected output is the instruction's latency.

Also reproduces the paper's negative result: clock-based measurement
(`CS2R SR_CLOCKLO` → our ``SCLK``) underestimates the stall count because
nothing guarantees the timed sequence has completed at the second clock read
(§4.3, Listing 7: 2.6 measured vs 4 true for IADD3).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from repro_torch.core.isa import Control, Instruction, SCALAR_OPS
from repro_torch.core.machine import Machine, dataflow_reference
from repro_torch.core.parser import analyze_operands

MAX_PROBE_STALL = 32

# Table-1 scope: "common integer operations, because they are frequently
# involved in address calculation".  VPU/MXU latencies are left to the
# inference pass — this split is what produces the paper's Fig. 7 db/infer
# fractions.
# SADDX (the IADD3.X analogue) is deliberately absent: the paper reports
# the analysis pass *infers* it from schedules instead (§3.2)
DEFAULT_BENCH_OPS: Tuple[str, ...] = tuple(
    o for o in SCALAR_OPS if o != "SADDX")


def _ins(opcode, operands, stall=1, pred=None, wait=(), wbar=None):
    ctrl = Control(wait_mask=frozenset(wait), write_bar=wbar, stall=stall)
    return analyze_operands(Instruction(opcode, list(operands), ctrl, pred))


def _probe_program(opcode: str, stall: int) -> list:
    """``SMOV``-seeded use-def pair: producer under test feeds a store to an
    observable HBM cell (the paper stores to global memory, Listing 6)."""
    wide = opcode.endswith("W")
    dst = "R6.64" if wide else "R6"
    prog = [
        _ins("SMOV", ["R2", "0x7"], stall=MAX_PROBE_STALL),
        _ins("SMOV", ["R4", "0x9"], stall=MAX_PROBE_STALL),
        _ins(opcode, [dst, "R2", "R4"], stall=stall),
        _ins("STV", ["[R90]", "R6"], stall=MAX_PROBE_STALL),
        _ins("CPYOUT.64", ["[OUT0]", "R6"], stall=MAX_PROBE_STALL),
        _ins("EXIT", [], stall=1),
    ]
    return prog


def measure_stall_count(opcode: str, machine: Optional[Machine] = None,
                        max_stall: int = MAX_PROBE_STALL) -> int:
    """Minimum stall count for ``opcode`` on the target machine.

    SMOV bootstraps itself: the very first probe measures SMOV using a
    maximally-stalled producer, which is always safe.
    """
    machine = machine or Machine()
    expected = dataflow_reference(_probe_program(opcode, max_stall))
    lo = None
    for stall in range(max_stall, 0, -1):
        got = machine.run(_probe_program(opcode, stall)).outputs
        if got == expected:
            lo = stall
        else:
            break
    if lo is None:
        raise RuntimeError(f"could not bound stall count for {opcode}")
    return lo


def build_stall_table(opcodes: Iterable[str] = DEFAULT_BENCH_OPS,
                      machine: Optional[Machine] = None) -> Dict[str, int]:
    """The paper's Table 1: opcode -> microbenchmarked stall count."""
    machine = machine or Machine()
    return {op: measure_stall_count(op, machine) for op in opcodes}


def clock_based_estimate(opcode: str = "SADD", n: int = 16,
                         machine: Optional[Machine] = None) -> float:
    """Listing-7-style clock measurement: two SCLK reads around an ``n``-long
    back-to-back sequence, average cycles per instruction.  Underestimates
    (no completion guarantee), motivating the dependency-based method.

    Clock reads are timing-only (an SCLK destination holds ``int(issue)``),
    so this probe runs on ``Machine.issue_times`` instead of the dataflow
    oracle; the dependency probes above must keep using ``run`` — observing
    stale values *is* their measurement principle.
    """
    machine = machine or Machine()
    prog = [_ins("SCLK", ["R2"], stall=2)]
    for i in range(n):
        prog.append(_ins(opcode, [f"R{10 + 2 * i}", "R4", "R6"], stall=1))
    prog.append(_ins("SCLK", ["R8"], stall=2))
    prog.append(_ins("EXIT", [], stall=1))
    issue = machine.issue_times(prog)
    t1 = int(issue[0])        # what the first SCLK wrote to R2
    t2 = int(issue[n + 1])    # ... second SCLK to R8
    return (t2 - t1) / n
