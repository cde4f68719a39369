"""The TSASS machine: a deterministic scoreboard model of a TPU TensorCore.

This module plays the role of the *A100 in the paper's reward loop* (§3.6):
the assembly game executes mutated schedules here and is rewarded by the
returned cycle count.  Two invariants keep the reproduction honest
(DESIGN.md §2.3):

1. **The latency/bandwidth tables below are private.**  The optimizer-facing
   code (analysis, masking, the agent) never imports them; like real SASS,
   they must be *measured* by dependency-based microbenchmarking
   (:mod:`repro_torch.core.microbench`, paper §4.3) or *inferred* from valid
   schedules (:mod:`repro_torch.core.analysis`, paper §3.2).  Tests are the only
   licensed peekers.

2. **Execution is statically scheduled with no interlocks** (post-Kepler
   semantics, paper §2.3.1): a consumer issued before its producer's latency
   has elapsed reads a *stale* value.  Registers and memory carry 64-bit
   dataflow hashes, so any dependency violation corrupts the final output —
   which is how probabilistic testing (§4.1) and the masking property tests
   catch invalid reorderings.

Timing model (in-order, single-issue scalar core):

  * issue of instruction ``i`` waits for: its stall-count slot, every
    semaphore in its wait mask, and structural hazards (DMA queue depth,
    MXU issue interval, VMEM ports);
  * fixed-latency ops commit their register result LAT cycles after issue;
  * DMA ops (CPYIN/CPYOUT) run on engines (2 inbound / 1 outbound) with a
    setup cost plus size/bandwidth, and clear their write/read barriers at
    completion — the LDGSTS analogue;
  * LDV/STV contend for VMEM ports; LDV sets a write barrier (LDS analogue);
  * back-to-back ``MXM`` with a ``.reuse`` operand hit an operand-forwarding
    buffer (lower issue interval) unless a DMA issue intervened — the
    TPU-idiomatic re-model of the paper's §5.7.1 operand-reuse-cache
    discovery.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import parser as tsass_parser
from repro_torch.core.isa import Instruction, OpClass, base_opcode

# ---------------------------------------------------------------------------
# PRIVATE ground truth.  Only tests and this module may look.
# ---------------------------------------------------------------------------

_TRUE_FIXED_LAT: Dict[str, int] = {
    # scalar core (paper Table 1: common integer ops 4, wide ops 5)
    "SADD": 4, "SADDX": 4, "SMUL": 4, "SMOV": 4, "SLEA": 4, "SSEL": 4,
    "SMIN": 4, "SSHL": 4,
    "SMULW": 5,
    # VPU lanes
    "VADD": 4, "VSUB": 4, "VMUL": 4, "VFMA": 4, "VMAX": 4,
    "VEXP": 8, "VRSQ": 8, "VRECIP": 8,
    # MXU result latency (systolic drain)
    "MXM": 24,
    # cycle-counter read
    "SCLK": 2,
}

_MXU_ISSUE_INTERVAL = 8          # cycles between MXM issues (throughput)
_MXU_REUSE_INTERVAL = 6          # ... when the operand-forwarding buffer hits
_DMA_SETUP = 48                  # per-copy engine setup cycles
_DMA_BYTES_PER_CYCLE = 32        # per-engine sustained bandwidth
_DMA_QUEUE_DEPTH = 6             # outstanding copies per engine
_NUM_IN_ENGINES = 2
_LDV_LAT = 12                    # VMEM->VREG (LDS analogue)
_STV_LAT = 4
_VMEM_PORTS = 2                  # concurrent LDV/STV issue slots
_VMEM_PORT_HOLD = 2              # cycles a port stays busy per access
_DEFAULT_DMA_BYTES = 16          # CPYIN without a size modifier = 128-bit
_SERIAL_STALL = 1024             # > any single-instruction latency; used by
                                 # the dataflow reference executor


def _dma_bytes(opcode: str) -> int:
    for part in opcode.split(".")[1:]:
        if part.isdigit():
            return int(part)
    return _DEFAULT_DMA_BYTES


def true_fixed_latency(opcode: str) -> Optional[int]:
    """TEST-ONLY oracle; optimizer code must not call this."""
    if opcode in _TRUE_FIXED_LAT:
        return _TRUE_FIXED_LAT[opcode]
    return _TRUE_FIXED_LAT.get(base_opcode(opcode))


# ---------------------------------------------------------------------------
# dataflow value domain: 64-bit hashes
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _mix_str(s: str) -> int:
    h = 1469598103934665603
    for ch in s.encode():
        h = ((h ^ ch) * 1099511628211) & _MASK64
    return h


def _mix(*vals) -> int:
    h = 0x9E3779B97F4A7C15
    for v in vals:
        if isinstance(v, str):
            v = _mix_str(v)
        h ^= (v + 0x9E3779B97F4A7C15 + ((h << 6) & _MASK64) + (h >> 2)) & _MASK64
        h = (h * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 27
    return h & _MASK64


class _ExecInfo:
    """Per-instruction execution metadata, computed once and cached on the
    instruction object (instructions are immutable during games; only their
    order changes), keeping the reward loop fast."""

    __slots__ = ("base", "klass", "uses", "defs", "effects", "read_cells",
                 "write_cells", "hbm_src", "nbytes", "pred_off", "lat",
                 "imm", "ldv_dst", "reuse_op")

    def __init__(self, ins: Instruction):
        self.base = ins.base
        self.klass = ins.klass
        self.uses = tuple(sorted(ins.uses or ()))
        self.defs = tuple(sorted(ins.defs or ()))
        self.effects = tuple(tsass_parser.memory_effects(ins))
        self.read_cells = tuple(c for c, w in self.effects if not w)
        self.write_cells = tuple(c for c, w in self.effects if w)
        self.hbm_src = _hbm_source_cell(ins) if self.base == "CPYIN" else None
        self.nbytes = _dma_bytes(ins.opcode) if self.base in ("CPYIN", "CPYOUT") else 0
        self.pred_off = ins.predicated_off()
        self.lat = true_fixed_latency(ins.opcode)
        self.imm = (ins.operands[-1]
                    if self.base == "SMOV" and ins.operands
                    and not ins.operands[-1].startswith(("R", "UR", "["))
                    else None)
        dst = ins.operands[0] if ins.operands else None
        self.ldv_dst = (tuple(sorted(tsass_parser.expand_register(dst)))
                        if self.base == "LDV" and dst is not None
                        and not dst.startswith("[") else ())
        self.reuse_op = any(".reuse" in op for op in ins.operands)


def exec_info(ins: Instruction) -> _ExecInfo:
    info = getattr(ins, "_exec", None)
    if info is None:
        info = _ExecInfo(ins)
        ins._exec = info
    return info


@dataclasses.dataclass
class RunResult:
    cycles: float
    outputs: Dict[tuple, int]          # observable HBM cells -> final hash
    counters: Dict[str, float]
    reg_values: Dict[str, int]         # final committed register file


class _DelayedStore:
    """Name -> value store with delayed commit: a read before a pending
    write's ready time observes the stale committed value (no interlock)."""

    def __init__(self, uninit_tag: str, seed: int):
        self._committed: Dict = {}
        self._pending: Dict[object, List[Tuple[float, int, int]]] = {}
        self._tag = uninit_tag
        self._seed = seed
        self._seq = 0

    def read(self, key, t: float):
        pend = self._pending.get(key)
        if pend:
            keep = []
            for ready, seq, val in sorted(pend):
                if ready <= t:
                    self._committed[key] = val
                else:
                    keep.append((ready, seq, val))
            if keep:
                self._pending[key] = keep
            else:
                del self._pending[key]
        if key not in self._committed:
            self._committed[key] = _mix(self._tag, self._seed, str(key))
        return self._committed[key]

    def write(self, key, val: int, ready: float) -> None:
        self._seq += 1
        self._pending.setdefault(key, []).append((ready, self._seq, val))

    def finalize(self) -> Dict:
        for key in list(self._pending):
            self.read(key, float("inf"))
        return dict(self._committed)


def _hbm_source_cell(ins: Instruction) -> tuple:
    """The HBM cell a CPYIN reads.  Lowering identifies logical tiles, so a
    tile token gives ``("hbm", space, idx)``; otherwise fall back to the
    textual source operand (exact for hand-written microbenchmarks)."""
    if ins.tile is not None:
        return ("hbm",) + ins.tile
    srcs = [op for op in ins.operands[1:]] or ["?"]
    return ("hbm", "|".join(srcs))


class Machine:
    """Cycle-level scoreboard executor for TSASS programs.

    ``run`` is the full-fidelity oracle (timing + dataflow hashes);
    ``time`` is the timing-only fast path (:mod:`repro_torch.core.timing`),
    bit-exact against ``run(...).cycles`` and the one the reward loop uses.
    """

    def __init__(self, noise: float = 0.0, seed: int = 0):
        self.noise = noise
        self._rng = random.Random(seed)

    def time(self, program: Sequence[Instruction],
             input_seed: int = 0) -> float:
        """Cycle count via the scoreboard rules alone — no dataflow hashes,
        no delayed stores.  Bit-exact against ``run(program).cycles``
        (property-tested).  ``input_seed`` is accepted for signature parity
        with ``run``; timing is independent of input values because reads
        never stall (no interlocks).  Measurement noise is applied exactly
        as in ``run`` (and draws from the same RNG stream)."""
        from repro_torch.core import timing
        cycles = timing.time_program(program)
        if self.noise:
            cycles *= 1.0 + self._rng.gauss(0.0, self.noise)
        return cycles

    def issue_times(self, program: Sequence[Instruction]) -> List[float]:
        """Per-instruction issue cycles via the timing-only path (LABELs
        report the running cycle count).  An ``SCLK`` destination register
        ends up holding ``int(issue)``, so clock-style microbenchmarks can
        run here instead of through the dataflow oracle."""
        from repro_torch.core import timing
        return timing.issue_times(program)

    def run(self, program: Sequence[Instruction], input_seed: int = 0,
            _serialize: bool = False) -> RunResult:
        regs = _DelayedStore("uninit-reg", input_seed)
        mem = _DelayedStore("uninit-mem", input_seed)
        sem_busy = [0.0] * 6
        in_engine_free = [0.0] * _NUM_IN_ENGINES
        out_engine_free = 0.0
        in_done: List[List[float]] = [[] for _ in range(_NUM_IN_ENGINES)]
        out_done: List[float] = []
        vmem_port_free = [0.0] * _VMEM_PORTS
        mxu_ready = 0.0
        last_mxm_srcs: frozenset = frozenset()
        dma_since_mxm = False
        next_in_engine = 0

        c = {
            "issued": 0, "exec_issued": 0, "cycles": 0.0,
            "stall_sem": 0.0, "stall_queue": 0.0, "stall_port": 0.0,
            "stall_mxu": 0.0, "stall_count_cycles": 0.0,
            "dma_bytes_in": 0, "dma_bytes_out": 0,
            "dma_busy_in": 0.0, "dma_busy_out": 0.0,
            "mxm_issues": 0, "mxm_reuse_hits": 0,
            "ldv": 0, "stv": 0, "cpyin": 0, "cpyout": 0,
        }

        t = 0.0
        end = 0.0
        for ins in program:
            info = exec_info(ins)
            base = info.base
            klass = info.klass
            if base == "LABEL":
                continue  # zero-size marker

            # -- semaphore waits (SASS wait-barrier mask) ---------------------
            t0 = t
            for s in ins.ctrl.wait_mask:
                t = max(t, sem_busy[s])
            c["stall_sem"] += t - t0

            executes = not info.pred_off

            # -- structural hazards -------------------------------------------
            if executes and base == "MXM":
                t1 = t
                t = max(t, mxu_ready)
                c["stall_mxu"] += t - t1
            if executes and base == "CPYIN":
                t1 = t
                q = in_done[next_in_engine]
                while len([d for d in q if d > t]) >= _DMA_QUEUE_DEPTH:
                    t = min(d for d in q if d > t)
                c["stall_queue"] += t - t1
            if executes and base == "CPYOUT":
                t1 = t
                while len([d for d in out_done if d > t]) >= _DMA_QUEUE_DEPTH:
                    t = min(d for d in out_done if d > t)
                c["stall_queue"] += t - t1
            if executes and base in ("LDV", "STV"):
                t1 = t
                p = min(range(_VMEM_PORTS), key=lambda i: vmem_port_free[i])
                t = max(t, vmem_port_free[p])
                c["stall_port"] += t - t1
                vmem_port_free[p] = t + _VMEM_PORT_HOLD

            # -- issue + effects ----------------------------------------------
            issue = t
            c["issued"] += 1
            if executes:
                c["exec_issued"] += 1
                srcs = [regs.read(r, issue) for r in info.uses]

                if klass in (OpClass.SCALAR, OpClass.VECTOR) or base == "SCLK":
                    lat = info.lat or 4
                    if base == "SCLK":
                        val = int(issue)
                    elif info.imm is not None:
                        val = _mix("imm", info.imm, input_seed)
                    else:
                        val = _mix(ins.opcode, *srcs)
                    for d in info.defs:
                        regs.write(d, val, issue + lat)

                elif base == "MXM":
                    lat = info.lat
                    srcs_set = frozenset(info.uses)
                    hit = (info.reuse_op and not dma_since_mxm
                           and bool(srcs_set & last_mxm_srcs))
                    if hit:
                        c["mxm_reuse_hits"] += 1
                    mxu_ready = issue + (_MXU_REUSE_INTERVAL if hit
                                         else _MXU_ISSUE_INTERVAL)
                    last_mxm_srcs = srcs_set
                    dma_since_mxm = False
                    c["mxm_issues"] += 1
                    val = _mix("MXM", *srcs)
                    for d in info.defs:
                        regs.write(d, val, issue + lat)

                elif base == "CPYIN":
                    nbytes = info.nbytes
                    eng = next_in_engine
                    next_in_engine = (next_in_engine + 1) % _NUM_IN_ENGINES
                    start = max(issue + _DMA_SETUP, in_engine_free[eng])
                    done = start + nbytes / _DMA_BYTES_PER_CYCLE
                    in_engine_free[eng] = done
                    in_done[eng].append(done)
                    c["dma_busy_in"] += done - start
                    c["dma_bytes_in"] += nbytes
                    c["cpyin"] += 1
                    dma_since_mxm = True
                    val = _mix("CPYIN",
                               mem.read(info.hbm_src, issue), *srcs)
                    for cell in info.write_cells:
                        mem.write(cell, val, done)
                    if ins.ctrl.write_bar is not None:
                        sem_busy[ins.ctrl.write_bar] = max(
                            sem_busy[ins.ctrl.write_bar], done)
                    if ins.ctrl.read_bar is not None:
                        sem_busy[ins.ctrl.read_bar] = max(
                            sem_busy[ins.ctrl.read_bar], start)

                elif base == "CPYOUT":
                    nbytes = info.nbytes
                    start = max(issue + _DMA_SETUP, out_engine_free)
                    done = start + nbytes / _DMA_BYTES_PER_CYCLE
                    out_engine_free = done
                    out_done.append(done)
                    c["dma_busy_out"] += done - start
                    c["dma_bytes_out"] += nbytes
                    c["cpyout"] += 1
                    dma_since_mxm = True
                    data = [mem.read(cell, start) for cell in info.read_cells]
                    val = _mix("CPYOUT", *(data + srcs))
                    for cell in info.write_cells:
                        mem.write(cell, val, done)
                    if ins.ctrl.write_bar is not None:
                        sem_busy[ins.ctrl.write_bar] = max(
                            sem_busy[ins.ctrl.write_bar], done)
                    if ins.ctrl.read_bar is not None:
                        sem_busy[ins.ctrl.read_bar] = max(
                            sem_busy[ins.ctrl.read_bar], start)

                elif base == "LDV":
                    done = issue + _LDV_LAT
                    c["ldv"] += 1
                    data = [mem.read(cell, issue) for cell in info.read_cells]
                    val = _mix("LDV", *(data + srcs))
                    for r in info.ldv_dst:
                        regs.write(r, val, done)
                    if ins.ctrl.write_bar is not None:
                        sem_busy[ins.ctrl.write_bar] = max(
                            sem_busy[ins.ctrl.write_bar], done)

                elif base == "STV":
                    done = issue + _STV_LAT
                    c["stv"] += 1
                    val = _mix("STV", *srcs)
                    for cell in info.write_cells:
                        mem.write(cell, val, done)
                    if ins.ctrl.read_bar is not None:
                        sem_busy[ins.ctrl.read_bar] = max(
                            sem_busy[ins.ctrl.read_bar], issue + 2)

                elif base == "SEMWAIT":
                    t = max([t] + sem_busy)
                    issue = t

            # -- advance by the stall count ------------------------------------
            step = max(1, _SERIAL_STALL if _serialize else ins.ctrl.stall)
            c["stall_count_cycles"] += max(0, ins.ctrl.stall - 1)
            t = issue + step
            end = max(end, t)

        end = max([end, out_engine_free] + list(in_engine_free) + sem_busy)
        cycles = float(end)
        if self.noise:
            cycles *= 1.0 + self._rng.gauss(0.0, self.noise)

        reg_final = regs.finalize()
        mem_final = mem.finalize()
        outputs = {cell: v for cell, v in mem_final.items()
                   if cell[0] == "addr"
                   or (cell[0] == "tile" and str(cell[1]).startswith("out"))}
        c["cycles"] = cycles
        c["ipc"] = c["exec_issued"] / max(cycles, 1.0)
        c["bw_in_Bpc"] = c["dma_bytes_in"] / max(cycles, 1.0)
        c["bw_out_Bpc"] = c["dma_bytes_out"] / max(cycles, 1.0)
        c["dma_busy_in_frac"] = c["dma_busy_in"] / max(cycles * _NUM_IN_ENGINES, 1.0)
        c["dma_busy_out_frac"] = c["dma_busy_out"] / max(cycles, 1.0)
        return RunResult(cycles, outputs, c, reg_final)


def dataflow_reference(program: Sequence[Instruction],
                       input_seed: int = 0) -> Dict[tuple, int]:
    """Oracle semantics: the program executed with every latency trivially
    satisfied (each instruction fully completes before the next issues).
    Any *valid* reordering must reproduce exactly this observable HBM state —
    the contract behind the paper's probabilistic testing (§4.1)."""
    return Machine().run(program, input_seed=input_seed,
                         _serialize=True).outputs
