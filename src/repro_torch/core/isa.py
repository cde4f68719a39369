"""TSASS: a TPU-flavored, statically-scheduled native assembly.

This is the adaptation layer of CuAsmRL's object of study (NVIDIA SASS,
undocumented, statically scheduled, §2.3 of the paper) to the TPU TensorCore:
an in-order scalar core issuing instructions with compiler-managed hazards
(stall counts), asynchronous DMA engines (HBM<->VMEM) signalling completion
through semaphores (the exact analogue of SASS write-barriers), a systolic
MXU and a VPU. See DESIGN.md §2 for the full SASS->TSASS mapping.

An instruction line round-trips through :mod:`repro_torch.core.parser` as::

    [B--1---:R-:W2:-:S04] CPYIN.128 [R219+0x4000], desc[UR16][R10.64] ; // tile=a:0 grp=3

with the same control-code structure as SASS (§2.3): wait-barrier mask,
read barrier, write barrier, yield flag, stall count.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


NUM_SEMAPHORES = 6  # SASS exposes barriers 0..5; we keep the same budget.


class OpClass(enum.Enum):
    SCALAR = "scalar"      # fixed-latency scalar core (address math)  ~ IADD3/IMAD/MOV
    VECTOR = "vector"      # fixed-latency VPU lanes                   ~ FFMA/FADD/MUFU
    MXU = "mxu"            # systolic matmul issue                     ~ HMMA
    MEM = "mem"            # variable-latency memory ops               ~ LDG/LDGSTS/STG/LDS/STS
    SYNC = "sync"          # scheduling fences: labels, waits, branches
    MISC = "misc"          # NOP, clock reads


# ---------------------------------------------------------------------------
# Opcode tables.
#
# Only the *classification* below is public to the optimizer.  The actual
# latency/bandwidth numbers live privately in repro_torch.core.machine — exactly as
# SASS latencies are undocumented and must be microbenchmarked/inferred
# (paper §3.2, §4.3).
# ---------------------------------------------------------------------------

SCALAR_OPS = (
    "SADD",     # IADD3 analogue (address add)
    "SADDX",    # IADD3.X analogue (add with carry chain)
    "SMUL",     # IMAD analogue
    "SMULW",    # IMAD.WIDE analogue (64-bit result -> pair dst)
    "SMOV",     # MOV analogue
    "SLEA",     # LEA analogue (shift-add)
    "SSEL",     # SEL analogue
    "SMIN",     # IMNMX analogue
    "SSHL",     # shift
)

VECTOR_OPS = (
    "VADD",
    "VMUL",
    "VFMA",
    "VMAX",
    "VSUB",
    "VEXP",     # MUFU.EX2 analogue (transcendental, slower lane)
    "VRSQ",     # MUFU.RSQ analogue
    "VRECIP",
)

MXU_OPS = ("MXM",)  # HMMA analogue: one 128x128x128 MXU pass

# Memory ops.  CPYIN is the LDGSTS analogue (async DMA HBM->VMEM, bypassing
# registers); CPYOUT the STG analogue (VMEM->HBM DMA); LDV/STV the LDS/STS
# analogues (VMEM<->vector registers).
MEM_LOAD_OPS = ("CPYIN", "LDV")
MEM_STORE_OPS = ("CPYOUT", "STV")
MEM_OPS = MEM_LOAD_OPS + MEM_STORE_OPS

SYNC_OPS = ("SEMWAIT", "LABEL", "BRA", "EXIT")
MISC_OPS = ("NOP", "SCLK")  # SCLK ~ CS2R SR_CLOCKLO (cycle counter read)

# The action space of the assembly game: "memory load/store instructions,
# such as LDG, LDGSTS, and STG" (paper §3.5).
SCHEDULABLE_OPS = frozenset(MEM_OPS)

_CLASS_OF = {}
for _o in SCALAR_OPS:
    _CLASS_OF[_o] = OpClass.SCALAR
for _o in VECTOR_OPS:
    _CLASS_OF[_o] = OpClass.VECTOR
for _o in MXU_OPS:
    _CLASS_OF[_o] = OpClass.MXU
for _o in MEM_OPS:
    _CLASS_OF[_o] = OpClass.MEM
for _o in SYNC_OPS:
    _CLASS_OF[_o] = OpClass.SYNC
for _o in MISC_OPS:
    _CLASS_OF[_o] = OpClass.MISC


def base_opcode(opcode: str) -> str:
    """Strip modifiers: ``CPYIN.128.BYPASS`` -> ``CPYIN``.

    Like SASS, modifiers can change behaviour/latency (paper §5.2 notes
    IMAD vs IMAD.WIDE differ), so the *full* opcode is the latency-table key,
    while the base opcode decides the class.
    """
    return opcode.split(".")[0]


def opclass(opcode: str) -> OpClass:
    try:
        return _CLASS_OF[base_opcode(opcode)]
    except KeyError as e:
        raise ValueError(f"unknown TSASS opcode: {opcode!r}") from e


def is_memory_op(opcode: str) -> bool:
    return base_opcode(opcode) in MEM_OPS


def is_fixed_latency(opcode: str) -> bool:
    return opclass(opcode) in (OpClass.SCALAR, OpClass.VECTOR, OpClass.MXU)


def is_boundary(opcode: str) -> bool:
    """Instructions that delimit basic blocks / cannot be crossed (§3.5)."""
    return opclass(opcode) is OpClass.SYNC


@dataclasses.dataclass
class Control:
    """SASS-style control code ``[B......:R.:W.:Y:S..]`` (paper §2.3)."""

    wait_mask: frozenset = frozenset()       # barrier indices this instr waits on
    read_bar: Optional[int] = None           # read-barrier it sets (operand protection)
    write_bar: Optional[int] = None          # write-barrier it sets (result protection)
    yield_flag: bool = False
    stall: int = 1                           # cycles before the next instr may issue

    def copy(self) -> "Control":
        return Control(self.wait_mask, self.read_bar, self.write_bar,
                       self.yield_flag, self.stall)

    def text(self) -> str:
        bits = "".join(str(i) if i in self.wait_mask else "-"
                       for i in range(NUM_SEMAPHORES))
        r = "-" if self.read_bar is None else str(self.read_bar)
        w = "-" if self.write_bar is None else str(self.write_bar)
        y = "Y" if self.yield_flag else "-"
        return f"[B{bits}:R{r}:W{w}:{y}:S{self.stall:02d}]"


@dataclasses.dataclass
class Instruction:
    """One TSASS instruction.

    ``operands`` keep their surface syntax (``R10.64``, ``[R219+0x4000]``,
    ``desc[UR16][R44.64]``, immediates).  Parsed def/use sets are computed by
    :mod:`repro_torch.core.parser` (operand expansion per the paper's Eq. 2) and
    cached on the instance.

    ``tile`` is the memory-alias token carried through lowering as a comment
    (``// tile=a:3``): ``(space, index)`` with index ``-1`` meaning unknown
    (conservatively aliases everything in its space).  ``group`` marks
    consecutive-DMA groups whose relative order is pinned (the paper's
    "additional dependencies" heuristic for LDGSTS sequences, §3.5).
    """

    opcode: str
    operands: list
    ctrl: Control = dataclasses.field(default_factory=Control)
    pred: Optional[str] = None               # "@P0" / "@!PT" style guard
    tile: Optional[tuple] = None             # (space, tile_index)
    group: Optional[int] = None              # consecutive-DMA group id
    comment: str = ""

    # --- caches filled by parser.analyze_operands -------------------------
    defs: Optional[frozenset] = None         # registers written
    uses: Optional[frozenset] = None         # registers read (incl. addresses)

    def copy(self) -> "Instruction":
        return Instruction(self.opcode, list(self.operands), self.ctrl.copy(),
                           self.pred, self.tile, self.group, self.comment,
                           self.defs, self.uses)

    @property
    def base(self) -> str:
        return base_opcode(self.opcode)

    @property
    def klass(self) -> OpClass:
        return opclass(self.opcode)

    def is_schedulable(self) -> bool:
        return self.base in SCHEDULABLE_OPS

    def predicated_off(self) -> bool:
        """``@!PT`` guards are constant-false: never executes (paper §5.7.2)."""
        return self.pred == "@!PT"

    def text(self) -> str:
        pred = f"{self.pred} " if self.pred else ""
        ops = ", ".join(str(o) for o in self.operands)
        meta = []
        if self.tile is not None:
            meta.append(f"tile={self.tile[0]}:{self.tile[1]}")
        if self.group is not None:
            meta.append(f"grp={self.group}")
        if self.comment:
            meta.append(self.comment)
        tail = f" ; // {' '.join(meta)}" if meta else " ;"
        return f"{self.ctrl.text()} {pred}{self.opcode} {ops}{tail}".rstrip()

    def __str__(self) -> str:  # pragma: no cover - convenience
        return self.text()


def program_text(program) -> str:
    return "\n".join(ins.text() for ins in program)
