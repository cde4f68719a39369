"""TSASS parser: text <-> Instruction round-trip + operand def/use analysis.

Reproduces the paper's §3.2 "CuAsmRL has a parser to decode SASS
instructions": it separates control codes / opcode / operands, and *expands*
``.64`` register-pair operands to recover the true dependencies, using the
paper's Eq. (2)::

    base = reg_no // 2
    mod  = reg_no %  2
    flip = 1 - mod
    adj  = base * 2 + flip

so ``R10.64`` touches {R10, R11} and ``R11.64`` touches {R10, R11}.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.isa import (Control, Instruction, MEM_STORE_OPS,
                                  NUM_SEMAPHORES, is_memory_op, opclass)

_CTRL_RE = re.compile(
    r"\[B(?P<mask>[-0-9]{%d}):R(?P<r>[-0-9]):W(?P<w>[-0-9]):(?P<y>[Y-]):S(?P<s>\d+)\]"
    % NUM_SEMAPHORES
)
_REG_RE = re.compile(r"\b(U?R)(\d+|Z)(\.64|\.reuse)?\b")
_PRED_RE = re.compile(r"^@!?P(?:T|\d+)$")
_META_TILE_RE = re.compile(r"tile=([A-Za-z_]\w*):(-?\d+)")
_META_GRP_RE = re.compile(r"grp=(\d+)")


def adjacent_register(reg_no: int) -> int:
    """Paper Eq. (2): the other half of a ``.64`` register pair."""
    base = reg_no // 2
    mod = reg_no % 2
    flip = 1 - mod
    return base * 2 + flip


def expand_register(token: str) -> frozenset:
    """Expand one register token to the set of architectural registers it
    touches.  ``RZ``/``URZ`` are the zero registers (no dependency), and a
    ``.64`` suffix pulls in the adjacent register (paper §3.2)."""
    regs = set()
    for m in _REG_RE.finditer(token):
        bank, num, suffix = m.group(1), m.group(2), m.group(3)
        if num == "Z":
            continue  # RZ reads as zero: not a dependency
        n = int(num)
        regs.add(f"{bank}{n}")
        if suffix == ".64":
            regs.add(f"{bank}{adjacent_register(n)}")
    return frozenset(regs)


def _split_operands(text: str) -> List[str]:
    """Split on commas that are not inside brackets."""
    out, depth, cur = [], 0, []
    for ch in text:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    last = "".join(cur).strip()
    if last:
        out.append(last)
    return out


def parse_control(text: str) -> Control:
    m = _CTRL_RE.match(text)
    if not m:
        raise ValueError(f"bad control code: {text!r}")
    mask = frozenset(int(c) for c in m.group("mask") if c != "-")
    r = None if m.group("r") == "-" else int(m.group("r"))
    w = None if m.group("w") == "-" else int(m.group("w"))
    return Control(mask, r, w, m.group("y") == "Y", int(m.group("s")))


def parse_line(line: str) -> Optional[Instruction]:
    """Parse one TSASS text line; returns None for blank/comment lines."""
    line = line.strip()
    if not line or line.startswith("//"):
        return None
    body, _, meta = line.partition("//")
    body = body.strip().rstrip(";").strip()

    m = _CTRL_RE.match(body)
    if m:
        ctrl = parse_control(body[: m.end()])
        body = body[m.end():].strip()
    else:
        ctrl = Control()

    pred = None
    parts = body.split(None, 1)
    if parts and _PRED_RE.match(parts[0]):
        pred = parts[0]
        body = parts[1] if len(parts) > 1 else ""
        parts = body.split(None, 1)
    if not parts:
        raise ValueError(f"no opcode in line: {line!r}")
    opcode = parts[0]
    opclass(opcode)  # reject unknown opcodes early
    operands = _split_operands(parts[1]) if len(parts) > 1 else []

    tile = None
    group = None
    meta = meta.strip()
    if meta:
        tm = _META_TILE_RE.search(meta)
        if tm:
            tile = (tm.group(1), int(tm.group(2)))
        gm = _META_GRP_RE.search(meta)
        if gm:
            group = int(gm.group(1))
    ins = Instruction(opcode, operands, ctrl, pred, tile, group)
    analyze_operands(ins)
    return ins


def parse_program(text: str) -> List[Instruction]:
    out = []
    for line in text.splitlines():
        ins = parse_line(line)
        if ins is not None:
            out.append(ins)
    return out


# ---------------------------------------------------------------------------
# def/use analysis
# ---------------------------------------------------------------------------

def _operand_regs(op: str) -> frozenset:
    return expand_register(op)


def analyze_operands(ins: Instruction) -> Instruction:
    """Fill ``ins.defs`` / ``ins.uses``.

    Conventions (mirroring SASS):
      * first operand is the destination for scalar/vector/MXU/LDV ops;
      * memory operands ``[...]`` contribute their *address registers* as
        uses, never as defs (the memory cell itself is tracked via ``tile``);
      * store-class ops (STV/CPYOUT) and CPYIN have no register destination;
      * predicates ``@P3`` read P3 (``PT`` is constant-true, no dep);
      * MXM accumulates in place: destination is also a use.
    """
    defs: set = set()
    uses: set = set()
    if ins.pred and ins.pred.strip("@!") not in ("PT",):
        uses.add(ins.pred.strip("@!"))

    base = ins.base
    has_reg_dst = (
        ins.operands
        and not ins.operands[0].startswith("[")
        and base not in MEM_STORE_OPS
        and base != "CPYIN"
        and base not in ("SEMWAIT", "LABEL", "BRA", "EXIT", "NOP")
    )
    for i, op in enumerate(ins.operands):
        regs = _operand_regs(op)
        if op.startswith("["):
            uses |= regs  # address computation
        elif i == 0 and has_reg_dst:
            defs |= regs
            if base == "MXM":  # accumulator: read-modify-write
                uses |= regs
        else:
            uses |= regs
    ins.defs = frozenset(defs)
    ins.uses = frozenset(uses)
    return ins


def analyze_program(program: Sequence[Instruction]) -> List[Instruction]:
    for ins in program:
        if ins.defs is None or ins.uses is None:
            analyze_operands(ins)
    return list(program)


# ---------------------------------------------------------------------------
# basic blocks
# ---------------------------------------------------------------------------

def block_id_vector(program: Sequence[Instruction]) -> List[int]:
    """Block index per instruction; boundary instructions occupy their own
    block so nothing can be swapped past them (paper §3.5: no reordering
    across labels or barrier/synchronization instructions)."""
    out = []
    blk = 0
    for ins in program:
        if ins.klass.name == "SYNC":
            blk += 1
            out.append(blk)
            blk += 1
        else:
            out.append(blk)
    return out


def memory_effects(ins: Instruction) -> List[Tuple[tuple, bool]]:
    """Memory cells touched by ``ins`` as ``[(cell_key, is_write), ...]``.

    Cell keys are ``("tile", space, idx)`` when lowering attached an alias
    token, else ``("addr", <first [..] operand text>)`` — a textual fallback
    that is exact for lowered programs (addresses are stable strings) and
    conservative otherwise (idx ``-1`` aliases its whole space, handled by
    the caller).

      * CPYIN  : writes its VMEM tile (HBM source is read-only kernel input)
      * LDV    : reads its VMEM tile
      * STV    : writes its VMEM tile
      * CPYOUT : reads its VMEM tile and writes an HBM cell keyed by its
                 destination address operand
    """
    if not is_memory_op(ins.opcode):
        return []
    base = ins.base
    tile_key = (("tile",) + ins.tile) if ins.tile is not None else None
    addr_ops = [op for op in ins.operands if op.startswith("[")]

    def _key(which: int) -> tuple:
        if tile_key is not None:
            return tile_key
        if which < len(addr_ops):
            return ("addr", addr_ops[which])
        return ("addr", "?")  # unknown: caller treats as aliasing everything

    if base == "CPYIN":
        return [(_key(0), True)]
    if base == "LDV":
        return [(_key(0), False)]
    if base == "STV":
        return [(_key(0), True)]
    if base == "CPYOUT":
        # operands: [hbm_dst], src... ; VMEM side rides on ``tile``.
        vmem_read = (tile_key, False) if tile_key is not None else None
        hbm_key = ("addr", addr_ops[0]) if addr_ops else ("addr", "?")
        eff = [(hbm_key, True)]
        if vmem_read is not None:
            eff.append(vmem_read)
        return eff
    return []


def roundtrip(program: Iterable[Instruction]) -> List[Instruction]:
    """parse(text(program)) — used by tests to pin the text format."""
    from repro_torch.core.isa import program_text
    return parse_program(program_text(list(program)))
