"""State embedding (paper §3.4).

Each instruction becomes a vector of individually-embedded fields,
concatenated: control code (wait-barrier bits, read/write barrier index or
-1 when absent, yield flag, stall count), opcode (binary: memory vs
non-memory, -1 for non-memory), and operands (memory locations mapped to
their index in the memory table and normalized by the table size; registers
mapped through the register table; -1 padding up to the maximum operand
count of the file).  Rows stack into the state matrix; a leading validity
column marks padding rows so a fixed-size CNN can consume programs of any
length.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.analysis import Analysis
from repro_torch.core.isa import Instruction, NUM_SEMAPHORES


# the analysis-independent leading columns of every embedding row:
# valid + 6 wait bits + read/write bar + yield + stall + is_mem + pred.
# The remaining ``analysis.max_operands`` operand columns vary per kernel,
# so cross-kernel consumers (the cost-model featurizer) aggregate over
# exactly this fixed prefix.
FIXED_FEATURES = 1 + NUM_SEMAPHORES + 2 + 1 + 1 + 1 + 1


def fixed_feature_dim() -> int:
    """Width of the kernel-independent embedding-row prefix."""
    return FIXED_FEATURES


def feature_dim(analysis: Analysis) -> int:
    return FIXED_FEATURES + analysis.max_operands


def embed_instruction(ins: Instruction, analysis: Analysis) -> np.ndarray:
    n_mem = max(len(analysis.mem_table), 1)
    n_reg = max(len(analysis.reg_table), 1)
    vec = [1.0]  # validity
    vec += [1.0 if i in ins.ctrl.wait_mask else 0.0
            for i in range(NUM_SEMAPHORES)]
    vec.append(-1.0 if ins.ctrl.read_bar is None else float(ins.ctrl.read_bar))
    vec.append(-1.0 if ins.ctrl.write_bar is None else float(ins.ctrl.write_bar))
    vec.append(1.0 if ins.ctrl.yield_flag else 0.0)
    vec.append(float(ins.ctrl.stall) / 16.0)
    vec.append(1.0 if ins.klass.name == "MEM" else -1.0)
    vec.append(-1.0 if ins.pred is None else (0.0 if ins.predicated_off() else 1.0))
    for k in range(analysis.max_operands):
        if k >= len(ins.operands):
            vec.append(-1.0)
            continue
        op = ins.operands[k]
        if op in analysis.mem_table:
            vec.append(analysis.mem_table[op] / n_mem)
        else:
            # register / immediate: register table index, -1 for immediates
            regs = sorted((ins.defs or frozenset()) | (ins.uses or frozenset()))
            first = op.split(".")[0]
            if first in analysis.reg_table:
                vec.append(analysis.reg_table[first] / n_reg)
            elif regs and first.startswith(("R", "UR")):
                vec.append(analysis.reg_table.get(first, 0) / n_reg)
            else:
                vec.append(-1.0)
    return np.asarray(vec, dtype=np.float32)


def embed_program(program: Sequence[Instruction], analysis: Analysis,
                  n_rows: Optional[int] = None) -> np.ndarray:
    """The state matrix S_i of the assembly game: one row per instruction,
    padded with invalid rows up to ``n_rows``."""
    f = feature_dim(analysis)
    n = len(program)
    rows = n_rows if n_rows is not None else n
    if n > rows:
        raise ValueError(f"program ({n}) longer than embedding rows ({rows})")
    out = np.full((rows, f), -1.0, dtype=np.float32)
    out[:, 0] = 0.0
    for i, ins in enumerate(program):
        out[i] = embed_instruction(ins, analysis)
    return out
