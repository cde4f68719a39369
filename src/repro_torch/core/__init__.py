"""CuAsmRL core: the paper's contribution as a composable library.

Port of ``repro/core`` (numpy; no framework): the TSASS ISA and parser,
static analysis (§3.2), the simulated scoreboard machine and its
timing-only fast path, the stall-table microbenchmarks, fault injection
and the assembly game env (§3.3–3.6).  The PPO agent (§3.7,
``core/ppo.py`` and ``core/game.py``) is not ported yet (ROADMAP A7).
"""

from repro_torch.core.analysis import Analysis, analyze
from repro_torch.core.env import AssemblyGame, can_swap
from repro_torch.core.faults import (FaultSpec, FaultyMachine, HardFault,
                                     MeasureError, MeasureTimeout,
                                     schedule_fingerprint)
from repro_torch.core.isa import Control, Instruction, program_text
from repro_torch.core.machine import Machine, dataflow_reference
from repro_torch.core.microbench import (build_stall_table,
                                         clock_based_estimate)
from repro_torch.core.parser import parse_line, parse_program

__all__ = [
    "Analysis", "analyze", "AssemblyGame", "can_swap", "Control",
    "Instruction", "program_text", "Machine", "dataflow_reference",
    "build_stall_table", "clock_based_estimate", "parse_line",
    "parse_program", "FaultSpec", "FaultyMachine", "HardFault",
    "MeasureError", "MeasureTimeout", "schedule_fingerprint",
]
