"""Probabilistic testing of optimized schedules (paper §4.1).

"Probabilistic testing generates randomized inputs and reference outputs and
then compares with the output of the program."  Formal verification of SASS
is impossible (no official semantics) and bitwise enumeration intractable —
both statements carry over to TSASS verbatim, so the sanity check is the
same: seed the input hash domain randomly, run the dataflow reference of the
*original* schedule, and compare the optimized schedule's machine execution
against it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core.isa import Instruction
from repro_torch.core.machine import Machine, dataflow_reference


@dataclasses.dataclass
class VerifyResult:
    ok: bool
    n_seeds: int
    failures: List[int]


def probabilistic_test(original: Sequence[Instruction],
                       optimized: Sequence[Instruction],
                       n_seeds: int = 8,
                       machine: Optional[Machine] = None) -> VerifyResult:
    machine = machine or Machine()
    failures = []
    for seed in range(n_seeds):
        expected = dataflow_reference(original, input_seed=seed)
        got = machine.run(optimized, input_seed=seed).outputs
        if got != expected:
            failures.append(seed)
    return VerifyResult(ok=not failures, n_seeds=n_seeds, failures=failures)
