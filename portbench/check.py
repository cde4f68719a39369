"""The comparison that decides ``correct`` for a training cell.

The program's first steps (run in set-up, through the window's own call
and feed) and the reference's steps from the same weights and batches
give three numbers, each held to its own limit from the cell's file
under ``portbench/limits/``:

* ``first_loss_gap``: |loss - reference's| over the reference's, of the
  first step.  The later steps' gaps are logged, not compared: from the
  drawn weights at the mix's peak rate the losses of steps 2 and 3 swing
  widely from seed to seed, and their gaps with them (PERF.md §6);
* ``grad_gap``: the worst leaf's gap between the norms of the first
  step's gradient as the program's optimizer got it (its first moment
  after one step, over 1 - b1 and the clip factor) and the reference's,
  over the larger of that leaf's reference norm and the median leaf's;
* ``change_gap``: the same of each leaf's change over the steps, leaving
  out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone).

A leaf is one layer's tensor (:func:`portbench.layout.per_layer_names`).
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List

NUMBERS = ("first_loss_gap", "grad_gap", "change_gap")
QUIET_GRADIENT = 1e-3    # of the median leaf's: such a leaf's change
                         # is not compared


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float
    worst: str = ""      # the step or leaf that gave the value

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
                names: List[str]):
    floor = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], floor) for n in names}
    worst = max(names, key=lambda n: (not math.isfinite(gaps[n]), gaps[n]))
    return gaps[worst], worst


def loss_gaps(prog, ref) -> List[float]:
    """Each step's |loss - reference's| over the reference's."""
    return [abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses)]


def gaps(prog, ref) -> Dict[str, tuple]:
    """{number: (value, where)} of the program's readings against the
    reference's (both :class:`portbench.reference.steps.Readings`)."""
    if set(prog.grad_norms) != set(ref.grad_norms) \
            or set(prog.change_norms) != set(ref.change_norms):
        raise ValueError("the program's leaves and the reference's differ")
    names = sorted(ref.grad_norms)
    median_grad = statistics.median(ref.grad_norms[n] for n in names)
    moving = [n for n in names
              if ref.grad_norms[n] >= QUIET_GRADIENT * median_grad]
    return {
        "first_loss_gap": (loss_gaps(prog, ref)[0], "step 1"),
        "grad_gap": _worst_leaf(prog.grad_norms, ref.grad_norms, names),
        "change_gap": _worst_leaf(prog.change_norms, ref.change_norms,
                                  moving),
    }


def compare(prog, ref, limits: Dict[str, float]) -> List[Check]:
    found = gaps(prog, ref)
    return [Check(name, float(found[name][0]), float(limits[name]),
                  found[name][1]) for name in NUMBERS]
