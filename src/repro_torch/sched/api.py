"""Legacy public API of the schedule optimizer — the ``@cuasmrl.jit``
analogue (paper §4.1 Listing 4, §4.2 Listing 5).

.. deprecated::
    ``CuAsmRL`` **is** an :class:`OptimizationSession` now — a
    ``DeprecationWarning``-emitting alias that pins one kernel and keeps
    the legacy ``optimize(force=...)`` / ``deploy(load_dir=...)``
    call shapes working.  New code should write

        session = OptimizationSession()
        res = session.optimize(OptimizeRequest(kernel="matmul_leakyrelu"))
        art = session.deploy("matmul_leakyrelu")

    Every session capability (``optimize_many``, scenario/target axes,
    pluggable backends) is available on the alias directly.

Port of ``repro/sched/api.py``.  One addition: ``device``, where the PPO
agent runs (default: the card; a search raises without one).
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Union

from repro_torch.core.game import GameResult
from repro_torch.core.machine import Machine
from repro_torch.core.ppo import PPOConfig
from repro_torch.sched import cache
from repro_torch.sched.backends import FastTimingBackend
from repro_torch.sched.cache import TARGET, ScheduleCache
from repro_torch.sched.session import (KernelDef, OptimizationSession,
                                       OptimizeRequest, PPOStrategy)

__all__ = ["CuAsmRL", "KernelDef", "TARGET"]


class CuAsmRL(OptimizationSession):
    """Deprecated one-kernel alias of :class:`OptimizationSession`."""

    def __init__(self, kdef: KernelDef,
                 ppo: Optional[PPOConfig] = None,
                 cache_dir: str = cache.DEFAULT_CACHE_DIR,
                 target: str = TARGET,
                 machine_factory: Callable[[], Machine] = Machine,
                 stall_db: Optional[Dict[str, int]] = None,
                 verify_seeds: int = 4, device=None):
        warnings.warn(
            "CuAsmRL is deprecated; use OptimizationSession.optimize("
            "OptimizeRequest(kernel=...)) — see repro_torch.sched.session",
            DeprecationWarning, stacklevel=2)
        super().__init__(
            backend=FastTimingBackend(machine_factory=machine_factory),
            strategy=PPOStrategy(ppo, device=device),
            cache_dir=cache_dir, target=target, stall_db=stall_db,
            verify_seeds=verify_seeds)
        self.kdef = kdef
        self.ppo = ppo or PPOConfig()
        self.cache_dir = cache_dir
        self.machine_factory = machine_factory
        self.last_game: Optional[GameResult] = None

    @property
    def stall_db(self) -> Dict[str, int]:
        # Table 1: built once per target by dependency microbenchmarking
        return self.stall_table()

    # ---- §4.2 Listing 5: invoke optimization --------------------------------

    def optimize(self, request=None, *, force: bool = False,
                 verbose: bool = False):
        """Legacy ``optimize(force=..., verbose=...)`` on the pinned
        kernel, returning the bare
        :class:`~repro_torch.sched.cache.Artifact`.
        A session-style request argument goes straight to
        :meth:`OptimizationSession.optimize` and returns its
        ``OptimizeResult``."""
        if request is not None:
            return super().optimize(request)
        res = super().optimize(OptimizeRequest(
            kernel=self.kdef, ppo=self.ppo, force=force, verbose=verbose))
        if res.game is not None:
            self.last_game = res.game
        return res.artifact

    # ---- §4.2 Listing 5: deployment lookup ------------------------------------

    def deploy(self, load_dir: Optional[str] = None, **kwargs):
        """Legacy ``deploy(load_dir=...)`` on the pinned kernel — a pure
        cache-index lookup (v1 single-artifact directories resolve
        through :class:`ScheduleCache` itself).  Passing a kernel
        name/def (session-style) forwards to
        :meth:`OptimizationSession.deploy`."""
        if isinstance(load_dir, (KernelDef,)) or kwargs or (
                isinstance(load_dir, str) and not _looks_like_path(load_dir)):
            return super().deploy(load_dir, **kwargs)
        sc = (self.cache if load_dir is None
              else ScheduleCache(load_dir, self.target))
        art = sc.lookup_best(self.kdef.name)
        if art is None:
            raise FileNotFoundError(
                f"no cached schedule for {self.kdef.name}; run optimize() "
                f"offline first (the paper's search/deploy split)")
        return art


def _looks_like_path(s: str) -> bool:
    """Disambiguate legacy ``deploy(load_dir)`` from session-style
    ``deploy(kernel_name)``: cache dirs carry path separators or exist on
    disk; registry names never do."""
    import os
    return os.sep in s or "/" in s or os.path.isdir(s)
