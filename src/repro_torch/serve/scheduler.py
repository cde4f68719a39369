"""Multi-tenant request scheduler: weighted fair queueing with a
starvation bound and per-tenant token budgets.

The engine asks this scheduler *which request to admit next* whenever a
slot frees up.  The policy is stride scheduling (virtual-time WFQ): each
tenant carries a virtual finish time ``vtime``; admitting one of its
requests advances ``vtime`` by ``cost / weight`` where ``cost`` is the
request's token footprint (prompt + max_new_tokens).  The tenant with the
smallest ``vtime`` among those with pending, admissible work wins — so
over a busy interval tenants receive token throughput proportional to
their weights, regardless of arrival order or request sizes.

Two production guards sit on top of the pure policy:

* **Starvation bound** — a tenant whose head-of-queue request has been
  passed over ``starvation_bound`` admission rounds is served next
  unconditionally, capping worst-case queueing delay for low-weight
  tenants (weights bound *rates*, not *waits*; this bounds waits).
* **Token budgets** — ``Tenant.token_budget`` caps a tenant's total
  in-flight token footprint; a tenant at budget is skipped (without
  aging the starvation counter — it is throttled, not starved) until
  releases bring it back under.

Preempted requests re-enter at the *front* of their tenant queue via
``requeue_front`` and their cost is not double-charged: the vtime advance
happened at first admission, and re-admission of a previously charged
request is free.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

_ids = itertools.count()

DEFAULT_TENANT = "default"


@dataclasses.dataclass
class Request:
    """One generation request as the scheduler and engine track it."""
    prompt: Sequence[int]
    max_new_tokens: int
    tenant: str = DEFAULT_TENANT
    id: int = dataclasses.field(default_factory=lambda: next(_ids))
    submit_time: float = dataclasses.field(default_factory=time.monotonic)
    # Filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    truncated: bool = False
    preemptions: int = 0
    # Tokens to teacher-force on (re)admission beyond the prompt — set by
    # recompute preemption (dense path) so generation resumes
    # bit-identically.
    resume_tokens: List[int] = dataclasses.field(default_factory=list)
    # Paged copy-free preemption payload (engine's _Spill: host copies of
    # the request's KV pages) — re-admission remaps and uploads instead
    # of recomputing the prefill.
    spill: Optional[object] = dataclasses.field(default=None, repr=False)

    @property
    def cost(self) -> int:
        return len(self.prompt) + self.max_new_tokens

    @property
    def done(self) -> bool:
        return self.finish_time is not None

    @property
    def latency(self) -> Optional[float]:
        return (None if self.finish_time is None
                else self.finish_time - self.submit_time)

    @property
    def ttft(self) -> Optional[float]:
        return (None if self.first_token_time is None
                else self.first_token_time - self.submit_time)


@dataclasses.dataclass
class Tenant:
    """A traffic class: relative weight plus an optional cap on total
    in-flight token footprint."""
    name: str
    weight: float = 1.0
    token_budget: Optional[int] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")


@dataclasses.dataclass
class _TenantState:
    tenant: Tenant
    queue: Deque[Request] = dataclasses.field(default_factory=deque)
    vtime: float = 0.0
    in_flight_tokens: int = 0
    wait_rounds: int = 0            # admission rounds passed over while ready
    admitted: int = 0
    served_tokens: int = 0
    charged: set = dataclasses.field(default_factory=set)


class FairScheduler:
    """Weighted-fair admission queue over named tenants."""

    def __init__(self, tenants: Optional[Sequence[Tenant]] = None,
                 starvation_bound: int = 8):
        if starvation_bound < 1:
            raise ValueError("starvation_bound must be >= 1")
        self.starvation_bound = int(starvation_bound)
        self._tenants: Dict[str, _TenantState] = {}
        self._vclock = 0.0
        for t in (tenants or [Tenant(DEFAULT_TENANT)]):
            self.add_tenant(t)

    def add_tenant(self, tenant: Tenant) -> None:
        if tenant.name in self._tenants:
            raise ValueError(f"duplicate tenant {tenant.name!r}")
        self._tenants[tenant.name] = _TenantState(tenant=tenant)

    @property
    def tenants(self) -> List[Tenant]:
        return [s.tenant for s in self._tenants.values()]

    # -- queue ops -----------------------------------------------------------

    def submit(self, request: Request) -> Request:
        try:
            st = self._tenants[request.tenant]
        except KeyError:
            raise KeyError(f"unknown tenant {request.tenant!r}; registered: "
                           f"{sorted(self._tenants)}") from None
        st.queue.append(request)
        return request

    def requeue_front(self, request: Request) -> None:
        """Put a preempted request back at the head of its tenant queue."""
        self._tenants[request.tenant].queue.appendleft(request)

    def pending(self) -> int:
        return sum(len(s.queue) for s in self._tenants.values())

    # -- admission -----------------------------------------------------------

    def _budget_ok(self, st: _TenantState, req: Request) -> bool:
        b = st.tenant.token_budget
        return b is None or st.in_flight_tokens + req.cost <= b

    def admit_next(self, predicate=None) -> Optional[Request]:
        """Pop the next request to admit, or None when nothing is
        admissible.  ``predicate(request)`` lets the caller veto on pool
        capacity; vetoed tenants still age toward the starvation bound
        (the scheduler passed them over), budget-capped ones do not."""
        ready: List[Tuple[_TenantState, Request]] = []
        for st in self._tenants.values():
            if not st.queue:
                continue
            req = st.queue[0]
            if not self._budget_ok(st, req):
                continue
            if predicate is not None and not predicate(req):
                st.wait_rounds += 1
                continue
            ready.append((st, req))
        if not ready:
            return None

        starved = [p for p in ready
                   if p[0].wait_rounds >= self.starvation_bound]
        pool = starved or ready
        st, req = min(pool, key=lambda p: (p[0].vtime, p[1].submit_time))
        for other, _ in ready:
            if other is not st:
                other.wait_rounds += 1
        st.wait_rounds = 0
        st.queue.popleft()

        if req.id not in st.charged:
            # Stride accounting: charge the request's footprint once.
            start = max(st.vtime, self._vclock)
            st.vtime = start + req.cost / st.tenant.weight
            self._vclock = start
            st.charged.add(req.id)
        st.in_flight_tokens += req.cost
        st.admitted += 1
        return req

    def release(self, request: Request, served_tokens: int = 0) -> None:
        """Return a request's in-flight footprint (finish or preemption)."""
        st = self._tenants[request.tenant]
        st.in_flight_tokens = max(0, st.in_flight_tokens - request.cost)
        st.served_tokens += served_tokens
        if request.done:
            st.charged.discard(request.id)

    # -- reporting -----------------------------------------------------------

    def fairness_table(self) -> List[Dict[str, object]]:
        rows = []
        for name in sorted(self._tenants):
            st = self._tenants[name]
            rows.append({
                "tenant": name,
                "weight": st.tenant.weight,
                "token_budget": st.tenant.token_budget,
                "queued": len(st.queue),
                "in_flight_tokens": st.in_flight_tokens,
                "admitted": st.admitted,
                "served_tokens": st.served_tokens,
                "vtime": round(st.vtime, 3),
                "wait_rounds": st.wait_rounds,
            })
        return rows
