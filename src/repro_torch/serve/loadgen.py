"""Synthetic-traffic load generator for the serve engine.

Produces a Poisson-arrival trace (exponential inter-arrival gaps at an
offered QPS) with mixed prompt/output length distributions across N
weighted tenants, then drives a :class:`~repro_torch.serve.engine.ServeEngine`
against the wall clock: requests are submitted when their arrival time
comes due, the engine ticks in between, and the engine's own
submit/first-token/finish timestamps yield p50/p99 end-to-end latency,
TTFT, and delivered tokens/s vs the offered rate.

Everything is seeded — the same :class:`TrafficConfig` replays the same
trace (same prompts, same lengths, same arrival offsets), so an A/B run
(continuous vs gang admission, plans on vs off) sees identical offered
load and differs only in the engine under test.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.scheduler import Request


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """One synthetic workload: Poisson arrivals at ``qps`` with uniform
    prompt/output length mixes over ``n_tenants`` round-robin tenants.

    With ``prefix_tokens > 0`` every prompt starts with one of
    ``prefix_groups`` shared system-prompt prefixes, chosen per request
    from a Zipf-like distribution (group ``g`` has weight
    ``1 / (g + 1) ** prefix_zipf``) — the hot group dominates, which is
    what makes paged prefix sharing pay off.  Prefix material comes from
    a *separate* rng stream seeded from ``seed``, so a config with
    ``prefix_tokens=0`` replays token-for-token the same trace it did
    before this knob existed."""
    qps: float = 8.0
    n_requests: int = 32
    n_tenants: int = 2
    prompt_len: tuple = (4, 24)          # inclusive uniform range
    output_len: tuple = (4, 24)
    vocab: int = 256
    seed: int = 0
    prefix_tokens: int = 0               # shared prefix length (0 = off)
    prefix_groups: int = 4               # distinct shared prefixes
    prefix_zipf: float = 1.5             # group popularity skew

    def __post_init__(self):
        if self.qps <= 0 or self.n_requests < 1 or self.n_tenants < 1:
            raise ValueError("need qps > 0, n_requests >= 1, n_tenants >= 1")
        if self.prefix_tokens < 0 or self.prefix_groups < 1:
            raise ValueError("need prefix_tokens >= 0, prefix_groups >= 1")


@dataclasses.dataclass
class Arrival:
    at: float                            # seconds from trace start
    tenant: str
    prompt: List[int]
    max_new_tokens: int


def poisson_trace(traffic: TrafficConfig,
                  tenant_names: Optional[Sequence[str]] = None
                  ) -> List[Arrival]:
    """The deterministic arrival list for a traffic config."""
    rng = np.random.default_rng(traffic.seed)
    names = (list(tenant_names) if tenant_names is not None
             else [f"t{i}" for i in range(traffic.n_tenants)])
    prefixes: List[List[int]] = []
    groups = None
    if traffic.prefix_tokens:
        # Separate stream: adding/removing the prefix knob must not
        # perturb the base trace (arrival gaps, lengths, suffix tokens).
        prng = np.random.default_rng((traffic.seed, 0x5E1F))
        prefixes = [prng.integers(0, traffic.vocab, size=traffic.prefix_tokens,
                                  dtype=np.int32).tolist()
                    for _ in range(traffic.prefix_groups)]
        w = 1.0 / (np.arange(traffic.prefix_groups) + 1.0) ** traffic.prefix_zipf
        groups = prng.choice(traffic.prefix_groups,
                             size=traffic.n_requests, p=w / w.sum())
    arrivals, t = [], 0.0
    for i in range(traffic.n_requests):
        t += float(rng.exponential(1.0 / traffic.qps))
        plen = int(rng.integers(traffic.prompt_len[0],
                                traffic.prompt_len[1] + 1))
        olen = int(rng.integers(traffic.output_len[0],
                                traffic.output_len[1] + 1))
        prompt = rng.integers(0, traffic.vocab, size=plen,
                              dtype=np.int32).tolist()
        if prefixes:
            prompt = prefixes[int(groups[i])] + prompt
        arrivals.append(Arrival(at=t, tenant=names[i % len(names)],
                                prompt=prompt, max_new_tokens=olen))
    return arrivals


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def run_load(engine, traffic: TrafficConfig, *, pace: bool = True
             ) -> Dict[str, object]:
    """Drive the engine with the trace; returns the measured report.

    ``pace=True`` replays arrivals against the wall clock (the engine
    idles if it outruns the offered rate — what a latency-vs-QPS sweep
    wants).  ``pace=False`` submits each arrival as soon as its time is
    *reached or passed* by busy stepping, never sleeping — saturation
    throughput on slow hosts/CI."""
    trace = poisson_trace(traffic,
                          [t.name for t in engine.scheduler.tenants]
                          if engine.scheduler.tenants else None)
    t0 = time.monotonic()
    pending = list(trace)
    requests: List[Request] = []
    while pending or engine.active or engine.scheduler.pending():
        now = time.monotonic() - t0
        while pending and pending[0].at <= now:
            a = pending.pop(0)
            requests.append(engine.submit(a.prompt, a.max_new_tokens,
                                          tenant=a.tenant))
        advanced = engine.step()
        if pending and not engine.active and not engine.scheduler.pending():
            if pace and advanced == 0:
                time.sleep(min(0.002, max(0.0, pending[0].at - now)))
            elif not pace:
                # jump the clock: submit the next arrival immediately
                pending[0] = dataclasses.replace(
                    pending[0], at=time.monotonic() - t0)
    wall = time.monotonic() - t0

    lat = [r.latency for r in requests if r.latency is not None]
    ttft = [r.ttft for r in requests if r.ttft is not None]
    toks = sum(len(r.output) for r in requests)
    return {
        "offered_qps": traffic.qps,
        "n_requests": len(requests),
        "completed": sum(r.done for r in requests),
        "truncated": sum(r.truncated for r in requests),
        "wall_s": wall,
        "tokens": toks,
        "tokens_per_s": toks / wall if wall > 0 else float("nan"),
        "latency_p50_s": _pct(lat, 50),
        "latency_p99_s": _pct(lat, 99),
        "ttft_p50_s": _pct(ttft, 50),
        "ttft_p99_s": _pct(ttft, 99),
        "stats": engine.stats(),
    }
