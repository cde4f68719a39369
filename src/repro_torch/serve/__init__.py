from repro_torch.serve.decode import (decode_step, init_caches,
                                      init_paged_caches, paged_cache_kinds,
                                      paged_decode_step)
from repro_torch.serve.engine import ServeEngine, generate
from repro_torch.serve.loadgen import TrafficConfig, poisson_trace, run_load
from repro_torch.serve.pool import KVBlockPool, PoolCapacityError, PoolError
from repro_torch.serve.scheduler import FairScheduler, Request, Tenant

__all__ = ["decode_step", "init_caches", "init_paged_caches",
           "paged_cache_kinds", "paged_decode_step", "generate",
           "ServeEngine", "KVBlockPool", "PoolCapacityError", "PoolError",
           "FairScheduler", "Request", "Tenant", "TrafficConfig",
           "poisson_trace", "run_load"]
