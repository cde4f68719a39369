"""Distribution layer: logical-axis sharding rules, pipeline parallelism,
and compressed cross-pod collectives, over ``torch.distributed`` with
one process per rank.

* :mod:`repro_torch.dist.sharding` — logical axis -> mesh axis rules with
  divisibility fallback; parameter / batch / KV-cache specs; a global
  tree's blocks on each rank and back.
* :mod:`repro_torch.dist.pipeline` — GPipe and 1F1B microbatch pipelining
  over ``pipe``.
* :mod:`repro_torch.dist.compress` — bf16 + error-feedback ``psum`` for
  the slow ``pod`` axis.
* :mod:`repro_torch.dist.collectives` — the named-axis collectives the
  others run on (the port's counterpart of ``jax.lax``'s inside
  ``shard_map``).
"""

from repro_torch.dist import collectives, compress, pipeline, sharding
from repro_torch.dist.compress import compressed_psum, ef_state
from repro_torch.dist.pipeline import gpipe
from repro_torch.dist.sharding import (batch_spec, cache_sharding,
                                       decode_cache_shardings, dp_axes,
                                       dp_size, model_size, param_shardings,
                                       spec_for_axes)

__all__ = [
    "sharding", "pipeline", "compress", "collectives",
    "spec_for_axes", "param_shardings", "batch_spec", "cache_sharding",
    "decode_cache_shardings", "dp_axes", "dp_size", "model_size",
    "gpipe", "compressed_psum", "ef_state",
]
