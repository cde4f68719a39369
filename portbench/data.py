"""Training batches from the seed: the port's synthetic-LM rule, copied.

The rule of ``repro_torch/data/pipeline.py::SyntheticLM.batch_at``: a
numpy generator keyed by (seed, step) draws ``u`` in [0, 1) for each of
``batch`` rows of ``seq_len + 1`` positions, the token is
``min(floor(u**3 * vocab), vocab - 1)`` (a Zipf-like marginal), and the
labels are the tokens shifted by one.  Every step's rows differ.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def batch_at(seed: int, step: int, batch: int, seq_len: int,
             vocab: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng((seed, step))
    u = rng.random((batch, seq_len + 1))
    tokens = np.minimum((u ** 3 * vocab).astype(np.int32), vocab - 1)
    return {"tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32)}
