"""Deterministic synthetic LM data pipeline (a numpy copy of the
reference's ``repro/data/pipeline.py``; batches are bit-identical per
(seed, step)).

Batches are a pure function of (seed, step) — the property the
checkpoint/restart machinery relies on: resuming at step k replays exactly
the batch stream a non-failed run would have seen (asserted by the
fault-tolerance tests).  Sharded placement is the caller's job
(dist.sharding.batch_spec); generation itself is host-side numpy to model
an input pipeline that is not part of the compiled step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0


class SyntheticLM:
    """Zipf-ish token stream with next-token labels (and stubbed modality
    frontends for the audio/vlm archs)."""

    def __init__(self, cfg: DataConfig, model_cfg: Optional[ModelConfig] = None):
        self.cfg = cfg
        self.model_cfg = model_cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.cfg.seed, step))
        B, S, V = self.cfg.global_batch, self.cfg.seq_len, self.cfg.vocab
        # zipf-like marginal over the vocab, cheap to sample
        u = rng.random((B, S + 1))
        tokens = np.minimum((u ** 3 * V).astype(np.int32), V - 1)
        out = {"tokens": tokens[:, :-1].astype(np.int32),
               "labels": tokens[:, 1:].astype(np.int32)}
        if self.model_cfg is not None and self.model_cfg.frontend == "audio_frames":
            out["frames"] = rng.standard_normal(
                (B, S, self.model_cfg.d_model)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_data(model_cfg: ModelConfig, seq_len: int, global_batch: int,
              seed: int = 0) -> SyntheticLM:
    return SyntheticLM(DataConfig(seq_len, global_batch, model_cfg.vocab,
                                  seed), model_cfg)
