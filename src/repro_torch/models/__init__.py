"""Model assembly for the ported architecture families: the decoder LMs
(dense, moe, ssm, hybrid) in :mod:`lm`, the encoder-decoder in
:mod:`encdec`."""

from repro_torch.models import encdec, lm


def for_config(cfg):
    return encdec if cfg.family == "encdec" else lm
