"""Model assembly for the ported architecture families (the dense, moe,
ssm and hybrid forwards; the encoder-decoder waits for ROADMAP D4)."""

from repro_torch.models import lm
from repro_torch.models.lm import require_family


def for_config(cfg):
    require_family(cfg, "for_config")
    return lm
