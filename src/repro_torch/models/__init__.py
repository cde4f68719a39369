"""Model assembly for the ported architecture families (the dense, ssm
and hybrid forwards so far)."""

from repro_torch.models import lm
from repro_torch.models.lm import require_family


def for_config(cfg):
    require_family(cfg, "for_config")
    return lm
