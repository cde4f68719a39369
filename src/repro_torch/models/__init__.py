"""Model assembly for the ported architecture families (the forward of
the dense and ssm families so far)."""

from repro_torch.models import lm
from repro_torch.models.lm import FORWARD_FAMILIES, require_family


def for_config(cfg):
    require_family(cfg, "for_config", FORWARD_FAMILIES)
    return lm
