"""Model assembly for the ported architecture families (dense so far)."""

from repro_torch.models import lm
from repro_torch.models.lm import require_dense


def for_config(cfg):
    require_dense(cfg, "for_config")
    return lm
