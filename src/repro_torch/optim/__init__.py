from repro_torch.optim.adamw import (AdamState, Optimizer, adam, adamw,
                                     apply_updates, sgd_momentum)
from repro_torch.optim.schedule import (constant_schedule, cosine_schedule,
                                        linear_schedule,
                                        linear_warmup_cosine)

__all__ = [
    "AdamState", "Optimizer", "adam", "adamw", "apply_updates",
    "sgd_momentum", "constant_schedule", "cosine_schedule",
    "linear_warmup_cosine", "linear_schedule",
]
