from repro_torch.train.loop import InjectedFailure, TrainConfig, Trainer
from repro_torch.train.step import (TrainState, compute_grads, cross_entropy,
                                    loss_fn, make_train_step)

__all__ = ["InjectedFailure", "TrainConfig", "Trainer", "TrainState",
           "compute_grads", "cross_entropy", "loss_fn", "make_train_step"]
