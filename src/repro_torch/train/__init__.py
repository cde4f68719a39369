from repro_torch.train.loop import (InjectedFailure, TrainConfig, Trainer,
                                    pipeline_microbatch_clamp)
from repro_torch.train.step import (PipelineStepError, TrainState,
                                    compute_grads, cross_entropy,
                                    init_ef_state, loss_fn,
                                    make_sharded_train_step, make_train_step,
                                    wants_ef)

__all__ = ["InjectedFailure", "PipelineStepError", "TrainConfig", "Trainer",
           "TrainState", "compute_grads", "cross_entropy", "init_ef_state",
           "loss_fn", "make_sharded_train_step", "make_train_step",
           "pipeline_microbatch_clamp", "wants_ef"]
