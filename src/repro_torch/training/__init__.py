"""Training state: AdamW, schedules, gradient clipping, the loss and the
train step, TrainState, checkpoints."""
from .optimizer import (AdamW, AdamWState, clip_by_global_norm,
                        cosine_schedule, global_norm)
from .train_step import (TrainState, cross_entropy, loss_fn,
                         make_eval_step, make_train_step, value_and_grad)

__all__ = ["AdamW", "AdamWState", "clip_by_global_norm", "cosine_schedule",
           "global_norm", "TrainState", "cross_entropy", "loss_fn",
           "make_eval_step", "make_train_step", "value_and_grad"]
