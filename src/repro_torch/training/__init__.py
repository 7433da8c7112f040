"""Training state: AdamW, schedules, gradient clipping, TrainState."""
from .optimizer import (AdamW, AdamWState, clip_by_global_norm,
                        cosine_schedule, global_norm)
from .train_step import TrainState

__all__ = ["AdamW", "AdamWState", "clip_by_global_norm", "cosine_schedule",
           "global_norm", "TrainState"]
