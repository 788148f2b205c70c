"""Ranker training (port of ``repro.train``): functional optimizers over
parameter trees and the train loop with checkpoints and resume."""
from .loop import (FitResult, TrainState, fit, make_train_step,
                   value_and_grad)
from .optimizer import (Optimizer, adafactor, adam, adamw, apply_updates,
                        clip_by_global_norm, get_optimizer, global_norm, sgd,
                        warmup_cosine)

__all__ = ["FitResult", "Optimizer", "TrainState", "fit", "make_train_step",
           "value_and_grad", "adafactor", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "get_optimizer", "global_norm", "sgd",
           "warmup_cosine"]
