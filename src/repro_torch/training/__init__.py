"""Training: AdamW, the train step (one card or data-parallel on a mesh),
int8 error-feedback gradient compression, the serving functions on a mesh."""

from .optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    lr_schedule,
)
from .train_step import (TrainStepConfig, compress_grads_int8, make_serve_fns,
                         make_train_step)

__all__ = ["AdamWConfig", "TrainStepConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "compress_grads_int8", "global_norm",
           "lr_schedule", "make_serve_fns", "make_train_step"]
