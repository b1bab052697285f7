"""Optimizers of the train step (the port of the JAX package's
``optim/``)."""
from .optimizers import (Optimizer, adamw, clip_by_global_norm,
                         get_optimizer, global_norm, momentum, sgd)

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "get_optimizer",
           "global_norm", "momentum", "sgd"]
