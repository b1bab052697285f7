"""The BrSGD train step (the port of the JAX package's ``training/``)."""
from .step import (StepBundle, build_train_step, resolve_strategy,
                   step_generator)

__all__ = ["StepBundle", "build_train_step", "resolve_strategy",
           "step_generator"]
