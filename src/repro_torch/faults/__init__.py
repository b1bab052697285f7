"""Fault-injection registry (the port of the JAX package's ``faults/``):
declarative FaultSpecs with seeded Trigger schedules and a ChaosPlan
that compiles them into per-step masks.  The recovery supervisor of the
train loop (``faults/supervisor.py`` in the JAX package) comes with the
port's train step."""
from .spec import (SCOPES, ChaosPlan, FaultEvent, FaultSpec, Trigger,
                   get_spec, register, registered)

__all__ = ["SCOPES", "ChaosPlan", "FaultEvent", "FaultSpec", "Trigger",
           "get_spec", "register", "registered"]
