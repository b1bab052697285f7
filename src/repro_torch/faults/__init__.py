"""Fault-injection registry (the port of the JAX package's ``faults/``):
declarative FaultSpecs with seeded Trigger schedules and a ChaosPlan
that compiles them into per-step masks, and the recovery supervisor of
the train loop (``faults/supervisor.py``)."""
from .spec import (SCOPES, ChaosPlan, FaultEvent, FaultSpec, Trigger,
                   get_spec, register, registered)
from .supervisor import Supervisor, SupervisorError, feasible_round

__all__ = ["SCOPES", "ChaosPlan", "FaultEvent", "FaultSpec", "Trigger",
           "Supervisor", "SupervisorError", "feasible_round", "get_spec",
           "register", "registered"]
