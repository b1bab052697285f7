"""Continuous-batching serving (the port of the JAX package's
``serving/``).  ``serving/engine.py`` (mesh shardings of the serve
step) waits for the port's distributed layouts."""
from .cache import BlockTable, SlotCache, batch_axes
from .scheduler import Request, ServeLoop
from .swap import RESTORE_ERRORS, HotSwapper
from .telemetry import ServeMetrics, append_row, latest_row, read_rows
