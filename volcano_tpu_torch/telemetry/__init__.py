"""Host-side observability of the scheduler loop (the port's subset of
``volcano_tpu/telemetry``).

- :mod:`.spans`: span tracing of the steady cycle, per-phase latency
  rings, the per-cycle span summary and the structured event log;
- :mod:`.flight_recorder`: the bounded ring of the last N cycle records
  that the scheduler loop keeps.

The in-graph cycle telemetry (``cycle.py``) is ROADMAP queue 1 item 7.
The reference's ``tracecount.py`` counts ``jax.jit`` traces, which have
no counterpart in the port.
"""

from __future__ import annotations

from . import spans
from .flight_recorder import FlightRecorder

__all__ = ["FlightRecorder", "spans"]
