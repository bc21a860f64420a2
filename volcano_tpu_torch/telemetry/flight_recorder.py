"""Bounded flight recorder: the last N cycle snapshots, host-stamped (the
port's copy of ``volcano_tpu/telemetry/flight_recorder.py``).

The reference exposes only cumulative prometheus counters; diagnosing "what
did cycle 1234 do" needs per-cycle snapshots. This ring keeps the most
recent ``capacity`` cycles — each entry a plain-JSON dict (host wall
timestamp, cycle latency, bind/evict counts, the in-graph CycleTelemetry
block when enabled, host-side stage timings). Bounded by construction:
memory is O(capacity), never O(uptime).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional


class FlightRecorder:
    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._recorded = 0   # total ever recorded (ring drops the oldest)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def recorded_total(self) -> int:
        with self._lock:
            return self._recorded

    def record(self, now: Optional[float] = None, **snapshot) -> Dict:
        """Append one cycle snapshot (host wall timestamp added)."""
        entry = dict(snapshot)
        entry["wall_ts"] = now if now is not None else time.time()
        with self._lock:
            self._ring.append(entry)
            self._recorded += 1
            entry["seq"] = self._recorded
        return entry

    def snapshots(self) -> List[Dict]:
        """Oldest-first copies of the retained entries."""
        with self._lock:
            return [dict(e) for e in self._ring]

    def to_json(self) -> str:
        with self._lock:
            body = {"capacity": self.capacity,
                    "recorded_total": self._recorded,
                    "cycles": [dict(e) for e in self._ring]}
        return json.dumps(body)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # the scheduler (and so the recorder) rides VolcanoSystem's pickled
    # state file (vcctl --state); locks don't pickle — recreate on load
    def __getstate__(self):
        with self._lock:
            return {"capacity": self.capacity, "_ring": list(self._ring),
                    "_recorded": self._recorded}

    def __setstate__(self, state):
        self.capacity = state["capacity"]
        self._ring = deque(state["_ring"], maxlen=self.capacity)
        self._recorded = state["_recorded"]
        self._lock = threading.Lock()
