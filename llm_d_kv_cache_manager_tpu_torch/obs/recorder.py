"""Flight recorder: bounded in-memory retention of completed traces.

Three tiers of retention, all O(1)-bounded so the recorder can run
always-on in production:

* **ring** — the last ``ring_size`` completed traces, newest evicting
  oldest (the "what just happened" view);
* **slow reservoir** — the ``slow_keep`` slowest traces whose duration
  crossed ``slow_threshold_ms``, kept even after the ring has cycled
  past them (a min-heap: a new slow trace displaces the least-slow
  retained one).  This is the slow-threshold *promotion*: an
  interesting trace survives long after ordinary traffic has flushed
  the ring;
* **errored reservoir** — the last ``error_keep`` traces that finished
  with a non-ok status (poison-pill events, scoring exceptions,
  failed offload jobs).

``get`` resolves a trace id across all three tiers, so
``GET /debug/traces/<id>`` keeps working for a slow or errored trace
whose ring slot is long gone.

Copied from the JAX reference's ``obs/recorder.py``.
"""

from __future__ import annotations

import heapq
import threading
from collections import deque
from typing import Deque, List, Optional, Tuple

DEFAULT_RING_SIZE = 256
DEFAULT_SLOW_KEEP = 32
DEFAULT_ERROR_KEEP = 32
DEFAULT_SLOW_THRESHOLD_MS = 100.0


class FlightRecorder:
    def __init__(
        self,
        ring_size: int = DEFAULT_RING_SIZE,
        slow_keep: int = DEFAULT_SLOW_KEEP,
        error_keep: int = DEFAULT_ERROR_KEEP,
        slow_threshold_ms: float = DEFAULT_SLOW_THRESHOLD_MS,
    ) -> None:
        if ring_size <= 0:
            raise ValueError("ring_size must be positive")
        if slow_keep <= 0 or error_keep <= 0:
            raise ValueError("reservoir sizes must be positive")
        self.ring_size = ring_size
        self.slow_keep = slow_keep
        self.error_keep = error_keep
        self.slow_threshold_ms = slow_threshold_ms
        self._lock = threading.Lock()
        self._ring: Deque = deque(maxlen=ring_size)  # guarded-by: _lock
        # Min-heap of (duration_s, seq, trace): the root is the least
        # slow retained trace, displaced first.  seq breaks duration
        # ties so traces never compare.
        self._slow: List[Tuple[float, int, object]] = []  # guarded-by: _lock
        self._errored: Deque = deque(maxlen=error_keep)  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._recorded = 0  # guarded-by: _lock
        self._slow_promoted = 0  # guarded-by: _lock
        self._error_recorded = 0  # guarded-by: _lock

    def record(self, trace) -> None:
        """Retain a finished trace (called exactly once, by finish())."""
        duration_ms = (trace.duration_s or 0.0) * 1000.0
        with self._lock:
            self._seq += 1
            self._recorded += 1
            self._ring.append(trace)
            if trace.status != "ok":
                self._error_recorded += 1
                self._errored.append(trace)
            if duration_ms >= self.slow_threshold_ms:
                self._slow_promoted += 1
                heapq.heappush(
                    self._slow, (trace.duration_s, self._seq, trace)
                )
                if len(self._slow) > self.slow_keep:
                    heapq.heappop(self._slow)

    def get(self, trace_id: str) -> Optional[object]:
        """Resolve a trace id across ring + slow + errored tiers."""
        with self._lock:
            for trace in reversed(self._ring):
                if trace.trace_id == trace_id:
                    return trace
            for _, _, trace in self._slow:
                if trace.trace_id == trace_id:
                    return trace
            for trace in reversed(self._errored):
                if trace.trace_id == trace_id:
                    return trace
        return None

    def recent(self, limit: int = 50) -> List[object]:
        """Newest-first slice of the ring."""
        with self._lock:
            return list(self._ring)[::-1][:limit]

    def slow(self, limit: int = 50) -> List[object]:
        """Slowest-first slice of the slow reservoir."""
        with self._lock:
            ordered = sorted(self._slow, key=lambda item: -item[0])
        return [trace for _, _, trace in ordered[:limit]]

    def errored(self, limit: int = 50) -> List[object]:
        """Newest-first slice of the errored reservoir."""
        with self._lock:
            return list(self._errored)[::-1][:limit]

    def stats(self) -> dict:
        """Occupancy and throughput counters for /healthz."""
        with self._lock:
            return {
                "ring_size": self.ring_size,
                "ring_occupancy": len(self._ring),
                "slow_retained": len(self._slow),
                "errored_retained": len(self._errored),
                "recorded": self._recorded,
                "slow_promoted": self._slow_promoted,
                "errors_recorded": self._error_recorded,
                "slow_threshold_ms": self.slow_threshold_ms,
            }

    def clear(self) -> None:
        """Drop all retained traces and counters (test isolation)."""
        with self._lock:
            self._ring.clear()
            self._slow.clear()
            self._errored.clear()
            self._seq = 0
            self._recorded = 0
            self._slow_promoted = 0
            self._error_recorded = 0
