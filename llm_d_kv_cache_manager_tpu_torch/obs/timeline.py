"""Ring-buffer gauge timelines (docs/observability.md "Gauge
timelines").

The flight recorder answers "what did request X do", the SLO engine
answers "are we degraded NOW" — this module answers "what did the
minutes BEFORE the burn-rate alert look like": a background sampler
thread polls a set of registered zero-arg sources once a second and
keeps each series' last ``window_s`` seconds in a bounded ring, read
back at ``GET /debug/timeline``.

Sources are plain callables returning a float (gauge semantics; feed
``counter_total`` wrappers for monotonic series — the reader can
difference them).  A source that raises records ``None`` for that
slot and keeps sampling: one broken gauge must never blind the rest
of the timeline.  Memory is bounded by construction:
``series x window_s`` points, no per-sample allocation beyond the
ring slot.

Copied from the JAX reference's ``obs/timeline.py``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("obs.timeline")

DEFAULT_WINDOW_S = 900
RESOLUTION_S = 1.0
MAX_SERIES = 64


def _env_window() -> int:
    raw = os.environ.get("TIMELINE_WINDOW_S", "")
    if not raw:
        return DEFAULT_WINDOW_S
    try:
        return max(0, int(raw))
    except ValueError:
        logger.warning(
            "invalid TIMELINE_WINDOW_S=%r; using %s",
            raw,
            DEFAULT_WINDOW_S,
        )
        return DEFAULT_WINDOW_S


class _Series:
    __slots__ = ("name", "description", "source", "ring", "errors")

    def __init__(
        self,
        name: str,
        description: str,
        source: Callable[[], float],
        window: int,
    ) -> None:
        self.name = name
        self.description = description
        self.source = source
        self.ring: Deque[Tuple[float, Optional[float]]] = deque(
            maxlen=window
        )
        self.errors = 0


class GaugeTimeline:
    """1s-resolution bounded history over registered gauge sources."""

    def __init__(self, window_s: Optional[int] = None) -> None:
        self.window_s = _env_window() if window_s is None else window_s
        self._lock = lockorder.tracked(
            threading.Lock(), "GaugeTimeline._lock"
        )
        self._series: Dict[str, _Series] = {}  # guarded-by: _lock
        self._ticks = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(
        self,
        name: str,
        source: Callable[[], float],
        description: str = "",
    ) -> bool:
        """Add a series (idempotent by name); False past MAX_SERIES."""
        with self._lock:
            if name in self._series:
                return True
            if len(self._series) >= MAX_SERIES:
                logger.warning(
                    "timeline series cap (%d) reached; dropping %r",
                    MAX_SERIES,
                    name,
                )
                return False
            self._series[name] = _Series(
                name, description, source, max(1, self.window_s)
            )
            return True

    # -- lifecycle -----------------------------------------------------

    def start(self) -> bool:
        """Spawn the 1s sampler; no-op (False) when window_s is 0."""
        if self.window_s <= 0:
            return False
        if self._thread is not None and self._thread.is_alive():
            return True
        self._stop.clear()
        # gil-atomic: lifecycle ref; start/close are control-plane
        self._thread = threading.Thread(
            target=self._run, name="kvtpu-timeline", daemon=True
        )
        self._thread.start()
        return True

    def close(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5)
            # gil-atomic: lifecycle ref; start/close are control-plane
            self._thread = None

    def running(self) -> bool:
        thread = self._thread
        return thread is not None and thread.is_alive()

    # -- sampling ------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(RESOLUTION_S):
            self.sample_once()

    def sample_once(self, now: Optional[float] = None) -> None:
        """One sampling pass (the loop body; tests drive it directly).

        Sources run OUTSIDE the timeline lock: they reach into pool /
        cluster / metrics internals that take their own locks, and
        nesting those under ours is a KV006 hazard for zero benefit.
        """
        stamp = time.time() if now is None else now
        with self._lock:
            series = list(self._series.values())
        readings: List[Tuple[_Series, Optional[float]]] = []
        for entry in series:
            try:
                readings.append((entry, float(entry.source())))
            except Exception:  # noqa: BLE001 — one bad gauge, not all
                entry.errors += 1
                if entry.errors == 1:
                    logger.exception(
                        "timeline source %r failed (logged once)",
                        entry.name,
                    )
                readings.append((entry, None))
        with self._lock:
            self._ticks += 1
            for entry, value in readings:
                entry.ring.append((stamp, value))

    # -- read surface --------------------------------------------------

    def snapshot(
        self,
        last_s: Optional[float] = None,
        series: Optional[str] = None,
    ) -> dict:
        """The ``/debug/timeline`` payload: per-series point arrays
        (``[unix_seconds, value|null]``), newest last, optionally
        bounded to the trailing ``last_s`` seconds or one series."""
        cutoff = None if last_s is None else time.time() - last_s
        with self._lock:
            if series is None:
                names = sorted(self._series)
            elif series in self._series:
                names = [series]
            else:
                # An unknown name returns an EMPTY map, never the
                # full payload: a typo'd ?series= filter that
                # silently hands back every series is undetectable
                # from the response shape.
                names = []
            out_series = {}
            for name in names:
                entry = self._series[name]
                points = [
                    [ts, value]
                    for ts, value in entry.ring
                    if cutoff is None or ts >= cutoff
                ]
                out_series[name] = {
                    "description": entry.description,
                    "errors": entry.errors,
                    "points": points,
                }
            return {
                "resolution_s": RESOLUTION_S,
                "window_s": self.window_s,
                "ticks": self._ticks,
                "running": self.running(),
                "series": out_series,
            }


def register_default_series(
    timeline: GaugeTimeline,
    pool=None,
    remote_index=None,
    resync=None,
) -> None:
    """Wire the stock fleet series (api/http_service.py): shard
    backlog + per-pod lanes, staging lane waits, cluster RPC
    in-flight, suspect pods, score traffic, and the process runtime
    block — the gauges an operator walks back from a burn-rate alert.
    """
    from llm_d_kv_cache_manager_tpu_torch.metrics.collector import (
        METRICS,
        counter_total,
        gauge_total,
        gauge_value,
        update_process_metrics,
    )

    timeline.register(
        "score_requests_total",
        lambda: counter_total(METRICS.score_requests),
        "scored requests served (monotonic; difference for rate)",
    )
    if pool is not None:
        # The pool's own shard walk, not the per-pod backlog gauge
        # sum: the gauge cache is bounded and label-sanitized, the
        # walk is exact.  Both series share ONE walk per tick —
        # memoized briefly so the 1s sampler takes each shard lock
        # once, not once per series (the sampler is the only caller,
        # so the plain-dict memo needs no lock).
        lane_memo = {"stamp": -1.0, "value": (0, 0)}

        def _pool_lane_stats() -> tuple:
            now = time.monotonic()
            if now - lane_memo["stamp"] > 0.5:
                lane_memo["value"] = pool.lane_stats()
                lane_memo["stamp"] = now
            return lane_memo["value"]

        timeline.register(
            "event_backlog",
            lambda: float(_pool_lane_stats()[0]),
            "queued-not-applied event messages across all pod lanes",
        )
        timeline.register(
            "event_lanes",
            lambda: float(_pool_lane_stats()[1]),
            "pods holding a live (non-empty) event lane",
        )
    else:
        timeline.register(
            "event_backlog",
            lambda: gauge_total(METRICS.kvevents_pod_backlog),
            "queued-not-applied event messages across all pod lanes",
        )
    timeline.register(
        "events_dropped_total",
        lambda: counter_total(METRICS.kvevents_dropped),
        "shed event messages (monotonic)",
    )
    timeline.register(
        "suspect_pods",
        lambda: gauge_value(METRICS.kvevents_suspect_pods),
        "pods gapped and not yet resynced",
    )
    timeline.register(
        "poller_sockets",
        lambda: gauge_total(METRICS.kvevents_poller_sockets),
        "SUB sockets multiplexed across event-plane pollers",
    )
    timeline.register(
        "staging_lane_waits_total",
        lambda: counter_total(METRICS.offload_staging_lane_waits),
        "staged transfers that waited for a staging lane (monotonic)",
    )
    timeline.register(
        "lock_contention_total",
        lambda: counter_total(METRICS.lock_contention),
        "contended sampled lock acquires (monotonic; "
        "LOCK_CONTENTION_SAMPLE gates)",
    )
    timeline.register(
        "process_rss_bytes",
        lambda: update_process_metrics()["rss_bytes"],
        "resident set size",
    )
    timeline.register(
        "process_threads",
        lambda: float(threading.active_count()),
        "live Python threads",
    )
    if remote_index is not None:
        timeline.register(
            "cluster_rpc_in_flight",
            lambda: float(remote_index.in_flight()),
            "router->replica RPCs currently outstanding",
        )
    if resync is not None:
        timeline.register(
            "resyncs_total",
            lambda: float(
                counter_total(METRICS.kvevents_resyncs)
            ),
            "anti-entropy pod resyncs (monotonic)",
        )
