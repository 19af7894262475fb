"""SLO engine: declarative SLIs, burn rates, degradation envelopes.

The observability stack already answers "what happened" (metrics) and
"why was THIS request slow" (traces); this module answers the contract
question operators and chaos tests actually ask: *is the service
inside its declared envelope right now, and how fast is it burning
budget?*  One engine, three pieces:

* **SLI specs** (:class:`SloSpec`) are declarative: a name, a kind
  (``ratio`` — good/total cumulative counters, higher is better;
  ``gauge`` — an instantaneous value, lower is better; ``rate`` — a
  cumulative counter whose windowed delta is bounded), an
  ``objective`` (the healthy bound) and a ``degraded_bound`` (the
  outer envelope).  Sources are zero-arg callables over EXISTING
  surfaces — prometheus counters/histograms, the analytics ledger,
  cluster membership — so the engine adds no instrumentation of its
  own to hot paths.
* **Multi-window evaluation**: every SLI is sampled into a bounded
  time-series ring and evaluated over a fast and a slow window
  (``SLO_WINDOW_FAST_S`` / ``SLO_WINDOW_SLOW_S``).  Ratio SLIs report
  burn rates (bad-fraction / error-budget — 1.0 burns exactly the
  budget); a breach on EITHER window degrades, so a slow bleed and a
  fast spike both surface.
* **Degradation envelopes** are machine-readable state:
  ``healthy`` (inside objective), ``degraded`` (objective breached
  but inside ``degraded_bound`` — "degraded-with-bound"), or
  ``violated`` (outside the declared envelope).  ``GET /debug/slo``
  publishes the full payload, ``/healthz`` a compact block, and chaos
  cells (bench ``replica_scaleout``, ``hack/slo_smoke.py``) assert
  against the published envelope via :func:`envelope_violations`
  instead of re-inventing ad-hoc numeric pins.

Nothing here is cluster-specific: :func:`default_fleet_slos` wires
the fleet SLIs (score latency, event-plane shed + backlog, hit rate,
replica deaths, replication lag, failover rate) from whatever
surfaces the embedding application actually has.

Copied from the JAX reference's ``obs/slo.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS, safe_label
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("obs.slo")

STATE_HEALTHY = "healthy"
STATE_DEGRADED = "degraded"
STATE_VIOLATED = "violated"
_STATE_RANK = {STATE_HEALTHY: 0, STATE_DEGRADED: 1, STATE_VIOLATED: 2}

DEFAULT_WINDOW_FAST_S = 300.0
DEFAULT_WINDOW_SLOW_S = 3600.0

# Leaf lock: sampling/evaluation state only — sources are called
# OUTSIDE it (a source may take its own locks, e.g. the ledger's).
# kvlint: lock-order: SloEngine._lock ascending
lockorder.declare_ascending("SloEngine._lock")


@dataclass
class SloSpec:
    """One declarative SLI.

    ``ratio``: the source returns cumulative ``(good, total)`` counts;
    the windowed good-fraction must stay >= ``objective`` (healthy)
    and >= ``degraded_bound`` (the violation floor).

    ``gauge``: the source returns an instantaneous value; the windowed
    aggregate (``gauge_agg``: ``max`` or ``last``) must stay <=
    ``objective`` / <= ``degraded_bound``.

    ``rate``: the source returns ONE cumulative count; the fast-window
    delta must stay <= ``objective`` / <= ``degraded_bound``.
    """

    name: str
    kind: str = "ratio"
    objective: float = 0.99
    degraded_bound: float = 0.9
    description: str = ""
    gauge_agg: str = "max"
    unit: str = ""

    def validate(self) -> None:
        if self.kind not in ("ratio", "gauge", "rate"):
            raise ValueError(f"unknown SLI kind: {self.kind!r}")
        if self.kind == "ratio":
            if not (0.0 <= self.degraded_bound <= self.objective <= 1.0):
                raise ValueError(
                    f"ratio SLI {self.name}: need 0 <= degraded_bound "
                    f"<= objective <= 1, got {self.degraded_bound} / "
                    f"{self.objective}"
                )
        else:
            if self.degraded_bound < self.objective:
                raise ValueError(
                    f"{self.kind} SLI {self.name}: degraded_bound "
                    f"{self.degraded_bound} must be >= objective "
                    f"{self.objective} (lower is better)"
                )
        if self.gauge_agg not in ("max", "last"):
            raise ValueError(f"unknown gauge_agg: {self.gauge_agg!r}")


@dataclass
class _Series:
    spec: SloSpec
    source: Callable[[], Optional[Tuple[float, float]]]
    # (unix_ts, a, b): ratio -> cumulative (good, total); gauge ->
    # (value, 0); rate -> cumulative (count, 0).  guarded-by: engine
    # lock.
    samples: Deque[Tuple[float, float, float]] = field(
        default_factory=deque
    )
    source_errors: int = 0


def _worst(states: List[str]) -> str:
    rank = max((_STATE_RANK[s] for s in states), default=0)
    for name, value in _STATE_RANK.items():
        if value == rank:
            return name
    return STATE_HEALTHY  # pragma: no cover - rank always resolves


class SloEngine:
    """Samples SLI sources and publishes degradation envelopes."""

    def __init__(
        self,
        window_fast_s: float = DEFAULT_WINDOW_FAST_S,
        window_slow_s: float = DEFAULT_WINDOW_SLOW_S,
    ) -> None:
        if window_fast_s <= 0 or window_slow_s < window_fast_s:
            raise ValueError(
                "need 0 < window_fast_s <= window_slow_s, got "
                f"{window_fast_s} / {window_slow_s}"
            )
        self.window_fast_s = window_fast_s
        self.window_slow_s = window_slow_s
        self._lock = lockorder.tracked(
            threading.Lock(), "SloEngine._lock"
        )
        self._series: Dict[str, _Series] = {}  # guarded-by: _lock
        self._evaluations = 0  # guarded-by: _lock
        self._last_payload: Optional[dict] = None  # guarded-by: _lock
        # Overall-state transition listeners (the incident bundler's
        # trigger, obs/capture.py): called OUTSIDE the lock with
        # (old_state, new_state, payload) on every overall-state
        # change; a raising listener is logged, never propagated.
        # Transitions are queued under the lock (atomically with the
        # state update) and drained FIFO by a single dispatcher at a
        # time, so concurrent evaluate() calls (the poll thread +
        # /debug/slo hits) can never deliver healthy→violated AFTER
        # the recovery that followed it — out-of-order delivery would
        # burn the incident bundler's rate limit on a stale violation.
        self._listeners: List[
            Callable[[str, str, dict], None]
        ] = []  # guarded-by: _lock
        self._last_state: Optional[str] = None  # guarded-by: _lock
        self._transitions: Deque[
            Tuple[str, str, dict]
        ] = deque()  # guarded-by: _lock
        self._dispatching = False  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- registration ---------------------------------------------------

    def register(
        self,
        spec: SloSpec,
        source: Callable[[], Optional[Tuple[float, float]]],
    ) -> None:
        """Add one SLI.  ``source`` is a zero-arg callable returning
        the kind-specific tuple (see :class:`SloSpec`) or ``None``
        when the underlying surface is unavailable; a raising source
        is counted and treated as None (an SLI must never take the
        health endpoint down)."""
        spec.validate()
        with self._lock:
            if spec.name in self._series:
                raise ValueError(f"duplicate SLI: {spec.name}")
            self._series[spec.name] = _Series(spec, source)

    def sli_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def add_listener(
        self, listener: Callable[[str, str, dict], None]
    ) -> None:
        """Subscribe to overall-state transitions.  ``listener(old,
        new, payload)`` runs on whichever thread evaluated (the
        background poll or a /debug/slo hit), outside the engine lock;
        the first evaluation compares against ``healthy`` so an engine
        that boots straight into ``violated`` still notifies."""
        with self._lock:
            self._listeners.append(listener)

    # -- sampling -------------------------------------------------------

    def sample(self, now: Optional[float] = None) -> None:
        """Record one snapshot of every SLI source (sources run
        outside the engine lock)."""
        now = time.time() if now is None else now
        with self._lock:
            series = list(self._series.values())
        retain = self.window_slow_s * 1.25
        for entry in series:
            try:
                raw = entry.source()
            except Exception:  # noqa: BLE001 - one SLI never downs /slo
                logger.exception(
                    "SLI source %s failed", entry.spec.name
                )
                entry.source_errors += 1
                continue
            if raw is None:
                continue
            if entry.spec.kind == "ratio":
                good, total = raw
                point = (now, float(good), float(total))
            elif entry.spec.kind == "rate":
                value = raw[0] if isinstance(raw, tuple) else raw
                point = (now, float(value), 0.0)
            else:  # gauge
                value = raw[0] if isinstance(raw, tuple) else raw
                point = (now, float(value), 0.0)
            with self._lock:
                samples = entry.samples
                # Concurrent samplers (the background poll + /debug/slo
                # hits on server threads) stamp `now` before running
                # sources outside the lock, so appends can arrive out
                # of order; a non-monotonic deque breaks _baseline's
                # scan.  A point older than the newest retained one
                # adds no window information — drop it.
                if samples and point[0] <= samples[-1][0]:
                    continue
                samples.append(point)
                while samples and samples[0][0] < now - retain:
                    samples.popleft()

    # -- window math ----------------------------------------------------

    @staticmethod
    def _baseline(
        samples, now: float, window_s: float
    ) -> Optional[Tuple[float, float, float]]:
        """The newest sample at or before ``now - window_s`` (the
        delta baseline), or the oldest sample when the series is
        younger than the window — a short-lived engine still reports
        over the data it has."""
        if not samples:
            return None
        cutoff = now - window_s
        baseline = None
        for point in samples:
            if point[0] <= cutoff:
                baseline = point
            else:
                break
        return baseline if baseline is not None else samples[0]

    def _ratio_window(
        self, samples, now: float, window_s: float, objective: float
    ) -> Tuple[Optional[float], Optional[float]]:
        """(good_fraction, burn_rate) over the window; (None, None)
        when the window saw no traffic."""
        if len(samples) < 2:
            return None, None
        base = self._baseline(samples, now, window_s)
        last = samples[-1]
        if base is None or last[0] <= base[0]:
            return None, None
        d_good = last[1] - base[1]
        d_total = last[2] - base[2]
        if d_total <= 0:
            return None, None
        # Counter resets (process restart behind a shared registry)
        # would produce negative deltas; clamp to the sane range.
        frac = min(1.0, max(0.0, d_good / d_total))
        budget = 1.0 - objective
        if budget <= 0:
            # A 100% objective has no budget to burn: any badness is a
            # breach; None keeps the payload JSON-clean (no Infinity).
            burn = 0.0 if frac >= 1.0 else None
        else:
            burn = (1.0 - frac) / budget
        return frac, burn

    def _counter_window(
        self, samples, now: float, window_s: float
    ) -> Optional[float]:
        if len(samples) < 2:
            return None
        base = self._baseline(samples, now, window_s)
        last = samples[-1]
        if base is None or last[0] <= base[0]:
            return None
        return max(0.0, last[1] - base[1])

    def _gauge_window(
        self, samples, now: float, window_s: float, agg: str
    ) -> Optional[float]:
        if not samples:
            return None
        cutoff = now - window_s
        values = [v for ts, v, _ in samples if ts >= cutoff]
        if not values:
            values = [samples[-1][1]]
        return values[-1] if agg == "last" else max(values)

    # -- evaluation -----------------------------------------------------

    def _evaluate_sli(self, entry: _Series, now: float) -> dict:
        spec = entry.spec
        with self._lock:
            samples = list(entry.samples)
        out: dict = {
            "kind": spec.kind,
            "objective": spec.objective,
            "degraded_bound": spec.degraded_bound,
            "description": spec.description,
            "samples": len(samples),
        }
        if spec.unit:
            out["unit"] = spec.unit
        if spec.kind == "ratio":
            frac_fast, burn_fast = self._ratio_window(
                samples, now, self.window_fast_s, spec.objective
            )
            frac_slow, burn_slow = self._ratio_window(
                samples, now, self.window_slow_s, spec.objective
            )
            value = frac_fast if frac_fast is not None else frac_slow
            out.update(
                value=value,
                value_slow=frac_slow,
                burn_fast=burn_fast,
                burn_slow=burn_slow,
            )
            if value is None:
                out["state"] = STATE_HEALTHY
                out["no_data"] = True
            elif value < spec.degraded_bound:
                out["state"] = STATE_VIOLATED
            elif value < spec.objective or (
                frac_slow is not None and frac_slow < spec.objective
            ):
                out["state"] = STATE_DEGRADED
            else:
                out["state"] = STATE_HEALTHY
        elif spec.kind == "rate":
            value = self._counter_window(
                samples, now, self.window_fast_s
            )
            slow = self._counter_window(samples, now, self.window_slow_s)
            out.update(value=value, value_slow=slow)
            if value is not None and spec.objective > 0:
                out["burn_fast"] = value / spec.objective
            if value is None:
                out["state"] = STATE_HEALTHY
                out["no_data"] = True
            elif value > spec.degraded_bound:
                out["state"] = STATE_VIOLATED
            elif value > spec.objective:
                out["state"] = STATE_DEGRADED
            else:
                out["state"] = STATE_HEALTHY
        else:  # gauge
            value = self._gauge_window(
                samples, now, self.window_fast_s, spec.gauge_agg
            )
            slow = self._gauge_window(
                samples, now, self.window_slow_s, spec.gauge_agg
            )
            out.update(value=value, value_slow=slow)
            if value is not None and spec.objective > 0:
                out["burn_fast"] = value / spec.objective
            # Gauges are instantaneous conditions: the fast-window
            # aggregate decides state; the slow aggregate is context
            # (a spike an hour ago should not pin "degraded").
            if value is None:
                out["state"] = STATE_HEALTHY
                out["no_data"] = True
            elif value > spec.degraded_bound:
                out["state"] = STATE_VIOLATED
            elif value > spec.objective:
                out["state"] = STATE_DEGRADED
            else:
                out["state"] = STATE_HEALTHY
        return out

    def evaluate(self, now: Optional[float] = None) -> dict:
        """The degradation envelope: per-SLI state + the overall worst
        (the payload ``GET /debug/slo`` serves and chaos cells assert
        against).  Also publishes the ``kvtpu_slo_*`` gauges."""
        now = time.time() if now is None else now
        with self._lock:
            series = dict(self._series)
            self._evaluations += 1
            evaluations = self._evaluations
        slis = {
            name: self._evaluate_sli(entry, now)
            for name, entry in sorted(series.items())
        }
        overall = _worst([s["state"] for s in slis.values()])
        for name, view in slis.items():
            METRICS.slo_state.labels(sli=safe_label(name)).set(
                _STATE_RANK[view["state"]]
            )
            for window, key in (("fast", "burn_fast"), ("slow", "burn_slow")):
                burn = view.get(key)
                if burn is not None:
                    METRICS.slo_burn_rate.labels(
                        sli=safe_label(name), window=window
                    ).set(burn)
        METRICS.slo_state.labels(sli="overall").set(_STATE_RANK[overall])
        payload = {
            "state": overall,
            "evaluated_unix": now,
            "evaluations": evaluations,
            "windows": {
                "fast_s": self.window_fast_s,
                "slow_s": self.window_slow_s,
            },
            "slis": slis,
        }
        with self._lock:
            self._last_payload = payload
            previous = self._last_state or STATE_HEALTHY
            self._last_state = overall
            if previous != overall and self._listeners:
                self._transitions.append((previous, overall, payload))
            if self._transitions and not self._dispatching:
                self._dispatching = True
                drain = True
            else:
                drain = False
        if drain:
            self._drain_transitions()
        return payload

    def _drain_transitions(self) -> None:
        """Deliver queued state transitions FIFO, one dispatcher at a
        time (the ``_dispatching`` flag hands late arrivals to the
        thread already draining); listeners run with NO engine lock
        held — they may read ``last_payload()`` or trigger an
        incident bundle."""
        while True:
            with self._lock:
                if not self._transitions:
                    self._dispatching = False
                    return
                previous, overall, payload = self._transitions.popleft()
                listeners = list(self._listeners)
            for listener in listeners:
                try:
                    listener(previous, overall, payload)
                except Exception:  # noqa: BLE001 - never down /slo
                    logger.exception(
                        "SLO transition listener failed (%s -> %s)",
                        previous,
                        overall,
                    )

    # -- surfaces -------------------------------------------------------

    def status(self, now: Optional[float] = None) -> dict:
        """The /debug/slo payload: sample-then-evaluate, so the
        endpoint is truthful even between background polls."""
        self.sample(now)
        payload = self.evaluate(now)
        with self._lock:
            payload["source_errors"] = {
                name: entry.source_errors
                for name, entry in self._series.items()
                if entry.source_errors
            }
        return payload

    def last_payload(self) -> Optional[dict]:
        """The most recent full evaluation payload (None before the
        first) — what the incident bundler snapshots as ``slo.json``
        without re-sampling every source mid-incident."""
        with self._lock:
            return self._last_payload

    def healthz_block(self) -> dict:
        """Compact envelope for /healthz, served from the LAST
        evaluation (the background poll or a /debug/slo hit keeps it
        fresh; ``evaluated_unix`` exposes staleness) — a 1 Hz liveness
        probe must not re-sample every SLI source per hit.  Falls back
        to one full evaluation when none has run yet."""
        with self._lock:
            payload = self._last_payload
        if payload is None:
            payload = self.status()
        block = {
            "state": payload["state"],
            "evaluated_unix": payload["evaluated_unix"],
        }
        for state_name in (STATE_DEGRADED, STATE_VIOLATED):
            names = [
                name
                for name, view in payload["slis"].items()
                if view["state"] == state_name
            ]
            if names:
                block[state_name] = names
        no_data = [
            name
            for name, view in payload["slis"].items()
            if view.get("no_data")
        ]
        if no_data:
            block["no_data"] = no_data
        return block

    # -- lifecycle ------------------------------------------------------

    def start(self, poll_interval_s: float = 5.0) -> None:
        """Background sample+evaluate loop (idempotent; restartable
        after ``close``)."""
        if poll_interval_s <= 0:
            raise ValueError("poll interval must be positive")
        if self._thread is not None:
            return
        # A previous close() left the stop flag set; without clearing
        # it the new thread would exit on its first wait() and polling
        # would silently stay dead.
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(poll_interval_s):
                try:
                    self.sample()
                    self.evaluate()
                except Exception:  # noqa: BLE001 - the loop must survive
                    logger.exception("SLO evaluation round failed")

        # gil-atomic: lifecycle ref; start/close are control-plane
        self._thread = threading.Thread(
            target=run, name="kvtpu-slo-engine", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            # gil-atomic: lifecycle ref; start/close are control-plane
            self._thread = None


def envelope_violations(payload: dict) -> List[str]:
    """Internal-consistency check of a published envelope: every SLI
    whose state claims "within bound" must actually be within its
    declared bound, and a ``violated`` overall state is itself a
    violation.  Chaos cells assert ``envelope_violations(payload) ==
    []`` instead of pinning ad-hoc numbers — the declared bounds ARE
    the contract."""
    problems: List[str] = []
    if payload.get("state") == STATE_VIOLATED:
        problems.append("overall state is violated")
    for name, view in (payload.get("slis") or {}).items():
        state = view.get("state")
        value = view.get("value")
        if value is None:
            continue
        bound = view.get("degraded_bound")
        if state == STATE_VIOLATED:
            problems.append(
                f"{name}: {value} outside declared bound {bound}"
            )
            continue
        if view.get("kind") == "ratio":
            if value < bound:
                problems.append(
                    f"{name}: state {state} but value {value} below "
                    f"declared bound {bound}"
                )
        elif value > bound:
            problems.append(
                f"{name}: state {state} but value {value} above "
                f"declared bound {bound}"
            )
    return problems


def envelope_states(payload: dict) -> Dict[str, str]:
    """Compact ``{sli: state}`` map (plus ``"overall"``) from one
    evaluation payload — the per-checkpoint shape the what-if engine's
    A/B replay compares to find the first point of SLO divergence
    (obs/whatif.py; docs/observability.md "What-if engine")."""
    states = {"overall": str(payload.get("state", STATE_HEALTHY))}
    for name, view in (payload.get("slis") or {}).items():
        states[str(name)] = str(view.get("state", STATE_HEALTHY))
    return states


# ------------------------- source constructors -------------------------


def counter_label_total(counter, **labels) -> float:
    """Sum of a labeled counter's ``_total`` samples matching
    ``labels`` (subset match)."""
    total = 0.0
    for metric in counter.collect():
        for sample in metric.samples:
            if not sample.name.endswith("_total"):
                continue
            if all(
                sample.labels.get(k) == v for k, v in labels.items()
            ):
                total += sample.value
    return total


def labeled_gauge_sum(gauge) -> float:
    """Sum of a labeled gauge across all label sets (0.0 when none)."""
    total = 0.0
    for metric in gauge.collect():
        for sample in metric.samples:
            total += sample.value
    return total


def labeled_gauge_max(gauge) -> float:
    """Max of a labeled gauge across all label sets (0.0 when none)."""
    best = 0.0
    for metric in gauge.collect():
        for sample in metric.samples:
            best = max(best, sample.value)
    return best


def histogram_latency_source(
    histogram, threshold_s: float
) -> Callable[[], Optional[Tuple[float, float]]]:
    """Ratio source from a prometheus histogram: good = observations
    <= the largest FINITE bucket bound <= ``threshold_s``, total =
    all observations — the classic "fraction of requests under X ms"
    SLI, windowed by the engine's cumulative-delta math.

    The bucket rounds DOWN, never up: a threshold between bounds (or
    past every finite bound — the +Inf bucket equals total by
    definition) must undercount "good", because rounding up would let
    a service miss the declared objective by most of a bucket width —
    or by any amount at all, past the widest bucket — while the SLI
    reports 100% healthy, the exact blindness the engine exists to
    remove.  Align the threshold (``SLO_SCORE_LATENCY_MS``) to a
    bucket bound for an exact reading.
    """

    def source() -> Optional[Tuple[float, float]]:
        good = None
        good_le = None
        total = 0.0
        for metric in histogram.collect():
            for sample in metric.samples:
                if sample.name.endswith("_bucket"):
                    try:
                        bound = float(sample.labels.get("le", ""))
                    except ValueError:
                        continue
                    if bound == float("inf"):
                        continue
                    if bound <= threshold_s and (
                        good_le is None or bound > good_le
                    ):
                        good_le = bound
                        good = sample.value
                elif sample.name.endswith("_count"):
                    total += sample.value
        if good is None:
            # Threshold below every finite bucket: nothing provably
            # under it — fully conservative.
            good = 0.0
        return good, total

    return source


def default_fleet_slos(
    window_fast_s: float = DEFAULT_WINDOW_FAST_S,
    window_slow_s: float = DEFAULT_WINDOW_SLOW_S,
    score_latency_s: float = 0.25,
    hit_rate_objective: float = 0.0,
    hit_rate_bound: Optional[float] = None,
    membership=None,
    pool=None,
) -> SloEngine:
    """The stock fleet SLO set, fed entirely from existing surfaces.

    ``membership`` (a ``cluster.ClusterMembership``) enables the
    replica-death and failover SLIs; ``pool`` (a ``kvevents.Pool``)
    enables the apply-side shed ratio.  A ``hit_rate_objective`` of 0
    keeps the hit-rate SLI informational (always healthy) — hit rate
    is workload-dependent, so the floor is deliberately opt-in
    (``SLO_HIT_RATE_OBJECTIVE``)."""
    from llm_d_kv_cache_manager_tpu_torch.metrics.collector import (
        counter_total,
    )

    engine = SloEngine(window_fast_s, window_slow_s)
    engine.register(
        SloSpec(
            "score_availability",
            kind="ratio",
            objective=0.999,
            degraded_bound=0.99,
            description="fraction of scored requests answering 200",
        ),
        lambda: (
            counter_label_total(METRICS.score_requests, outcome="ok"),
            counter_total(METRICS.score_requests),
        ),
    )
    engine.register(
        SloSpec(
            "score_latency",
            kind="ratio",
            objective=0.99,
            degraded_bound=0.90,
            description=(
                f"fraction of scored requests under {score_latency_s}s"
            ),
        ),
        histogram_latency_source(METRICS.score_latency, score_latency_s),
    )
    engine.register(
        SloSpec(
            "hit_rate",
            kind="ratio",
            objective=hit_rate_objective,
            degraded_bound=(
                hit_rate_bound
                if hit_rate_bound is not None
                else hit_rate_objective / 2.0
            ),
            description="ledger hit fraction of scored requests",
        ),
        lambda: (
            counter_label_total(
                METRICS.cachestats_requests, outcome="hit"
            ),
            counter_total(METRICS.cachestats_requests),
        ),
    )
    engine.register(
        SloSpec(
            "event_apply_backlog",
            kind="gauge",
            objective=1024.0,
            degraded_bound=16384.0,
            description=(
                "queued-not-applied event messages across pod lanes"
            ),
            unit="messages",
        ),
        lambda: (labeled_gauge_sum(METRICS.kvevents_pod_backlog), 0.0),
    )
    engine.register(
        SloSpec(
            "resync_suspect_pods",
            kind="gauge",
            objective=0.0,
            degraded_bound=8.0,
            description="pods gapped and not yet resynced",
            unit="pods",
        ),
        lambda: (
            labeled_gauge_sum(METRICS.kvevents_suspect_pods),
            0.0,
        ),
    )
    if pool is not None:
        def shed_source() -> Optional[Tuple[float, float]]:
            applied = float(
                pool.stage_stats().get("apply_msgs", 0) or 0
            )
            dropped = counter_total(METRICS.kvevents_dropped)
            return applied, applied + dropped

        engine.register(
            SloSpec(
                "event_shed",
                kind="ratio",
                objective=0.99,
                degraded_bound=0.90,
                description=(
                    "fraction of event messages applied (not shed)"
                ),
            ),
            shed_source,
        )
    if membership is not None:
        engine.register(
            SloSpec(
                "replicas_dead",
                kind="gauge",
                objective=0.0,
                degraded_bound=1.0,
                description=(
                    "configured replicas currently out of the ring"
                ),
                unit="replicas",
            ),
            lambda: (
                float(
                    len(membership.members()) - len(membership.alive())
                ),
                0.0,
            ),
        )
        engine.register(
            SloSpec(
                "failovers",
                kind="rate",
                objective=0.0,
                degraded_bound=2.0,
                description="ring removals in the fast window",
                unit="failovers",
            ),
            lambda: (float(membership.failover_count()), 0.0),
        )
        engine.register(
            SloSpec(
                "replication_lag",
                kind="gauge",
                objective=512.0,
                degraded_bound=8192.0,
                description=(
                    "max journal records a replication follower is "
                    "behind its primary"
                ),
                unit="records",
            ),
            lambda: (labeled_gauge_max(METRICS.cluster_replica_lag), 0.0),
        )
    return engine
