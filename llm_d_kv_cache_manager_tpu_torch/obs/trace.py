"""Request-scoped tracing: spans, sampling, W3C traceparent, propagation.

Zero-hard-dependency span tracing for the scoring read path, the
KV-event write path, and the offload pipelines.  Design constraints:

* **Always-on cheap.**  The untraced path allocates nothing: ``span()``
  returns a preallocated null context manager when no trace is active
  and no torch profiler records, and an unsampled ``start_trace`` costs
  one lock-free counter increment.
* **One clock with the device.**  While a torch profiler records in
  this process (``torch.profiler.profile``, ``emit_nvtx``,
  ``emit_itt``), every span also opens a ``kvtpu.<name>`` range on the
  profiler's timeline, whether or not a trace is active, so Kineto puts
  the port's host work and the CUDA kernels on one timeline (and
  ``emit_nvtx`` hands the ranges to Nsight Systems).
  :func:`profiler_range` opens such a range alone, for work whose spans
  a trace lays out otherwise or which has no request to belong to (the
  model step, the event pool's hand-off, the kernel builds).  The
  ranges are function-scope records, not user annotations, so the
  profiler draws no device-side copy of them: its device rows stay the
  kernels' own.  ``obs/DEVICE_TRACE.md`` lists the ranges and says how
  to take such a trace.
* **Explicit propagation.**  A ``contextvars.ContextVar`` carries the
  active trace within a thread; crossing the thread-pool boundaries we
  own (tokenization pool, kvevents shards, offload workers) is done by
  attaching the ``Trace`` object to the queued task and re-entering it
  with ``use_trace`` on the worker — never by thread-locals that would
  silently fail to cross.
* **Thread-safe traces.**  Spans complete from worker threads while the
  submitting thread keeps tracing, so span append is locked.
* **Flat span model.**  Spans carry an optional ``parent`` stage *name*
  rather than a span-id tree: top-level spans (``parent is None``) are
  the request's sequential stage breakdown — their durations sum to
  ~the end-to-end latency — and dotted children (``tokenize.encode``)
  attribute time inside a stage.  This is what /debug and ``explain=1``
  render, and what feeds ``kvtpu_stage_latency_seconds{stage=...}``.

Env knobs (read at import; ``configure`` overrides for tests/embeds):
``TRACE_SAMPLE_RATE`` (0..1, default 0.01), ``TRACE_RING_SIZE``
(default 256), ``TRACE_SLOW_MS`` (slow-promotion threshold, default
100).  A request bearing a ``traceparent`` header with the sampled
flag set is always traced regardless of the rate — that is the
operator's "trace THIS request" switch.

Copied from the JAX reference's ``obs/trace.py``.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import random
import re
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.obs.recorder import (
    DEFAULT_ERROR_KEEP,
    DEFAULT_RING_SIZE,
    DEFAULT_SLOW_KEEP,
    DEFAULT_SLOW_THRESHOLD_MS,
    FlightRecorder,
)
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("obs.trace")

DEFAULT_SAMPLE_RATE = 0.01

_ZERO_TRACE_ID = "0" * 32
_ZERO_SPAN_ID = "0" * 16

# version-trace_id-parent_id-flags; the trailing group captures any
# future-version suffix fields (W3C forward compatibility: parsers
# must accept higher versions by reading the first four fields and
# ignoring the rest; version 00 allows no suffix).
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})(-.*)?$"
)


class ParentContext(NamedTuple):
    """Parsed W3C traceparent header."""

    trace_id: str
    span_id: str
    sampled: bool


def parse_traceparent(header: Optional[str]) -> Optional[ParentContext]:
    """Parse a W3C traceparent header; None when absent or malformed."""
    if not header:
        return None
    match = _TRACEPARENT_RE.match(header.strip().lower())
    if not match:
        return None
    version, trace_id, span_id, flags, suffix = match.groups()
    # "ff" is forbidden by the spec; all-zero ids are invalid; only
    # future versions may carry suffix fields.
    if version == "ff" or (version == "00" and suffix):
        return None
    if trace_id == _ZERO_TRACE_ID or span_id == _ZERO_SPAN_ID:
        return None
    return ParentContext(trace_id, span_id, bool(int(flags, 16) & 0x01))


def format_traceparent(
    trace_id: str, span_id: str, sampled: bool = True
) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def _new_trace_id() -> str:
    while True:
        trace_id = f"{random.getrandbits(128):032x}"
        if trace_id != _ZERO_TRACE_ID:
            return trace_id


def _new_span_id() -> str:
    while True:
        span_id = f"{random.getrandbits(64):016x}"
        if span_id != _ZERO_SPAN_ID:
            return span_id


class Span:
    """One timed stage of a trace (append-to-trace happens at exit)."""

    __slots__ = ("name", "parent", "start", "end", "status", "attrs")

    def __init__(
        self, name: str, parent: Optional[str], start: float
    ) -> None:
        self.name = name
        self.parent = parent
        self.start = start
        self.end = start
        self.status = "ok"
        self.attrs: Dict[str, Any] = {}

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    @property
    def duration_s(self) -> float:
        return self.end - self.start


class _SpanCtx:
    """Context manager recording one span onto a trace."""

    __slots__ = ("_trace", "_span")

    def __init__(self, trace: "Trace", span: Span) -> None:
        self._trace = trace
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._span.end = time.perf_counter()
        if exc_type is not None:
            self._span.status = "error"
            self._span.attrs["error"] = repr(exc)
        self._trace.append_span(self._span)
        return False


class _NullSpan:
    """Inert span stand-in: attribute writes vanish."""

    __slots__ = ()

    def set_attr(self, key: str, value: Any) -> None:
        return None


class _NullSpanCtx:
    """Stateless, shareable no-op span context (untraced path)."""

    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return _NULL_SPAN

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()
_NULL_SPAN_CTX = _NullSpanCtx()


# ------------------------ the torch profiler bridge ------------------------

# Every range the port opens on a torch profiler's timeline is named
# with this prefix, so a reader of the trace can tell the port's host
# work from the caller's labels and from torch's own ops.
RANGE_PREFIX = "kvtpu."
_NO_INPUTS = ()


def _profiler_record():
    """torch's ``_RecordFunctionFast`` while a torch profiler records in
    this process, else None: one dict lookup and one flag read.  The
    flag is process-wide (``torch.autograd.profiler._is_profiler_enabled``);
    a range opened on a thread the profiler does not follow records
    nothing.  A process that never imported torch has no profiler to
    feed, and this module does not import it."""
    profiler = sys.modules.get("torch.autograd.profiler")
    if profiler is None or not profiler._is_profiler_enabled:
        return None
    return sys.modules["torch"]._C._profiler._RecordFunctionFast


def _open_range(record, name: str, attrs: Optional[Dict[str, Any]]):
    # Attributes (ints, floats, strings, bools) reach the trace as the
    # range's keyword inputs when the profiler records shapes.
    if attrs:
        return record(RANGE_PREFIX + name, _NO_INPUTS, attrs)
    return record(RANGE_PREFIX + name)


class _RangeCtx:
    """A profiler range around a span context (a trace's, or the null
    one): the range opens first and closes last."""

    __slots__ = ("_range", "_inner")

    def __init__(self, range_, inner) -> None:
        self._range = range_
        self._inner = inner

    def __enter__(self):
        self._range.__enter__()
        return self._inner.__enter__()

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            return self._inner.__exit__(exc_type, exc, tb)
        finally:
            self._range.__exit__(exc_type, exc, tb)


def profiler_range(name: str, attrs: Optional[Dict[str, Any]] = None):
    """A ``kvtpu.<name>`` range on the torch profiler's timeline while
    one records, else the shared no-op context.  ``attrs`` (the call's
    shape: ints, floats, strings, bools) ride on the range.  Records
    nothing onto a request trace."""
    record = _profiler_record()
    if record is None:
        return _NULL_SPAN_CTX
    return _open_range(record, name, attrs)


class Trace:
    """One sampled request: id, attributes, and completed spans."""

    def __init__(
        self,
        name: str,
        trace_id: str,
        root_span_id: str,
        recorder: FlightRecorder,
        parent_span_id: Optional[str] = None,
    ) -> None:
        self.name = name
        self.trace_id = trace_id
        self.root_span_id = root_span_id
        self.parent_span_id = parent_span_id
        self._recorder = recorder
        self.start_wall = time.time()
        self.start = time.perf_counter()
        self.duration_s: Optional[float] = None
        self.status = "in_flight"
        self._lock = threading.Lock()
        self._spans: List[Span] = []  # guarded-by: _lock
        self._attrs: Dict[str, Any] = {}  # guarded-by: _lock
        self._error: Optional[str] = None  # guarded-by: _lock
        self._finished = False  # guarded-by: _lock

    # -- span recording (any thread) --

    def span(self, name: str, parent: Optional[str] = None) -> _SpanCtx:
        """Open a span; it records itself on context exit."""
        return _SpanCtx(self, Span(name, parent, time.perf_counter()))

    def add_completed(
        self,
        name: str,
        start: float,
        end: Optional[float] = None,
        parent: Optional[str] = None,
    ) -> Span:
        """Record an already-elapsed interval (queue waits, async I/O)
        from explicit ``time.perf_counter()`` stamps."""
        span = Span(name, parent, start)
        span.end = time.perf_counter() if end is None else end
        self.append_span(span)
        return span

    def append_span(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def set_attr(self, key: str, value: Any) -> None:
        with self._lock:
            self._attrs[key] = value

    def set_error(self, message: str) -> None:
        with self._lock:
            self._error = message

    # -- completion --

    def finish(self, status: Optional[str] = None) -> None:
        """Seal the trace and hand it to the flight recorder.

        Idempotent: only the first call records.  Status defaults to
        "error" when ``set_error`` was called, else "ok".
        """
        end = time.perf_counter()
        with self._lock:
            if self._finished:
                return
            self._finished = True
            self.duration_s = end - self.start
            if status is None:
                status = "ok" if self._error is None else "error"
            self.status = status
            spans = list(self._spans)
        # Outside the trace lock: the prometheus client and the
        # recorder take their own locks.
        for span in spans:
            METRICS.stage_latency.labels(span.name).observe(
                span.duration_s
            )
        self._recorder.record(self)

    def traceparent(self) -> str:
        """The header value we echo: our root span as the parent id."""
        return format_traceparent(self.trace_id, self.root_span_id)

    # -- read surface --

    @staticmethod
    def _stages_view(spans: List[Span]) -> List[Dict[str, Any]]:
        """Top-level spans (parent None) in completion order: the
        request's sequential stage latency breakdown."""
        return [
            {"stage": s.name, "duration_ms": s.duration_s * 1e3}
            for s in spans
            if s.parent is None
        ]

    def stage_breakdown(self) -> List[Dict[str, Any]]:
        with self._lock:
            spans = list(self._spans)
        return self._stages_view(spans)

    def to_dict(self, include_spans: bool = True) -> Dict[str, Any]:
        with self._lock:
            spans = list(self._spans)
            attrs = dict(self._attrs)
            error = self._error
            duration_s = self.duration_s
            status = self.status
        out: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "name": self.name,
            "status": status,
            "start_unix": self.start_wall,
            "duration_ms": (
                duration_s * 1e3 if duration_s is not None else None
            ),
            "traceparent": self.traceparent(),
            "attributes": attrs,
            "stages": self._stages_view(spans),
        }
        if self.parent_span_id is not None:
            out["parent_span_id"] = self.parent_span_id
        if error is not None:
            out["error"] = error
        if include_spans:
            out["spans"] = [
                {
                    "name": s.name,
                    "parent": s.parent,
                    "start_ms": (s.start - self.start) * 1e3,
                    "duration_ms": s.duration_s * 1e3,
                    "status": s.status,
                    "attributes": s.attrs,
                }
                for s in spans
            ]
        return out


# ------------------------------ the tracer ------------------------------


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("invalid %s=%r; using %s", name, raw, default)
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        value = int(raw)
        if value <= 0:
            raise ValueError(raw)
        return value
    except ValueError:
        logger.warning("invalid %s=%r; using %s", name, raw, default)
        return default


@dataclass
class TracerConfig:
    # Fraction of requests traced without an explicit traceparent ask.
    sample_rate: float = DEFAULT_SAMPLE_RATE
    ring_size: int = DEFAULT_RING_SIZE
    slow_threshold_ms: float = DEFAULT_SLOW_THRESHOLD_MS
    slow_keep: int = DEFAULT_SLOW_KEEP
    error_keep: int = DEFAULT_ERROR_KEEP

    @classmethod
    def from_env(cls) -> "TracerConfig":
        return cls(
            sample_rate=_env_float("TRACE_SAMPLE_RATE", DEFAULT_SAMPLE_RATE),
            ring_size=_env_int("TRACE_RING_SIZE", DEFAULT_RING_SIZE),
            slow_threshold_ms=_env_float(
                "TRACE_SLOW_MS", DEFAULT_SLOW_THRESHOLD_MS
            ),
        )


class Tracer:
    """Sampling decisions + trace construction over one recorder."""

    def __init__(self, config: Optional[TracerConfig] = None) -> None:
        self.config = config or TracerConfig.from_env()
        self.recorder = FlightRecorder(
            ring_size=self.config.ring_size,
            slow_keep=self.config.slow_keep,
            error_keep=self.config.error_keep,
            slow_threshold_ms=self.config.slow_threshold_ms,
        )
        self._lock = threading.Lock()
        self._sampled = 0  # guarded-by: _lock
        # Unsampled starts, counted without the lock: ``next`` on an
        # ``itertools.count`` is one C call, so no increment is lost.
        # ``stats()`` draws one more number and subtracts its own draws.
        self._unsampled = itertools.count()
        self._unsampled_reads = 0  # guarded-by: _lock

    def start_trace(
        self,
        name: str,
        traceparent: Optional[str] = None,
        force: bool = False,
    ) -> Optional[Trace]:
        """A new Trace when sampled, else None (count it and move on).

        A valid incoming ``traceparent`` with the sampled flag forces
        tracing and continues the caller's trace id; ``force=True``
        (e.g. ``?explain=1``) does the same with a fresh id.
        """
        parent = parse_traceparent(traceparent)
        if parent is not None and parent.sampled:
            force = True
        if not force:
            rate = self.config.sample_rate
            if rate <= 0.0 or (rate < 1.0 and random.random() >= rate):
                # gil-atomic: itertools.count.__next__ is one C call
                next(self._unsampled)
                return None
        with self._lock:
            self._sampled += 1
        return Trace(
            name,
            parent.trace_id if parent is not None else _new_trace_id(),
            _new_span_id(),
            self.recorder,
            parent_span_id=(
                parent.span_id if parent is not None else None
            ),
        )

    def configure(self, **overrides) -> None:
        """Mutate sampling knobs in place (tests, embedding apps).

        Recorder geometry (ring/reservoir sizes) is fixed at
        construction; only ``sample_rate`` and ``slow_threshold_ms``
        are live-tunable.
        """
        for key in ("sample_rate",):
            if key in overrides:
                self.config.sample_rate = float(overrides.pop(key))
        if "slow_threshold_ms" in overrides:
            value = float(overrides.pop("slow_threshold_ms"))
            self.config.slow_threshold_ms = value
            self.recorder.slow_threshold_ms = value
        if overrides:
            raise TypeError(
                f"unknown tracer overrides: {sorted(overrides)}"
            )

    def stats(self) -> dict:
        """Sampling + recorder health for /healthz."""
        with self._lock:
            sampled = self._sampled
            dropped = next(self._unsampled) - self._unsampled_reads
            self._unsampled_reads += 1
        out = {
            "sample_rate": self.config.sample_rate,
            "traces_sampled": sampled,
            "traces_unsampled": dropped,
        }
        out.update(self.recorder.stats())
        return out

    def reset(self) -> None:
        """Clear recorder + counters (test isolation)."""
        with self._lock:
            self._sampled = 0
            self._unsampled = itertools.count()
            self._unsampled_reads = 0
        # gil-atomic: delegates to the recorder's own internal lock
        self.recorder.clear()


# --------------------------- context plumbing ---------------------------

_CURRENT: "contextvars.ContextVar[Optional[Trace]]" = (
    contextvars.ContextVar("kvtpu_trace", default=None)
)


def current_trace() -> Optional[Trace]:
    return _CURRENT.get()


class use_trace:
    """Bind a trace (or None: no-op) to the current context."""

    __slots__ = ("_trace", "_token")

    def __init__(self, trace: Optional[Trace]) -> None:
        self._trace = trace
        self._token = None

    def __enter__(self) -> Optional[Trace]:
        if self._trace is not None:
            self._token = _CURRENT.set(self._trace)
        return self._trace

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        return False


def span(name: str, parent: Optional[str] = None):
    """Span on the context's active trace, inside a ``kvtpu.<name>``
    profiler range while a torch profiler records; a free no-op when
    neither."""
    trace = _CURRENT.get()
    record = _profiler_record()
    if trace is None:
        if record is None:
            return _NULL_SPAN_CTX
        return _RangeCtx(_open_range(record, name, None), _NULL_SPAN_CTX)
    if record is None:
        return trace.span(name, parent)
    return _RangeCtx(_open_range(record, name, None), trace.span(name, parent))


class shield_trace:
    """Clear the active trace for a scope.

    The process-boundary guard: an in-process wire server (the
    cluster replica's ``handle_wire`` under ``LocalReplicaTransport``
    strict mode) must behave exactly like its cross-process twin —
    server-side spans travel only via the explicit piggyback, never by
    leaking through the caller's context var.
    """

    __slots__ = ("_token",)

    def __init__(self) -> None:
        self._token = None

    def __enter__(self) -> None:
        self._token = _CURRENT.set(None)
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        return False


# Process-wide tracer, mirroring metrics.collector.METRICS: modules
# import this instead of plumbing a tracer through every constructor.
TRACER = Tracer()
