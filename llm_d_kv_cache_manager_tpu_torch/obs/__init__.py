"""Observability: request-scoped tracing + flight recorder.

See docs/observability.md.  Import surface:

    from llm_d_kv_cache_manager_tpu_torch.obs import (
        TRACER, current_trace, span, use_trace,
    )

The port carries the reference's ``obs/trace.py`` and ``obs/recorder.py``;
its capture, replay, what-if, profiler, timeline and SLO modules are not
ported yet (ROADMAP.md, Queue A).
"""

from llm_d_kv_cache_manager_tpu_torch.obs.recorder import FlightRecorder
from llm_d_kv_cache_manager_tpu_torch.obs.trace import (
    TRACER,
    ParentContext,
    Span,
    Trace,
    Tracer,
    TracerConfig,
    current_trace,
    format_traceparent,
    parse_traceparent,
    span,
    use_trace,
)

__all__ = [
    "FlightRecorder",
    "TRACER",
    "ParentContext",
    "Span",
    "Trace",
    "Tracer",
    "TracerConfig",
    "current_trace",
    "format_traceparent",
    "parse_traceparent",
    "span",
    "use_trace",
]
