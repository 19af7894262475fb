"""Observability: request-scoped tracing + flight recorder.

See docs/observability.md.  Import surface:

    from llm_d_kv_cache_manager_tpu_torch.obs import (
        TRACER, current_trace, span, use_trace,
    )

Copied from the JAX reference's ``obs/__init__.py``: the same ``__all__``.
"""

from llm_d_kv_cache_manager_tpu_torch.obs.capture import (
    CaptureConfig,
    IncidentManager,
    InputCaptureRecorder,
    capture_enabled_env,
    config_fingerprint,
    encode_capture,
    fingerprint_status,
    set_build_info_metric,
)
from llm_d_kv_cache_manager_tpu_torch.obs.replay import (
    CaptureMismatchError,
    ReplayReport,
    load_capture,
    replay_capture,
)
from llm_d_kv_cache_manager_tpu_torch.obs.whatif import (
    StackConfig,
    WhatIfConfig,
    WhatIfRegistry,
    capture_to_bytes,
    gate_headlines,
    interleave,
    reference_ab,
    repeat,
    run_ab,
    run_whatif,
    scale_pods,
    splice,
    stretch,
)
from llm_d_kv_cache_manager_tpu_torch.obs.profiler import (
    PROFILER,
    ProfilerConfig,
    SamplingProfiler,
    thread_role,
)
from llm_d_kv_cache_manager_tpu_torch.obs.recorder import FlightRecorder
from llm_d_kv_cache_manager_tpu_torch.obs.timeline import (
    GaugeTimeline,
    register_default_series,
)
from llm_d_kv_cache_manager_tpu_torch.obs.slo import (
    SloEngine,
    SloSpec,
    default_fleet_slos,
    envelope_states,
    envelope_violations,
)
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
    "CaptureConfig",
    "CaptureMismatchError",
    "IncidentManager",
    "InputCaptureRecorder",
    "ReplayReport",
    "capture_enabled_env",
    "config_fingerprint",
    "fingerprint_status",
    "load_capture",
    "replay_capture",
    "set_build_info_metric",
    "FlightRecorder",
    "GaugeTimeline",
    "PROFILER",
    "ProfilerConfig",
    "SamplingProfiler",
    "register_default_series",
    "thread_role",
    "SloEngine",
    "SloSpec",
    "default_fleet_slos",
    "envelope_states",
    "envelope_violations",
    "StackConfig",
    "WhatIfConfig",
    "WhatIfRegistry",
    "capture_to_bytes",
    "encode_capture",
    "gate_headlines",
    "interleave",
    "reference_ab",
    "repeat",
    "run_ab",
    "run_whatif",
    "scale_pods",
    "splice",
    "stretch",
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
