"""Arithmetic the per-layer readers share: model-FLOP utilisation over
CUDA-event times, a kernel's roofline share over the traced slice, and
the device's idle share.  Operations and bytes come from the record's
``shape``, the configuration's family's (``families/<family>.py``), from
shapes alone."""

from __future__ import annotations

from typing import Optional

from bench_port.trace import kernel_seconds


def _flops(rec, call) -> float:
    if call.kind == "prefill":
        return rec["shape"].prefill_flops(call.prefix, call.new)
    return rec["shape"].decode_flops(call.contexts)


def utilisation(rec, kind: str) -> Optional[float]:
    calls = [c for c in rec["calls"] if c.kind == kind and c.events is not None]
    if not calls:
        return None
    seconds = sum(c.events[0].elapsed_time(c.events[1]) for c in calls) * 1e-3
    flops = sum(_flops(rec, c) for c in calls)
    return 100.0 * flops / (seconds * rec["peaks"]["bf16_flops"])


def _bound_s(rec, call) -> float:
    if call.kind == "prefill":
        return rec["shape"].prefill_attention_bound_s(call.prefix, call.new, rec["peaks"])
    return rec["shape"].decode_attention_bound_s(call.contexts, call.kv_tokens, rec["peaks"])


def roofline_share(rec, kind: str, kernels) -> Optional[float]:
    summary = rec.get("trace") or {}
    seconds = kernel_seconds(summary, kernels)
    calls = [c for c in rec["slice_calls"] if c.kind == kind]
    if seconds <= 0 or not calls:
        return None
    return 100.0 * sum(_bound_s(rec, c) for c in calls) / seconds


def idle_share(rec) -> Optional[float]:
    summary = rec.get("trace") or {}
    if not summary or summary["work_s"] <= 0:
        return None
    return 100.0 * summary["idle_with_work_s"] / summary["work_s"]
