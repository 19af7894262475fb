"""Reduce a torch.profiler trace of a slice of the window to what the
per-layer metrics and the ``breakdown`` read: device time by kernel, the
device's busy time, and its idle gaps labelled by what the serving loop
was doing (the ``loop.*`` ranges it records while a slice is traced).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

Interval = Tuple[float, float]
LABELS = ("loop.admit", "loop.prefill", "loop.publish", "loop.decode", "loop.wait")


def merge(intervals: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def length(intervals: List[Interval]) -> float:
    return sum(b - a for a, b in intervals)


def intersect(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    """The overlap of two merged, sorted interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def gaps(busy: List[Interval], lo: float, hi: float) -> List[Interval]:
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def _events(prof):
    """(on the device?, name, start s, end s) of every event."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        yield e.device_type() == DeviceType.CUDA, e.name(), start, start + e.duration_ns() * 1e-9


def reduce(prof) -> Dict:
    """Kernel seconds by name, busy and window seconds, idle seconds by
    loop label, and idle seconds while work was present (outside
    ``loop.wait``)."""
    kernels: Dict[str, float] = defaultdict(float)
    device: List[Interval] = []
    ranges: Dict[str, List[Interval]] = defaultdict(list)
    for on_device, name, a, b in _events(prof):
        if on_device and name not in LABELS:  # labels also show as device annotations
            kernels[name] += b - a
            device.append((a, b))
        elif not on_device and name in LABELS:
            ranges[name].append((a, b))
    spans = [iv for label in LABELS for iv in ranges[label]]
    if not device or not spans:
        return {}
    lo = min(a for a, _ in spans)
    hi = max(b for _, b in spans)
    busy = intersect(merge(device), [(lo, hi)])
    idle = gaps(busy, lo, hi)
    by_label = {}
    for label in LABELS:
        by_label[label] = length(intersect(idle, merge(ranges[label])))
    labelled = sum(by_label.values())
    by_label["loop.other"] = max(0.0, length(idle) - labelled)
    waiting = merge(ranges["loop.wait"])
    work = (hi - lo) - length(intersect(waiting, [(lo, hi)]))
    return {
        "kernels": dict(kernels),
        "busy_s": length(busy),
        "window_s": hi - lo,
        "idle_by_label": by_label,
        "idle_with_work_s": length(idle) - by_label["loop.wait"],
        "work_s": work,
    }


def kernel_seconds(summary: Dict, fragments) -> float:
    return sum(s for name, s in summary.get("kernels", {}).items()
               if any(f in name for f in fragments))


def breakdown(summary: Dict) -> Dict:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(summary["idle_by_label"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:120], s] for name, s in ops],
            "idle_gaps": [[name, s] for name, s in idle if s > 0]}
