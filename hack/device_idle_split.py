"""Split the device idle of one traced benchmark run between the port's
host work and the serving loop's.

    python3 -m hack.device_idle_split --workload <cell> --seed <n> --seconds <s> [--all-threads]

Run from the root of a checkout on a CUDA machine.  It runs
``bench_port.run`` with ``--trace 1`` as it is, with the port's gc hook
installed (``install_gc_metrics()``), and prints the run's own JSON
line as that prints it.  A last line ``{"device_idle_split": ...}``
then sets the traced slice's ``kvtpu.`` ranges (the port's spans on
the profiler's timeline, ``obs/DEVICE_TRACE.md`` of the port) against
the idle that ``bench_port.trace.reduce`` finds: an idle second inside
a ``kvtpu.`` range of the serving loop's thread is the port's host
work, one outside every such range the stand-in's.  It gives
``port_idle_share`` (%, of the slice's work time, the denominator of
``device_idle_share``), ``prefill_idle_ms`` and ``decode_idle_ms``
(device idle inside the model step's ranges, per call in the slice),
the idle under each range name (``idle_gaps``, nested ranges each under
their own name), the ranges counted by thread, and the process's
``kvtpu_kernel_builds_total`` by what was built.  ``--all-threads``
makes the profiler follow every thread, so that the event and tokenizer
pools' ranges are recorded too.

Every idle figure is ``trace.reduce``'s own, computed on the slice's
events with labels moved: the loop's ranges of interest, together with
its ``loop.wait`` ranges, are put under one label, and the idle under
that label less the idle under ``loop.wait`` is the idle while work
waits inside the ranges.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import sys
from collections import defaultdict
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

PREFIX = "kvtpu."
PREFILL = ("kvtpu.model.prefill_paged", "kvtpu.model.prefill_continue")
DECODE = ("kvtpu.model.decode_step",)
WAIT = "loop.wait"
HELD = "loop.admit"  # the label the ranges of interest are put under
OTHER = "loop.publish"  # the label every other loop range is put under


def bench(module: str):
    """A module of the benchmark harness (``bench_port``)."""
    return importlib.import_module(f"bench_port.{module}")


class Event:
    """A profiler event as ``trace.reduce`` reads it, under a name of
    this tool's choosing."""

    __slots__ = ("on_device", "label", "start", "duration", "thread")

    def __init__(self, on_device: bool, label: str, start: int, duration: int, thread: int):
        self.on_device, self.label = on_device, label
        self.start, self.duration, self.thread = start, duration, thread

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self.on_device else DeviceType.CPU

    def name(self) -> str:
        return self.label

    def start_ns(self) -> int:
        return self.start

    def duration_ns(self) -> int:
        return self.duration


def events_of(prof) -> List[Event]:
    from torch.autograd import DeviceType

    return [Event(e.device_type() == DeviceType.CUDA, e.name(), e.start_ns(), e.duration_ns(),
                  e.start_thread_id()) for e in prof.profiler.kineto_results.events()]


def as_profile(events: Sequence[Event]):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


def split(events: Sequence[Event]) -> Dict:
    """The slice's work and idle-with-work seconds (``trace.reduce``'s),
    the part of that idle inside any ``kvtpu.`` range of the loop's
    thread (``port_idle_s``) and inside each range name
    (``idle_by_range``), the loop thread's ranges counted by name where
    they start inside the slice (``calls``), and every thread's
    ``kvtpu.`` ranges counted (``ranges_by_thread``).  Empty where the
    slice has no device work or no loop labels."""
    trace = bench("trace")
    base = trace.reduce(as_profile(events))
    if not base:
        return {}
    labels = [e for e in events if not e.on_device and e.label in trace.LABELS]
    loop_threads = {e.thread for e in labels}
    lo = min(e.start for e in labels)
    hi = max(e.start + e.duration for e in labels)
    ranges: Dict[str, List[Event]] = defaultdict(list)
    by_thread: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.on_device or not e.label.startswith(PREFIX):
            continue
        by_thread[str(e.thread)] += 1
        if e.thread in loop_threads and e.start < hi and e.start + e.duration > lo:
            ranges[e.label].append(e)
    waits = [e for e in labels if e.label == WAIT]
    device = [e for e in events if e.on_device]
    moved = [Event(False, WAIT if e.label == WAIT else OTHER, e.start, e.duration, e.thread)
             for e in labels]

    def held(of: Sequence[Event]) -> float:
        """Idle while work waits inside ``of``, clipped to the slice."""
        inside = [Event(False, HELD, max(e.start, lo), min(e.start + e.duration, hi) - max(e.start, lo),
                        e.thread) for e in list(of) + waits]
        by = trace.reduce(as_profile(device + moved + inside))["idle_by_label"]
        return max(0.0, by[HELD] - by[WAIT])

    every = [e for of in ranges.values() for e in of]
    return {
        "work_s": base["work_s"],
        "idle_with_work_s": base["idle_with_work_s"],
        "port_idle_s": held(every),
        "idle_by_range": {name: held(of) for name, of in ranges.items()},
        "calls": {name: sum(1 for e in of if e.start >= lo) for name, of in ranges.items()},
        "ranges_by_thread": dict(by_thread),
        "loop_threads": sorted(str(t) for t in loop_threads),
    }


def idle_gaps(result: Dict, top: int = 10) -> List[List]:
    """The loop thread's ``kvtpu.`` ranges by the idle they hold, largest
    first, as ``breakdown.idle_gaps`` entries: each a part of the
    ``loop.*`` entry around it, and a nested range a part of its
    parent's."""
    by = sorted(result.get("idle_by_range", {}).items(), key=lambda kv: -kv[1])[:top]
    return [[name, s] for name, s in by if s > 0]


def port_idle_share(result: Dict) -> Optional[float]:
    """Share of the slice's work time with no kernel running while the
    loop's thread was inside a ``kvtpu.`` range, in percent."""
    if not result or result["work_s"] <= 0:
        return None
    return 100.0 * result["port_idle_s"] / result["work_s"]


def idle_per_call(result: Dict, names: Sequence[str]) -> Optional[float]:
    """Device idle inside the loop thread's ranges of ``names``, in ms
    per such range that starts in the slice."""
    calls = sum(result.get("calls", {}).get(n, 0) for n in names)
    if not calls:
        return None
    return 1e3 * sum(result["idle_by_range"].get(n, 0.0) for n in names) / calls


def follow_every_thread() -> None:
    """Make this process's ``torch.profiler.profile`` follow all threads
    (torch's ``profile_all_threads``)."""
    import torch

    plain = torch.profiler.profile

    @functools.wraps(plain)
    def profile(*args, **kwargs):
        kwargs.setdefault("experimental_config",
                          torch._C._profiler._ExperimentalConfig(profile_all_threads=True))
        return plain(*args, **kwargs)

    torch.profiler.profile = profile


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--all-threads", action="store_true")
    args = ap.parse_args(argv)
    if args.all_threads:
        follow_every_thread()
    collector = bench("serve").port("metrics.collector")
    collector.install_gc_metrics()
    trace, kept = bench("trace"), {}
    reduce = trace.reduce

    def keeping(prof):  # the run reduces its profile once, then drops it
        kept["events"] = events_of(prof)
        return reduce(prof)

    trace.reduce = keeping
    try:
        rc = bench("run").main(["--workload", args.workload, "--seed", str(args.seed),
                                "--seconds", str(args.seconds), "--trace", "1"])
    finally:
        trace.reduce = reduce
    result = split(kept.get("events", []))
    builds = {s.labels["what"]: s.value for f in collector.METRICS.kernel_builds.collect()
              for s in f.samples if s.name.endswith("_total")}
    print(json.dumps({"device_idle_split": {
        **result, "idle_gaps": idle_gaps(result), "port_idle_share": port_idle_share(result),
        "prefill_idle_ms": idle_per_call(result, PREFILL),
        "decode_idle_ms": idle_per_call(result, DECODE), "kernel_builds": builds}}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
