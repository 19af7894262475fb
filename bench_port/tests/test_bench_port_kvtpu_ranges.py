"""The port's ``kvtpu.`` ranges in a traced slice: ``trace.reduce``
counts the same device work with them, the tiny serving loop opens them
on its thread, and the ``event_lag_ms`` reader reads the event pool's
``lag_s``.  (``hack/device_idle_split.py`` splits the idle by them;
``tests/test_torch_device_idle_split.py`` holds it.)"""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from bench_port import spec, trace
from bench_port import run as bench_run
from bench_port.tests.test_bench_port_serving import CPU, tiny_cell

LOOP, WORKER = 1, 7


class Event:
    def __init__(self, on_device, name, start_ms, end_ms, thread=LOOP):
        self._d, self._n, self._a, self._b, self._t = on_device, name, start_ms, end_ms, thread

    def device_type(self):
        return DeviceType.CUDA if self._d else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._a * 1e6)

    def duration_ns(self):
        return int((self._b - self._a) * 1e6)

    def start_thread_id(self):
        return self._t


def prof_of(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


# A 100 ms slice.  Kernels run over [0, 20), [30, 50), [80, 90).  The
# loop: a prefill over [0, 40) whose host copies leave [20, 30) idle, a
# decode step over [40, 70) idle from 50, a wait over [90, 100), and
# other loop work over [70, 90) idle until the kernel at 80.
KERNELS = [(True, "gemm", 0, 20), (True, "flash_bf16_kernel", 30, 50), (True, "gemm", 80, 90),
           (True, "loop.prefill", 0, 40), (True, "loop.decode", 40, 60)]
LOOP_LABELS = [(False, "loop.prefill", 0, 40), (False, "loop.decode", 40, 70),
               (False, "loop.admit", 70, 90), (False, "loop.wait", 90, 100)]
PORT = [(False, "kvtpu.model.prefill_continue", 1, 39),
        (False, "kvtpu.model.prefill.inputs", 20, 26),
        (False, "kvtpu.model.prefill.layers", 26, 38),
        (False, "kvtpu.model.decode_step", 41, 65),
        (False, "kvtpu.model.decode.replay", 60, 64),
        (False, "kvtpu.router.get_pod_scores", 72, 75),
        (False, "kvtpu.kvevents.apply", 71, 79, WORKER)]


def events(*groups):
    return [Event(*e) for group in groups for e in group]


def test_reduce_counts_the_same_device_work_with_the_port_ranges():
    plain = trace.reduce(prof_of(events(KERNELS, LOOP_LABELS)))
    ranged = trace.reduce(prof_of(events(KERNELS, LOOP_LABELS, PORT)))
    assert ranged == plain
    assert plain["busy_s"] == pytest.approx(0.05)
    assert plain["idle_with_work_s"] == pytest.approx(0.04)


def test_event_lag_reads_lag_over_frames_and_nothing_without_it():
    read = spec.metric_reader("event_lag_ms").read
    start = {"apply_msgs": 10, "apply_s": 0.1, "queue_s": 0.2, "lag_s": 0.5}
    end = {"apply_msgs": 30, "apply_s": 0.3, "queue_s": 0.4, "lag_s": 0.9}
    assert read({"stages": (start, end)}) == pytest.approx(20.0)
    # A pool that keeps no lag (the parent's) reads nothing, and raises nothing.
    old = {k: v for k, v in start.items() if k in ("apply_msgs", "apply_s")}
    assert read({"stages": (old, {**old, "apply_msgs": 12})}) is None
    assert read({"stages": ({}, {})}) is None
    assert read({"stages": (start, start)}) is None


def test_the_tiny_loop_opens_the_port_ranges_on_its_thread():
    """The serving loop on the CPU under a CPU-only profiler: the loop's
    thread holds the model step's, the router's and the event pool's
    ranges, and the window's frames read an event lag."""
    cell = tiny_cell("open")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run = bench_run.serve_cell(cell, 2**31 + 5, 0.5, False, CPU)
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("kvtpu.")}
    assert {"kvtpu.model.prefill_paged", "kvtpu.model.prefill_continue",
            "kvtpu.model.decode_step", "kvtpu.model.decode.inputs",
            "kvtpu.router.get_pod_scores", "kvtpu.kvevents.add_tasks"} <= names
    assert not any(e.device_type() == DeviceType.CUDA for e in prof.profiler.kineto_results.events())
    lag = spec.metric_reader("event_lag_ms").read(bench_run.record(run))
    assert lag is not None and lag > 0
