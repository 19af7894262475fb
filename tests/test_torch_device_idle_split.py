"""``hack/device_idle_split.py`` on synthetic traced slices: the device
idle while work waits, split between the port's ``kvtpu.`` ranges on
the serving loop's thread and the rest, every figure computed by the
benchmark's own ``trace.reduce``."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from hack import device_idle_split as tool

trace = tool.bench("trace")
mfu = tool.bench("mfu")

LOOP, WORKER = 1, 7


class Kineto:
    """A profiler event as torch's kineto results give it, times in ms."""

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


def prof_of(*groups):
    events = [Kineto(*e) for group in groups for e in group]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


def split_of(*groups):
    return tool.split(tool.events_of(prof_of(*groups)))


def test_the_split_of_a_synthetic_slice():
    split = split_of(KERNELS, LOOP_LABELS, PORT)
    assert split["work_s"] == pytest.approx(0.09)
    assert split["idle_with_work_s"] == pytest.approx(0.04)
    # Idle [20, 30) inside the prefill's inputs; [50, 65) inside the
    # decode step (of it [60, 64) in the replay); [72, 75) in the router.
    assert split["port_idle_s"] == pytest.approx(0.028)
    by = split["idle_by_range"]
    assert by["kvtpu.model.prefill.inputs"] == pytest.approx(0.006)
    assert by["kvtpu.model.prefill_continue"] == pytest.approx(0.010)
    assert by["kvtpu.model.decode_step"] == pytest.approx(0.015)
    assert by["kvtpu.model.decode.replay"] == pytest.approx(0.004)
    assert by["kvtpu.router.get_pod_scores"] == pytest.approx(0.003)
    assert "kvtpu.kvevents.apply" not in by  # another thread's range
    assert split["ranges_by_thread"] == {str(LOOP): 6, str(WORKER): 1}
    assert tool.idle_per_call(split, tool.PREFILL) == pytest.approx(10.0)
    assert tool.idle_per_call(split, tool.DECODE) == pytest.approx(15.0)
    assert tool.port_idle_share(split) == pytest.approx(100 * 0.028 / 0.09)
    names = [n for n, _ in tool.idle_gaps(split)]
    assert names[:2] == ["kvtpu.model.decode_step", "kvtpu.model.prefill_continue"]


def test_a_range_across_the_slice_edge_is_clipped_and_counted_where_it_starts():
    """A decode step open before the first loop label and one still open
    after the last: each keeps the idle inside the slice, and only the
    one that starts inside it counts as a call."""
    edges = [(False, "kvtpu.model.decode_step", -5, 0.5), (False, "kvtpu.model.decode_step", 95, 130),
             (False, "kvtpu.model.decode_step", 41, 65)]
    split = split_of(KERNELS, LOOP_LABELS, edges)
    # [-5, 0.5) holds no idle (a kernel runs from 0); [95, 100) is the
    # loop's wait, which is no idle with work; [50, 65) is.
    assert split["idle_by_range"]["kvtpu.model.decode_step"] == pytest.approx(0.015)
    assert split["calls"]["kvtpu.model.decode_step"] == 2
    late = [(False, "kvtpu.model.prefill_paged", 85, 130)]
    cut = split_of([(True, "gemm", 0, 20), (True, "gemm", 30, 50)], LOOP_LABELS, late)
    # After the last kernel at 50, [85, 90) is idle with work inside the
    # range; [90, 100) is the wait; past 100 is outside the slice.
    assert cut["idle_by_range"]["kvtpu.model.prefill_paged"] == pytest.approx(0.005)
    assert cut["calls"]["kvtpu.model.prefill_paged"] == 1


def test_the_split_works_out_nothing_the_harness_does_not():
    """The tool's work and idle are ``trace.reduce``'s, and the idle a
    range holds counts nothing of the loop's wait."""
    prof = prof_of(KERNELS, LOOP_LABELS, PORT)
    split, summary = tool.split(tool.events_of(prof)), trace.reduce(prof)
    assert split["work_s"] == summary["work_s"]
    assert split["idle_with_work_s"] == summary["idle_with_work_s"]
    waiting = [(False, "kvtpu.kvevents.add_tasks", 88, 100)]
    assert split_of(KERNELS, LOOP_LABELS, waiting)["port_idle_s"] == pytest.approx(0.0)


@pytest.mark.parametrize("shift", [0, 5, 17, 40])
def test_the_port_holds_no_more_idle_than_the_device_has(shift):
    moved = [(d, n, a + shift, b + shift) + tuple(rest) for d, n, a, b, *rest in PORT]
    prof = prof_of(KERNELS, LOOP_LABELS, moved)
    split, summary = tool.split(tool.events_of(prof)), trace.reduce(prof)
    device_idle = mfu.idle_share({"trace": summary})
    assert tool.port_idle_share(split) <= device_idle + 1e-9
    calls = split["calls"]
    parts = sum((tool.idle_per_call(split, names) or 0.0) * 1e-3
                * sum(calls.get(n, 0) for n in names) for names in (tool.PREFILL, tool.DECODE))
    assert parts <= summary["idle_with_work_s"] + 1e-9


def test_a_slice_without_device_work_or_loop_labels_gives_nothing():
    assert split_of(LOOP_LABELS, PORT) == {}
    assert split_of(KERNELS, PORT) == {}
    assert tool.port_idle_share({}) is None
    assert tool.idle_per_call({}, tool.DECODE) is None
    assert tool.idle_gaps({}) == []
