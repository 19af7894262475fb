"""The port's profiling plane (``obs/profiler.py``, ``obs/timeline.py``)
against the JAX package's, on the CPU.

Every case of the reference's ``tests/test_profiler.py`` runs on both
packages (``m`` is either one's names): the sampling profiler attributes
real threads to their ``kvtpu-*`` roles, exports collapsed stacks and a
top-N table, bounds its memory and is inert at ``hz=0``; the tracked
locks count contended acquires; the gauge timeline records, bounds and
filters its series; and ``/debug/``, ``/debug/profile`` and
``/debug/timeline`` answer through each package's own ``serve()``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from llm_d_kv_cache_manager_tpu.api import http_service as ref_http_service
from llm_d_kv_cache_manager_tpu.kvcache import indexer as ref_indexer
from llm_d_kv_cache_manager_tpu.metrics import collector as ref_collector
from llm_d_kv_cache_manager_tpu.obs import profiler as ref_profiler
from llm_d_kv_cache_manager_tpu.obs import timeline as ref_timeline
from llm_d_kv_cache_manager_tpu import utils as ref_utils
from tests.helpers.torch_port import namespace

SIDES = ("ref", "port")
_REF = {
    "api.http_service": ref_http_service,
    "kvcache.indexer": ref_indexer,
    "metrics.collector": ref_collector,
    "obs.profiler": ref_profiler,
    "obs.timeline": ref_timeline,
    "utils": ref_utils,
}
_NAMES = {
    "api.http_service": ("serve",),
    "kvcache.indexer": ("Indexer", "IndexerConfig"),
    "metrics.collector": ("METRICS", "counter_total"),
    "obs.profiler": ("ProfilerConfig", "SamplingProfiler", "is_attributed", "thread_role"),
    "obs.timeline": ("GaugeTimeline", "register_default_series"),
    "utils": ("lockorder",),
}


@pytest.fixture(params=SIDES)
def m(request):
    return namespace(request.param, _REF, _NAMES)


def _busy_thread(name: str, stop: threading.Event) -> threading.Thread:
    def spin() -> None:
        while not stop.is_set():
            sum(range(200))

    thread = threading.Thread(target=spin, name=name, daemon=True)
    thread.start()
    return thread


# ------------------------------ roles -----------------------------------


class TestThreadRole:
    def test_worker_index_folds(self, m):
        assert m.thread_role("kvtpu-events-3") == "events"
        assert m.thread_role("kvtpu-tokenize-0") == "tokenize"
        assert m.thread_role("kvtpu-evplane-poller-12") == "evplane-poller"
        # ThreadPoolExecutor names its threads "<prefix>_<n>".
        assert m.thread_role("kvtpu-grpc_0") == "grpc"
        assert m.thread_role("kvtpu-uds-tokenizer_3") == "uds-tokenizer"

    def test_singleton_roles(self, m):
        assert m.thread_role("kvtpu-metrics-beat") == "metrics-beat"
        assert m.thread_role("kvtpu-http-handler") == "http-handler"

    def test_main_and_anonymous(self, m):
        assert m.thread_role("MainThread") == "main"
        assert m.thread_role("Thread-7") == "other:Thread-7"
        assert m.is_attributed("kvtpu-anything")
        assert not m.is_attributed("MainThread")
        assert not m.is_attributed("Thread-7")


# ---------------------------- profiler ----------------------------------


class TestSamplingProfiler:
    def test_hz_zero_is_inert(self, m):
        prof = m.SamplingProfiler(m.ProfilerConfig(hz=0))
        before = threading.active_count()
        assert prof.start() is False
        assert not prof.running()
        assert threading.active_count() == before
        assert prof.status()["samples"] == 0
        prof.close()  # harmless

    def test_samples_attribute_to_roles(self, m):
        stop = threading.Event()
        thread = _busy_thread("kvtpu-busy-0", stop)
        prof = m.SamplingProfiler(m.ProfilerConfig(hz=200))
        try:
            assert prof.start()
            deadline = time.time() + 5.0
            while (
                prof.status()["samples"] < 50 and time.time() < deadline
            ):
                time.sleep(0.02)
        finally:
            stop.set()
            prof.close()
            thread.join(timeout=5)
        status = prof.status()
        assert status["samples"] >= 50
        assert "busy" in status["roles"]
        assert status["attributed_samples"] > 0
        # The sampler never samples itself.
        assert "profiler" not in status["roles"]

    def test_collapsed_format_and_top(self, m):
        stop = threading.Event()
        thread = _busy_thread("kvtpu-busy-1", stop)
        prof = m.SamplingProfiler(m.ProfilerConfig(hz=200))
        prof.start()
        time.sleep(0.4)
        stop.set()
        prof.close()
        thread.join(timeout=5)
        lines = [
            line for line in prof.collapsed().splitlines() if line
        ]
        assert lines
        for line in lines:
            stack, _, count = line.rpartition(" ")
            assert count.isdigit() and int(count) >= 1
            assert ";" in stack  # role;frame at minimum
        busy_lines = [
            line for line in lines if line.startswith("busy;")
        ]
        assert busy_lines, lines[:5]
        top = prof.top(5)
        assert top and top[0]["self_samples"] >= top[-1]["self_samples"]
        assert all(
            set(entry) >= {"role", "frame", "self_samples", "self_pct"}
            for entry in top
        )

    def test_bounded_stacks_overflow_bucket(self, m):
        prof = m.SamplingProfiler(m.ProfilerConfig(hz=100, max_stacks=1))
        stop = threading.Event()
        threads = [
            _busy_thread(f"kvtpu-busy-ov-{i}", stop) for i in range(2)
        ]
        prof.start()
        time.sleep(0.4)
        stop.set()
        prof.close()
        for thread in threads:
            thread.join(timeout=5)
        status = prof.status()
        assert status["overflowed_samples"] > 0
        # One kept stack plus at most one <other> bucket per role —
        # never proportional to the sample stream.
        roles = len(status["roles"])
        assert status["distinct_stacks"] <= 1 + roles
        assert any(
            ";<other> " in line
            for line in prof.collapsed().splitlines()
        )

    def test_reset_clears_aggregation(self, m):
        prof = m.SamplingProfiler(m.ProfilerConfig(hz=200))
        prof.start()
        time.sleep(0.1)
        prof.close()
        assert prof.status()["samples"] > 0
        prof.reset()
        status = prof.status()
        assert status["samples"] == 0
        assert status["roles"] == {}
        assert prof.collapsed() == ""


# ------------------------- lock contention ------------------------------


class TestLockContention:
    @pytest.fixture(autouse=True)
    def _disarmed(self, m):
        prev = m.lockorder.set_contention_sample(0)
        m.lockorder.reset_contention_stats()
        yield
        m.lockorder.set_contention_sample(prev)

    def test_disarmed_returns_raw_lock(self, m):
        raw = threading.Lock()
        assert m.lockorder.tracked(raw, "T.off") is raw

    def test_contended_fight_is_counted(self, m):
        m.lockorder.set_contention_sample(1)
        lock = m.lockorder.tracked(threading.Lock(), "T.fight")
        assert type(lock).__name__ == "ContentionTimedLock"
        stop = threading.Event()

        def fight() -> None:
            while not stop.is_set():
                with lock:
                    time.sleep(0.001)

        threads = [
            threading.Thread(target=fight, daemon=True) for _ in range(2)
        ]
        before = m.counter_total(m.METRICS.lock_contention)
        for thread in threads:
            thread.start()
        time.sleep(0.5)
        stop.set()
        for thread in threads:
            thread.join(timeout=5)
        stats = m.lockorder.contention_stats()["T.fight"]
        assert stats["contended"] > 0
        assert stats["sampled"] >= stats["contended"]
        assert stats["wait_ewma_us"] > 0
        assert stats["wait_max_us"] >= stats["wait_ewma_us"] / 2
        assert 0.0 < stats["contention_ratio"] <= 1.0
        assert m.counter_total(m.METRICS.lock_contention) > before

    def test_uncontended_lock_records_no_contention(self, m):
        m.lockorder.set_contention_sample(1)
        lock = m.lockorder.tracked(threading.Lock(), "T.calm")
        for _ in range(100):
            with lock:
                pass
        stats = m.lockorder.contention_stats()["T.calm"]
        assert stats["sampled"] == 100
        assert stats["contended"] == 0
        assert stats["wait_ewma_us"] == 0.0

    def test_sampling_interval_thins_probes(self, m):
        m.lockorder.set_contention_sample(10)
        lock = m.lockorder.tracked(threading.Lock(), "T.sampled")
        for _ in range(100):
            with lock:
                pass
        stats = m.lockorder.contention_stats()["T.sampled"]
        assert stats["sampled"] == 10

    def test_nonblocking_contended_acquire(self, m):
        m.lockorder.set_contention_sample(1)
        lock = m.lockorder.tracked(threading.Lock(), "T.nonblock")
        lock.acquire()
        try:
            other = threading.Thread(
                target=lambda: lock.acquire(False), daemon=True
            )
            other.start()
            other.join(timeout=5)
        finally:
            lock.release()
        stats = m.lockorder.contention_stats()["T.nonblock"]
        assert stats["contended"] >= 1

    def test_watchdog_supersedes_timing(self, m):
        m.lockorder.set_contention_sample(1)
        prev = m.lockorder.enable(True)
        try:
            lock = m.lockorder.tracked(threading.Lock(), "T.debug")
            assert type(lock).__name__ == "TrackedLock"
        finally:
            m.lockorder.enable(prev)

    def test_condition_passthrough(self, m):
        m.lockorder.set_contention_sample(1)
        cond = m.lockorder.tracked(threading.Condition(), "T.cond")
        with cond:
            cond.notify_all()  # falls through via __getattr__


# ----------------------------- timeline ---------------------------------


class TestGaugeTimeline:
    def test_records_and_windows(self, m):
        timeline = m.GaugeTimeline(window_s=5)
        values = {"v": 0.0}
        assert timeline.register("v", lambda: values["v"], "test")
        for i in range(8):
            values["v"] = float(i)
            timeline.sample_once(now=1000.0 + i)
        snap = timeline.snapshot()
        points = snap["series"]["v"]["points"]
        # Ring bound: only the last window_s slots survive.
        assert [value for _, value in points] == [3.0, 4.0, 5.0, 6.0, 7.0]
        assert snap["ticks"] == 8

    def test_broken_source_records_none(self, m):
        timeline = m.GaugeTimeline(window_s=5)
        timeline.register("boom", lambda: 1 / 0, "bad")
        timeline.register("ok", lambda: 1.0, "good")
        timeline.sample_once(now=1.0)
        snap = timeline.snapshot()
        assert snap["series"]["boom"]["points"][0][1] is None
        assert snap["series"]["boom"]["errors"] == 1
        assert snap["series"]["ok"]["points"][0][1] == 1.0

    def test_series_filter_and_last(self, m):
        timeline = m.GaugeTimeline(window_s=30)
        timeline.register("a", lambda: 1.0)
        timeline.register("b", lambda: 2.0)
        now = time.time()
        for offset in (-20.0, -10.0, 0.0):
            timeline.sample_once(now=now + offset)
        only_a = timeline.snapshot(series="a")
        assert set(only_a["series"]) == {"a"}
        recent = timeline.snapshot(last_s=15.0)
        assert len(recent["series"]["b"]["points"]) == 2

    def test_unknown_series_returns_empty_not_everything(self, m):
        timeline = m.GaugeTimeline(window_s=5)
        timeline.register("real", lambda: 1.0)
        timeline.sample_once(now=1.0)
        snap = timeline.snapshot(series="typo")
        assert snap["series"] == {}

    def test_window_zero_never_starts(self, m):
        timeline = m.GaugeTimeline(window_s=0)
        assert timeline.start() is False
        assert not timeline.running()
        timeline.close()

    def test_register_is_idempotent_and_bounded(self, m):
        timeline = m.GaugeTimeline(window_s=5)
        assert timeline.register("x", lambda: 0.0)
        assert timeline.register("x", lambda: 1.0)  # same name: kept
        timeline.sample_once(now=1.0)
        assert timeline.snapshot()["series"]["x"]["points"][0][1] == 0.0

    def test_default_series_register(self, m):
        timeline = m.GaugeTimeline(window_s=5)
        m.register_default_series(timeline)
        timeline.sample_once(now=1.0)
        snap = timeline.snapshot()
        assert "score_requests_total" in snap["series"]
        assert "process_rss_bytes" in snap["series"]
        rss = snap["series"]["process_rss_bytes"]["points"][0][1]
        assert rss and rss > 0

    def test_live_sampler_thread_name(self, m):
        timeline = m.GaugeTimeline(window_s=5)
        timeline.register("t", lambda: 1.0)
        assert timeline.start()
        try:
            names = {thread.name for thread in threading.enumerate()}
            assert "kvtpu-timeline" in names
        finally:
            timeline.close()
        assert not timeline.running()


# ------------------------- debug endpoints ------------------------------


def _get(base: str, path: str, as_text: bool = False):
    with urllib.request.urlopen(base + path, timeout=30) as response:
        if as_text:
            return response.read().decode()
        return json.load(response)


@pytest.fixture()
def service(m):
    indexer = m.Indexer(m.IndexerConfig())
    indexer.run()
    profiler = m.SamplingProfiler(m.ProfilerConfig(hz=100))
    profiler.start()
    timeline = m.GaugeTimeline(window_s=60)
    timeline.register("unit", lambda: 42.0, "constant")
    timeline.sample_once(now=time.time())
    server = m.serve(
        indexer,
        host="127.0.0.1",
        port=0,
        profiler=profiler,
        timeline=timeline,
    )
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        yield base
    finally:
        server.shutdown()
        server.server_close()
        profiler.close()
        timeline.close()
        indexer.shutdown()


@pytest.fixture()
def bare_service(m):
    indexer = m.Indexer(m.IndexerConfig())
    indexer.run()
    server = m.serve(indexer, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        yield base
    finally:
        server.shutdown()
        server.server_close()
        indexer.shutdown()


@pytest.fixture()
def off_service(m):
    """The shipped main() wiring with the planes OFF: profiler and
    timeline objects are passed but PROFILE_HZ=0 / TIMELINE_WINDOW_S=0
    — the index must read them disabled and the sampler views 404."""
    indexer = m.Indexer(m.IndexerConfig())
    indexer.run()
    profiler = m.SamplingProfiler(m.ProfilerConfig(hz=0))
    profiler.start()  # no-op by contract
    timeline = m.GaugeTimeline(window_s=0)
    server = m.serve(
        indexer,
        host="127.0.0.1",
        port=0,
        profiler=profiler,
        timeline=timeline,
    )
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        yield base
    finally:
        server.shutdown()
        server.server_close()
        profiler.close()
        timeline.close()
        indexer.shutdown()


class TestDebugEndpoints:
    def test_debug_index_lists_surfaces(self, service):
        payload = _get(service, "/debug/")
        by_path = {s["path"]: s for s in payload["surfaces"]}
        assert by_path["/debug/profile"]["enabled"]
        assert by_path["/debug/timeline"]["enabled"]
        assert by_path["/debug/traces"]["enabled"]
        assert not by_path["/debug/tiering"]["enabled"]
        assert all(s["description"] for s in payload["surfaces"])
        assert "/healthz" in payload["also"]
        # Both spellings resolve.
        assert _get(service, "/debug") == payload

    def test_profile_top(self, service):
        time.sleep(0.3)  # let the sampler accumulate
        payload = _get(service, "/debug/profile")
        assert payload["running"]
        assert payload["samples"] > 0
        assert isinstance(payload["top"], list)

    def test_profile_stacks_collapsed(self, service):
        time.sleep(0.2)
        text = _get(service, "/debug/profile?kind=stacks", as_text=True)
        for line in text.splitlines():
            if line:
                assert line.rsplit(" ", 1)[1].isdigit()

    def test_profile_locks_kind(self, service):
        payload = _get(service, "/debug/profile?kind=locks")
        assert "sample" in payload and "locks" in payload

    def test_profile_bad_kind(self, service):
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(service, "/debug/profile?kind=nope")
        assert err.value.code == 400

    def test_timeline_snapshot_and_filters(self, service):
        payload = _get(service, "/debug/timeline")
        assert payload["series"]["unit"]["points"][0][1] == 42.0
        one = _get(service, "/debug/timeline?series=unit&last=3600")
        assert set(one["series"]) == {"unit"}
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(service, "/debug/timeline?last=abc")
        assert err.value.code == 400

    def test_disabled_surfaces_404(self, bare_service):
        for path in ("/debug/profile", "/debug/timeline"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(bare_service, path)
            assert err.value.code == 404, path
        payload = _get(bare_service, "/debug/")
        by_path = {s["path"]: s for s in payload["surfaces"]}
        assert not by_path["/debug/profile"]["enabled"]
        assert not by_path["/debug/timeline"]["enabled"]
        # The contention table is module-global lockorder state: it
        # answers even with no profiler wired at all.
        locks = _get(bare_service, "/debug/profile?kind=locks")
        assert "locks" in locks

    def test_wired_but_off_reads_disabled(self, off_service):
        # PROFILE_HZ=0 / TIMELINE_WINDOW_S=0 with the objects still
        # wired (the shipped main() path): index says disabled, the
        # sampler views 404 — but ?kind=locks still answers, because
        # LOCK_CONTENTION_SAMPLE arms independently of the sampler.
        payload = _get(off_service, "/debug/")
        by_path = {s["path"]: s for s in payload["surfaces"]}
        assert not by_path["/debug/profile"]["enabled"]
        assert not by_path["/debug/timeline"]["enabled"]
        for path in (
            "/debug/profile",
            "/debug/profile?kind=stacks",
            "/debug/timeline",
        ):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(off_service, path)
            assert err.value.code == 404, path
        locks = _get(off_service, "/debug/profile?kind=locks")
        assert "locks" in locks

    def test_timeline_unknown_series_is_empty(self, service):
        payload = _get(service, "/debug/timeline?series=typo")
        assert payload["series"] == {}
