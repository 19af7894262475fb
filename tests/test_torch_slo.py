"""The port's SLO engine (``obs/slo.py``) against the JAX package's, on
the CPU.

Every case of the reference's ``tests/test_slo.py`` runs on both packages
(``m`` is either one's names): window math, burn rates, envelope state
transitions, the source constructors over each package's own metrics,
the fleet defaults, and the envelope-consistency checker.
"""

import time

import pytest

from llm_d_kv_cache_manager_tpu import cluster as ref_cluster
from llm_d_kv_cache_manager_tpu.metrics import collector as ref_collector
from llm_d_kv_cache_manager_tpu.obs import slo as ref_slo
from tests.helpers.torch_port import namespace

SIDES = ("ref", "port")
_REF = {
    "cluster": ref_cluster,
    "metrics.collector": ref_collector,
    "obs.slo": ref_slo,
}
_NAMES = {
    "cluster": ("LocalCluster",),
    "metrics.collector": ("METRICS", "gauge_value"),
    "obs.slo": ("STATE_DEGRADED", "STATE_HEALTHY", "STATE_VIOLATED", "SloEngine", "SloSpec",
                "counter_label_total", "default_fleet_slos", "envelope_violations",
                "histogram_latency_source", "labeled_gauge_max", "labeled_gauge_sum"),
}


@pytest.fixture(params=SIDES)
def m(request):
    return namespace(request.param, _REF, _NAMES)


class _RatioFeed:
    """Mutable cumulative (good, total) source."""

    def __init__(self):
        self.good = 0.0
        self.total = 0.0

    def add(self, good, bad=0):
        self.good += good
        self.total += good + bad

    def __call__(self):
        return self.good, self.total


class _ValueFeed:
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self):
        return (self.value, 0.0)


def ratio_engine(m, objective=0.9, bound=0.5, fast=10.0, slow=100.0):
    engine = m.SloEngine(window_fast_s=fast, window_slow_s=slow)
    feed = _RatioFeed()
    engine.register(
        m.SloSpec(
            "sli", kind="ratio", objective=objective, degraded_bound=bound
        ),
        feed,
    )
    return engine, feed


class TestSpecValidation:
    def test_ratio_bounds_ordering(self, m):
        with pytest.raises(ValueError):
            m.SloSpec("x", kind="ratio", objective=0.5, degraded_bound=0.9
                      ).validate()

    def test_gauge_bounds_ordering(self, m):
        with pytest.raises(ValueError):
            m.SloSpec("x", kind="gauge", objective=10, degraded_bound=5
                      ).validate()

    def test_unknown_kind(self, m):
        with pytest.raises(ValueError):
            m.SloSpec("x", kind="p99").validate()

    def test_duplicate_sli_rejected(self, m):
        engine, _ = ratio_engine(m)
        with pytest.raises(ValueError):
            engine.register(m.SloSpec("sli"), lambda: (0, 0))

    def test_window_ordering_rejected(self, m):
        with pytest.raises(ValueError):
            m.SloEngine(window_fast_s=100, window_slow_s=10)


class TestWindowMath:
    def test_no_data_is_healthy_and_flagged(self, m):
        engine, _ = ratio_engine(m)
        view = engine.evaluate(now=100.0)["slis"]["sli"]
        assert view["state"] == m.STATE_HEALTHY
        assert view["no_data"] is True
        assert view["value"] is None

    def test_delta_is_windowed_not_lifetime(self, m):
        """Old badness outside the window must not count against the
        current fraction."""
        engine, feed = ratio_engine(m, objective=0.9, bound=0.5)
        feed.add(good=0, bad=100)  # terrible history
        engine.sample(now=0.0)
        feed.add(good=100)  # perfect recent traffic
        engine.sample(now=5.0)
        feed.add(good=100)
        engine.sample(now=9.0)
        view = engine.evaluate(now=9.0)["slis"]["sli"]
        # Fast window (10s) baseline is the t=0 sample: deltas are the
        # 200 good / 200 total recent requests.
        assert view["value"] == 1.0
        assert view["state"] == m.STATE_HEALTHY

    def test_burn_rate_math(self, m):
        engine, feed = ratio_engine(m, objective=0.9, bound=0.0)
        engine.sample(now=0.0)
        feed.add(good=80, bad=20)  # 20% bad over a 10% budget
        engine.sample(now=5.0)
        view = engine.evaluate(now=5.0)["slis"]["sli"]
        assert view["burn_fast"] == pytest.approx(2.0)
        assert view["state"] == m.STATE_DEGRADED

    def test_engine_younger_than_window_uses_oldest_sample(self, m):
        engine, feed = ratio_engine(m, fast=1000.0, slow=10000.0)
        engine.sample(now=0.0)
        feed.add(good=10)
        engine.sample(now=1.0)
        view = engine.evaluate(now=1.0)["slis"]["sli"]
        assert view["value"] == 1.0

    def test_counter_reset_clamps(self, m):
        """A registry restart (cumulative counters falling) must not
        produce a negative fraction."""
        engine, feed = ratio_engine(m)
        feed.add(good=100)
        engine.sample(now=0.0)
        feed.good = 10.0
        feed.total = 10.0
        engine.sample(now=5.0)
        view = engine.evaluate(now=5.0)["slis"]["sli"]
        assert view["no_data"] is True or 0.0 <= view["value"] <= 1.0


class TestStateTransitions:
    def test_ratio_healthy_degraded_violated_and_back(self, m):
        engine, feed = ratio_engine(m, objective=0.9, bound=0.5, fast=10,
                                    slow=20)
        now = 0.0
        engine.sample(now=now)
        feed.add(good=99, bad=1)
        now += 5
        engine.sample(now=now)
        assert engine.evaluate(now=now)["slis"]["sli"]["state"] == (
            m.STATE_HEALTHY
        )
        # Objective breach inside the declared bound -> degraded.
        feed.add(good=70, bad=30)
        now += 5
        engine.sample(now=now)
        payload = engine.evaluate(now=now)
        assert payload["slis"]["sli"]["state"] == m.STATE_DEGRADED
        assert payload["state"] == m.STATE_DEGRADED
        assert m.envelope_violations(payload) == []
        # Bound breach -> violated; the consistency checker flags it.
        now += 25  # age the good history out of both windows
        engine.sample(now=now)
        feed.add(good=10, bad=90)
        now += 5
        engine.sample(now=now)
        payload = engine.evaluate(now=now)
        assert payload["slis"]["sli"]["state"] == m.STATE_VIOLATED
        assert payload["state"] == m.STATE_VIOLATED
        assert m.envelope_violations(payload)
        # Recovery: good traffic ages the badness out again.
        now += 25
        engine.sample(now=now)
        feed.add(good=100)
        now += 5
        engine.sample(now=now)
        assert engine.evaluate(now=now)["slis"]["sli"]["state"] == (
            m.STATE_HEALTHY
        )

    def test_slow_window_bleed_degrades_despite_healthy_fast(self, m):
        engine, feed = ratio_engine(m, objective=0.9, bound=0.1, fast=10,
                                    slow=100)
        engine.sample(now=0.0)
        feed.add(good=50, bad=50)  # bad burst, old
        engine.sample(now=50.0)
        feed.add(good=100)  # recent traffic perfect
        engine.sample(now=95.0)
        view = engine.evaluate(now=95.0)["slis"]["sli"]
        assert view["value"] == 1.0  # fast window is clean
        assert view["value_slow"] < 0.9
        assert view["state"] == m.STATE_DEGRADED

    def test_gauge_states(self, m):
        engine = m.SloEngine(window_fast_s=10, window_slow_s=100)
        feed = _ValueFeed(0.0)
        engine.register(
            m.SloSpec("g", kind="gauge", objective=2.0, degraded_bound=5.0,
                      gauge_agg="last"),
            feed,
        )
        engine.sample(now=0.0)
        assert engine.evaluate(now=0.0)["slis"]["g"]["state"] == (
            m.STATE_HEALTHY
        )
        feed.value = 3.0
        engine.sample(now=1.0)
        assert engine.evaluate(now=1.0)["slis"]["g"]["state"] == (
            m.STATE_DEGRADED
        )
        feed.value = 6.0
        engine.sample(now=2.0)
        payload = engine.evaluate(now=2.0)
        assert payload["slis"]["g"]["state"] == m.STATE_VIOLATED
        assert m.envelope_violations(payload)

    def test_gauge_max_agg_holds_spikes_for_the_window(self, m):
        engine = m.SloEngine(window_fast_s=10, window_slow_s=100)
        feed = _ValueFeed(9.0)
        engine.register(
            m.SloSpec("g", kind="gauge", objective=2.0,
                      degraded_bound=20.0),
            feed,
        )
        engine.sample(now=0.0)
        feed.value = 0.0
        engine.sample(now=5.0)
        # max agg: the 9.0 spike is still inside the fast window.
        assert engine.evaluate(now=5.0)["slis"]["g"]["state"] == (
            m.STATE_DEGRADED
        )
        # Once the spike ages out of the fast window the current value
        # (0.0, via the last-sample fallback) decides.
        assert engine.evaluate(now=50.0)["slis"]["g"]["state"] == (
            m.STATE_HEALTHY
        )

    def test_rate_kind_windows_counter_deltas(self, m):
        engine = m.SloEngine(window_fast_s=10, window_slow_s=100)
        feed = _ValueFeed(0.0)
        engine.register(
            m.SloSpec("failovers", kind="rate", objective=0.0,
                      degraded_bound=2.0),
            feed,
        )
        engine.sample(now=0.0)
        engine.sample(now=5.0)
        assert engine.evaluate(now=5.0)["slis"]["failovers"]["state"] == (
            m.STATE_HEALTHY
        )
        feed.value = 1.0  # one failover in the fast window
        engine.sample(now=6.0)
        assert engine.evaluate(now=6.0)["slis"]["failovers"]["state"] == (
            m.STATE_DEGRADED
        )
        feed.value = 4.0  # three more: past the declared bound
        engine.sample(now=7.0)
        assert engine.evaluate(now=7.0)["slis"]["failovers"]["state"] == (
            m.STATE_VIOLATED
        )
        # The window slides: with no NEW failovers the delta decays.
        engine.sample(now=30.0)
        assert engine.evaluate(now=30.0)["slis"]["failovers"][
            "state"
        ] == m.STATE_HEALTHY


class TestEngineSurface:
    def test_overall_is_worst_sli(self, m):
        engine = m.SloEngine(window_fast_s=10, window_slow_s=100)
        good = _ValueFeed(0.0)
        bad = _ValueFeed(100.0)
        engine.register(
            m.SloSpec("ok", kind="gauge", objective=1, degraded_bound=2),
            good,
        )
        engine.register(
            m.SloSpec("broken", kind="gauge", objective=1,
                      degraded_bound=2),
            bad,
        )
        engine.sample(now=0.0)
        payload = engine.evaluate(now=0.0)
        assert payload["state"] == m.STATE_VIOLATED
        assert payload["slis"]["ok"]["state"] == m.STATE_HEALTHY

    def test_raising_source_is_counted_not_fatal(self, m):
        engine = m.SloEngine(window_fast_s=10, window_slow_s=100)

        def explode():
            raise RuntimeError("source down")

        engine.register(m.SloSpec("s", kind="gauge", objective=1,
                                  degraded_bound=2), explode)
        payload = engine.status(now=0.0)
        assert payload["slis"]["s"]["state"] == m.STATE_HEALTHY
        assert payload["source_errors"]["s"] >= 1

    def test_none_source_means_no_data(self, m):
        engine = m.SloEngine(window_fast_s=10, window_slow_s=100)
        engine.register(
            m.SloSpec("s", kind="gauge", objective=1, degraded_bound=2),
            lambda: None,
        )
        engine.sample(now=0.0)
        assert engine.evaluate(now=0.0)["slis"]["s"]["no_data"] is True

    def test_healthz_block_lists_unhealthy_slis(self, m):
        engine = m.SloEngine(window_fast_s=10, window_slow_s=100)
        engine.register(
            m.SloSpec("burning", kind="gauge", objective=0.0,
                      degraded_bound=10.0),
            _ValueFeed(5.0),
        )
        block = engine.healthz_block()
        assert block["state"] == m.STATE_DEGRADED
        assert block["degraded"] == ["burning"]

    def test_state_gauge_exported(self, m):
        engine = m.SloEngine(window_fast_s=10, window_slow_s=100)
        engine.register(
            m.SloSpec("exported_sli", kind="gauge", objective=0.0,
                      degraded_bound=1.0),
            _ValueFeed(0.5),
        )
        engine.sample(now=0.0)
        engine.evaluate(now=0.0)
        sample_value = None
        for metric in m.METRICS.slo_state.collect():
            for sample in metric.samples:
                if sample.labels.get("sli") == "exported_sli":
                    sample_value = sample.value
        assert sample_value == 1.0  # degraded
        assert m.gauge_value is not None  # helper importable

    def test_sample_retention_is_bounded(self, m):
        engine, feed = ratio_engine(m, fast=10, slow=20)
        for i in range(1000):
            feed.add(good=1)
            engine.sample(now=float(i))
        view = engine.evaluate(now=999.0)["slis"]["sli"]
        assert view["samples"] <= 30  # pruned to ~slow window span

    def test_background_loop_starts_and_stops(self, m):
        engine, feed = ratio_engine(m)
        feed.add(good=5)
        engine.start(poll_interval_s=0.01)
        deadline = time.time() + 5
        while time.time() < deadline:
            if engine.evaluate()["slis"]["sli"]["samples"] >= 2:
                break
            time.sleep(0.01)
        engine.close()
        assert engine.evaluate()["slis"]["sli"]["samples"] >= 2

    def test_start_after_close_restarts_polling(self, m):
        """close() sets the stop flag; a later start() must clear it
        or the new thread exits on its first wait and polling silently
        dies."""
        engine, feed = ratio_engine(m)
        engine.start(poll_interval_s=0.01)
        engine.close()
        before = engine.evaluate()["slis"]["sli"]["samples"]
        feed.add(good=1)
        engine.start(poll_interval_s=0.01)
        deadline = time.time() + 5
        grew = False
        while time.time() < deadline:
            if engine.evaluate()["slis"]["sli"]["samples"] > before:
                grew = True
                break
            time.sleep(0.01)
        engine.close()
        assert grew, "restarted loop never sampled"

    def test_healthz_block_serves_cached_evaluation(self, m):
        """A liveness probe must not re-sample every source per hit:
        healthz_block serves the LAST evaluation (with its timestamp),
        falling back to a full pass only when none has run."""
        engine = m.SloEngine(window_fast_s=10, window_slow_s=100)
        calls = {"n": 0}

        def source():
            calls["n"] += 1
            return (0.0, 0.0)

        engine.register(
            m.SloSpec("s", kind="gauge", objective=1, degraded_bound=2),
            source,
        )
        engine.sample(now=0.0)
        engine.evaluate(now=0.0)
        sampled = calls["n"]
        block = engine.healthz_block()
        assert block["evaluated_unix"] == 0.0
        assert calls["n"] == sampled  # no re-sampling on the hit


class TestSources:
    def test_histogram_latency_source_good_total(self, m):
        from prometheus_client import CollectorRegistry, Histogram

        registry = CollectorRegistry()
        hist = Histogram(
            "t_latency_seconds", "t", registry=registry,
            buckets=(0.01, 0.1, 1.0),
        )
        source = m.histogram_latency_source(hist, 0.1)
        hist.observe(0.005)
        hist.observe(0.05)
        hist.observe(0.5)
        good, total = source()
        assert total == 3.0
        assert good == 2.0  # <= the 0.1 bucket

    def test_histogram_threshold_between_buckets_rounds_down(self, m):
        """A threshold between bounds must undercount good, never
        round up to the next bucket (a service 60% over the objective
        would otherwise read 100% healthy)."""
        from prometheus_client import CollectorRegistry, Histogram

        registry = CollectorRegistry()
        hist = Histogram(
            "t3_latency_seconds", "t", registry=registry,
            buckets=(0.1, 0.25),
        )
        hist.observe(0.24)  # over a 0.15 objective, inside le=0.25
        good, total = m.histogram_latency_source(hist, 0.15)()
        assert (good, total) == (0.0, 1.0)  # NOT (1.0, 1.0)
        hist.observe(0.05)
        good, total = m.histogram_latency_source(hist, 0.15)()
        assert (good, total) == (1.0, 2.0)

    def test_histogram_threshold_above_finite_buckets_clamps_down(self, m):
        """The +Inf bucket must never satisfy the threshold — it would
        report a 100%-healthy latency SLI however slow the service
        got.  Past the widest finite bucket the source clamps DOWN
        (good undercounts, never overcounts)."""
        from prometheus_client import CollectorRegistry, Histogram

        registry = CollectorRegistry()
        hist = Histogram(
            "t2_latency_seconds", "t", registry=registry,
            buckets=(0.01,),
        )
        hist.observe(5.0)  # lands only in +Inf
        good, total = m.histogram_latency_source(hist, 100.0)()
        assert (good, total) == (0.0, 1.0)
        hist.observe(0.005)  # inside the widest finite bucket
        good, total = m.histogram_latency_source(hist, 100.0)()
        assert (good, total) == (1.0, 2.0)

    def test_counter_label_total_filters(self, m):
        from prometheus_client import CollectorRegistry, Counter

        registry = CollectorRegistry()
        counter = Counter(
            "t_requests", "t", ("outcome",), registry=registry
        )
        counter.labels(outcome="hit").inc(3)
        counter.labels(outcome="miss").inc(2)
        assert m.counter_label_total(counter, outcome="hit") == 3.0
        assert m.counter_label_total(counter) == 5.0

    def test_labeled_gauge_sum_and_max(self, m):
        from prometheus_client import CollectorRegistry, Gauge

        registry = CollectorRegistry()
        gauge = Gauge("t_backlog", "t", ("pod",), registry=registry)
        gauge.labels(pod="a").set(3)
        gauge.labels(pod="b").set(7)
        assert m.labeled_gauge_sum(gauge) == 10.0
        assert m.labeled_gauge_max(gauge) == 7.0


class TestDefaultFleetSlos:
    def test_constructs_and_evaluates_against_live_metrics(self, m):
        engine = m.default_fleet_slos(window_fast_s=1.0, window_slow_s=2.0)
        payload = engine.status()
        assert "score_latency" in payload["slis"]
        assert "hit_rate" in payload["slis"]
        assert payload["state"] in (
            m.STATE_HEALTHY, m.STATE_DEGRADED, m.STATE_VIOLATED,
        )

    def test_membership_slis_follow_a_kill(self, m):
        cluster = m.LocalCluster()
        try:
            engine = m.default_fleet_slos(
                window_fast_s=60.0,
                window_slow_s=120.0,
                membership=cluster.membership,
            )
            now = time.time()
            engine.sample(now=now)
            payload = engine.evaluate(now=now)
            assert payload["slis"]["replicas_dead"]["state"] == (
                m.STATE_HEALTHY
            )
            cluster.kill("replica-0")
            engine.sample(now=now + 1)
            payload = engine.evaluate(now=now + 1)
            assert payload["slis"]["replicas_dead"]["state"] == (
                m.STATE_DEGRADED
            )
            assert payload["slis"]["failovers"]["state"] == (
                m.STATE_DEGRADED
            )
            # Degraded-with-bound, not violated, for the SLIs this
            # test controls.  (Other default SLIs read process-global
            # gauges — e.g. pod backlog — that unrelated tests may
            # have inflated, so the check is scoped, not engine-wide.)
            violations = m.envelope_violations(payload)
            assert not [
                v
                for v in violations
                if v.startswith(("replicas_dead", "failovers"))
            ], violations
        finally:
            cluster.close()

    def test_hit_rate_objective_zero_is_informational(self, m):
        engine = m.default_fleet_slos(window_fast_s=1.0, window_slow_s=2.0)
        view = engine.status()["slis"]["hit_rate"]
        assert view["objective"] == 0.0
        assert view["state"] == m.STATE_HEALTHY
