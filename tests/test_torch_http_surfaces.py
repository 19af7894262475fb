"""The port's ``/debug/cachestats`` and ``/metrics`` surfaces against the
JAX package's, on the CPU.

Every case of the reference's ``tests/test_cache_analytics.py::
TestDebugCachestatsEndpoint`` and of ``tests/test_metrics_endpoint.py``
runs on both packages, each through that package's own ``serve()``,
``Indexer``, ledger, auditor and metrics collector, and holds each to
that test's expectations.  Where a case builds its own metric families,
the reference's come from ``prometheus_client`` and the port's from its
own registry (``metrics/collector.py``), which needs no
``prometheus_client``.
"""

from __future__ import annotations

import gc
import json
import logging
import re
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import prometheus_client
import pytest

from llm_d_kv_cache_manager_tpu.analytics import auditor as ref_auditor
from llm_d_kv_cache_manager_tpu.analytics import ledger as ref_ledger
from llm_d_kv_cache_manager_tpu.api import http_service as ref_http
from llm_d_kv_cache_manager_tpu.kvcache import indexer as ref_indexer
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import index as ref_index
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as ref_tp
from llm_d_kv_cache_manager_tpu.kvevents import resync as ref_resync
from llm_d_kv_cache_manager_tpu.metrics import collector as ref_collector
from llm_d_kv_cache_manager_tpu.tokenization import pool as ref_tok_pool
from llm_d_kv_cache_manager_tpu.tokenization import tokenizers as ref_tokenizers
from tests.helpers.tiny_tokenizer import save_tokenizer_json
from tests.helpers.torch_port import port

SIDES = ("ref", "port")
BLOCK_SIZE = 4
_REF = dict(auditor=ref_auditor, ledger=ref_ledger, http=ref_http, indexer=ref_indexer,
            index=ref_index, tp=ref_tp, resync=ref_resync, collector=ref_collector,
            tok_pool=ref_tok_pool, tokenizers=ref_tokenizers, prom=prometheus_client)
_PORT = dict(auditor="analytics.auditor", ledger="analytics.ledger", http="api.http_service",
             indexer="kvcache.indexer", index="kvcache.kvblock.index",
             tp="kvcache.kvblock.token_processor", resync="kvevents.resync",
             collector="metrics.collector", tok_pool="tokenization.pool",
             tokenizers="tokenization.tokenizers", prom="metrics.collector")


def mods(side: str) -> SimpleNamespace:
    if side == "ref":
        return SimpleNamespace(side=side, **_REF)
    return SimpleNamespace(side=side, **{k: port(v) for k, v in _PORT.items()})


@pytest.fixture(params=SIDES)
def m(request):
    return mods(request.param)


def http_json(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as response:
        return response.status, json.load(response)


def post_score(base, prompt, model, headers=None):
    request = urllib.request.Request(
        base + "/score_completions",
        data=json.dumps({"prompt": prompt, "model": model}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    with urllib.request.urlopen(request, timeout=10) as response:
        return json.load(response)


# ------------------------------------------------ /debug/cachestats

ANALYTICS_MODEL = "analytics-model"


class WordTokenizer:
    """Deterministic whitespace tokenizer: 'tN' -> N."""

    def __init__(self, m):
        self._encoding = m.tokenizers.Encoding

    def type(self) -> str:
        return "word"

    def encode(self, prompt, model_name, add_special_tokens=True):
        tokens, offsets, pos = [], [], 0
        for word in prompt.split(" "):
            tokens.append(int(word[1:]))
            offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return self._encoding(tokens, offsets)


@pytest.fixture()
def analytics_service(m, tmp_path):
    ledger = m.ledger.CacheStatsLedger(m.ledger.LedgerConfig(sample_rate=1.0, tier_sample=1))
    tokenizer_dir = save_tokenizer_json(str(tmp_path), ANALYTICS_MODEL)
    indexer = m.indexer.Indexer(
        m.indexer.IndexerConfig(
            token_processor_config=m.tp.TokenProcessorConfig(block_size=BLOCK_SIZE),
            tokenizers_pool_config=m.tok_pool.TokenizationPoolConfig(
                workers=2, model_name=ANALYTICS_MODEL)),
        tokenizer=m.tokenizers.LocalFastTokenizer(tokenizer_dir),
        cache_stats_ledger=ledger)
    indexer.run()
    source_state = {}

    def fetch(pod_id):
        fn = source_state.get(pod_id)
        return fn() if fn else None

    auditor = m.auditor.IndexAuditor(indexer.kv_block_index, indexer.token_processor,
                                     m.resync.CallableInventorySource(fetch),
                                     m.auditor.AuditorConfig(interval_s=0.0))
    server = m.http.serve(indexer, host="127.0.0.1", port=0, auditor=auditor)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    yield base, indexer, auditor, source_state
    server.shutdown()
    server.server_close()
    indexer.shutdown()


def test_cachestats_endpoint_and_healthz(m, analytics_service):
    """``TestDebugCachestatsEndpoint.test_endpoint_and_healthz``."""
    base, indexer, auditor, _ = analytics_service
    prompt = "the quick brown fox jumps over the lazy dog . " * 4
    tokens = indexer.tokenization_pool.tokenize(prompt, ANALYTICS_MODEL, None)
    keys = indexer.token_processor.tokens_to_kv_block_keys(0, tokens, ANALYTICS_MODEL)
    indexer.kv_block_index.add(keys, keys, [m.index.PodEntry("pod-1", "hbm")])
    for _ in range(2):
        post_score(base, prompt, ANALYTICS_MODEL)
    status, stats = http_json(base, "/debug/cachestats")
    assert status == 200
    assert stats["totals"]["recorded"] == 2
    assert stats["totals"]["hits"] >= 1
    assert stats["windows"]["1m"]["requests"] == 2
    family_id = stats["top_families"][0]["family"]
    status, detail = http_json(base, f"/debug/cachestats?family={family_id}")
    assert status == 200 and detail["family"] == family_id
    # Unknown family -> 404; bad hex -> 400.
    with pytest.raises(urllib.error.HTTPError) as err:
        http_json(base, "/debug/cachestats?family=00000000000000ff")
    assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        http_json(base, "/debug/cachestats?family=zzz")
    assert err.value.code == 400
    status, health = http_json(base, "/healthz")
    assert health["analytics"]["cachestats"]["recorded"] == 2
    assert "audit" in health["analytics"]


def test_cachestats_disabled_ledger_404s(m):
    """``TestDebugCachestatsEndpoint.test_disabled_ledger_404s``."""
    indexer = m.indexer.Indexer(
        m.indexer.IndexerConfig(
            token_processor_config=m.tp.TokenProcessorConfig(block_size=BLOCK_SIZE),
            tokenizers_pool_config=m.tok_pool.TokenizationPoolConfig(
                workers=1, model_name=ANALYTICS_MODEL),
            cache_stats=False),
        tokenizer=WordTokenizer(m))
    indexer.run()
    server = m.http.serve(indexer, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            http_json(base, "/debug/cachestats")
        assert err.value.code == 404
        # healthz answers without an analytics block.
        _, health = http_json(base, "/healthz")
        assert "analytics" not in health
    finally:
        server.shutdown()
        server.server_close()
        indexer.shutdown()


# ------------------------------------------------------------- /metrics

MODEL = "test-model"
PROMPT = "the quick brown fox jumps over the lazy dog . " * 8
SAMPLED_TP = "00-" + "1f" * 16 + "-" + "2d" * 8 + "-01"


@pytest.fixture()
def service(m, tmp_path):
    # The metrics-wrapped index has no version vector, so the Indexer
    # latches the process-wide ``score_memo_disabled`` gauge; put it
    # back afterwards for the tests that run later in this process.
    memo_gauge = m.collector.METRICS.score_memo_disabled
    memo_before = m.collector.gauge_value(memo_gauge)
    tokenizer_dir = save_tokenizer_json(str(tmp_path), MODEL)
    indexer = m.indexer.Indexer(
        m.indexer.IndexerConfig(
            token_processor_config=m.tp.TokenProcessorConfig(block_size=BLOCK_SIZE),
            # InstrumentedIndex wrapper: lookups feed the counters.
            kvblock_index_config=m.index.IndexConfig(enable_metrics=True),
            tokenizers_pool_config=m.tok_pool.TokenizationPoolConfig(workers=2,
                                                                     model_name=MODEL),
            # Composite tokenizer via auto-discovery so the real
            # tokenization_latency{tokenizer=...} path is exercised.
            local_tokenizers_dir=tokenizer_dir))
    indexer.run()
    server = m.http.serve(indexer, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    yield base
    server.shutdown()
    server.server_close()
    indexer.shutdown()
    memo_gauge.set(memo_before)


def fetch_metrics(base):
    with urllib.request.urlopen(base + "/metrics", timeout=10) as response:
        return response.headers.get("Content-Type"), response.read().decode()


def sample_value(text, name, label_substr=""):
    """Sum of exposition samples matching name (+ label substring)."""
    total, seen = 0.0, False
    for line in text.splitlines():
        if line.startswith(name) and label_substr in line:
            total += float(line.rsplit(" ", 1)[1])
            seen = True
    return total if seen else None


class TestMetricsEndpoint:
    def test_exposition_content_type(self, service):
        content_type, _ = fetch_metrics(service)
        assert content_type.startswith("text/plain")
        assert "version=0.0.4" in content_type

    def test_scoring_request_moves_lookup_counter(self, service):
        name = "kvtpu_kvcache_index_lookup_requests_total"
        _, before_text = fetch_metrics(service)
        before = sample_value(before_text, name) or 0.0
        post_score(service, PROMPT, MODEL)
        _, after_text = fetch_metrics(service)
        assert sample_value(after_text, name) == before + 1

    def test_stage_histogram_appears_with_stage_labels(self, service):
        name = "kvtpu_stage_latency_seconds_count"
        _, before_text = fetch_metrics(service)
        stages = ("tokenize", "hash_blocks", "index_lookup", "score")
        before = {stage: sample_value(before_text, name, f'stage="{stage}"') or 0.0
                  for stage in stages}
        # A sampled traceparent forces the trace that feeds the histogram.
        post_score(service, PROMPT, MODEL, headers={"traceparent": SAMPLED_TP})
        _, after_text = fetch_metrics(service)
        for stage, prior in before.items():
            assert sample_value(after_text, name, f'stage="{stage}"') == prior + 1, stage

    def test_tokenization_latency_has_sub_ms_buckets(self, service):
        post_score(service, PROMPT, MODEL)
        _, text = fetch_metrics(service)
        bucket_lines = [line for line in text.splitlines()
                        if line.startswith("kvtpu_tokenization_latency_seconds_bucket")]
        assert bucket_lines, "histogram never observed"
        les = {re.search(r'le="([^"]+)"', line).group(1) for line in bucket_lines}
        # Sub-millisecond resolution (Prometheus defaults start at 5ms).
        assert {"5e-05", "0.0001", "0.00025", "0.0005", "0.001"} <= les


class TestExpositionHardening:
    def test_label_values_escaped_per_text_format(self, m, service):
        c = m.collector
        hostile = 'pod"quote\\back'
        assert c.safe_label(hostile) == hostile
        c.METRICS.kvevents_pod_shed.labels(pod=c.safe_label(hostile)).inc()
        _, text = fetch_metrics(service)
        # Prometheus text format: \ -> \\ then " -> \" inside quotes.
        assert 'pod="pod\\"quote\\\\back"' in text

    def test_newline_label_escaped_at_exposition(self, m):
        registry = m.prom.CollectorRegistry()
        counter = m.prom.Counter("t_esc", "d.", ("who",), registry=registry)
        counter.labels(who="a\nb").inc()
        text = m.prom.generate_latest(registry).decode()
        assert 'who="a\\nb"' in text
        sample_lines = [line for line in text.splitlines() if line.startswith("t_esc")]
        assert all("a\\nb" in line for line in sample_lines if "who" in line)

    def test_safe_label_bounds_and_sanitizes(self, m):
        c = m.collector
        assert c.safe_label("pod-7") == "pod-7"
        cleaned = c.safe_label("a\x00b\x1fc\x7fd")
        assert "\x00" not in cleaned and "\x7f" not in cleaned
        assert cleaned == "a�b�c�d"
        long = c.safe_label("x" * 1000)
        assert len(long) == c.MAX_LABEL_LEN
        assert long.endswith("…")

    def test_concurrent_scrape_vs_write_contract(self, m, service):
        """Scrapes while labeled families churn always parse: every
        sample line is name{labels} value, no torn lines, no duplicate
        HELP per family."""
        metrics = m.collector.METRICS
        stop = threading.Event()
        errors = []

        def writer(i):
            n = 0
            while not stop.is_set():
                metrics.kvevents_pod_shed.labels(pod=f"w{i}-pod{n % 7}").inc()
                metrics.kvevents_pod_backlog.labels(pod=f"w{i}-pod{n % 7}").set(n)
                metrics.kvevents_dropped.labels(reason="queue_full").inc()
                n += 1

        threads = [threading.Thread(target=writer, args=(i,), daemon=True) for i in range(4)]
        for t in threads:
            t.start()
        try:
            line_re = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [-+0-9.eEinfNa]+$')
            for _ in range(10):
                _, text = fetch_metrics(service)
                seen_help = set()
                for line in text.splitlines():
                    if not line:
                        continue
                    if line.startswith("# HELP "):
                        name = line.split(" ", 3)[2]
                        if name in seen_help:
                            errors.append(f"duplicate HELP for {name}")
                        seen_help.add(name)
                        continue
                    if line.startswith("#"):
                        continue
                    if not line_re.match(line):
                        errors.append(f"unparseable sample line: {line!r}")
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:5]


class TestCollectorHelpers:
    def test_counter_total_sums_labeled_counter(self, m):
        registry = m.prom.CollectorRegistry()
        counter = m.prom.Counter("t_dropped", "d.", ("reason",), registry=registry)
        assert m.collector.counter_total(counter) == 0.0  # no children yet
        counter.labels(reason="a").inc(2)
        counter.labels(reason="b").inc(3)
        assert m.collector.counter_total(counter) == 5.0

    def test_counter_total_unlabeled(self, m):
        registry = m.prom.CollectorRegistry()
        counter = m.prom.Counter("t_plain", "d.", registry=registry)
        counter.inc(4)
        assert m.collector.counter_total(counter) == 4.0

    def test_gauge_value(self, m):
        registry = m.prom.CollectorRegistry()
        gauge = m.prom.Gauge("t_gauge", "d.", registry=registry)
        assert m.collector.gauge_value(gauge) == 0.0
        gauge.set(17)
        assert m.collector.gauge_value(gauge) == 17.0

    def test_beat_survives_labeled_counters_and_reports_drops(self, m):
        """The beat line does not crash on the labeled kvevents_dropped
        counter and carries the dropped-events, journal-lag and process
        fields."""
        m.collector.METRICS.kvevents_dropped.labels(reason="queue_full").inc()
        records = []

        class Capture(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        handler = Capture()
        beat_logger = logging.getLogger("kvtpu.metrics")
        beat_logger.addHandler(handler)
        stop = m.collector.start_metrics_logging(0.05)
        try:
            deadline = time.time() + 5
            while not records and time.time() < deadline:
                time.sleep(0.02)
        finally:
            stop.set()
            beat_logger.removeHandler(handler)
        assert records, "beat never fired"
        for field in ("dropped_events=", "journal_lag=", "rss_mb=", "threads=", "gc="):
            assert field in records[0], field

    def test_gauge_total_sums_labeled_gauge(self, m):
        registry = m.prom.CollectorRegistry()
        gauge = m.prom.Gauge("t_backlog", "d.", ("pod",), registry=registry)
        assert m.collector.gauge_total(gauge) == 0.0
        gauge.labels(pod="a").set(3)
        gauge.labels(pod="b").set(4)
        assert m.collector.gauge_total(gauge) == 7.0


class TestProcessRuntimeMetrics:
    def test_update_sets_gauges(self, m):
        c = m.collector
        values = c.update_process_metrics()
        assert values["rss_bytes"] > 0
        assert values["open_fds"] > 0
        assert values["threads"] >= 1
        assert c.gauge_value(c.METRICS.process_rss) == values["rss_bytes"]
        assert c.gauge_value(c.METRICS.process_threads) == values["threads"]

    def test_gc_callbacks_count_collections(self, m):
        c = m.collector
        assert c.install_gc_metrics()
        assert c.install_gc_metrics()  # idempotent
        try:
            before = c.counter_total(c.METRICS.gc_collections)
            pause_before = c.METRICS.gc_pause.collect()[0].samples
            gc.collect()
            assert c.counter_total(c.METRICS.gc_collections) > before

            def hist_count(samples):
                return sum(s.value for s in samples if s.name.endswith("_count"))

            assert hist_count(c.METRICS.gc_pause.collect()[0].samples) > hist_count(pause_before)
            text = c.METRICS.exposition().decode()
            assert 'kvtpu_gc_collections_total{gen="2"}' in text
        finally:
            c.uninstall_gc_metrics()

    def test_process_gauges_exposed(self, m):
        c = m.collector
        c.update_process_metrics()
        text = c.METRICS.exposition().decode()
        for name in ("kvtpu_process_rss_bytes", "kvtpu_process_open_fds",
                     "kvtpu_process_threads"):
            assert name in text
