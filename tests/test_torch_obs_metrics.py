"""The port's observability layer against the JAX package's, on the CPU:
the lock-order watchdog (tests/test_lockorder.py's cases, each run on
both packages, every violation reported with the same message), a traced
request's span tree through both Indexers, the W3C traceparent helpers,
the flight recorder, and the metrics: for the same observations the
port's own exposition and the reference's ``prometheus_client`` one
parse, through ``prometheus_client.parser``, to the same samples."""

import os
import subprocess
import sys
import threading

import pytest
from prometheus_client.parser import text_string_to_metric_families

from llm_d_kv_cache_manager_tpu.kvcache import indexer as jax_indexer
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import index as jax_index
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as jax_tp
from llm_d_kv_cache_manager_tpu.metrics import collector as jax_collector
from llm_d_kv_cache_manager_tpu.obs import recorder as jax_recorder
from llm_d_kv_cache_manager_tpu.obs import trace as jax_trace
from llm_d_kv_cache_manager_tpu.tokenization import tokenizers as jax_tokenizers
from llm_d_kv_cache_manager_tpu.utils import lockorder as jax_lockorder
from tests.helpers.torch_port import PACKAGE, port

lockorder = port("utils.lockorder")
collector = port("metrics.collector")
trace_mod = port("obs.trace")
recorder = port("obs.recorder")

WATCHDOGS = {"jax": jax_lockorder, "port": lockorder}


# ------------------------------------------------------------ lock order


def _tracked(mod, kind, name, rank=None):
    lock = {"lock": threading.Lock, "rlock": threading.RLock,
            "cond": threading.Condition}[kind]()
    return mod.tracked(lock, name) if rank is None else mod.tracked(lock, name, rank=rank)


def _run_in_thread(fn):
    errors = []

    def body():
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    thread = threading.Thread(target=body, name="lockorder-case")
    thread.start()
    thread.join(timeout=5)
    assert not thread.is_alive()
    if errors:
        raise errors[0]


def _nest(mod, outer, inner):
    """Hold ``outer``, then acquire ``inner``; returns what is held at the
    innermost point, or raises the watchdog's violation."""
    with outer:
        with inner:
            return [name for name, _ in mod.held()]


CASES = {
    # name: (declarations, body) -> held lock names or a violation
    "declared_direction": (
        lambda m: m.declare_order("T.outer", "T.inner"),
        lambda m: _nest(m, _tracked(m, "lock", "T.outer"), _tracked(m, "lock", "T.inner"))),
    "inversion": (
        lambda m: m.declare_order("T.outer", "T.inner"),
        lambda m: _nest(m, _tracked(m, "lock", "T.inner"), _tracked(m, "lock", "T.outer"))),
    "ascending_ranks": (
        lambda m: m.declare_ascending("T.shard"),
        lambda m: _nest(m, _tracked(m, "lock", "T.shard", 0), _tracked(m, "lock", "T.shard", 2))),
    "descending_ranks": (
        lambda m: m.declare_ascending("T.shard"),
        lambda m: _nest(m, _tracked(m, "lock", "T.shard", 2), _tracked(m, "lock", "T.shard", 1))),
    "equal_rank": (
        lambda m: m.declare_ascending("T.shard"),
        lambda m: _nest(m, _tracked(m, "lock", "T.shard", 1), _tracked(m, "lock", "T.shard", 1))),
    "unranked_nesting": (
        lambda m: m.declare_ascending("T.shard"),
        lambda m: _nest(m, _tracked(m, "lock", "T.shard"), _tracked(m, "lock", "T.shard"))),
    "undeclared_same_name": (
        lambda m: None,
        lambda m: _nest(m, _tracked(m, "lock", "T.undeclared", 0),
                        _tracked(m, "lock", "T.undeclared", 1))),
    "self_reacquire": (
        lambda m: None,
        lambda m: (lambda lock: _nest(m, lock, lock))(_tracked(m, "lock", "T.lock"))),
    "rlock_reenters": (
        lambda m: None,
        lambda m: (lambda lock: _nest(m, lock, lock))(_tracked(m, "rlock", "T.rlock"))),
    "other_thread_holds_nothing": (
        lambda m: m.declare_order("T.a", "T.b"),
        lambda m: (lambda a, b: _nest(m, a, _ThreadAcquire(m, b)))(
            _tracked(m, "lock", "T.a"), _tracked(m, "lock", "T.b"))),
    "inversion_in_thread": (
        lambda m: m.declare_order("T.first", "T.second"),
        lambda m: _run_in_thread(lambda: _nest(m, _tracked(m, "lock", "T.second"),
                                               _tracked(m, "lock", "T.first")))),
}


class _ThreadAcquire:
    """A context manager that takes ``lock`` on another thread (which
    holds nothing) and lets it go."""

    def __init__(self, mod, lock):
        self._mod, self._lock = mod, lock

    def __enter__(self):
        _run_in_thread(lambda: self._lock.acquire() and self._lock.release())

    def __exit__(self, *exc):
        return False


@pytest.fixture()
def armed():
    """Both watchdogs on, their declaration registries restored after."""
    saved = {}
    for name, mod in WATCHDOGS.items():
        saved[name] = (mod.enable(True), set(mod._ordered_pairs), set(mod._ascending))
    try:
        yield
    finally:
        for name, mod in WATCHDOGS.items():
            previous, pairs, ascending = saved[name]
            mod.enable(previous)
            mod._ordered_pairs.clear()
            mod._ordered_pairs.update(pairs)
            mod._ascending.clear()
            mod._ascending.update(ascending)


@pytest.mark.parametrize("case", list(CASES))
def test_lock_order_reports_match_reference(armed, case):
    """Each case on both watchdogs: the same outcome, and a violation
    with the same type name and message; nothing is left held."""
    declare, body = CASES[case]
    outcomes = {}
    for name, mod in WATCHDOGS.items():
        declare(mod)
        try:
            outcomes[name] = ("ok", body(mod))
        except AssertionError as exc:
            outcomes[name] = (type(exc).__name__, str(exc))
        assert mod.held() == []
    assert outcomes["port"] == outcomes["jax"]
    violation = case not in ("declared_direction", "ascending_ranks", "rlock_reenters",
                             "other_thread_holds_nothing")
    assert (outcomes["port"][0] == "LockOrderViolation") == violation, outcomes["port"]


def test_lock_order_gate_matches_reference(armed):
    """Disabled, ``tracked`` hands the lock back unchanged; the gate is
    the same environment variable in a fresh interpreter."""
    for mod in WATCHDOGS.values():
        mod.enable(False)
        lock = threading.Lock()
        assert mod.tracked(lock, "X._lock") is lock
    script = ("import importlib, sys; "
              "print([importlib.import_module(p + '.utils.lockorder').enabled() "
              "for p in sys.argv[1:]])")
    for value, want in (("1", True), ("", False)):
        env = dict(os.environ, KVTPU_LOCK_ORDER_DEBUG=value)
        out = subprocess.run([sys.executable, "-c", script, "llm_d_kv_cache_manager_tpu",
                              PACKAGE], capture_output=True, text=True, timeout=60, env=env,
                             cwd=os.path.dirname(os.path.dirname(__file__)))
        assert out.stdout.strip() == str([want, want]), out.stderr


def test_port_index_runs_under_the_watchdog(armed):
    """The port's in-memory index and LRU take their locks in the
    declared order on every cross-shard walk."""
    index_mod, in_memory = port("kvcache.kvblock.index"), port("kvcache.kvblock.in_memory")
    index = in_memory.InMemoryIndex(index_mod.InMemoryIndexConfig(size=64, shards=4))
    keys = list(range(16))
    index.add(keys, keys, [index_mod.PodEntry("pod-a", "hbm")])
    index.lookup(keys)
    index.touch_chain(keys)
    entries, engine_map = index.dump_entries()
    index.restore_entries(entries, engine_map)
    assert index.purge_pod_keys("pod-a", keys[:4]) == 4
    assert index.purge_pod("pod-a") == 12
    assert lockorder.held() == []


# ----------------------------------------------------------------- spans


class WordTokenizer:
    def __init__(self, encoding):
        self._encoding = encoding

    def type(self):
        return "test-word"

    def encode(self, prompt, model_name, add_special_tokens):
        tokens, offsets, pos = [], [], 0
        for word in prompt.split(" "):
            tokens.append(int(word[1:]))
            offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return self._encoding(tokens=tokens, offsets=offsets)


def _span_tree(indexer_mod, index_mod, tp_mod, tracing, encoding, fast):
    indexer = indexer_mod.Indexer(
        indexer_mod.IndexerConfig(
            token_processor_config=tp_mod.TokenProcessorConfig(block_size=4),
            read_path_fast_lane=fast, cache_stats=False),
        tokenizer=WordTokenizer(encoding))
    indexer.run()
    try:
        tokens = list(range(1, 200))
        keys = indexer.token_processor.tokens_to_kv_block_keys(0, tokens, "m")
        indexer.kv_block_index.add(keys[:30], keys[:30], [index_mod.PodEntry("pod-a", "hbm")])
        indexer.kv_block_index.add(keys[:9], keys[:9], [index_mod.PodEntry("pod-b", "host")])
        prompt = " ".join(f"t{t}" for t in tokens)
        trees = []
        for _ in range(2):  # a full encode, then a prefix-store hit
            trace = tracing.TRACER.start_trace("score", force=True)
            with tracing.use_trace(trace):
                scores = indexer.get_pod_scores(prompt, "m", ["pod-a", "pod-b"])
            trace.finish()
            spans = trace.to_dict()["spans"]
            trees.append((scores, sorted(
                (s["name"], s["parent"], s["status"], sorted(s["attributes"].items()))
                for s in spans)))
        return trees
    finally:
        indexer.shutdown()


@pytest.mark.parametrize("fast", [True, False], ids=["fast_lane", "straight"])
def test_traced_request_span_tree_matches_reference(fast):
    """Names, parents, status and attributes of every span of a traced
    request (not ids or times), cold and warm, on both Indexers."""
    ours = _span_tree(port("kvcache.indexer"), port("kvcache.kvblock.index"),
                      port("kvcache.kvblock.token_processor"), trace_mod,
                      port("tokenization.tokenizers").Encoding, fast)
    ref = _span_tree(jax_indexer, jax_index, jax_tp, jax_trace, jax_tokenizers.Encoding, fast)
    assert ours == ref
    names = {name for name, *_ in ours[0][1]}
    assert {"tokenize", "tokenize.prefix_probe", "tokenize.encode", "hash_blocks",
            "index_lookup", "score"} <= names


TRACEPARENTS = [None, "", "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
                "00-" + "a" * 32 + "-" + "b" * 16 + "-00", "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
                "00-" + "0" * 32 + "-" + "b" * 16 + "-01", "01-" + "A" * 32 + "-" + "c" * 16
                + "-03-extra", "00-" + "a" * 32 + "-" + "b" * 16 + "-01-extra", "garbage"]


def test_traceparent_and_recorder_match_reference():
    for header in TRACEPARENTS:
        assert trace_mod.parse_traceparent(header) == jax_trace.parse_traceparent(header)
    assert trace_mod.format_traceparent("a" * 32, "b" * 16, False) == (
        jax_trace.format_traceparent("a" * 32, "b" * 16, False))
    recs = [mod.FlightRecorder(ring_size=4, slow_keep=2, error_keep=2, slow_threshold_ms=5.0)
            for mod in (jax_recorder, recorder)]
    tracers = (jax_trace, trace_mod)
    for i in range(9):
        for rec, tracing in zip(recs, tracers):
            trace = tracing.Trace(f"t{i}", f"{i:032x}", "1" * 16, rec)
            trace.start -= i * 0.002  # durations 0, 2, 4, ... ms
            if i % 3 == 0:
                trace.set_error("boom")
            trace.finish()
    views = [(rec.stats(), [t.trace_id for t in rec.recent()], [t.trace_id for t in rec.slow()],
              [t.trace_id for t in rec.errored()]) for rec in recs]
    assert views[0] == views[1]


# --------------------------------------------------------------- metrics


def _samples(text):
    out = []
    for family in text_string_to_metric_families(text):
        for sample in family.samples:
            if not sample.name.endswith("_created"):
                out.append((sample.name, tuple(sorted(sample.labels.items())), sample.value))
    return sorted(out)


def _drive(metrics, n):
    """The same observations on every series of one ``KVCacheMetrics``:
    counters and gauges moved, histograms observed across their buckets
    (edges included), labeled series under two label sets, one of them
    needing escapes."""
    for attr, metric in sorted(vars(metrics).items()):
        if attr == "registry":
            continue
        labelnames = metric._labelnames
        targets = [metric] if not labelnames else [
            metric.labels(*[f"{label}-{i}" for label in labelnames]) for i in range(2)
        ] + [metric.labels(*['we"ird\\label\n' for _ in labelnames])]
        for k, target in enumerate(targets):
            kind = type(metric).__name__
            for i in range(n):
                if kind == "Counter":
                    target.inc(i + k)
                elif kind == "Gauge":
                    target.set(i * 1.5 - k)
                    target.inc(0.25)
                    target.dec(1)
                else:
                    for value in (0.0, 5e-5, 0.001, 0.3 * i, 1.0, 7.0 + k, 1e9):
                        target.observe(value)


# The port's own families, which the reference has no counterpart for:
# its CUDA device work built in the process (kernels, work lists, graphs).
PORT_ONLY = {"kernel_builds": "kvtpu_kernel_builds",
             "kernel_build_seconds": "kvtpu_kernel_build_seconds"}


def _shared(samples):
    return [s for s in samples if not s[0].startswith(tuple(PORT_ONLY.values()))]


@pytest.mark.parametrize("n", [0, 1, 3])
def test_metric_samples_match_reference(n):
    """Every series of ``KVCacheMetrics``: the same names, labels,
    buckets and values in both expositions, but for ``PORT_ONLY``."""
    ours, ref = collector.KVCacheMetrics(), jax_collector.KVCacheMetrics()
    assert sorted(vars(ours)) == sorted(set(vars(ref)) | set(PORT_ONLY))
    _drive(ours, n)
    _drive(ref, n)
    got, want = _samples(ours.exposition().decode()), _samples(ref.exposition().decode())
    assert _shared(got) == want
    assert len(got) > len(_shared(got))
    assert len(want) > 300 if n else len(want) > 100
    families = [{f.name: (f.type, f.documentation)
                 for f in text_string_to_metric_families(m.exposition().decode())
                 if not f.name.endswith("_created")} for m in (ours, ref)]
    assert set(families[0]) - set(families[1]) == set(PORT_ONLY.values())
    assert {k: v for k, v in families[0].items() if k not in PORT_ONLY.values()} == families[1]


def test_metric_helpers_match_reference():
    ours, ref = collector.KVCacheMetrics(), jax_collector.KVCacheMetrics()
    _drive(ours, 2)
    _drive(ref, 2)
    for attr in ("index_admissions", "kvevents_dropped", "cachestats_requests"):
        assert collector.counter_total(getattr(ours, attr)) == jax_collector.counter_total(
            getattr(ref, attr))
    for attr in ("score_memo_disabled", "process_rss"):
        assert collector.gauge_value(getattr(ours, attr)) == jax_collector.gauge_value(
            getattr(ref, attr))
    assert collector.gauge_total(ours.kvevents_pod_backlog) == jax_collector.gauge_total(
        ref.kvevents_pod_backlog)
    for value in ("pod-1", "a\x00b\x7f", "x" * 300, "東京"):
        assert collector.safe_label(value) == jax_collector.safe_label(value)
    with pytest.raises(ValueError):
        ours.index_admissions.inc(-1)
    with pytest.raises(ValueError):
        ours.tokenization_tokens.labels("a", "b")


def test_indexer_metrics_match_reference():
    """One scoring workload through an instrumented index in each
    package moves the process-wide ``METRICS`` the same way (lookups,
    hits, admissions, the cache-stats ledger, the prefix fast path)."""
    names = ("kvtpu_kvcache_index_lookup_requests_total", "kvtpu_kvcache_index_lookup_hits_total",
             "kvtpu_kvcache_index_admissions_total", "kvtpu_cachestats_requests_total",
             "kvtpu_tokenization_prefix_fast_path_total")

    def totals(mod):
        out = dict.fromkeys(names, 0.0)
        for name, _, value in _samples(mod.METRICS.exposition().decode()):
            if name in out:
                out[name] += value
        return out

    deltas = {}
    for side, indexer_mod, index_mod, tp_mod, coll, encoding in (
            ("jax", jax_indexer, jax_index, jax_tp, jax_collector, jax_tokenizers.Encoding),
            ("port", port("kvcache.indexer"), port("kvcache.kvblock.index"),
             port("kvcache.kvblock.token_processor"), collector,
             port("tokenization.tokenizers").Encoding)):
        before = totals(coll)
        indexer = indexer_mod.Indexer(
            indexer_mod.IndexerConfig(
                token_processor_config=tp_mod.TokenProcessorConfig(block_size=4),
                kvblock_index_config=index_mod.IndexConfig(enable_metrics=True),
                cache_stats=True),
            tokenizer=WordTokenizer(encoding))
        indexer.cache_stats.config.sample_rate = 1.0
        indexer.run()
        try:
            tokens = list(range(1, 300))
            keys = indexer.token_processor.tokens_to_kv_block_keys(0, tokens, "m")
            indexer.kv_block_index.add(keys[:40], keys[:40], [index_mod.PodEntry("p", "hbm")])
            for cut in (300, 200, 300, 100, 300):
                indexer.get_pod_scores(" ".join(f"t{t}" for t in tokens[:cut]), "m")
        finally:
            indexer.shutdown()
        after = totals(coll)
        deltas[side] = {name: after[name] - before[name] for name in names}
    assert deltas["port"] == deltas["jax"]
    assert deltas["port"]["kvtpu_kvcache_index_lookup_requests_total"] == 5
