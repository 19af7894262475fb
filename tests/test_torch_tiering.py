"""The port's predictive tiering (``tiering/``) against the JAX package's,
on the CPU.

The same inputs (a numpy seed, ``now``s given by the test) go through
both packages and their decisions and state must be equal: policy
snapshots from the same ledger traffic, eviction victims, compute-or-
load advice (exact: both compute in float64 on the host), demotion
records and published events, the index after both event pools applied
them, and the bytes a ``StagedDemotionTarget`` moves into the host tier
and into files.  The cases are those of the JAX package's
``tests/test_tiering.py``, its ``TestPolicyEngineSurface`` HTTP cases
(``/debug/tiering`` and ``/healthz`` through each package's ``serve()``)
included; each runs on both packages and holds each to that test's
expectations.  Last, the wiring:
``TPUOffloadConnector(policy_engine=...)`` and the explain surface's
advice.
"""

import dataclasses
import os
import random
import time
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest

from llm_d_kv_cache_manager_tpu import tiering as ref_tiering
from llm_d_kv_cache_manager_tpu.analytics import ledger as ref_ledger
from llm_d_kv_cache_manager_tpu.api import http_service as ref_http
from llm_d_kv_cache_manager_tpu.kvcache import indexer as ref_indexer
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import cost_aware as ref_cost_aware
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import index as ref_index
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as ref_tp
from llm_d_kv_cache_manager_tpu.kvevents import events as ref_events
from llm_d_kv_cache_manager_tpu.kvevents import pool as ref_pool
from llm_d_kv_cache_manager_tpu.models import kv_cache_pool as ref_kv_pool
from llm_d_kv_cache_manager_tpu.offload import host_tier as ref_host_tier
from llm_d_kv_cache_manager_tpu.offload import spec as ref_spec
from llm_d_kv_cache_manager_tpu.offload import worker as ref_worker
from llm_d_kv_cache_manager_tpu.tiering import demotion as ref_demotion
from llm_d_kv_cache_manager_tpu.tiering import staged_target as ref_staged
from llm_d_kv_cache_manager_tpu.tokenization import pool as ref_tok_pool
from llm_d_kv_cache_manager_tpu.tokenization import tokenizers as ref_tokenizers
from tests.helpers.torch_port import port

MODEL = "tiering-model"
BLOCK_SIZE = 4
SIDES = ("ref", "port")

_REF = dict(
    tiering=ref_tiering, ledger=ref_ledger, indexer=ref_indexer, cost_aware=ref_cost_aware,
    index=ref_index, tp=ref_tp, events=ref_events, pool=ref_pool, kv_pool=ref_kv_pool,
    host_tier=ref_host_tier, spec=ref_spec, worker=ref_worker, demotion=ref_demotion,
    staged=ref_staged, tok_pool=ref_tok_pool, tokenizers=ref_tokenizers, http=ref_http,
)
_PORT = dict(
    tiering="tiering", ledger="analytics.ledger", indexer="kvcache.indexer",
    cost_aware="kvcache.kvblock.cost_aware", index="kvcache.kvblock.index",
    tp="kvcache.kvblock.token_processor", events="kvevents.events", pool="kvevents.pool",
    kv_pool="models.kv_cache_pool", host_tier="offload.host_tier", spec="offload.spec",
    worker="offload.worker", demotion="tiering.demotion", staged="tiering.staged_target",
    tok_pool="tokenization.pool", tokenizers="tokenization.tokenizers",
    http="api.http_service",
)


def mods(side: str) -> SimpleNamespace:
    if side == "ref":
        return SimpleNamespace(side=side, **_REF)
    return SimpleNamespace(side=side, **{k: port(v) for k, v in _PORT.items()})


def same(story):
    """``story(mods)`` on both packages; the results must be equal."""
    out = {side: story(mods(side)) for side in SIDES}
    assert out["port"] == out["ref"]
    return out["port"]


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


def prompt_of(tokens) -> str:
    return " ".join(f"t{t}" for t in tokens)


def make_ledger(m, **kw):
    return m.ledger.CacheStatsLedger(m.ledger.LedgerConfig(sample_rate=1.0, **kw))


def make_feed(m, ledger=None, **kw):
    return m.tiering.PolicyFeed(ledger=ledger, config=m.tiering.PolicyFeedConfig(**kw))


def seeded_feed(m, family=0xF00, ewma=2.0, now=100.0, keys=(1, 2, 3)):
    """Feed + ledger with one family whose EWMA is ``ewma`` and whose
    chain keys are ``keys`` (family key last)."""
    ledger = make_ledger(m)
    chain = list(keys) + [family]
    ledger.record(family, MODEL, 4, 4, now=now - ewma)
    ledger.record(family, MODEL, 4, 4, now=now)
    feed = make_feed(m, ledger)
    feed.observe_chain(chain, family, now=now)
    feed.refresh(now)
    return feed, ledger


def pred(prediction):
    return None if prediction is None else dataclasses.astuple(prediction)


def snapshot_view(snapshot):
    return (snapshot.at, dict(snapshot.key_family),
            {f: pred(p) for f, p in snapshot.predictions.items()})


# ------------------------------------------------------------------- feed


def _family_prediction_from_ledger_ewma(m):
    feed, _ = seeded_feed(m, ewma=2.0, now=100.0)
    snapshot = feed.snapshot()
    prediction = snapshot.prediction_for_key(2)
    assert prediction.source == "family" and prediction.predicted_interarrival_s == 2.0
    # Half the rhythm elapsed: next use expected in ~1s.
    assert abs(snapshot.expected_next_use_s(2, 101.0) - 1.0) < 1e-6
    return pred(prediction), snapshot.expected_next_use_s(2, 101.0)


def _overdue_families_back_off(m):
    feed, _ = seeded_feed(m, ewma=2.0, now=100.0)
    # 10s past a 2s rhythm: 8s overdue.
    assert feed.snapshot().expected_next_use_s(2, 110.0) == 8.0
    return feed.snapshot().expected_next_use_s(2, 110.0)


def _cluster_fallback_for_single_shot_family(m):
    ledger = make_ledger(m)
    feed = make_feed(m, ledger, cluster_blocks=2)
    ledger.record(0xA, MODEL, 4, 4, now=10.0)
    feed.observe_chain([100, 200, 0xA], 0xA, now=10.0)
    ledger.record(0xB, MODEL, 4, 4, now=13.0)
    feed.observe_chain([100, 200, 0xB], 0xB, now=13.0)
    snapshot = feed.refresh(13.0)
    assert ledger.predicted_interarrival_s(0xA) is None
    for family in (0xA, 0xB):
        prediction = snapshot.predictions[family]
        assert prediction.source == "cluster" and prediction.predicted_interarrival_s == 3.0
    return snapshot_view(snapshot)


def _family_history_beats_cluster(m):
    feed, _ = seeded_feed(m, ewma=2.0, now=100.0)
    prediction = feed.prediction(0xF00, now=100.0)
    assert prediction.source == "family" and prediction.predicted_interarrival_s == 2.0
    return pred(prediction)


def _key_map_is_bounded_lru(m):
    feed = make_feed(m, None, key_map_size=8)
    for i in range(4):
        feed.observe_chain([i * 10, i * 10 + 1], i, now=float(i))
    feed.observe_chain([900, 901], 99, now=10.0)
    snapshot = feed.refresh(10.0)
    assert len(snapshot.key_family) == 8
    assert snapshot.family_of(0) is None and snapshot.family_of(900) == 99
    return snapshot_view(snapshot)


def _reobserving_resident_keys_evicts_nothing(m):
    feed = make_feed(m, None, key_map_size=6)
    feed.observe_chain([1, 2, 3], 0xA, now=1.0)
    feed.observe_chain([4, 5, 6], 0xB, now=2.0)
    for _ in range(3):
        feed.observe_chain([1, 2, 3], 0xA, now=3.0)
    snapshot = feed.refresh(3.0)
    assert len(snapshot.key_family) == 6 and snapshot.family_of(4) == 0xB
    return snapshot_view(snapshot)


def _family_cluster_map_is_bounded(m):
    feed = make_feed(m, None, max_families=4)
    for i in range(10):
        feed.observe_chain([i * 10, i * 10 + 1], i, now=float(i))
    with feed._lock:
        families = dict(feed._family_cluster)
    assert len(families) == 4 and 0 not in families and 9 in families
    return families


def _unknown_key_predicts_none(m):
    feed, _ = seeded_feed(m)
    assert feed.snapshot().expected_next_use_s(0xDEAD, 100.0) is None
    return None


def _observe_keys_registers_extra_keys(m):
    feed, _ = seeded_feed(m, family=0xF00, now=100.0)
    feed.observe_keys([0xFEED], 0xF00)
    snapshot = feed.refresh(100.0)
    assert snapshot.family_of(0xFEED) == 0xF00
    assert snapshot.expected_next_use_s(0xFEED, 100.5) is not None
    return snapshot_view(snapshot)


def _ledger_bulk_export(m):
    _, ledger = seeded_feed(m, family=0xF00, ewma=2.0, now=100.0)
    rows = ledger.reuse_predictions()
    assert [tuple(r) for r in rows] == [(0xF00, 2.0, 100.0, 2)]
    return [tuple(r) for r in rows]


def _seeded_ledger_traffic(m):
    """Random chains over a few shared prefixes at increasing ``now``s,
    recorded in the ledger and observed by a small feed (its key, family
    and cluster maps all overflow), refreshed as it goes."""
    rng = np.random.default_rng(7)
    ledger = make_ledger(m, family_blocks=3)
    feed = make_feed(m, ledger, cluster_blocks=2, key_map_size=48, max_clusters=6,
                     max_families=10)
    heads = [[int(x) for x in rng.integers(1, 1 << 60, 2)] for _ in range(8)]
    now, views = 50.0, []
    for i in range(200):
        now += float(rng.exponential(2.0))
        head = heads[int(rng.integers(len(heads)))]
        tail = [int(x) for x in rng.integers(1, 1 << 60, int(rng.integers(1, 5)))]
        chain = head + tail
        family = ledger.family_key(chain, len(chain))
        ledger.record(family, MODEL, len(chain), int(rng.integers(0, len(chain) + 1)), now=now)
        feed.observe_chain(chain, family, now=now)
        if i % 25 == 24:
            views.append(snapshot_view(feed.refresh(now)))
    stats = feed.stats()
    stats.pop("snapshot")
    return views, stats


FEED_STORIES = {f.__name__[1:]: f for f in (
    _family_prediction_from_ledger_ewma, _overdue_families_back_off,
    _cluster_fallback_for_single_shot_family, _family_history_beats_cluster,
    _key_map_is_bounded_lru, _reobserving_resident_keys_evicts_nothing,
    _family_cluster_map_is_bounded, _unknown_key_predicts_none,
    _observe_keys_registers_extra_keys, _ledger_bulk_export, _seeded_ledger_traffic)}


@pytest.mark.parametrize("story", sorted(FEED_STORIES))
def test_policy_feed_matches_reference(story):
    same(FEED_STORIES[story])


# --------------------------------------------------------- eviction ranking


def _prediction_overrides_recency(m):
    feed, ledger = seeded_feed(m, family=0xF00, ewma=2.0, now=100.0)
    ledger.record(0xC01D, MODEL, 4, 4, now=100.0 - 3600.0)
    ledger.record(0xC01D, MODEL, 4, 4, now=100.0)
    feed.observe_chain([7, 8, 0xC01D], 0xC01D, now=100.0)
    feed.refresh(100.0)
    policy = m.tiering.PredictiveEvictionPolicy(feed, backend="test")
    victim = policy.select_victim([(2, 100), (7, 100)], now=101.0)
    assert victim == 1 and policy.predicted_choices == 1
    return victim, policy.stats()


def _byte_cost_breaks_ties(m):
    feed, _ = seeded_feed(m)
    policy = m.tiering.PredictiveEvictionPolicy(feed, backend="test")
    victim = policy.select_victim([(50, 10), (51, 1000)], now=0.0)
    assert victim == 1
    return victim, policy.stats()


def _all_unknown_degrades_toward_lru(m):
    policy = m.tiering.PredictiveEvictionPolicy(make_feed(m, None), backend="test")
    victim = policy.select_victim([(1, 64), (2, 64), (3, 64)], now=0.0)
    assert victim == 0 and policy.fallback_choices == 1
    return victim, policy.stats()


def _lru_escape_hatch_always_picks_first(m):
    assert m.tiering.LRU_POLICY.select_victim([(9, 1), (8, 999)]) == 0
    return m.tiering.LRU_POLICY.sample


def _seeded_victim_sequence(m):
    """A feed with families of many rhythms, then 300 random candidate
    samples (keys known and unknown, random costs) at rising ``now``s."""
    rng = np.random.default_rng(11)
    ledger = make_ledger(m)
    feed = make_feed(m, ledger)
    for family in range(1, 13):
        ewma = float(rng.uniform(0.5, 900.0))
        last = float(rng.uniform(0.0, 50.0))
        ledger.record(family, MODEL, 4, 4, now=last - ewma)
        ledger.record(family, MODEL, 4, 4, now=last)
        feed.observe_chain([family * 100 + i for i in range(4)] + [family], family, now=last)
    feed.refresh(50.0)
    policy = m.tiering.PredictiveEvictionPolicy(feed, backend="test", sample=6)
    victims, now = [], 50.0
    for _ in range(300):
        now += float(rng.uniform(0.0, 30.0))
        n = int(rng.integers(1, 7))
        keys = [int(rng.integers(1, 13)) * 100 + int(rng.integers(0, 6)) for _ in range(n)]
        costs = [int(rng.integers(0, 5000)) for _ in range(n)]
        victims.append(policy.select_victim(list(zip(keys, costs)), now=now))
    return victims, policy.stats()


EVICTION_STORIES = {f.__name__[1:]: f for f in (
    _prediction_overrides_recency, _byte_cost_breaks_ties, _all_unknown_degrades_toward_lru,
    _lru_escape_hatch_always_picks_first, _seeded_victim_sequence)}


@pytest.mark.parametrize("story", sorted(EVICTION_STORIES))
def test_predictive_eviction_matches_reference(story):
    same(EVICTION_STORIES[story])


def _random_ops(m, index, rng, n=400):
    """A deterministic random add/evict/lookup mix."""
    for _ in range(n):
        op = rng.random()
        key = rng.randrange(64)
        if op < 0.6:
            index.add([key * 7 + 1], [key], [m.index.PodEntry(f"pod-{rng.randrange(4)}", "hbm")])
        elif op < 0.8:
            index.evict(key * 7 + 1, [m.index.PodEntry("pod-0", "hbm")])
        else:
            index.lookup([key])


def dump_view(dump):
    entries, engine_map = dump
    return ([(key, [(e.pod_identifier, e.device_tier) for e in pods]) for key, pods in entries],
            [tuple(x) for x in engine_map])


def tight_index(m, policy=None):
    return m.cost_aware.CostAwareMemoryIndex(
        m.index.CostAwareIndexConfig(max_cost_bytes=2000, eviction_policy=policy))


def test_cost_aware_policy_off_parity_is_bit_identical():
    """``policy=None`` and ``LRU_POLICY`` give the pristine eviction order,
    bit for bit, in the port and in the reference."""
    views = []
    for side in SIDES:
        m = mods(side)
        for policy in (None, m.tiering.LRU_POLICY):
            index = tight_index(m, policy)
            _random_ops(m, index, random.Random(42))
            views.append((dump_view(index.dump_entries()), index.resident_cost_bytes))
    assert all(view == views[0] for view in views)


def test_cost_aware_predictive_policy_protects_hot_family():
    def story(m):
        # Real clock: the index's eviction path stamps its own monotonic time.
        feed, _ = seeded_feed(m, family=0xF00, ewma=1.0, now=time.monotonic())
        policy = m.tiering.PredictiveEvictionPolicy(feed, backend="cost_aware", sample=8)
        index = tight_index(m, policy)
        index.add([21], [2], [m.index.PodEntry("pod-1", "hbm")])
        for i in range(30):
            index.add([1000 + i], [500 + i], [m.index.PodEntry("pod-1", "hbm")])
        assert index.lookup([2]), "hot family key was evicted"
        return dump_view(index.dump_entries())

    same(story)


def test_cost_aware_broken_policy_falls_back_to_lru():
    class Broken:
        sample = 4

        def select_victim(self, candidates, now=None):
            raise RuntimeError("boom")

    def story(m):
        index = tight_index(m, Broken())
        for i in range(40):
            index.add([1000 + i], [500 + i], [m.index.PodEntry("pod-1", "hbm")])
        assert index.resident_cost_bytes <= 2000
        return dump_view(index.dump_entries()), index.resident_cost_bytes

    same(story)


def test_host_tier_policy_off_parity():
    logs = []
    for side in SIDES:
        m = mods(side)
        for policy in (None, m.tiering.LRU_POLICY):
            cache = m.host_tier.HostTierCache(max_bytes=1024, eviction_policy=policy)
            evicted = []
            cache._on_evict = evicted.append
            for i in range(8):
                cache.put(i, np.zeros(256, dtype=np.uint8))
            logs.append((evicted, cache.stats()["entries"]))
    assert all(log == logs[0] for log in logs) and logs[0][0]


def test_host_tier_predictive_policy_keeps_hot_group():
    def story(m):
        now = time.monotonic()  # real clock: put() stamps its own
        feed, _ = seeded_feed(m, family=0xF00, ewma=1.0, now=now)
        feed.observe_keys([7], 0xF00)
        feed.refresh(now)
        policy = m.tiering.PredictiveEvictionPolicy(feed, backend="host_tier", sample=8)
        cache = m.host_tier.HostTierCache(max_bytes=1024, eviction_policy=policy)
        cache.put(7, np.zeros(256, dtype=np.uint8))  # the hot group, inserted first
        for i in range(100, 106):
            cache.put(i, np.zeros(256, dtype=np.uint8))
        assert cache.contains(7)
        return sorted(k for k in [7] + list(range(100, 106)) if cache.contains(k))

    same(story)


# ----------------------------------------------------------------- advisor


def advice(a):
    return dataclasses.astuple(a)


def advisor(m, per_byte_s=None, prefill=16384.0, **kw):
    out = m.tiering.ComputeOrLoadAdvisor(m.tiering.AdvisorConfig(
        bytes_per_block=1024, block_tokens=16, prefill_tokens_per_s=prefill, **kw))
    if per_byte_s is not None:
        out.observe_load(1 << 20, per_byte_s * (1 << 20))
    return out


def _cold_estimator_returns_none(m):
    assert m.tiering.RttEstimator().estimate(1024) is None


def _floor_plus_per_byte(m):
    estimator = m.tiering.RttEstimator(floor_s=0.05)
    estimator.observe(1 << 20, 0.05 + 0.1)
    estimate = estimator.estimate(2 << 20)
    assert abs(estimate - (0.05 + 0.2)) < 1e-6
    return estimate, estimator.stats()


def _ignores_nonpositive_samples(m):
    estimator = m.tiering.RttEstimator()
    estimator.observe(0, 1.0)
    estimator.observe(100, 0.0)
    assert estimator.stats()["observations"] == 0
    return estimator.stats()


def _no_rtt_means_recompute(m):
    a = advisor(m).advise(64)
    assert (a.action, a.reason) == ("recompute", "no-rtt-observations")
    return advice(a)


def _no_prefill_rate_means_load(m):
    a = advisor(m, per_byte_s=1e-9, prefill=0.0).advise(64)
    assert (a.action, a.reason) == ("load", "no-prefill-rate")
    return advice(a)


def _no_signal_at_all(m):
    out = m.tiering.ComputeOrLoadAdvisor(m.tiering.AdvisorConfig(block_tokens=16))
    a, empty = out.advise(64), out.advise(0)
    assert a.reason == "no-rtt-and-no-prefill-signal" and empty.reason == "empty-chunk"
    return advice(a), advice(empty), out.stats()


def _slow_rtt_flips_to_recompute(m):
    out = advisor(m, per_byte_s=1e-9)
    fast = out.advise(512)
    assert fast.action in ("load", "hybrid")
    for _ in range(20):
        out.observe_load(1 << 20, 30.0)
    slow = out.advise(512)
    assert slow.action == "recompute" and slow.recompute_s < slow.load_s
    return advice(fast), advice(slow), out.stats()


def _hybrid_never_beats_both_pures_dishonestly(m):
    a = advisor(m, per_byte_s=3e-6).advise(512)
    assert a.hybrid_s <= min(a.load_s, a.recompute_s) + 1e-9
    if a.action == "hybrid":
        assert 0 < a.load_blocks < 512
    return advice(a), a.to_dict()


def _hybrid_disabled(m):
    a = advisor(m, per_byte_s=3e-6, hybrid=False).advise(512)
    assert a.hybrid_s is None and a.action in ("load", "recompute")
    return advice(a)


def _learned_prefill_rate(m):
    out = m.tiering.ComputeOrLoadAdvisor(m.tiering.AdvisorConfig(bytes_per_block=1024,
                                                                 block_tokens=16))
    out.observe_prefill(8192, 0.5)
    assert abs(out.prefill_tokens_per_s - 16384.0) < 1e-6
    return out.prefill_tokens_per_s


def _advice_serializes(m):
    a = advisor(m, per_byte_s=1e-9).advise(8)
    view = a.to_dict()
    assert isinstance(a, m.tiering.Advice) and view["action"] == a.action and view["blocks"] == 8
    return view


def _seeded_observation_streams(m):
    """Random load, store and prefill observations (a floor, hybrid on),
    the advice for many sizes and tiers after each burst, and the store
    estimate: every field equal, exactly."""
    rng = np.random.default_rng(5)
    out = m.tiering.ComputeOrLoadAdvisor(m.tiering.AdvisorConfig(
        bytes_per_block=int(rng.integers(1 << 10, 1 << 22)), block_tokens=16, rtt_floor_s=0.002,
        margin=0.07))
    views = []
    for _ in range(12):
        for _ in range(int(rng.integers(1, 6))):
            kind = int(rng.integers(3))
            nbytes, seconds = int(rng.integers(1, 1 << 30)), float(rng.uniform(1e-4, 2.0))
            if kind == 0:
                out.observe_load(nbytes, seconds)
            elif kind == 1:
                out.observe_store(nbytes, seconds, float(rng.uniform(0, 0.5)))
            else:
                out.observe_prefill(int(rng.integers(1, 20000)), seconds)
        for blocks in (0, 1, 2, 7, 64, 513):
            views.append(advice(out.advise(blocks, tier=("host", "shared_storage", None)[
                blocks % 3])))
        views.append(out.estimate_store_s(int(rng.integers(1, 1 << 30))))
    return views, out.stats()


ADVISOR_STORIES = {f.__name__[1:]: f for f in (
    _cold_estimator_returns_none, _floor_plus_per_byte, _ignores_nonpositive_samples,
    _no_rtt_means_recompute, _no_prefill_rate_means_load, _no_signal_at_all,
    _slow_rtt_flips_to_recompute, _hybrid_never_beats_both_pures_dishonestly, _hybrid_disabled,
    _learned_prefill_rate, _advice_serializes, _seeded_observation_streams)}


@pytest.mark.parametrize("story", sorted(ADVISOR_STORIES))
def test_advisor_matches_reference(story):
    same(ADVISOR_STORIES[story])


# ---------------------------------------------------------------- demotion


def event_view(event):
    return (type(event).__name__, dataclasses.asdict(event))


def worker_view(worker):
    stats = worker.stats()
    for record in stats["recent"]:
        record.pop("age_s")
        record.pop("idle_s")  # the target's scan reads the wall clock
    stats.pop("running")
    return stats


def tier_state(m, feed, sink=None, capacity=10_000, host_cache=None):
    return m.tiering.PodTierState(capacity_bytes=capacity, event_sink=sink, feed=feed,
                                  host_cache=host_cache)


def register(state, key, nbytes=1000, family=None, now=None):
    state.register_group(key, engine_hashes=[key * 10 + i for i in range(2)],
                         token_ids=list(range(8)), nbytes=nbytes, block_size=BLOCK_SIZE,
                         family=family, now=now)


def _state_machine_hbm_host_storage(m):
    batches = []
    feed, _ = seeded_feed(m, family=0xF00, now=100.0)
    state = tier_state(m, feed, sink=batches.append)
    register(state, 1, family=0xF00, now=time.monotonic() - 500)
    worker = m.tiering.DemotionWorker(state, feed, m.tiering.DemotionConfig(
        demote_host_idle_s=0.0, demote_storage_idle_s=0.0))
    moves = [worker.run_cycle(now=100.0 + i) for i in range(3)]
    assert moves == [1, 1, 0] and state.tiers() == {"shared_storage": 1}
    mediums = [(batch[0].medium, batch[1].medium) for batch in batches]
    assert mediums == [("host", "hbm"), ("shared_storage", "host")]
    return [[event_view(e) for e in batch] for batch in batches], worker_view(worker)


def _cold_but_unpredicted_is_left_alone(m):
    feed, _ = seeded_feed(m, family=0xF00, now=100.0)
    state = tier_state(m, feed)
    register(state, 1, family=None, now=time.monotonic() - 500)
    worker = m.tiering.DemotionWorker(state, feed, m.tiering.DemotionConfig(
        demote_host_idle_s=0.0))
    assert worker.run_cycle(now=100.0) == 0 and state.tiers() == {"hbm": 1}
    return worker_view(worker)


def _pressure_forces_unpredicted_demotion(m):
    feed, _ = seeded_feed(m)
    state = tier_state(m, feed, capacity=1000)
    register(state, 1, nbytes=900, family=None)
    worker = m.tiering.DemotionWorker(state, feed, m.tiering.DemotionConfig(
        demote_host_idle_s=1e9, pressure_watermark=0.85))
    assert state.pressure() == 0.9
    assert worker.run_cycle(now=100.0) == 1 and state.tiers() == {"host": 1}
    assert worker.stats()["recent"][0]["forced_by_pressure"] is True
    return worker_view(worker)


def _move_budget_bounds_a_cycle(m):
    feed, _ = seeded_feed(m, family=0xF00, now=100.0)
    state = tier_state(m, feed)
    old = time.monotonic() - 500
    for i in range(10):
        register(state, i, family=0xF00, now=old)
    worker = m.tiering.DemotionWorker(state, feed, m.tiering.DemotionConfig(
        demote_host_idle_s=0.0, max_moves_per_cycle=3))
    assert worker.run_cycle(now=100.0) == 3
    assert state.tiers() == {"hbm": 7, "host": 3}
    return worker_view(worker)


def _coldest_reusable_goes_first(m):
    ledger = make_ledger(m)
    feed = make_feed(m, ledger)
    now = 1000.0
    for family, ewma in ((0xA, 1.0), (0xB, 900.0)):
        ledger.record(family, MODEL, 4, 4, now=now - ewma)
        ledger.record(family, MODEL, 4, 4, now=now)
        feed.observe_chain([family * 100, family], family, now=now)
    state = tier_state(m, feed)
    register(state, 1, family=0xA, now=time.monotonic() - 50)
    register(state, 2, family=0xB, now=time.monotonic() - 50)
    worker = m.tiering.DemotionWorker(state, feed, m.tiering.DemotionConfig(
        demote_host_idle_s=0.0, max_moves_per_cycle=1))
    assert worker.run_cycle(now=now) == 1
    tiers = {key: group.tier for key, group in state._groups.items()}
    assert tiers == {1: "hbm", 2: "host"}
    return worker_view(worker)


def _worker_start_close_idempotent(m):
    feed, _ = seeded_feed(m)
    worker = m.tiering.DemotionWorker(tier_state(m, feed), feed,
                                      m.tiering.DemotionConfig(interval_s=0.05))
    worker.start()
    worker.start()
    time.sleep(0.12)
    worker.close()
    worker.close()
    stats = worker.stats()
    assert stats["cycles"] >= 1 and stats["running"] is False
    return stats["moves"], stats["running"]


def _host_cache_rejection_keeps_tier(m):
    class RejectingCache:
        def put(self, key, group):
            return False

    feed, _ = seeded_feed(m, family=0xF00, now=100.0)
    state = tier_state(m, feed, host_cache=RejectingCache())
    register(state, 1, family=0xF00, now=time.monotonic() - 500)
    assert state.demote(1, "host") is False and state.tiers() == {"hbm": 1}
    return state.tiers()


def _seeded_demotion_cycles(m):
    """Forty groups of random sizes and families (some unpredicted), a
    random pressure, idle ages and a move budget; six cycles at rising
    ``now``s: the same records and the same event batches."""
    rng = np.random.default_rng(3)
    ledger = make_ledger(m)
    feed = make_feed(m, ledger)
    for family in range(1, 7):
        ewma = float(rng.uniform(1.0, 600.0))
        ledger.record(family, MODEL, 4, 4, now=100.0 - ewma)
        ledger.record(family, MODEL, 4, 4, now=100.0)
        feed.observe_chain([family * 1000, family], family, now=100.0)
    batches = []
    state = tier_state(m, feed, sink=batches.append, capacity=60_000)
    wall = time.monotonic()
    for key in range(40):
        family = int(rng.integers(0, 7)) or None
        register(state, 7000 + key, nbytes=int(rng.integers(100, 3000)), family=family,
                 now=wall - float(rng.choice([5.0, 50.0, 500.0, 5000.0])))
    worker = m.tiering.DemotionWorker(state, feed, m.tiering.DemotionConfig(
        demote_host_idle_s=30.0, demote_storage_idle_s=120.0, pressure_watermark=0.5,
        max_moves_per_cycle=7))
    moves = [worker.run_cycle(now=100.0 + 20.0 * i) for i in range(6)]
    return moves, state.tiers(), [[event_view(e) for e in b] for b in batches], worker_view(worker)


DEMOTION_STORIES = {f.__name__[1:]: f for f in (
    _state_machine_hbm_host_storage, _cold_but_unpredicted_is_left_alone,
    _pressure_forces_unpredicted_demotion, _move_budget_bounds_a_cycle,
    _coldest_reusable_goes_first, _worker_start_close_idempotent,
    _host_cache_rejection_keeps_tier, _seeded_demotion_cycles)}


@pytest.mark.parametrize("story", sorted(DEMOTION_STORIES))
def test_demotion_matches_reference(story):
    same(DEMOTION_STORIES[story])


# ------------------------------------------------- demotion round trip


def make_stack(m, ledger=None):
    indexer = m.indexer.Indexer(
        m.indexer.IndexerConfig(
            token_processor_config=m.tp.TokenProcessorConfig(block_size=BLOCK_SIZE),
            tokenizers_pool_config=m.tok_pool.TokenizationPoolConfig(workers=1,
                                                                     model_name=MODEL)),
        tokenizer=WordTokenizer(m), cache_stats_ledger=ledger)
    indexer.run()
    pool = m.pool.Pool(indexer.kv_block_index, indexer.token_processor,
                       m.pool.PoolConfig(concurrency=2))
    pool.start()
    return indexer, pool


def seed_chain(m, pool, pod, hashes, tokens, medium="hbm"):
    batch = m.events.EventBatch(ts=1.0, events=[m.events.BlockStored(
        block_hashes=list(hashes), parent_block_hash=None, token_ids=list(tokens),
        block_size=BLOCK_SIZE, medium=medium)])
    pool.add_task(m.pool.Message(topic=f"kv@{pod}@{MODEL}", payload=batch.encode(),
                                 pod_identifier=pod, model_name=MODEL))
    pool.drain()


def test_demotion_round_trip_matches_reference():
    """Demote a group through a worker whose events ride each package's
    own event pool (``pool_event_sink``): the index tier, the score (1.0
    -> 0.8 -> 0.5 a block), the ledger's tier split and the index's
    ``dump_entries()`` after each rung are the reference's."""

    def story(m):
        ledger = make_ledger(m, tier_sample=1)
        indexer, pool = make_stack(m, ledger)
        try:
            engine = m.tiering.PolicyEngine(ledger=ledger, config=m.tiering.TieringConfig())
            indexer.set_policy_engine(engine)
            tokens = list(range(1, 33))
            n_blocks = len(tokens) // BLOCK_SIZE
            prompt = prompt_of(tokens)
            hashes = [0x9000 + i for i in range(n_blocks)]
            seed_chain(m, pool, "pod-1", hashes, tokens)
            views = [indexer.get_pod_scores(prompt, MODEL, ["pod-1"])]
            keys = indexer.token_processor.tokens_to_kv_block_keys(0, tokens, MODEL)
            state = m.tiering.PodTierState(
                capacity_bytes=10_000, event_sink=m.tiering.pool_event_sink(pool, "pod-1", MODEL),
                feed=engine.feed)
            state.register_group(0xF11E, engine_hashes=hashes, token_ids=tokens, nbytes=4096,
                                 block_size=BLOCK_SIZE, family=ledger.family_key(keys, n_blocks),
                                 now=time.monotonic() - 600)
            worker = engine.start_demotion(state, m.tiering.DemotionConfig(
                demote_host_idle_s=0.0, demote_storage_idle_s=0.0, require_prediction=False),
                start=False)
            for weight in (0.8, 0.5):
                assert worker.run_cycle(now=200.0) == 1
                pool.drain()
                scores = indexer.get_pod_scores(prompt, MODEL, ["pod-1"])
                assert abs(scores["pod-1"] - weight * n_blocks) < 1e-9
                views.append((scores, dump_view(indexer.kv_block_index.dump_entries())))
            ledger.flush_metrics()
            tiers = ledger.snapshot()["totals"]["tiers"]
            assert tiers.get("host") == n_blocks, tiers
            engine.close()
            records = worker_view(worker)
            for record in records["recent"]:
                # The scored requests reached the ledger at the wall clock's time.
                record.pop("predicted_next_use_s")
            return views, tiers, records
        finally:
            pool.shutdown()
            indexer.shutdown()

    same(story)


@pytest.mark.parametrize("device_medium, weights", [
    ("gpu", (0.8, 0.5)),
    # The index removes an entry only under the tier it was stored with:
    # a target that names the device tier otherwise than the pod leaves
    # the pod's entry behind, and the score does not move.
    ("hbm", (1.0, 1.0)),
])
def test_demotion_of_a_gpu_pod_moves_its_score(device_medium, weights):
    """A pod that publishes its device tier as ``gpu``, as vLLM pods on
    GPUs do: the port's own target and sink take the demoted chain out
    of ``gpu`` when the target is given that name."""
    m = mods("port")
    indexer, pool = make_stack(m)
    try:
        tokens = list(range(1, 33))
        n_blocks = len(tokens) // BLOCK_SIZE
        prompt = prompt_of(tokens)
        hashes = [0x9000 + i for i in range(n_blocks)]
        seed_chain(m, pool, "pod-1", hashes, tokens, medium="gpu")
        assert indexer.get_pod_scores(prompt, MODEL, ["pod-1"]) == {"pod-1": n_blocks}
        state = m.tiering.PodTierState(
            capacity_bytes=10_000, event_sink=m.tiering.pool_event_sink(pool, "pod-1", MODEL),
            device_medium=device_medium)
        state.register_group(0xF11E, engine_hashes=hashes, token_ids=tokens, nbytes=4096,
                             block_size=BLOCK_SIZE, now=time.monotonic() - 600)
        worker = m.tiering.DemotionWorker(state, None, m.tiering.DemotionConfig(
            demote_host_idle_s=0.0, demote_storage_idle_s=0.0, require_prediction=False))
        for weight, tier in zip(weights, ("host", "shared_storage")):
            assert worker.run_cycle(now=200.0) == 1
            pool.drain()
            scores = indexer.get_pod_scores(prompt, MODEL, ["pod-1"])
            assert abs(scores["pod-1"] - weight * n_blocks) < 1e-9
            entries, _ = indexer.kv_block_index.dump_entries()
            held = {e.device_tier for _, pods in entries for e in pods}
            assert held == ({tier} if device_medium == "gpu" else {"gpu", tier})
    finally:
        pool.shutdown()
        indexer.shutdown()


def test_pool_event_sink_payload_is_the_references():
    """The sink's message: topic, pod, model and the events its payload
    decodes to (the batch's timestamp is the wall clock's)."""

    class Collect:
        def __init__(self):
            self.messages = []

        def add_task(self, message):
            self.messages.append(message)

    def story(m):
        sink_pool = Collect()
        sink = m.tiering.pool_event_sink(sink_pool, "pod-9", MODEL)
        sink([])
        sink([m.events.BlockStored(block_hashes=[1, 2], parent_block_hash=7,
                                   token_ids=list(range(8)), block_size=4, medium="host"),
              m.events.BlockRemoved(block_hashes=[1, 2], medium="hbm")])
        (message,) = sink_pool.messages
        batch = m.events.decode_event_batch(bytes(message.payload))
        return (message.topic, message.pod_identifier, message.model_name,
                [event_view(m.events.decode_event(e)) for e in batch.events])

    same(story)


# ------------------------------------------------------ staged demotion


GEOMETRY = (2, 16, 4, 2, 8)  # layers, blocks, block_size, kv heads, head_dim


def host_numpy(dtype):
    return np.dtype(ml_dtypes.bfloat16) if dtype == "bfloat16" else np.dtype(dtype)


def kv_pool(m, dtype):
    config = m.kv_pool.KVCachePoolConfig(*GEOMETRY, dtype=dtype)
    if m.side == "port":
        return m.kv_pool.KVCachePool(config, device="cpu")
    return m.kv_pool.KVCachePool(config)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_staged_target_bytes_and_files_match_reference(tmp_path, dtype):
    """Both packages' ``StagedDemotionTarget`` over pools holding the same
    seeded blocks: the host-tier groups after the first rung and the
    files after the second are bit-equal, as are the events, the store
    observations' byte counts and the advisor's counts."""
    layers, _, bs, heads, dim = GEOMETRY
    blocks = np.random.default_rng(1).standard_normal(
        (layers, 12, 2, bs, heads, dim)).astype(host_numpy(dtype))

    def story(m):
        pool = kv_pool(m, dtype)
        pool.scatter_from_host(list(range(2, 14)), blocks)
        root = tmp_path / m.side
        spec = m.spec.TPUOffloadSpec(shared_storage_path=str(root), model_name=MODEL,
                                     device_block_size=bs, offloaded_block_size=2 * bs,
                                     threads_per_chip=2, dtype=dtype)
        connector = m.spec.TPUOffloadConnector(spec, pool)
        batches, stores = [], []
        cache = m.host_tier.HostTierCache(1 << 20)
        target = m.tiering.StagedDemotionTarget(
            capacity_bytes=16 * pool.block_nbytes, pool=pool,
            file_mapper=connector.file_mapper, host_cache=cache, event_sink=batches.append,
            store_rtt_observer=lambda n, s, d: stores.append((n, d)))
        groups = {0xA0 + g: [2 + 2 * g, 3 + 2 * g] for g in range(6)}
        for key, ids in groups.items():
            target.register_pool_group(key, block_ids=ids, engine_hashes=[key, key + 1],
                                       token_ids=list(range(2 * bs)), block_size=bs,
                                       now=time.monotonic() - 600)
        worker = m.tiering.DemotionWorker(target, None, m.tiering.DemotionConfig(
            demote_host_idle_s=0.0, demote_storage_idle_s=0.0, require_prediction=False,
            max_moves_per_cycle=6))
        try:
            assert worker.run_cycle(now=1.0) == 6
            host = {key: np.asarray(cache.get(key)).view(np.uint8).tobytes() for key in groups}
            assert worker.run_cycle(now=2.0) == 6
            files = {}
            for folder, _, names in os.walk(root):
                for name in names:
                    with open(os.path.join(folder, name), "rb") as handle:
                        files[os.path.relpath(os.path.join(folder, name), root)] = handle.read()
            assert len(files) == 6 and cache.stats()["entries"] == 0
            assert target.tiers() == {"shared_storage": 6}
            return host, files, [[event_view(e) for e in b] for b in batches], stores
        finally:
            connector.close()

    host, files, _, _ = same(story)
    # The bytes are the pool's blocks, block-major (the file layout).
    want = np.moveaxis(blocks, 1, 0).reshape(6, 2, *blocks.shape[:1], *blocks.shape[2:])
    for g, key in enumerate(sorted(host)):
        assert host[key] == np.ascontiguousarray(want[g]).view(np.uint8).tobytes()
    assert sorted(files.values()) == sorted(host.values())


def test_staged_target_failed_write_keeps_tier(tmp_path):
    """A file write that fails leaves the group in the host tier, its
    bytes still cached, and publishes nothing, in both packages."""

    class NoFiles:
        def get_file_name(self, key):
            return str(tmp_path / "not-a-dir" / f"{key:x}.bin")

    (tmp_path / "not-a-dir").write_text("a file where a directory must be")

    def story(m):
        pool = kv_pool(m, "float32")
        cache = m.host_tier.HostTierCache(1 << 20)
        batches = []
        target = m.tiering.StagedDemotionTarget(
            capacity_bytes=pool.block_nbytes * 16, pool=pool, file_mapper=NoFiles(),
            host_cache=cache, event_sink=batches.append)
        target.register_pool_group(0xB1, block_ids=[1, 2], engine_hashes=[5, 6],
                                   token_ids=list(range(8)), block_size=4)
        assert target.demote(0xB1, "host") is True
        assert target.demote(0xB1, "shared_storage") is False
        assert target.tiers() == {"host": 1} and cache.get(0xB1) is not None
        return len(batches), target.tiers()

    same(story)


# ------------------------------------------------- engine and wiring


def test_tiering_config_from_env_matches_reference(monkeypatch):
    for name, value in (("TIERING_REFRESH_S", "0.25"), ("TIERING_CLUSTER_BLOCKS", "3"),
                        ("TIERING_KEY_MAP_SIZE", "99"), ("TIERING_EVICTION_SAMPLE", "5"),
                        ("TIERING_UNKNOWN_NEXT_USE_S", "42"), ("TIERING_BLOCK_BYTES", "2048"),
                        ("BLOCK_SIZE", "8"), ("TIERING_PREFILL_TOKENS_PER_S", "1e4"),
                        ("TIERING_HYBRID", "off"), ("TIERING_DEMOTION_INTERVAL_S", "bogus"),
                        ("TIERING_DEMOTE_HOST_IDLE_S", "7"),
                        ("TIERING_DEMOTE_STORAGE_IDLE_S", "70"),
                        ("TIERING_PRESSURE_WATERMARK", "0.5")):
        monkeypatch.setenv(name, value)
    config = same(lambda m: dataclasses.asdict(m.tiering.TieringConfig.from_env()))
    assert config["refresh_s"] == 0.25 and config["advisor"]["hybrid"] is False
    assert config["demotion"]["interval_s"] == 5.0  # bogus: the default


def test_observe_scored_populates_feed():
    def story(m):
        ledger = make_ledger(m)
        engine = m.tiering.PolicyEngine(ledger=ledger,
                                        config=m.tiering.TieringConfig(refresh_s=0.0))
        ledger.record(0xAB, MODEL, 4, 4, now=10.0)
        engine.observe_scored([1, 2, 0xAB], 0xAB, now=10.0)
        engine.observe_scored([1, 2], None, now=11.0)  # no family: nothing learned
        status = engine.status()
        assert status["feed"]["observed_chains"] == 1 and status["feed"]["keys_mapped"] == 3
        policy = engine.eviction_policy("cost_aware")
        status = engine.status()
        status["feed"].pop("snapshot")
        return status["feed"], status["eviction"], status["advisor"], policy.stats()

    same(story)


def test_explain_carries_advice():
    def story(m):
        indexer, pool = make_stack(m)
        try:
            engine = m.tiering.PolicyEngine(ledger=indexer.cache_stats)
            engine.advisor.config.bytes_per_block = 1024
            engine.advisor.observe_load(1 << 20, 0.01)
            engine.advisor.observe_prefill(8192, 0.5)
            indexer.set_policy_engine(engine)
            tokens = list(range(1, 17))
            keys = indexer.token_processor.tokens_to_kv_block_keys(0, tokens, MODEL)
            indexer.kv_block_index.add(keys, keys, [m.index.PodEntry("pod-1", "host")])
            _, explanation = indexer.get_pod_scores_explained(prompt_of(tokens), MODEL)
            got = explanation["tiering"]
            assert got["pod"] == "pod-1" and got["blocks"] == len(keys)
            engine.close()
            return got
        finally:
            pool.shutdown()
            indexer.shutdown()

    advice_view = same(story)
    assert advice_view["action"] in ("load", "recompute", "hybrid")


@pytest.mark.parametrize("staging_lanes", [0, 2], ids=["one_shot", "staged"])
def test_connector_policy_engine_feeds_the_advisor(tmp_path, staging_lanes):
    """``TPUOffloadConnector(policy_engine=...)``: the host tier ranks by
    the engine's predictive policy, ``bytes_per_block`` comes from the
    pool, and a store and a load feed ``observe_store`` and
    ``observe_load`` once each, in both packages."""
    layers, _, bs, heads, dim = GEOMETRY
    blocks = np.random.default_rng(2).standard_normal(
        (layers, 4, 2, bs, heads, dim)).astype(host_numpy("bfloat16"))

    def story(m):
        pool = kv_pool(m, "bfloat16")
        pool.scatter_from_host([1, 2, 3, 4], blocks)
        engine = m.tiering.PolicyEngine(config=m.tiering.TieringConfig())
        spec = m.spec.TPUOffloadSpec(
            shared_storage_path=str(tmp_path / m.side / "a"), model_name=MODEL,
            device_block_size=bs, offloaded_block_size=2 * bs, threads_per_chip=2,
            staging_lanes=staging_lanes, host_cache_bytes=1 << 20, dtype="bfloat16")
        connector = m.spec.TPUOffloadConnector(spec, pool, policy_engine=engine)
        try:
            assert connector.host_cache._eviction_policy.backend == "host_tier"
            assert engine.advisor.config.bytes_per_block == pool.block_nbytes
            groups = m.worker.group_blocks_per_file([0xC1, 0xC2], [1, 2, 3, 4], 2)
            connector.store_handler.transfer_async(1, groups)
            assert connector.store_handler.wait(1).name == "SUCCEEDED"
            # Files only: the host tier would serve the load without I/O.
            connector.host_cache.evict(0xC1)
            connector.host_cache.evict(0xC2)
            connector.load_handler.transfer_async(
                2, m.worker.group_blocks_per_file([0xC1, 0xC2], [5, 6, 7, 8], 2))
            assert connector.load_handler.wait(2).name == "SUCCEEDED"
            stats = engine.advisor.stats()
            counts = (stats["rtt"]["observations"], stats["rtt_store"]["observations"],
                      stats["bytes_per_block"], engine.status()["eviction"][0]["backend"])
            assert counts[:2] == (1, 1)
            return counts
        finally:
            connector.close()
            engine.close()

    same(story)


@pytest.mark.parametrize("feed", ["rtt_observer", "store_rtt_observer", "eviction_policy"])
def test_connector_refuses_a_plain_feed_beside_the_engine(tmp_path, feed):
    """The engine supplies all three feeds; one passed beside it would be
    dropped or would race it, so the connector refuses the pair."""
    m = mods("port")
    pool = kv_pool(m, "float32")
    spec = m.spec.TPUOffloadSpec(shared_storage_path=str(tmp_path), model_name=MODEL,
                                 device_block_size=4, offloaded_block_size=8, dtype="float32",
                                 host_cache_bytes=1 << 20)
    with pytest.raises(ValueError, match="not both"):
        m.spec.TPUOffloadConnector(spec, pool, policy_engine=m.tiering.PolicyEngine(
            config=m.tiering.TieringConfig()), **{feed: m.tiering.LRU_POLICY})


# ------------------------------------------------ HTTP debug surface


def _http_indexer(m):
    indexer = m.indexer.Indexer(
        m.indexer.IndexerConfig(
            token_processor_config=m.tp.TokenProcessorConfig(block_size=BLOCK_SIZE),
            tokenizers_pool_config=m.tok_pool.TokenizationPoolConfig(workers=1,
                                                                     model_name=MODEL)),
        tokenizer=WordTokenizer(m))
    indexer.run()
    return indexer


def _get_json(base, path):
    import json
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=10) as response:
        return json.load(response)


def _tiering_surface(m):
    """``/debug/tiering`` and ``/healthz`` of a service whose Indexer
    has a policy engine."""
    indexer = _http_indexer(m)
    engine = m.tiering.PolicyEngine(ledger=indexer.cache_stats)
    indexer.set_policy_engine(engine)
    server = m.http.serve(indexer, host="127.0.0.1", port=0, tiering=engine)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        return _get_json(base, "/debug/tiering"), _get_json(base, "/healthz")
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
        indexer.shutdown()


@pytest.mark.parametrize("side", SIDES)
def test_debug_tiering_endpoint_and_healthz(side):
    """``TestPolicyEngineSurface.test_debug_endpoint_and_healthz``: the
    engine's status at ``/debug/tiering`` and its block in ``/healthz``."""
    payload, health = _tiering_surface(mods(side))
    assert "feed" in payload and "advisor" in payload
    assert payload["config"]["eviction_sample"] >= 1
    assert "tiering" in health
    assert "advice_counts" in health["tiering"]


def test_debug_tiering_answers_the_same_on_both_packages():
    """The two packages' ``/debug/tiering`` and ``/healthz`` tiering
    blocks carry the same keys and the same configuration."""

    def view(m):
        payload, health = _tiering_surface(m)
        return sorted(payload), payload["config"], sorted(health["tiering"])

    same(view)


@pytest.mark.parametrize("side", SIDES)
def test_debug_tiering_404_when_disabled(side):
    """``TestPolicyEngineSurface.test_debug_endpoint_404_when_disabled``."""
    import urllib.error

    m = mods(side)
    indexer = _http_indexer(m)
    server = m.http.serve(indexer, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _get_json(base, "/debug/tiering")
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        indexer.shutdown()
