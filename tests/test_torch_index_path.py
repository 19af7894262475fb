"""The port's copied index path against the JAX package's: block keys,
the in-memory index and the longest-prefix scorer must agree exactly."""

import random

import pytest

from llm_d_kv_cache_manager_tpu.kvcache.kvblock.index import (
    IndexConfig,
    InMemoryIndexConfig as JaxIndexConfig,
    PodEntry as JaxPodEntry,
    new_index as jax_new_index,
)
from llm_d_kv_cache_manager_tpu.kvcache.kvblock.token_processor import (
    ChunkedTokenDatabase as JaxDatabase,
    TokenProcessorConfig as JaxTokenConfig,
)
from llm_d_kv_cache_manager_tpu.kvcache.scorer import (
    ScorerConfig as JaxScorerConfig,
    TierConfig as JaxTierConfig,
    new_scorer as jax_new_scorer,
)
from tests.helpers.torch_port import port

tp = port("kvcache.kvblock.token_processor")
index_mod = port("kvcache.kvblock.index")
scorer_mod = port("kvcache.scorer")

MODELS = ["meta-llama/Llama-3.1-8B", "Qwen/Qwen2-7B"]
TIERS = ["hbm", "host", "shared_storage", "gpu", "cpu"]


@pytest.mark.parametrize("hash_seed", ["", "0", "1234"])
@pytest.mark.parametrize("block_size", [4, 16])
def test_block_keys_bit_identical(hash_seed, block_size):
    rng = random.Random(hash_seed + str(block_size))
    jax_db = JaxDatabase(JaxTokenConfig(block_size=block_size, hash_seed=hash_seed))
    port_db = tp.ChunkedTokenDatabase(
        tp.TokenProcessorConfig(block_size=block_size, hash_seed=hash_seed))
    assert port_db.key_space == jax_db.key_space
    for model in MODELS:
        for n in (0, block_size - 1, block_size, 5 * block_size + 3, 40 * block_size):
            # Token ids across every CBOR head width (1, 2, 3, 5, 9 bytes).
            tokens = [rng.choice([rng.randrange(24), rng.randrange(256),
                                  rng.randrange(65536), rng.randrange(2**32),
                                  rng.randrange(2**40)]) for _ in range(n)]
            want = jax_db.tokens_to_kv_block_keys(0, tokens, model)
            assert port_db.tokens_to_kv_block_keys(0, tokens, model) == want
            if want:  # resuming a chain off a parent key
                rest = tokens[block_size:]
                assert port_db.extend_block_keys(want[0], rest, model) == \
                    jax_db.extend_block_keys(want[0], rest, model)


def test_hash_seed_mismatch_gives_other_keys():
    tokens = list(range(64))
    a = tp.ChunkedTokenDatabase(tp.TokenProcessorConfig(hash_seed="0"))
    b = JaxDatabase(JaxTokenConfig(hash_seed="1"))
    assert set(a.tokens_to_kv_block_keys(0, tokens, MODELS[0])).isdisjoint(
        b.tokens_to_kv_block_keys(0, tokens, MODELS[0]))


def _entries(rng, pods, cls):
    chosen = rng.sample(pods, rng.randint(1, 2))
    return [cls(pod, rng.choice(TIERS)) for pod in chosen]


def _plain(value):
    """PodEntry structures of either package as comparable tuples."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if hasattr(value, "pod_identifier"):
        return (value.pod_identifier, value.device_tier)
    return value


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shards", [1, 8])
def test_random_index_workload_matches_reference(seed, shards):
    """One random add/evict/lookup/score sequence driven through both
    packages: every lookup, chain lookup, score and the final dump agree.
    Small capacities force LRU evictions of keys and of pod entries."""
    rng = random.Random(seed)
    cfg = dict(size=96, pod_cache_size=2, shards=shards)
    jax_index = jax_new_index(IndexConfig(in_memory_config=JaxIndexConfig(**cfg)))
    port_index = index_mod.new_index(
        index_mod.IndexConfig(in_memory_config=index_mod.InMemoryIndexConfig(**cfg)))
    jax_db = JaxDatabase(JaxTokenConfig(block_size=4, hash_seed="7"))
    port_db = tp.ChunkedTokenDatabase(tp.TokenProcessorConfig(block_size=4, hash_seed="7"))
    jax_scorer = jax_new_scorer(JaxScorerConfig())
    port_scorer = scorer_mod.new_scorer(scorer_mod.ScorerConfig())
    pods = [f"pod-{i}" for i in range(4)]
    prefixes = [[rng.randrange(1000) for _ in range(rng.choice([8, 16, 32]))] for _ in range(5)]
    stored = []  # (engine keys, pod, tier) for later evictions

    def prompt():
        return rng.choice(prefixes) + [rng.randrange(1000) for _ in range(rng.randrange(0, 24))]

    for _ in range(300):
        op = rng.random()
        tokens = prompt()
        keys = port_db.tokens_to_kv_block_keys(0, tokens, MODELS[0])
        assert keys == jax_db.tokens_to_kv_block_keys(0, tokens, MODELS[0])
        if not keys:
            continue
        if op < 0.45:
            entries = _entries(rng, pods, index_mod.PodEntry)
            engine = [k ^ 0x5555 for k in keys]
            port_index.add(engine, keys, entries)
            jax_index.add(engine, keys, [JaxPodEntry(e.pod_identifier, e.device_tier)
                                         for e in entries])
            stored.append((engine, entries))
        elif op < 0.6 and stored:
            engine, entries = rng.choice(stored)
            victim = rng.choice(entries)
            key = rng.choice(engine)
            port_index.evict(key, [victim])
            jax_index.evict(key, [JaxPodEntry(victim.pod_identifier, victim.device_tier)])
        elif op < 0.8:
            pod_set = set(rng.sample(pods, 2)) if rng.random() < 0.5 else None
            got = port_index.lookup(keys, pod_set)
            want = jax_index.lookup(keys, pod_set)
            assert _plain(got) == _plain(want)
            assert port_scorer.score(keys, got) == jax_scorer.score(keys, want)
            assert port_scorer.explain(keys, got) == jax_scorer.explain(keys, want)
        else:
            got = port_index.lookup_chain(keys)
            want = jax_index.lookup_chain(keys)
            assert _plain(got) == _plain(want)
            chain_p, chain_j = port_scorer.begin(True, True), jax_scorer.begin(True, True)
            pod_set = set(rng.sample(pods, 3))
            assert port_scorer.advance(chain_p, got, pod_set) == \
                jax_scorer.advance(chain_j, want, pod_set)
            assert chain_p.scores == chain_j.scores
            assert chain_p.tier_counts == chain_j.tier_counts
            assert chain_p.provenance() == chain_j.provenance()
    assert _plain(port_index.dump_entries()) == _plain(jax_index.dump_entries())
    assert port_index.purge_pod("pod-1") == jax_index.purge_pod("pod-1")
    assert _plain(port_index.dump_entries()) == _plain(jax_index.dump_entries())


def test_restore_round_trip_matches_reference():
    rng = random.Random(5)
    cfg = dict(size=64, pod_cache_size=3, shards=4)
    jax_index = jax_new_index(IndexConfig(in_memory_config=JaxIndexConfig(**cfg)))
    port_index = index_mod.new_index(
        index_mod.IndexConfig(in_memory_config=index_mod.InMemoryIndexConfig(**cfg)))
    for i in range(40):
        keys = [rng.getrandbits(64) for _ in range(3)]
        entry = (f"pod-{i % 3}", rng.choice(TIERS))
        jax_index.add(keys, keys, [JaxPodEntry(*entry)])
        port_index.add(keys, keys, [index_mod.PodEntry(*entry)])
    dump = jax_index.dump_entries()
    fresh = index_mod.new_index(
        index_mod.IndexConfig(in_memory_config=index_mod.InMemoryIndexConfig(**cfg)))
    blocks = [(k, [index_mod.PodEntry(p.pod_identifier, p.device_tier) for p in pods])
              for k, pods in dump[0]]
    assert fresh.restore_entries(blocks, dump[1]) == len(blocks)
    assert _plain(fresh.dump_entries()) == _plain(port_index.dump_entries())
    for engine, request in dump[1]:
        assert fresh.get_request_key(engine) == request
    with pytest.raises(KeyError):
        fresh.get_request_key(12345)


def test_scorer_tier_weights_match_reference():
    tiers = [("hbm", 1.0), ("host", 0.8), ("fast-ssd", 0.3)]
    jax_scorer = jax_new_scorer(JaxScorerConfig(tier_configs=[JaxTierConfig(*t) for t in tiers]))
    port_scorer = scorer_mod.new_scorer(
        scorer_mod.ScorerConfig(tier_configs=[scorer_mod.TierConfig(*t) for t in tiers]))
    keys = [1, 2, 3, 4]
    rows = {1: [("a", "hbm"), ("b", "host"), ("c", "brand-new-tier")],
            2: [("a", "fast-ssd"), ("b", "host"), ("c", "hbm")],
            3: [("a", "host"), ("c", "hbm")],
            4: [("c", "host")]}
    got = port_scorer.score(keys, {k: [index_mod.PodEntry(*e) for e in v] for k, v in rows.items()})
    want = jax_scorer.score(keys, {k: [JaxPodEntry(*e) for e in v] for k, v in rows.items()})
    assert got == want
    with pytest.raises(ValueError):
        scorer_mod.new_scorer(scorer_mod.ScorerConfig(scoring_strategy="nope"))
