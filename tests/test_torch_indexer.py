"""The port's Indexer read path against the JAX package's, on the CPU.

The same seeded prompts and index operations go through the JAX
``Indexer`` and the port's; every score dict must be equal (the same
keys, the same floats), on the straight path and the fast lane, with the
score memo on and off, and at pipeline depths 0 and 3 over a backend
with ``lookup_chain_async``.  Also: the reference's end-to-end cases on
the tiny tokenizer and its chat template, load blending, the explain
surface, the cost-aware and metrics-wrapped backends, and the in-memory
index's version vector, chain touch, key walk and slice-scoped purge."""

import random
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

from llm_d_kv_cache_manager_tpu.kvcache import indexer as jax_indexer
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import index as jax_index
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as jax_tp
from llm_d_kv_cache_manager_tpu.metrics import collector as jax_collector
from llm_d_kv_cache_manager_tpu.preprocessing import chat_templating as jax_chat
from llm_d_kv_cache_manager_tpu.tokenization import pool as jax_pool
from llm_d_kv_cache_manager_tpu.tokenization import tokenizers as jax_tokenizers
from tests.helpers.miniresp import MiniRespServer
from tests.helpers.tiny_tokenizer import (
    build_transformers_tokenizer,
    save_tokenizer_json,
)
from tests.helpers.torch_port import port

MODEL = "test-model"


def _modules(get):
    return SimpleNamespace(
        indexer=get("kvcache.indexer"),
        index=get("kvcache.kvblock.index"),
        tp=get("kvcache.kvblock.token_processor"),
        collector=get("metrics.collector"),
        chat=get("preprocessing.chat_templating"),
        pool=get("tokenization.pool"),
        tokenizers=get("tokenization.tokenizers"),
    )


JAX = SimpleNamespace(indexer=jax_indexer, index=jax_index, tp=jax_tp,
                      collector=jax_collector, chat=jax_chat, pool=jax_pool,
                      tokenizers=jax_tokenizers)
PORT = _modules(port)
SIDES = {"jax": JAX, "port": PORT}


class WordTokenizer:
    """``"t<id>"`` words to ids, with exact byte offsets."""

    def __init__(self, pkg):
        self._encoding = pkg.tokenizers.Encoding

    def type(self):
        return "test-word"

    def encode(self, prompt, model_name, add_special_tokens):
        tokens, offsets, pos = [], [], 0
        for word in prompt.split(" "):
            tokens.append(int(word[1:]) if word[:1] == "t" else 0)
            offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return self._encoding(tokens=tokens, offsets=offsets)


class AsyncBackend:
    """An index whose ``lookup_chain_async`` runs the chain lookup on a
    thread pool (as the cluster's RemoteIndex fans out), so the fast
    lane keeps chunks in flight; everything else is the inner index."""

    def __init__(self, inner):
        self._inner = inner
        self._executor = ThreadPoolExecutor(2, thread_name_prefix="test-async-index")
        self.speculation = []

    def lookup_chain_async(self, keys):
        return self._executor.submit(self._inner.lookup_chain, list(keys))

    def record_speculation(self, speculated, wasted):
        self.speculation.append((speculated, wasted))

    def close(self):
        self._executor.shutdown(wait=True)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def words(tokens):
    return " ".join(f"t{t}" for t in tokens)


def make_indexer(pkg, tokenizer=None, *, fast=True, memo=True, depth=0, block_size=16,
                 index_config=None, async_backend=False, load_blend=None, **config):
    cfg = pkg.indexer.IndexerConfig(
        token_processor_config=pkg.tp.TokenProcessorConfig(block_size=block_size),
        kvblock_index_config=index_config or pkg.index.IndexConfig(
            in_memory_config=pkg.index.InMemoryIndexConfig(size=200_000)),
        read_path_fast_lane=fast,
        score_memo_size=None if memo else 0,
        pipeline_depth=depth,
        lookup_chunk_size=8,
        cache_stats=True,
        load_blend=load_blend,
        **config,
    )
    backend = None
    if async_backend:
        backend = AsyncBackend(pkg.index.new_index(cfg.kvblock_index_config))
    indexer = pkg.indexer.Indexer(cfg, tokenizer=tokenizer or WordTokenizer(pkg),
                                  kv_block_index=backend)
    indexer.run()
    return indexer


def close(indexers):
    for indexer in indexers:
        indexer.shutdown()
        if isinstance(indexer.kv_block_index, AsyncBackend):
            indexer.kv_block_index.close()


def add_chain(pkg, indexer, tokens, pod, tier, model="m", cut=None):
    keys = indexer.token_processor.tokens_to_kv_block_keys(
        pkg.tp.EMPTY_BLOCK_HASH, tokens, model)
    if cut is not None:
        keys = keys[:cut]
    if keys:
        indexer.kv_block_index.add(keys, keys, [pkg.index.PodEntry(pod, tier)])
    return keys


# --------------------------------------------------- the in-memory index


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_version_vector_and_slice_purge_match_reference(seed, shards):
    """A seeded sequence of adds, evicts, purges (pod-wide and
    slice-scoped), chain touches and restores through both in-memory
    indexes: equal version vectors after every operation, equal resident
    key walks and equal purge results; small capacities force LRU
    evictions."""
    rng = np.random.default_rng(seed)
    indexes = {name: pkg.index.new_index(pkg.index.IndexConfig(
        in_memory_config=pkg.index.InMemoryIndexConfig(size=160, pod_cache_size=3,
                                                       shards=shards)))
               for name, pkg in SIDES.items()}
    pods = [f"pod-{i}" for i in range(4)]
    tiers = ["hbm", "host", "shared_storage"]
    stored = []
    for step in range(220):
        op = rng.choice(["add", "add", "evict", "touch", "purge", "purge_keys", "restore"],
                        p=[0.3, 0.2, 0.2, 0.1, 0.05, 0.1, 0.05])
        results = {}
        if op == "add":
            n = int(rng.integers(1, 12))
            engine = [int(k) for k in rng.integers(0, 2**63, n)]
            request = [int(k) for k in rng.integers(0, 400, n)]
            pod, tier = str(rng.choice(pods)), str(rng.choice(tiers))
            stored.append((engine, pod, tier))
            for name, pkg in SIDES.items():
                indexes[name].add(engine, request, [pkg.index.PodEntry(pod, tier)])
        elif op == "evict" and stored:
            engine, pod, tier = stored[int(rng.integers(len(stored)))]
            key = engine[int(rng.integers(len(engine)))]
            for name, pkg in SIDES.items():
                indexes[name].evict(key, [pkg.index.PodEntry(pod, tier)])
        elif op == "touch":
            keys = [int(k) for k in rng.integers(0, 400, 8)]
            for index in indexes.values():
                index.touch_chain(keys)
        elif op == "purge":
            pod = str(rng.choice(pods))
            results = {name: index.purge_pod(pod) for name, index in indexes.items()}
        elif op == "purge_keys":
            pod = str(rng.choice(pods))
            keys = [int(k) for k in rng.integers(0, 400, 40)]
            results = {name: index.purge_pod_keys(pod, keys) for name, index in indexes.items()}
        elif op == "restore":
            entries, engine_map = indexes["jax"].dump_entries()
            for name, pkg in SIDES.items():
                blocks = [(k, [pkg.index.PodEntry(p.pod_identifier, p.device_tier) for p in ps])
                          for k, ps in entries]
                results[name] = indexes[name].restore_entries(blocks, engine_map)
        assert results.get("jax") == results.get("port"), (step, op, results)
        assert indexes["port"].version_vector() == indexes["jax"].version_vector(), (step, op)
        assert indexes["port"].request_keys() == indexes["jax"].request_keys(), (step, op)
    assert sum(indexes["port"].version_vector()) > 0


def test_new_index_dispatch_matches_reference():
    """``new_index(IndexConfig)`` picks the same backend class as the
    reference's, Redis included: against a ``miniresp`` server the port
    builds its own ``RedisIndex``, never falling back onto an in-memory
    index."""
    server = MiniRespServer()
    try:
        for fields in ({}, {"cost_aware_config": "CostAwareIndexConfig"},
                       {"enable_metrics": True}, {"redis_config": "RedisIndexConfig"}):
            built = {}
            for name, pkg in SIDES.items():
                kwargs = {k: (getattr(pkg.index, v)() if isinstance(v, str) else v)
                          for k, v in fields.items()}
                if "redis_config" in kwargs:
                    kwargs["redis_config"].address = server.address
                index = pkg.index.new_index(pkg.index.IndexConfig(**kwargs))
                built[name] = (type(index).__name__, type(index).__module__.split(".", 1)[1])
            assert built["port"] == built["jax"], fields
    finally:
        server.close()


def test_port_indexer_runs_with_the_score_memo():
    """Over the port's own in-memory index the memo is on and building
    the Indexer leaves ``kvtpu_score_memo_disabled`` where it was.  The
    gauge is process-wide and latches to 1 once any Indexer meets a
    backend without ``version_vector``, so it is read before and after,
    as the reference's cluster test does."""
    gauge = PORT.collector.METRICS.score_memo_disabled
    before = PORT.collector.gauge_value(gauge)
    indexer = make_indexer(PORT)
    try:
        assert indexer._score_memo is not None
        assert PORT.collector.gauge_value(gauge) == before
    finally:
        close([indexer])


def test_uds_tokenizer_is_not_ported():
    """The name dates from before the port had the UDS backend; it now
    checks the opposite: ``uds_tokenizer_path`` puts the port's sidecar
    client ahead of the hub fallback, as in the reference (the channel
    connects lazily, so a missing socket does not fail construction)."""
    indexer = PORT.indexer.Indexer(PORT.indexer.IndexerConfig(uds_tokenizer_path="/nonexistent"))
    try:
        backends = indexer.tokenization_pool._tokenizer.backends
        assert [b.type() for b in backends] == ["uds", "transformers"]
        assert type(backends[0]).__module__ == "llm_d_kv_cache_manager_tpu_torch.tokenization.uds_tokenizer"
    finally:
        backends[0].close()
        indexer.shutdown()


# ------------------------------------------- end-to-end, tiny tokenizer

PROMPT = "the quick brown fox jumps over the lazy dog . " * 8


@pytest.fixture()
def tiny_stacks(tmp_path):
    """A JAX and a port Indexer on the tiny fast tokenizer (block size 4)
    with its chat template registered, for the e2e cases."""
    tokenizer_dir = save_tokenizer_json(str(tmp_path), MODEL)
    stacks = {}
    try:
        for name, pkg in SIDES.items():
            indexer = pkg.indexer.Indexer(
                pkg.indexer.IndexerConfig(
                    token_processor_config=pkg.tp.TokenProcessorConfig(block_size=4),
                    kvblock_index_config=pkg.index.IndexConfig(
                        in_memory_config=pkg.index.InMemoryIndexConfig(size=10_000)),
                    tokenizers_pool_config=pkg.pool.TokenizationPoolConfig(
                        workers=2, model_name=MODEL),
                ),
                tokenizer=pkg.tokenizers.LocalFastTokenizer(tokenizer_dir),
            )
            indexer.chat_processor.register_tokenizer(MODEL, build_transformers_tokenizer())
            indexer.run()
            stacks[name] = indexer
        yield stacks
    finally:
        close(stacks.values())


def publish(stacks, prompt, pod, medium="hbm", base_hash=0x1000):
    """Each pod stores every full block of ``prompt``'s tokens, as the
    event pool would apply a BlockStored event; returns the engine keys
    and the block count."""
    out = None
    for name, indexer in stacks.items():
        pkg = SIDES[name]
        tokens = indexer.tokenization_pool._tokenizer.encode(prompt, MODEL, True).tokens
        n_blocks = len(tokens) // 4
        engine = [base_hash + i for i in range(n_blocks)]
        request = indexer.token_processor.tokens_to_kv_block_keys(
            pkg.tp.EMPTY_BLOCK_HASH, tokens[:n_blocks * 4], MODEL)
        indexer.kv_block_index.add(engine, request, [pkg.index.PodEntry(pod, medium)])
        out = (engine, n_blocks)
    return out


def scores(stacks, prompt, pods, render=None):
    got = {}
    for name, indexer in stacks.items():
        req = None if render is None else SIDES[name].chat.ApplyChatTemplateRequest(
            conversation=render)
        got[name] = indexer.get_pod_scores(prompt, MODEL, pods, render_req=req)
    assert got["port"] == got["jax"]
    return got["port"]


E2E = ["miss_then_hit", "prefix_reduction", "prefix_expansion", "tier_weighting",
       "eviction", "pod_filter", "chat_completions", "long_prompt"]


@pytest.mark.parametrize("case", E2E)
def test_indexer_e2e_cases_match_reference(tiny_stacks, case):
    """tests/test_indexer_e2e.py's cases, on both Indexers at once."""
    stacks = tiny_stacks
    if case == "miss_then_hit":
        assert scores(stacks, PROMPT, ["pod-1"]) == {"pod-1": 0.0}
        _, n = publish(stacks, PROMPT, "pod-1")
        assert scores(stacks, PROMPT, ["pod-1"]) == {"pod-1": float(n)}
    elif case == "prefix_reduction":
        publish(stacks, PROMPT, "pod-1")
        assert scores(stacks, PROMPT[: len(PROMPT) // 2], ["pod-1"])["pod-1"] > 0
    elif case == "prefix_expansion":
        _, n = publish(stacks, PROMPT, "pod-1")
        longer = PROMPT + "pack my box with five dozen liquor jugs . " * 8
        assert 0 < scores(stacks, longer, ["pod-1"])["pod-1"] <= n
    elif case == "tier_weighting":
        publish(stacks, PROMPT, "pod-hbm", "hbm", 0x1000)
        publish(stacks, PROMPT, "pod-host", "host", 0x2000)
        got = scores(stacks, PROMPT, ["pod-hbm", "pod-host"])
        assert got["pod-hbm"] > got["pod-host"] > 0
    elif case == "eviction":
        engine, _ = publish(stacks, PROMPT, "pod-1")
        for name, indexer in stacks.items():
            for key in engine:
                indexer.kv_block_index.evict(key, [SIDES[name].index.PodEntry("pod-1", "hbm")])
        assert scores(stacks, PROMPT, ["pod-1"]) == {"pod-1": 0.0}
    elif case == "pod_filter":
        publish(stacks, PROMPT, "pod-1")
        assert scores(stacks, PROMPT, ["other-pod"]) == {"other-pod": 0.0}
    elif case == "chat_completions":
        conversation = [{"role": "system", "content": "you are a helpful assistant ."},
                        {"role": "user", "content": "hello world"}]
        rendered = {name: indexer.chat_processor.apply_chat_template(
            MODEL, SIDES[name].chat.ApplyChatTemplateRequest(conversation=conversation))
            for name, indexer in stacks.items()}
        assert rendered["port"] == rendered["jax"]
        publish(stacks, rendered["port"], "pod-chat")
        assert scores(stacks, "", ["pod-chat"], render=conversation)["pod-chat"] > 0
    elif case == "long_prompt":
        _, n = publish(stacks, PROMPT * 12, "pod-long")
        assert n > 100
        assert scores(stacks, PROMPT * 12, ["pod-long"]) == {"pod-long": float(n)}


# ------------------------------------------------ randomized lane parity

LANES = {
    "straight": dict(fast=False),
    "fast": dict(fast=True),
    "fast_no_memo": dict(fast=True, memo=False),
    "pipeline_0": dict(fast=True, depth=0, async_backend=True),
    "pipeline_3": dict(fast=True, depth=3, async_backend=True),
}


@pytest.mark.parametrize("lane", list(LANES))
def test_lane_scores_match_reference(lane):
    """Numpy-seeded multi-turn growth, tier mixes, pod filters and broken
    chains (tests/test_read_path_fastlane.py's workload): each of the
    port's scores equals the JAX Indexer's on the same lane, and equals
    the JAX straight path's."""
    rng = np.random.default_rng(42)
    indexers = {name: make_indexer(pkg, **LANES[lane]) for name, pkg in SIDES.items()}
    oracle = make_indexer(JAX, fast=False)
    every = {**indexers, "oracle": oracle}
    sides = {**SIDES, "oracle": JAX}
    pods = [f"pod-{i}" for i in range(4)]
    try:
        convo = [int(t) for t in rng.integers(1, 60_000, 400)]
        for turn in range(4):
            for name, indexer in every.items():
                keys = add_chain(sides[name], indexer, convo, "pod-0", "hbm")
                add_chain(sides[name], indexer, convo, "pod-1", "host", cut=len(keys) // 2)
            prompt = words(convo)
            for flt in (None, pods, pods[:2], ["pod-404"]):
                for _ in range(3):  # cold, warm, memo hit
                    got = {name: ix.get_pod_scores(prompt, "m", flt) for name, ix in every.items()}
                    assert got["port"] == got["jax"] == got["oracle"], (turn, flt, got)
            convo.extend(int(t) for t in rng.integers(1, 60_000, 48))
        for trial in range(20):
            tokens = [int(t) for t in rng.integers(1, 60_000, int(rng.integers(0, 300)))]
            prompt = words(tokens) if tokens else "t1"
            cut, tier = float(rng.random()), str(rng.choice(["hbm", "host", "cpu", "weird"]))
            pod = str(rng.choice(pods))
            for name, indexer in every.items():
                keys = indexer.token_processor.tokens_to_kv_block_keys(0, tokens, "m")
                if keys:
                    add_chain(sides[name], indexer, tokens, pod, tier,
                              cut=max(1, int(cut * len(keys))))
            flt = [None, pods, pods[:2]][int(rng.integers(3))]
            got = {name: ix.get_pod_scores(prompt, "m", flt) for name, ix in every.items()}
            assert got["port"] == got["jax"] == got["oracle"], (trial, got)
        if lane.startswith("pipeline"):
            assert (indexers["port"].kv_block_index.speculation
                    == indexers["jax"].kv_block_index.speculation)
    finally:
        close(every.values())


def test_load_blending_matches_reference():
    """LOAD_BLEND's ``score / (1 + blend * depth)`` on both Indexers, on
    ``get_pod_scores`` and on the explain surface."""
    indexers = {name: make_indexer(pkg, load_blend=0.5) for name, pkg in SIDES.items()}
    try:
        tokens = list(range(100, 420))
        for name, indexer in indexers.items():
            add_chain(SIDES[name], indexer, tokens, "pod-a", "hbm")
            add_chain(SIDES[name], indexer, tokens, "pod-b", "host", cut=7)
        prompt = words(tokens)
        results = {}
        for what, pod_loads in (("cold", None), ("loads", {"pod-a": 3.0, "pod-b": 0.5}),
                                ("negative", {"pod-a": -2.0}), ("none", None)):
            got = {name: ix.get_pod_scores(prompt, "m", ["pod-a", "pod-b", "pod-c"],
                                           pod_loads=pod_loads)
                   for name, ix in indexers.items()}
            assert got["port"] == got["jax"], pod_loads
            explained = {name: ix.get_pod_scores_explained(prompt, "m", pod_loads=pod_loads)
                         for name, ix in indexers.items()}
            assert explained["port"] == explained["jax"], pod_loads
            results[what] = got["port"], explained["port"][1]
        blend = results["loads"][1]["load_blend"]["pods"]["pod-a"]
        assert blend["queue_depth"] == 3.0 and blend["blended"] == blend["raw"] / 2.5
        assert results["loads"][0]["pod-a"] == blend["blended"]
        assert results["negative"][0] == results["none"][0]  # a negative depth counts as 0
        assert "load_blend" not in results["none"][1]
    finally:
        close(indexers.values())


def test_explain_without_engines_matches_reference():
    """``get_pod_scores_explained`` with no policy or transfer engine:
    equal scores and explanation (tokens, block keys, per-pod matched
    blocks, break index and tiers), and ``get_pod_scores_planned`` gives
    no directive."""
    indexers = {name: make_indexer(pkg) for name, pkg in SIDES.items()}
    try:
        rng = random.Random(9)
        tokens = [rng.randrange(1, 60_000) for _ in range(320)]
        for name, indexer in indexers.items():
            add_chain(SIDES[name], indexer, tokens, "pod-0", "hbm")
            add_chain(SIDES[name], indexer, tokens, "pod-1", "host", cut=5)
        prompt = words(tokens)
        for flt in (None, ["pod-1", "pod-9"]):
            got = {name: ix.get_pod_scores_explained(prompt, "m", flt)
                   for name, ix in indexers.items()}
            assert got["port"] == got["jax"]
            planned = {name: ix.get_pod_scores_planned(prompt, "m", flt)
                       for name, ix in indexers.items()}
            assert planned["port"] == planned["jax"] and planned["port"][1] is None
    finally:
        close(indexers.values())


@pytest.mark.parametrize("backend", ["cost_aware", "instrumented"])
def test_backends_match_reference(backend):
    """The byte-budgeted index (a budget small enough to evict) and the
    metrics wrapper under both Indexers, fast lane and straight path; the
    wrapper's lookup counter moves by the same amount in both packages."""
    def config(pkg):
        if backend == "cost_aware":
            return pkg.index.IndexConfig(cost_aware_config=pkg.index.CostAwareIndexConfig(
                max_cost_bytes=12_000))
        return pkg.index.IndexConfig(enable_metrics=True)

    indexers = {(name, fast): make_indexer(pkg, fast=fast, index_config=config(pkg))
                for name, pkg in SIDES.items() for fast in (True, False)}
    totals = {name: pkg.collector.counter_total(pkg.collector.METRICS.index_lookup_requests)
              for name, pkg in SIDES.items()}
    try:
        rng = np.random.default_rng(3)
        for step in range(30):
            tokens = [int(t) for t in rng.integers(1, 5_000, int(rng.integers(16, 200)))]
            pod, tier = f"pod-{int(rng.integers(3))}", str(rng.choice(["hbm", "host"]))
            for (name, _), indexer in indexers.items():
                add_chain(SIDES[name], indexer, tokens, pod, tier)
            prompt = words(tokens[: int(rng.integers(16, len(tokens) + 1))])
            got = {key: ix.get_pod_scores(prompt, "m") for key, ix in indexers.items()}
            for fast in (True, False):
                assert got[("port", fast)] == got[("jax", fast)], (step, fast)
        moved = {name: pkg.collector.counter_total(pkg.collector.METRICS.index_lookup_requests)
                 - totals[name] for name, pkg in SIDES.items()}
        if backend == "instrumented":
            assert moved["port"] == moved["jax"] == 60
    finally:
        close(indexers.values())
