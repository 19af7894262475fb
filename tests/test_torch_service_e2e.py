"""The deep end-to-end suite through each package's booted HTTP service,
on the CPU.

Every case of the reference's ``tests/test_service_e2e.py`` runs on both
packages (``m`` is either one's names): cache hit and miss, prefix
reduction, prefix expansion churn (store, score, store more, rescore),
~4.5k-token prompts, chat-completions flows with long multi-turn
conversations, tokenizer auto-discovery (plain and HF-cache layouts)
through the booted service, and eviction then rescore.  The write path is
the package's own event pool (encoded batches, chained engine hashes);
the read path is HTTP against that package's ``api/http_service.py``.
"""

from __future__ import annotations

import json
import os
import urllib.request

import pytest

from tests.helpers.tiny_tokenizer import (
    build_fast_tokenizer,
    build_transformers_tokenizer,
    save_tokenizer_json,
)

from llm_d_kv_cache_manager_tpu.api import http_service as ref_http_service
from llm_d_kv_cache_manager_tpu.kvcache import indexer as ref_indexer
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import index as ref_index
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as ref_token_processor
from llm_d_kv_cache_manager_tpu.kvevents import events as ref_events
from llm_d_kv_cache_manager_tpu.kvevents import pool as ref_kvevents_pool
from llm_d_kv_cache_manager_tpu.metrics import collector as ref_collector
from llm_d_kv_cache_manager_tpu.preprocessing import chat_templating as ref_chat_templating
from llm_d_kv_cache_manager_tpu.tokenization import pool as ref_tokenization_pool
from tests.helpers.torch_port import namespace

SIDES = ("ref", "port")
_REF = {
    "api.http_service": ref_http_service,
    "kvcache.indexer": ref_indexer,
    "kvcache.kvblock.index": ref_index,
    "kvcache.kvblock.token_processor": ref_token_processor,
    "kvevents.events": ref_events,
    "kvevents.pool": ref_kvevents_pool,
    "metrics.collector": ref_collector,
    "preprocessing.chat_templating": ref_chat_templating,
    "tokenization.pool": ref_tokenization_pool,
}
_NAMES = {
    "api.http_service": ("serve",),
    "kvcache.indexer": ("Indexer", "IndexerConfig"),
    "kvcache.kvblock.index": ("InMemoryIndexConfig", "IndexConfig"),
    "kvcache.kvblock.token_processor": ("TokenProcessorConfig",),
    "kvevents.events": ("BlockRemoved", "BlockStored", "EventBatch"),
    "kvevents.pool": ("Message", "Pool", "PoolConfig"),
    "metrics.collector": ("METRICS",),
    "preprocessing.chat_templating": ("ApplyChatTemplateRequest",),
    "tokenization.pool": ("TokenizationPoolConfig",),
}


@pytest.fixture(params=SIDES)
def m(request):
    return namespace(request.param, _REF, _NAMES)


MODEL = "test-model"
BLOCK_SIZE = 4
SENTENCE = "the quick brown fox jumps over the lazy dog . "  # 10 tokens


class ServiceFleet:
    """The booted stack + helpers shared by every scenario."""

    def __init__(self, m, indexer, event_pool, base_url):
        self.m = m
        self.indexer = indexer
        self.event_pool = event_pool
        self.base_url = base_url
        self._next_hash = 0x1000

    # -- write path (real event pool, chained engine hashes) --

    def publish(self, pod, tokens, parent=None, medium="hbm"):
        """One BlockStored batch for every full block of ``tokens``;
        returns the engine hashes.  ``parent`` chains onto an earlier
        batch's last hash (prefix expansion, reference
        e2e_test.go:178-213)."""
        m = self.m
        n_blocks = len(tokens) // BLOCK_SIZE
        hashes = [self._next_hash + i for i in range(n_blocks)]
        self._next_hash += n_blocks
        batch = m.EventBatch(
            ts=1.0,
            events=[
                m.BlockStored(
                    block_hashes=hashes,
                    parent_block_hash=parent,
                    token_ids=tokens[: n_blocks * BLOCK_SIZE],
                    block_size=BLOCK_SIZE,
                    medium=medium,
                )
            ],
        )
        self._send(pod, batch)
        return hashes

    def evict(self, pod, hashes):
        m = self.m
        self._send(
            pod, m.EventBatch(ts=2.0, events=[m.BlockRemoved(block_hashes=hashes)])
        )

    def _send(self, pod, batch):
        self.event_pool.add_task(
            self.m.Message(
                topic=f"kv@{pod}@{MODEL}",
                payload=batch.encode(),
                pod_identifier=pod,
                model_name=MODEL,
            )
        )
        self.event_pool.drain()

    def tokenize(self, prompt):
        return self.indexer.tokenization_pool.tokenize(prompt, MODEL, None)

    # -- read path (real HTTP) --

    def _post(self, path, obj):
        request = urllib.request.Request(
            self.base_url + path,
            data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(request, timeout=30) as response:
            assert response.status == 200
            return json.load(response)

    def score(self, prompt, model=MODEL):
        return self._post(
            "/score_completions", {"prompt": prompt, "model": model}
        )

    def score_chat(self, messages, model=MODEL):
        return self._post(
            "/score_chat_completions",
            {"model": model, "messages": messages},
        )


def boot(m, tokenizers_dir, register_chat=True):
    indexer = m.Indexer(
        m.IndexerConfig(
            token_processor_config=m.TokenProcessorConfig(
                block_size=BLOCK_SIZE
            ),
            kvblock_index_config=m.IndexConfig(
                in_memory_config=m.InMemoryIndexConfig(size=100_000)
            ),
            tokenizers_pool_config=m.TokenizationPoolConfig(
                workers=2, model_name=MODEL
            ),
            # Auto-discovery: no injected tokenizer; the composite's
            # local backend walks this dir (reference
            # TestCacheHitWithLocalTokenizer, e2e_test.go:388-433).
            local_tokenizers_dir=tokenizers_dir,
        )
    )
    if register_chat:
        indexer.chat_processor.register_tokenizer(
            MODEL, build_transformers_tokenizer()
        )
    indexer.run()
    event_pool = m.Pool(
        indexer.kv_block_index,
        indexer.token_processor,
        m.PoolConfig(concurrency=2),
    )
    event_pool.start()
    server = m.serve(indexer, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    return ServiceFleet(m, indexer, event_pool, base), server


@pytest.fixture()
def fleet(m, tmp_path):
    tokenizers_dir = save_tokenizer_json(str(tmp_path), MODEL)
    booted, server = boot(m, tokenizers_dir)
    yield booted
    server.shutdown()
    server.server_close()
    booted.event_pool.shutdown()
    booted.indexer.shutdown()


class TestServiceE2E:
    def test_cache_hit(self, fleet):
        """e2e_test.go:116 TestCacheHit."""
        prompt = SENTENCE * 8
        tokens = fleet.tokenize(prompt)
        fleet.publish("pod-1", tokens)
        scores = fleet.score(prompt)
        assert scores["pod-1"] == pytest.approx(
            len(tokens) // BLOCK_SIZE
        )

    def test_cache_miss(self, fleet):
        """e2e_test.go:131 TestCacheMiss."""
        fleet.publish("pod-1", fleet.tokenize(SENTENCE * 8))
        scores = fleet.score("pack my box with five dozen liquor jugs . " * 8)
        assert scores == {}

    def test_prefix_reduction(self, fleet):
        """e2e_test.go:142 TestPrefixReduction: a shorter prompt sharing
        the stored prefix still hits, proportionally."""
        long_prompt = SENTENCE * 16
        fleet.publish("pod-1", fleet.tokenize(long_prompt))
        short = SENTENCE * 4
        scores = fleet.score(short)
        n_short_blocks = len(fleet.tokenize(short)) // BLOCK_SIZE
        assert scores["pod-1"] == pytest.approx(n_short_blocks)

    def test_prefix_expansion_churn(self, fleet):
        """e2e_test.go:178 TestPrefixExpansion: score caps at the stored
        prefix; storing the extension (chained off the parent hash)
        lifts the score on rescore."""
        full_prompt = SENTENCE * 16
        tokens = fleet.tokenize(full_prompt)
        half = len(tokens) // 2 // BLOCK_SIZE * BLOCK_SIZE
        first = fleet.publish("pod-1", tokens[:half])

        capped = fleet.score(full_prompt)
        assert capped["pod-1"] == pytest.approx(half // BLOCK_SIZE)

        fleet.publish("pod-1", tokens[half:], parent=first[-1])
        lifted = fleet.score(full_prompt)
        assert lifted["pod-1"] == pytest.approx(len(tokens) // BLOCK_SIZE)
        assert lifted["pod-1"] > capped["pod-1"]

    def test_long_prefix_expansion_4500_tokens(self, fleet):
        """e2e_test.go:214 TestLongPrefixExpansion at ~4.5k tokens.

        At this length the read path takes the prefix-store fast path
        (coverage >= min_prefix_overlap_ratio serves the cached token
        stream instead of re-tokenizing, pool.py — the reference's 0.8
        overlap design, pool.go:31-34), which may trail the full
        tokenization by a few chunk-boundary tokens; the score lands
        within 3% of the full block count, never above it."""
        prompt = SENTENCE * 450  # 4500 tokens with the word tokenizer
        tokens = fleet.tokenize(prompt)
        assert len(tokens) >= 4500
        fleet.publish("pod-long", tokens)
        n_blocks = len(tokens) // BLOCK_SIZE
        score = fleet.score(prompt)["pod-long"]
        assert 0.97 * n_blocks <= score <= n_blocks
        # Expansion past the stored prefix stays capped at it.
        extended = prompt + "how vexingly quick daft zebras jump . " * 50
        assert fleet.score(extended)["pod-long"] <= n_blocks

    def test_long_prompt_full_scenario(self, m, fleet):
        """Reference depth (e2e_test.go:214-251) at >280-block chains:
        prefix expansion, reduction, and mid-prompt divergence through
        the booted service, with BLOCK-ACCURATE hit-count asserts —
        each expectation computed from the token stream the service
        will actually use (full tokenization, or the prefix store's
        serve when its coverage engages the fast path) — plus the
        fast path PROVEN engaged via its metrics counter."""
        prompt = SENTENCE * 460  # 4600 tokens
        # NOTE: this helper tokenize populates the prefix store, so
        # every score below may be served from it; expectations are
        # computed accordingly (served_blocks_for), never hand-waved.
        tokens = fleet.tokenize(prompt)
        assert len(tokens) >= 4500
        n_blocks = len(tokens) // BLOCK_SIZE
        assert n_blocks > 280  # the reference's per-request chain scale

        def served_blocks_for(text):
            """Block count of the token stream the service will score
            ``text`` with: the prefix-store serve when its coverage
            engages the fast path, full tokenization otherwise."""
            pool = fleet.indexer.tokenization_pool
            served, coverage = (
                pool._prefix_store.find_longest_contained_tokens(
                    text, MODEL
                )
            )
            # The LIVE threshold, not a copy of its default: the test
            # must follow whatever serve path the pool actually takes.
            if coverage >= pool.config.min_prefix_overlap_ratio:
                return len(served) // BLOCK_SIZE
            return len(fleet.tokenize(text)) // BLOCK_SIZE

        # -- expansion: store the first half; the score caps exactly
        # there regardless of serve path (stored < served length).
        half = n_blocks // 2 * BLOCK_SIZE
        first = fleet.publish("pod-long", tokens[:half])
        assert fleet.score(prompt)["pod-long"] == pytest.approx(
            half // BLOCK_SIZE
        )
        # Store the second half chained on the parent hash: the score
        # lifts to exactly the served block count (== full tokenization
        # minus at most one trailing chunk).
        fleet.publish("pod-long", tokens[half:], parent=first[-1])
        expected = served_blocks_for(prompt)
        assert 0.97 * n_blocks <= expected <= n_blocks
        assert fleet.score(prompt)["pod-long"] == pytest.approx(expected)

        # -- reduction: a one-third prefix of the same prompt hits
        # exactly its served block count.
        short = SENTENCE * 150
        assert fleet.score(short)["pod-long"] == pytest.approx(
            served_blocks_for(short)
        )

        # -- mid-prompt divergence: same first half, different tail.
        # Shared coverage ~0.5 < 0.8 keeps it off the fast path, so
        # the cap is exactly the shared full blocks.
        divergent = (
            SENTENCE * 230
            + "pack my box with five dozen liquor jugs . " * 230
        )
        div_tokens = fleet.tokenize(divergent)
        shared = 0
        for a, b in zip(tokens, div_tokens):
            if a != b:
                break
            shared += 1
        assert shared >= 2000  # genuinely long shared prefix
        assert fleet.score(divergent)["pod-long"] == pytest.approx(
            shared // BLOCK_SIZE
        )

        # -- fast path PROVEN engaged (counter, not assumption) on a
        # full-prompt re-score.
        def fast_path_count():
            counter = m.METRICS.tokenization_prefix_fast_path
            return counter.collect()[0].samples[0].value

        before = fast_path_count()
        rescore = fleet.score(prompt)["pod-long"]
        after = fast_path_count()
        assert after > before, "prefix-store fast path never engaged"
        assert rescore == pytest.approx(expected)

    def test_chat_completions_e2e(self, m, fleet):
        """e2e_test.go:254 TestChatCompletionsE2E through the service."""
        messages = [
            {"role": "system", "content": "you are a helpful assistant ."},
            {"role": "user", "content": "hello world"},
        ]
        rendered = fleet.indexer.chat_processor.apply_chat_template(
            MODEL,
            _render_request(m, messages),
        )
        fleet.publish("pod-chat", fleet.tokenize(rendered))
        scores = fleet.score_chat(messages)
        assert scores.get("pod-chat", 0) > 0

    def test_long_chat_completions_e2e(self, m, fleet):
        """e2e_test.go:314 TestLongChatCompletionsE2E: a growing
        multi-turn conversation keeps hitting its stored prefix."""
        messages = [
            {"role": "system", "content": "you are a helpful assistant ."}
        ]
        for turn in range(12):
            messages.append(
                {"role": "user", "content": SENTENCE * 4}
            )
            messages.append(
                {"role": "assistant", "content": SENTENCE * 2}
            )
        rendered = fleet.indexer.chat_processor.apply_chat_template(
            MODEL, _render_request(m, messages)
        )
        tokens = fleet.tokenize(rendered)
        assert len(tokens) > 800  # genuinely long conversation
        fleet.publish("pod-chat", tokens)

        n_blocks = len(tokens) // BLOCK_SIZE
        full = fleet.score_chat(messages)["pod-chat"]
        # Prefix-store fast path may trail full tokenization by a few
        # chunk-boundary tokens (see test_long_prefix_expansion).
        assert 0.95 * n_blocks <= full <= n_blocks
        # One MORE turn: the prior conversation is the stored prefix.
        scores = fleet.score_chat(
            messages + [{"role": "user", "content": "hello world"}]
        )
        assert scores.get("pod-chat", 0) > 0

    def test_eviction_then_rescore(self, fleet):
        """Tail eviction reduces the score (lookup early-stops at the
        break); head eviction zeroes it; counterpart of the eviction
        churn the reference drives via BlockRemoved."""
        prompt = SENTENCE * 16
        tokens = fleet.tokenize(prompt)
        hashes = fleet.publish("pod-1", tokens)
        n_blocks = len(hashes)
        assert fleet.score(prompt)["pod-1"] == pytest.approx(n_blocks)

        fleet.evict("pod-1", hashes[n_blocks // 2:])
        reduced = fleet.score(prompt)
        assert reduced["pod-1"] == pytest.approx(n_blocks // 2)

        fleet.evict("pod-1", hashes[:1])
        assert fleet.score(prompt) == {}


def _render_request(m, messages):
    return m.ApplyChatTemplateRequest(conversation=list(messages))


class TestTokenizerDiscoveryE2E:
    """e2e_test.go:388-485: tokenizer auto-discovery through the booted
    service — no tokenizer injected anywhere."""

    def test_plain_layout(self, m, tmp_path):
        tokenizers_dir = save_tokenizer_json(str(tmp_path), MODEL)
        fleet, server = boot(m, tokenizers_dir, register_chat=False)
        try:
            prompt = SENTENCE * 8
            tokens = fleet.tokenize(prompt)
            fleet.publish("pod-1", tokens)
            assert fleet.score(prompt)["pod-1"] > 0
        finally:
            server.shutdown()
            server.server_close()
            fleet.event_pool.shutdown()
            fleet.indexer.shutdown()

    def test_hf_cache_layout(self, m, tmp_path):
        """models--org--name/snapshots/<rev>/tokenizer.json, the layout
        a mounted HF cache volume presents (e2e_test.go:434)."""
        model = "test-org/chat-model"
        snapshot = os.path.join(
            str(tmp_path),
            "models--test-org--chat-model",
            "snapshots",
            "abcdef123",
        )
        os.makedirs(snapshot)
        build_fast_tokenizer().save(
            os.path.join(snapshot, "tokenizer.json")
        )
        fleet, server = boot(m, str(tmp_path), register_chat=False)
        try:
            prompt = SENTENCE * 8
            tokens = fleet.indexer.tokenization_pool.tokenize(
                prompt, model, None
            )
            n_blocks = len(tokens) // BLOCK_SIZE
            hashes = [0x9000 + i for i in range(n_blocks)]
            batch = m.EventBatch(
                ts=1.0,
                events=[
                    m.BlockStored(
                        block_hashes=hashes,
                        parent_block_hash=None,
                        token_ids=tokens[: n_blocks * BLOCK_SIZE],
                        block_size=BLOCK_SIZE,
                        medium="hbm",
                    )
                ],
            )
            fleet.event_pool.add_task(
                m.Message(
                    topic=f"kv@pod-hf@{model}",
                    payload=batch.encode(),
                    pod_identifier="pod-hf",
                    model_name=model,
                )
            )
            fleet.event_pool.drain()
            scores = fleet.score(prompt, model=model)
            assert scores["pod-hf"] == pytest.approx(n_blocks)
        finally:
            server.shutdown()
            server.server_close()
            fleet.event_pool.shutdown()
            fleet.indexer.shutdown()
