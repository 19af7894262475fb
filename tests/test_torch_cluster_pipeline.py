"""Read-path fan-out pipelining of the JAX package's
``tests/test_cluster_pipeline.py`` on both packages, on the CPU.

``m`` is either package's names; each case holds both to the reference's
expectations: the overlapped and pipelined drive returns bit-identical
scores to the sequential oracle and to a single ``InMemoryIndex``, a
replica killed mid-walk re-routes to the oracle's scores, the
version-vector score memo serves repeats without lookup RPCs and always
equals a recompute, and arming follows the per-RPC latency EWMA.  The
arming cases pin the threshold (an explicit hour, zero, or an injected
EWMA) instead of reading the host's clock, so host load cannot flip them.
"""

import random

import pytest

from llm_d_kv_cache_manager_tpu import cluster as ref_cluster
from llm_d_kv_cache_manager_tpu.kvcache import indexer as ref_indexer
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import in_memory as ref_in_memory
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import index as ref_index
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as ref_token_processor
from llm_d_kv_cache_manager_tpu.metrics import collector as ref_collector
from llm_d_kv_cache_manager_tpu.tokenization import tokenizers as ref_tokenizers
from tests.helpers.torch_port import namespace

SIDES = ("ref", "port")
_REF = {
    "cluster": ref_cluster,
    "kvcache.indexer": ref_indexer,
    "kvcache.kvblock.in_memory": ref_in_memory,
    "kvcache.kvblock.index": ref_index,
    "kvcache.kvblock.token_processor": ref_token_processor,
    "metrics.collector": ref_collector,
    "tokenization.tokenizers": ref_tokenizers,
}
_NAMES = {
    "cluster": ("LocalCluster",),
    "kvcache.indexer": ("Indexer", "IndexerConfig"),
    "kvcache.kvblock.in_memory": ("InMemoryIndex",),
    "kvcache.kvblock.index": ("IndexConfig", "InMemoryIndexConfig", "PodEntry"),
    "kvcache.kvblock.token_processor": ("EMPTY_BLOCK_HASH", "TokenProcessorConfig"),
    "metrics.collector": ("METRICS", "gauge_value"),
    "tokenization.tokenizers": ("Encoding",),
}


def mods(side):
    m = namespace(side, _REF, _NAMES)
    m.PODS = [
        m.PodEntry("pod-a", "hbm"),
        m.PodEntry("pod-b", "host"),
        m.PodEntry("pod-c", "shared_storage"),
    ]
    return m


@pytest.fixture(params=SIDES)
def m(request):
    return mods(request.param)


MODEL = "m"


class WordTokenizer:
    """Deterministic test tokenizer: 't<id>' words -> stable ids with
    exact byte offsets, returning the given package's ``Encoding``."""

    def __init__(self, m):
        self._encoding = m.Encoding

    def type(self) -> str:
        return "test-word"

    def encode(self, prompt, model_name, add_special_tokens=True):
        tokens, offsets, pos = [], [], 0
        for word in prompt.split(" "):
            tokens.append(int(word[1:]) if word and word[0] == "t" else 0)
            offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return self._encoding(tokens=tokens, offsets=offsets)


def words(tokens):
    return " ".join(f"t{t}" for t in tokens)


def _make_indexer(m, index, pipeline_depth=None, score_memo=0):
    indexer = m.Indexer(
        m.IndexerConfig(
            token_processor_config=m.TokenProcessorConfig(block_size=4),
            kvblock_index_config=m.IndexConfig(
                in_memory_config=m.InMemoryIndexConfig(size=200_000)
            ),
            read_path_fast_lane=True,
            lookup_chunk_size=8,
            score_memo_size=score_memo,
            cache_stats=False,
            pipeline_depth=pipeline_depth,
        ),
        tokenizer=WordTokenizer(m),
        kv_block_index=index,
    )
    indexer.run()
    return indexer


def _seed_random_prefixes(m, rng, db, indexes, n_prompts=30):
    """Random pods claim random prefixes of random chains in every
    index; returns the prompt token lists."""
    prompts = []
    for _ in range(n_prompts):
        tokens = [
            rng.randrange(1, 500)
            for _ in range(rng.randrange(4, 240))
        ]
        prompts.append(tokens)
        keys = db.tokens_to_kv_block_keys(m.EMPTY_BLOCK_HASH, tokens, MODEL)
        if not keys:
            continue
        for pod in rng.sample(m.PODS, rng.randrange(0, 4)):
            prefix = keys[: rng.randrange(1, len(keys) + 1)]
            for index in indexes:
                index.add(prefix, prefix, [pod])
    return prompts


class TestPipelinedParityOracle:
    @pytest.mark.parametrize("seed", [3, 17])
    def test_pipelined_matches_sequential_and_single(self, m, seed):
        """The tentpole oracle: overlapped fan-out + chunk pipelining
        + speculation must be BIT-IDENTICAL to the sequential drive
        and the single-process backend — unfiltered and pod-filtered,
        strict canonical wire."""
        rng = random.Random(seed)
        cluster = m.LocalCluster(strict_wire=True, overlap_min_rpc_s=0)
        single_index = m.InMemoryIndex()
        sequential = _make_indexer(m,
            cluster.remote_index, pipeline_depth=0
        )
        pipelined = _make_indexer(m, cluster.remote_index)
        single = _make_indexer(m, single_index)
        try:
            prompts = _seed_random_prefixes(m,
                rng,
                single.token_processor,
                [cluster.remote_index, single_index],
            )
            for tokens in prompts:
                prompt = words(tokens)
                for pod_filter in (None, ["pod-a", "pod-c"]):
                    want = single.get_pod_scores(
                        prompt, MODEL, pod_filter
                    )
                    assert (
                        sequential.get_pod_scores(
                            prompt, MODEL, pod_filter
                        )
                        == want
                    )
                    assert (
                        pipelined.get_pod_scores(
                            prompt, MODEL, pod_filter
                        )
                        == want
                    )
            # The pipelined lane really speculated (the oracle above
            # would pass vacuously if the async drive never engaged).
            stats = cluster.remote_index.rpc_stats()["critical_path"]
            assert stats["speculative_rpcs"] > 0
        finally:
            sequential.shutdown()
            pipelined.shutdown()
            single.shutdown()
            cluster.close()

    @pytest.mark.parametrize("kill_at_call", [2, 6, 11])
    def test_mid_walk_kill_reroutes_to_oracle_scores(
        self, m, tmp_path, kill_at_call
    ):
        """A replica dying BETWEEN a pipelined request's RPC rounds
        (transport counter trips the kill mid-walk) re-routes the
        failed subset to the journal-warm follower and the final
        scores still equal the pre-kill oracle."""
        state = {"calls": 0, "armed": False, "killed": None}

        class TripwireTransport:
            def __init__(self, replica_id, inner):
                self._replica_id = replica_id
                self._inner = inner
                self.supports_deadline = getattr(
                    inner, "supports_deadline", False
                )

            def _maybe_trip(self):
                if not state["armed"] or state["killed"] is not None:
                    return
                state["calls"] += 1
                if state["calls"] >= kill_at_call:
                    state["killed"] = victim
                    cluster.kill(victim, notice=False)

            def call(self, method, args):
                self._maybe_trip()
                return self._inner.call(method, args)

            def call_ex(self, method, args, traceparent=None):
                self._maybe_trip()
                return self._inner.call_ex(
                    method, args, traceparent=traceparent
                )

            def call_vv(
                self, method, args, traceparent=None, timeout=None
            ):
                self._maybe_trip()
                return self._inner.call_vv(
                    method, args, traceparent=traceparent, timeout=timeout
                )

        cluster = m.LocalCluster(
            journal_root=str(tmp_path),
            overlap_min_rpc_s=0,
            transport_wrap=TripwireTransport,
        )
        pipelined = _make_indexer(m, cluster.remote_index)
        try:
            db = pipelined.token_processor
            tokens = list(range(1, 161))  # 40 blocks -> several chunks
            keys = db.tokens_to_kv_block_keys(
                m.EMPTY_BLOCK_HASH, tokens, MODEL
            )
            cluster.remote_index.add(keys, keys, [m.PODS[0]])
            while cluster.sync_followers():
                pass  # followers warm before anything can die
            prompt = words(tokens)
            oracle = pipelined.get_pod_scores(prompt, MODEL)
            assert oracle == {"pod-a": float(len(keys))}
            victim = cluster.membership.ring().owner(keys[0])
            state["armed"] = True
            # Several walks: one of them loses `victim` mid-flight.
            for _ in range(4):
                assert (
                    pipelined.get_pod_scores(prompt, MODEL) == oracle
                )
            assert state["killed"] == victim
            assert cluster.membership.failover_count() >= 1
        finally:
            pipelined.shutdown()
            cluster.close()


class TestClusterScoreMemo:
    def test_memo_enables_and_hits_without_rpc_rounds(self, m):
        """The memo arms against the RemoteIndex (it exposes
        version_vector/touch_chain), converges after the piggybacked
        vectors arrive, and then serves repeats with ZERO further
        lookup RPC rounds — the ``kvtpu_score_memo_disabled`` gauge
        never latches for a cluster backend."""
        gauge_before = m.gauge_value(m.METRICS.score_memo_disabled)
        cluster = m.LocalCluster(strict_wire=True, overlap_min_rpc_s=0)
        memoized = _make_indexer(m, cluster.remote_index, score_memo=64)
        try:
            assert memoized._score_memo is not None
            assert (
                m.gauge_value(m.METRICS.score_memo_disabled)
                == gauge_before
            )
            db = memoized.token_processor
            tokens = list(range(1, 101))
            keys = db.tokens_to_kv_block_keys(
                m.EMPTY_BLOCK_HASH, tokens, MODEL
            )
            cluster.remote_index.add(keys, keys, [m.PODS[0], m.PODS[1]])
            prompt = words(tokens)
            # Request 1 stores a sentinel-validated entry (no vectors
            # cached yet); request 2 recomputes against the now-real
            # composed vector; request 3+ must hit.
            want = memoized.get_pod_scores(prompt, MODEL)
            memoized.get_pod_scores(prompt, MODEL)
            rounds = lambda: cluster.remote_index.rpc_stats()[  # noqa: E731
                "critical_path"
            ]["lookup_calls"]
            before = rounds()
            for _ in range(5):
                assert memoized.get_pod_scores(prompt, MODEL) == want
            assert rounds() == before  # pure memo hits
        finally:
            memoized.shutdown()
            cluster.close()

    def test_memo_hits_equal_recompute_across_mutations(self, m):
        """Memo-hit ≡ recompute under router-driven cluster mutations:
        after every add / evict / purge_pod the memoized indexer must
        agree with a memo-free indexer walking the same cluster."""
        rng = random.Random(23)
        cluster = m.LocalCluster(strict_wire=True, overlap_min_rpc_s=0)
        memoized = _make_indexer(m, cluster.remote_index, score_memo=64)
        recompute = _make_indexer(m, cluster.remote_index)
        try:
            db = memoized.token_processor
            tokens = [rng.randrange(1, 500) for _ in range(120)]
            keys = db.tokens_to_kv_block_keys(
                m.EMPTY_BLOCK_HASH, tokens, MODEL
            )
            prompt = words(tokens)

            def check():
                # Call both indexers in lockstep: the tokenizer prefix
                # store serves repeats a (possibly shorter) cached
                # stream, so scores are only comparable at the SAME
                # request ordinal — the second memoized call is the
                # memo hit and must equal the recompute twin's fresh
                # walk at that ordinal.
                want1 = recompute.get_pod_scores(prompt, MODEL)
                got1 = memoized.get_pod_scores(prompt, MODEL)
                want2 = recompute.get_pod_scores(prompt, MODEL)
                got2 = memoized.get_pod_scores(prompt, MODEL)
                assert (got1, got2) == (want1, want2)

            cluster.remote_index.add(keys, keys, [m.PODS[0]])
            check()
            # Deepen one pod's claim: the memo entry for the old state
            # must invalidate (owner vector advanced on the add reply).
            cluster.remote_index.add(keys, keys, [m.PODS[1]])
            check()
            # Shrink it again via evict at the chain head.
            cluster.remote_index.evict(keys[0], [m.PODS[1]])
            check()
            # Wipe a pod fleet-wide.
            cluster.remote_index.purge_pod("pod-a")
            check()
        finally:
            memoized.shutdown()
            recompute.shutdown()
            cluster.close()


class TestAdaptiveArming:
    def test_local_transport_stays_sequential(self, m):
        """Below the arming threshold neither the fan-out pool nor the
        pipe pool arms — results unchanged, no pool handoff tax.  The
        reference's case relies on the in-process transport's measured
        per-RPC EWMA staying under the default 250 us, a wall-clock
        property that a loaded host breaks; here the threshold is an
        explicit hour, which no RPC reaches."""
        cluster = m.LocalCluster(strict_wire=True, overlap_min_rpc_s=3600.0)
        try:
            remote = cluster.remote_index
            assert remote.overlap_min_rpc_s == 3600.0
            remote.add([1, 2, 3], [1, 2, 3], [m.PODS[0]])
            fanout = remote.rpc_stats()["fanout"]
            assert fanout["rpc_ewma_us"] > 0
            assert fanout["armed"] is False
            # The async surface degenerates to the inline handle.
            handle = remote.lookup_chain_async([1, 2, 3])
            assert type(handle).__name__ == "_CompletedLookup"
            assert len(handle.result()) == 3
        finally:
            cluster.close()

    def test_arming_follows_the_rpc_ewma(self, m):
        """Arming reads the per-RPC latency EWMA against the threshold:
        an EWMA injected below it keeps the inline handle, one at or
        above it arms the pipe pool, and the scores are the same."""
        cluster = m.LocalCluster(strict_wire=True, overlap_min_rpc_s=0.001)
        try:
            remote = cluster.remote_index
            remote.add([1, 2, 3], [1, 2, 3], [m.PODS[0]])
            results = []
            for ewma, armed in ((0.0009, False), (0.001, True), (0.5, True)):
                with remote._stats_lock:
                    remote._rpc_ewma_s = ewma
                assert remote.rpc_stats()["fanout"]["armed"] is armed
                handle = remote.lookup_chain_async([1, 2, 3])
                assert (type(handle).__name__ != "_CompletedLookup") is armed
                results.append([sorted(map(str, pods)) for pods in handle.result()])
            assert results[0] == results[1] == results[2] and len(results[0]) == 3
        finally:
            cluster.close()

    def test_zero_threshold_forces_overlap(self, m):
        """overlap_min_rpc_s=0 (CLUSTER_OVERLAP_MIN_RPC_S=0) arms the
        overlapped paths unconditionally — the deployment posture for
        real network transports and what the parity tests pin."""
        cluster = m.LocalCluster(strict_wire=True, overlap_min_rpc_s=0)
        try:
            remote = cluster.remote_index
            remote.add([1, 2, 3], [1, 2, 3], [m.PODS[0]])
            assert remote.rpc_stats()["fanout"]["armed"] is True
            handle = remote.lookup_chain_async([1, 2, 3])
            assert type(handle).__name__ != "_CompletedLookup"
            assert len(handle.result()) == 3
        finally:
            cluster.close()

    def test_close_degrades_async_surface_inline(self, m):
        """After close() the pools are gone: lookup_chain_async still
        answers (inline) so a racing scorer completes instead of
        crashing."""
        cluster = m.LocalCluster(strict_wire=True, overlap_min_rpc_s=0)
        remote = cluster.remote_index
        remote.add([7, 8], [7, 8], [m.PODS[0]])
        with remote._exec_lock:
            pass  # lock healthy before close
        remote.close()
        handle = remote.lookup_chain_async([7, 8])
        assert type(handle).__name__ == "_CompletedLookup"
        assert len(handle.result()) == 2
        cluster.close()
