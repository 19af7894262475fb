"""Cross-replica trace stitching of the JAX package's
``tests/test_cluster_trace.py`` on both packages, on the CPU: traceparent
round trips over the strict-wire codec and an HTTP transport on the
loopback (to each package's own ``serve(replica=...)``, and to a stdlib
server around ``ClusterReplica.handle_wire``,
``tests/helpers/replica_http.py``), killed-replica retries visible as
re-routed spans, error-kind classification, and the piggyback knobs.
``m`` is either package's names; each case holds both to the reference's
expectations.
"""

import threading

import pytest

from llm_d_kv_cache_manager_tpu import cluster as ref_cluster
from llm_d_kv_cache_manager_tpu.api import http_service as ref_http_service
from llm_d_kv_cache_manager_tpu.cluster import membership as ref_membership
from llm_d_kv_cache_manager_tpu.cluster import remote_index as ref_remote_index
from llm_d_kv_cache_manager_tpu.cluster import replica as ref_replica
from llm_d_kv_cache_manager_tpu.kvcache import indexer as ref_indexer
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import index as ref_index
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as ref_token_processor
from llm_d_kv_cache_manager_tpu.kvevents import events as ref_events
from llm_d_kv_cache_manager_tpu.kvevents import pool as ref_pool
from llm_d_kv_cache_manager_tpu.metrics import collector as ref_collector
from llm_d_kv_cache_manager_tpu.obs import slo as ref_slo
from llm_d_kv_cache_manager_tpu.obs import trace as ref_trace
from llm_d_kv_cache_manager_tpu.tokenization import tokenizers as ref_tokenizers
from tests.helpers.replica_http import ReplicaHttpServer
from tests.helpers.torch_port import namespace

SIDES = ("ref", "port")
_REF = {
    "api.http_service": ref_http_service,
    "cluster": ref_cluster,
    "cluster.membership": ref_membership,
    "cluster.remote_index": ref_remote_index,
    "cluster.replica": ref_replica,
    "kvcache.indexer": ref_indexer,
    "kvcache.kvblock.index": ref_index,
    "kvcache.kvblock.token_processor": ref_token_processor,
    "kvevents.events": ref_events,
    "kvevents.pool": ref_pool,
    "metrics.collector": ref_collector,
    "obs.slo": ref_slo,
    "obs.trace": ref_trace,
    "tokenization.tokenizers": ref_tokenizers,
}
_NAMES = {
    "api.http_service": ("serve",),
    "cluster": ("LocalCluster",),
    "cluster.membership": ("ClusterMembership",),
    "cluster.remote_index": ("RemoteIndex",),
    "cluster.replica": ("ClusterReplica", "HttpReplicaTransport", "LocalReplicaTransport",
                        "ReplicaUnavailable", "decode_request", "decode_response_ex",
                        "encode_request", "encode_response"),
    "kvcache.indexer": ("Indexer", "IndexerConfig"),
    "kvcache.kvblock.index": ("PodEntry",),
    "kvcache.kvblock.token_processor": ("ChunkedTokenDatabase", "TokenProcessorConfig"),
    "kvevents.events": ("BlockStored", "EventBatch"),
    "kvevents.pool": ("Message", "Pool", "PoolConfig"),
    "metrics.collector": ("METRICS",),
    "obs.slo": ("counter_label_total",),
    "obs.trace": ("TRACER", "use_trace"),
    "tokenization.tokenizers": ("Encoding",),
}


def mods(side):
    m = namespace(side, _REF, _NAMES)
    m.POD_A = m.PodEntry("pod-a", "hbm")
    return m


@pytest.fixture(params=SIDES)
def m(request):
    return mods(request.param)


class WordTokenizer:
    def __init__(self, m):
        self._encoding = m.Encoding

    def type(self):
        return "test-word"

    def encode(self, prompt, model_name, add_special_tokens):
        tokens, offsets, pos = [], [], 0
        for word in prompt.split(" "):
            tokens.append(int(word[1:]) if word.startswith("t") else 0)
            offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return self._encoding(tokens=tokens, offsets=offsets)


def traced(m, fn):
    """Run ``fn`` under a forced trace; returns the finished trace."""
    trace = m.TRACER.start_trace("test.cluster", force=True)
    assert trace is not None
    with m.use_trace(trace):
        fn()
    trace.finish()
    return trace


def spans_named(trace, name):
    return [
        s for s in trace.to_dict()["spans"] if s["name"] == name
    ]


class TestWireCodec:
    def test_request_round_trip_with_traceparent(self, m):
        tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        data = m.encode_request("lookup", [[1], None], tp)
        assert m.decode_request(data) == ("lookup", [[1], None], tp)

    def test_two_element_request_still_decodes(self, m):
        data = m.encode_request("ping", [])
        assert m.decode_request(data) == ("ping", [], None)

    def test_response_round_trip_with_spans(self, m):
        spans = [["replica.lookup", "cluster.rpc", 5, 10, "ok",
                  [["replica", "r0"]]]]
        payload, got = m.decode_response_ex(
            m.encode_response(0, [1, 2], spans)
        )
        assert payload == [1, 2]
        assert got == spans

    def test_two_element_response_still_decodes(self, m):
        payload, spans = m.decode_response_ex(m.encode_response(0, "x"))
        assert payload == "x"
        assert spans is None


class TestLocalStrictWireStitching:
    def test_lookup_stitches_per_owner_rpc_and_server_spans(self, m):
        cluster = m.LocalCluster(strict_wire=True)
        try:
            keys = list(range(1, 65))
            cluster.remote_index.add(keys, keys, [m.POD_A])
            trace = traced(m, lambda: cluster.remote_index.lookup(keys))
            rpcs = spans_named(trace, "cluster.rpc")
            lookups = [
                s for s in rpcs if s["attributes"]["method"] == "lookup"
            ]
            # 64 keys over 3 replicas: every owner answered one RPC.
            owners = {s["attributes"]["replica"] for s in lookups}
            assert owners == set(cluster.replicas)
            # Server-side spans rode the reply and nest under the RPC.
            server = spans_named(trace, "replica.lookup")
            assert {s["attributes"]["replica"] for s in server} == owners
            assert all(s["parent"] == "cluster.rpc" for s in server)
            decode = spans_named(trace, "replica.decode")
            assert {s["attributes"]["replica"] for s in decode} == owners
            # Stitched spans sit inside their RPC window (re-anchored
            # to the router's clock).
            for rpc in lookups:
                children = [
                    s
                    for s in server
                    if s["attributes"]["replica"]
                    == rpc["attributes"]["replica"]
                ]
                for child in children:
                    assert child["start_ms"] >= rpc["start_ms"] - 0.5
                    assert (
                        child["start_ms"] + child["duration_ms"]
                        <= rpc["start_ms"] + rpc["duration_ms"] + 0.5
                    )
        finally:
            cluster.close()

    def test_nonstrict_local_transport_records_server_spans_directly(self, m):
        cluster = m.LocalCluster()  # same-thread dispatch, no codec
        try:
            cluster.remote_index.add([1], [11], [m.POD_A])
            trace = traced(m, lambda: cluster.remote_index.lookup([11]))
            assert spans_named(trace, "cluster.rpc")
            assert spans_named(trace, "replica.lookup")
        finally:
            cluster.close()

    def test_untraced_calls_send_two_element_frames(self, m):
        """The untraced path pays zero extra wire bytes: no
        traceparent element, no span piggyback."""
        replica = m.ClusterReplica("r0")
        seen = []
        original = replica.handle_wire

        def spy(data):
            seen.append(m.decode_request(data))
            return original(data)

        replica.handle_wire = spy
        transport = m.LocalReplicaTransport(replica, strict_wire=True)
        membership = m.ClusterMembership({"r0": transport})
        remote = m.RemoteIndex(membership)
        remote.add([1], [11], [m.POD_A])
        assert seen and all(tp is None for _, _, tp in seen)

    def test_killed_replica_retry_appears_as_rerouted_span(self, m):
        cluster = m.LocalCluster()
        try:
            keys = list(range(1, 33))
            cluster.remote_index.add(keys, keys, [m.POD_A])
            ring = cluster.membership.ring()
            victim = ring.owner(keys[0])
            # Transport down, membership not yet told: the traced
            # lookup itself discovers the death and re-routes.
            cluster.kill(victim, notice=False)
            trace = traced(m, lambda: cluster.remote_index.lookup(keys))
            rpcs = spans_named(trace, "cluster.rpc")
            failed = [s for s in rpcs if s["status"] == "error"]
            assert failed, "the dead owner's RPC must record an error"
            assert any(
                s["attributes"]["replica"] == victim for s in failed
            )
            retried = [
                s
                for s in rpcs
                if s["status"] == "ok"
                and s["attributes"]["method"] == "lookup"
                and s["attributes"]["replica"] != victim
            ]
            assert retried, "the re-route must appear as its own span"
            stats = cluster.remote_index.rpc_stats()
            assert stats["reroutes"] >= 1
            last = stats["replicas"][victim]["last_error"]
            assert last["kind"] == "killed"
        finally:
            cluster.close()

    def test_piggyback_disabled_on_replica_returns_no_spans(self, m):
        replica = m.ClusterReplica("r0", trace_piggyback=False)
        transport = m.LocalReplicaTransport(replica, strict_wire=True)
        membership = m.ClusterMembership({"r0": transport})
        remote = m.RemoteIndex(membership)
        remote.add([1], [11], [m.POD_A])
        trace = traced(m, lambda: remote.lookup([11]))
        assert spans_named(trace, "cluster.rpc")  # router side intact
        assert not spans_named(trace, "replica.lookup")

    def test_trace_rpcs_disabled_on_router_records_nothing(self, m):
        cluster = m.LocalCluster(strict_wire=True)
        try:
            cluster.remote_index.trace_rpcs = False
            cluster.remote_index.add([1], [11], [m.POD_A])
            trace = traced(m, lambda: cluster.remote_index.lookup([11]))
            assert not spans_named(trace, "cluster.rpc")
            assert not spans_named(trace, "replica.lookup")
        finally:
            cluster.close()

    def test_trace_rpcs_disabled_nonstrict_leaks_no_orphan_spans(self, m):
        """The non-strict local transport dispatches on the caller's
        thread; with the router plane off the replica's direct
        context-var record must be shielded, or orphan replica.* spans
        dangle under a cluster.rpc parent that was never opened."""
        cluster = m.LocalCluster()  # non-strict: same-thread dispatch
        try:
            cluster.remote_index.trace_rpcs = False
            cluster.remote_index.add([1], [11], [m.POD_A])
            trace = traced(m, lambda: cluster.remote_index.lookup([11]))
            span_names = {s["name"] for s in trace.to_dict()["spans"]}
            assert not {
                n for n in span_names if n.startswith(("cluster.", "replica."))
            }, span_names
        finally:
            cluster.close()

    def test_replica_piggyback_off_nonstrict_records_no_server_spans(self, m):
        """trace_piggyback=False means the same thing over both
        transports: no server-side spans, even via the in-process
        direct record."""
        replica = m.ClusterReplica("r0", trace_piggyback=False)
        transport = m.LocalReplicaTransport(replica)  # non-strict
        membership = m.ClusterMembership({"r0": transport})
        remote = m.RemoteIndex(membership)
        remote.add([1], [11], [m.POD_A])
        trace = traced(m, lambda: remote.lookup([11]))
        assert spans_named(trace, "cluster.rpc")  # router side intact
        assert not [
            s
            for s in trace.to_dict()["spans"]
            if s["name"].startswith("replica.")
        ]

    def test_garbled_piggyback_never_fails_the_call(self, m):
        replica = m.ClusterReplica("r0")
        transport = m.LocalReplicaTransport(replica, strict_wire=True)

        original = transport.call_ex

        def garbled(method, args, traceparent=None):
            payload, _ = original(method, args, traceparent)
            return payload, [["bad-record"]]  # wrong arity

        transport.call_ex = garbled
        membership = m.ClusterMembership({"r0": transport})
        remote = m.RemoteIndex(membership)
        remote.add([1], [11], [m.POD_A])
        trace = traced(m, lambda: remote.lookup([11]))
        assert spans_named(trace, "cluster.rpc")


class TestScoreParityUnderTracing:
    def test_traced_and_untraced_scores_identical(self, m):
        cluster = m.LocalCluster(strict_wire=True)
        indexer = m.Indexer(
            m.IndexerConfig(cache_stats=False),
            tokenizer=WordTokenizer(m),
            kv_block_index=cluster.remote_index,
        )
        try:
            tokens = list(range(1, 65))
            keys = indexer.token_processor.tokens_to_kv_block_keys(
                0, tokens, "m"
            )
            cluster.remote_index.add(keys, keys, [m.POD_A])
            prompt = " ".join(f"t{t}" for t in tokens)
            plain = indexer.get_pod_scores(prompt, "m")

            box = {}

            def run():
                box["scores"] = indexer.get_pod_scores(prompt, "m")

            traced(m, run)
            assert box["scores"] == plain
        finally:
            indexer.shutdown()
            cluster.close()


class TestHttpTransportStitching:
    def _serve_replica(self, m, replica_id="r0"):
        indexer = m.Indexer(m.IndexerConfig(cache_stats=False), tokenizer=WordTokenizer(m))
        replica = m.ClusterReplica(replica_id, index=indexer.kv_block_index)
        server = m.serve(indexer, host="127.0.0.1", port=0, replica=replica)
        return indexer, server

    def test_traceparent_round_trip_over_the_service(self, m):
        """The reference's case: the replica behind the package's own
        ``serve()``, its spans stitched into the router's trace."""
        indexer, server = self._serve_replica(m)
        port = server.server_address[1]
        try:
            membership = m.ClusterMembership(
                {"r0": m.HttpReplicaTransport(f"http://127.0.0.1:{port}")}
            )
            remote = m.RemoteIndex(membership)
            remote.add([1, 2], [11, 12], [m.POD_A])
            trace = traced(m, lambda: remote.lookup([11, 12]))
            rpcs = spans_named(trace, "cluster.rpc")
            assert any(
                s["attributes"]["method"] == "lookup" for s in rpcs
            )
            server_side = spans_named(trace, "replica.lookup")
            assert server_side
            assert all(
                s["attributes"]["replica"] == "r0" for s in server_side
            )
            remote.close()
        finally:
            server.shutdown()
            server.server_close()
            indexer.shutdown()

    def test_traceparent_round_trip_over_real_http(self, m):
        server = ReplicaHttpServer(m.ClusterReplica("r0"))
        try:
            membership = m.ClusterMembership(
                {"r0": m.HttpReplicaTransport(server.url)}
            )
            remote = m.RemoteIndex(membership)
            remote.add([1, 2], [11, 12], [m.POD_A])
            trace = traced(m, lambda: remote.lookup([11, 12]))
            rpcs = spans_named(trace, "cluster.rpc")
            assert any(
                s["attributes"]["method"] == "lookup" for s in rpcs
            )
            server_side = spans_named(trace, "replica.lookup")
            assert server_side
            assert all(
                s["attributes"]["replica"] == "r0" for s in server_side
            )
            remote.close()
        finally:
            server.close()

    def test_http_error_kinds_refused_and_killed(self, m):
        refused = m.HttpReplicaTransport("http://127.0.0.1:9")  # closed
        with pytest.raises(m.ReplicaUnavailable) as info:
            refused.call("ping", [])
        assert info.value.kind in ("refused", "io", "timeout")

        replica = m.ClusterReplica("r0")
        transport = m.LocalReplicaTransport(replica)
        transport.kill()
        with pytest.raises(m.ReplicaUnavailable) as info:
            transport.call("ping", [])
        assert info.value.kind == "killed"

    def test_http_failure_lands_in_error_metric_and_debug(self, m):
        alive = m.ClusterReplica("alive")
        membership = m.ClusterMembership(
            {
                "alive": m.LocalReplicaTransport(alive),
                "dead": m.HttpReplicaTransport("http://127.0.0.1:9"),
            }
        )
        remote = m.RemoteIndex(membership)
        before = m.counter_label_total(
            m.METRICS.cluster_rpc_errors, replica="dead"
        )
        # Drive keys until one routes to the dead replica and fails
        # over; the tally and metric must attribute the transport kind.
        for key in range(1, 50):
            remote.add([key], [key + 1000], [m.POD_A])
            if not membership.is_alive("dead"):
                break
        assert not membership.is_alive("dead")
        after = m.counter_label_total(
            m.METRICS.cluster_rpc_errors, replica="dead"
        )
        assert after > before
        stats = remote.rpc_stats()
        assert stats["replicas"]["dead"]["errors"] >= 1
        assert stats["replicas"]["dead"]["last_error"]["kind"] in (
            "refused", "io", "timeout",
        )
        status = membership.status()
        assert "dead" in status["last_errors"]


class TestEventPlaneTraceCrossesReplicaBoundary:
    def test_kvevents_message_trace_carries_cluster_rpc_spans(self, m):
        """The ingest path (subscriber/ingestor -> pool -> RemoteIndex)
        rides the same wire propagation: a sampled event message's
        trace shows the per-owner apply RPCs."""

        cluster = m.LocalCluster(strict_wire=True)
        processor = m.ChunkedTokenDatabase(
            m.TokenProcessorConfig(block_size=4)
        )
        pool = m.Pool(
            cluster.remote_index, processor, m.PoolConfig(concurrency=1)
        )
        previous_rate = m.TRACER.config.sample_rate
        m.TRACER.configure(sample_rate=1.0)
        try:
            pool.start()
            batch = m.EventBatch(
                ts=1.0,
                events=[
                    m.BlockStored(
                        block_hashes=[1, 2, 3, 4],
                        parent_block_hash=None,
                        token_ids=list(range(16)),
                        block_size=4,
                        medium="hbm",
                    )
                ],
            )
            pool.add_task(
                m.Message(
                    topic="kv@pod-1@m",
                    payload=batch.encode(),
                    pod_identifier="pod-1",
                    model_name="m",
                    seq=1,
                )
            )
            pool.drain()
            recorded = [
                t
                for t in m.TRACER.recorder.recent(50)
                if t.name == "kvevents.message"
            ]
            assert recorded, "the event message must have been traced"
            spans = recorded[0].to_dict()["spans"]
            rpcs = [s for s in spans if s["name"] == "cluster.rpc"]
            assert rpcs, [s["name"] for s in spans]
            assert all(
                s["parent"] == "kvevents.apply" for s in rpcs
            )
            assert [
                s for s in spans if s["name"] == "replica.apply"
            ], "server-side apply spans must ride the reply"
        finally:
            m.TRACER.configure(sample_rate=previous_rate)
            m.TRACER.reset()
            pool.shutdown()
            cluster.close()


class TestConcurrentTracedFanout:
    def test_parallel_traced_lookups_do_not_cross_traces(self, m):
        cluster = m.LocalCluster(strict_wire=True)
        try:
            keys = list(range(1, 129))
            cluster.remote_index.add(keys, keys, [m.POD_A])
            traces = [None] * 8
            errors = []

            def work(i):
                try:
                    traces[i] = traced(m,
                        lambda: cluster.remote_index.lookup(keys)
                    )
                except Exception as exc:  # noqa: BLE001 - reraised below
                    errors.append(exc)

            threads = [
                threading.Thread(target=work, args=(i,))
                for i in range(8)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not errors
            ids = {t.trace_id for t in traces}
            assert len(ids) == 8
            for trace in traces:
                rpcs = spans_named(trace, "cluster.rpc")
                lookups = [
                    s
                    for s in rpcs
                    if s["attributes"]["method"] == "lookup"
                ]
                # Exactly one RPC per owner per trace: no span leaked
                # into a sibling trace.
                assert len(lookups) == len(cluster.replicas)
        finally:
            cluster.close()
