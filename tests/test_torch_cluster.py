"""The port's cluster (``cluster/``) against the JAX package's, on the CPU.

Every case of the reference's ``tests/test_cluster.py`` that needs no HTTP
service runs on both packages (``m`` is either one's names) and holds each
to that test's expectations: the rendezvous ring is deterministic across
processes and moves about 1/N of the keys on a membership change, a killed
replica's slice fails over warm to its journal-fed follower, purges are
never resurrected by replay, the event pool routes admissions to slice
owners, and a 3-replica cluster scores bit-identically to one
``InMemoryIndex``.  The replica endpoint is each package's own HTTP
service (``api.http_service.serve(replica=...)``) and, for the transport
alone, a stdlib server on the loopback (``tests/helpers/replica_http.py``).
Then the two packages against each other, exactly: ring owners,
wire frames both ways, and a port cluster's scores against the
reference's single index before and after a failover and a purge.
"""

import itertools
import json
import random
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from llm_d_kv_cache_manager_tpu import cluster as ref_cluster
from llm_d_kv_cache_manager_tpu.api import http_service as ref_http_service
from llm_d_kv_cache_manager_tpu.cluster import replica as ref_replica
from llm_d_kv_cache_manager_tpu.cluster import replication as ref_replication
from llm_d_kv_cache_manager_tpu.cluster import ring as ref_ring
from llm_d_kv_cache_manager_tpu.kvcache import indexer as ref_indexer
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import in_memory as ref_in_memory
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import index as ref_index
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as ref_token_processor
from llm_d_kv_cache_manager_tpu.kvevents import events as ref_events
from llm_d_kv_cache_manager_tpu.kvevents import pool as ref_pool
from llm_d_kv_cache_manager_tpu.obs import trace as ref_trace
from llm_d_kv_cache_manager_tpu.persistence import journal as ref_journal
from llm_d_kv_cache_manager_tpu.tokenization import tokenizers as ref_tokenizers
from tests.helpers.replica_http import ReplicaHttpServer
from tests.helpers.torch_port import PACKAGE, namespace, port

SIDES = ("ref", "port")
PACKAGES = {"ref": "llm_d_kv_cache_manager_tpu", "port": PACKAGE}
_REF = {
    "api.http_service": ref_http_service,
    "cluster": ref_cluster,
    "cluster.replica": ref_replica,
    "cluster.replication": ref_replication,
    "cluster.ring": ref_ring,
    "kvcache.indexer": ref_indexer,
    "kvcache.kvblock.in_memory": ref_in_memory,
    "kvcache.kvblock.index": ref_index,
    "kvcache.kvblock.token_processor": ref_token_processor,
    "kvevents.events": ref_events,
    "kvevents.pool": ref_pool,
    "persistence.journal": ref_journal,
    "tokenization.tokenizers": ref_tokenizers,
}
_NAMES = {
    "api.http_service": ("serve",),
    "cluster": ("ClusterMembership", "HeartbeatMonitor", "LocalCluster", "RemoteIndex"),
    "cluster.replica": ("ClusterReplica", "HttpReplicaTransport", "LocalReplicaTransport",
                        "ReplicaError", "ReplicaUnavailable", "encode_request",
                        "decode_response_vv"),
    "cluster.replication": ("ReplicationFollower", "standby_record_filter"),
    "cluster.ring": ("HashRing",),
    "kvcache.indexer": ("Indexer", "IndexerConfig"),
    "kvcache.kvblock.in_memory": ("InMemoryIndex",),
    "kvcache.kvblock.index": ("IndexConfig", "InMemoryIndexConfig", "PodEntry"),
    "kvcache.kvblock.token_processor": ("EMPTY_BLOCK_HASH", "ChunkedTokenDatabase",
                                        "TokenProcessorConfig"),
    "kvevents.events": ("BlockRemoved", "BlockStored", "EventBatch"),
    "kvevents.pool": ("Message", "Pool", "PoolConfig"),
    "persistence.journal": ("Journal", "OP_ADD", "JournalRecord"),
    "tokenization.tokenizers": ("Encoding",),
}


def mods(side):
    m = namespace(side, _REF, _NAMES)
    m.POD_A = m.PodEntry("pod-a", "hbm")
    m.POD_B = m.PodEntry("pod-b", "host")
    return m


@pytest.fixture(params=SIDES)
def m(request):
    return mods(request.param)


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


MODEL = "m"
KEYS = [((i * 2654435761) ^ (i << 17)) & ((1 << 64) - 1) for i in range(2000)]


# ------------------------------------------------------------- ring


class TestHashRing:
    def test_deterministic_across_processes_and_seeds(self, m):
        """Ownership must never depend on PYTHONHASHSEED: a router and
        a replica booted with different seeds MUST agree on every
        key's owner (the subprocess recomputes with a different
        seed)."""
        members = ["replica-0", "replica-1", "replica-2"]
        ring = m.HashRing(members)
        keys = KEYS[:64]
        expected = [ring.owner(k) for k in keys]
        script = (
            f"from {PACKAGES[m.side]}.cluster.ring import "
            "HashRing;"
            f"ring = HashRing({members!r});"
            f"print(','.join(ring.owner(k) for k in {keys!r}))"
        )
        out = subprocess.run(
            [sys.executable, "-c", script],
            capture_output=True,
            text=True,
            env={
                "PYTHONHASHSEED": "12345",
                "PATH": "/usr/bin:/bin",
                "PYTHONPATH": ":".join(sys.path),
                "JAX_PLATFORMS": "cpu",
            },
            check=True,
        )
        assert out.stdout.strip().split(",") == expected

    def test_membership_order_is_irrelevant(self, m):
        a = m.HashRing(["r2", "r0", "r1"])
        b = m.HashRing(["r0", "r1", "r2"])
        assert [a.owner(k) for k in KEYS[:200]] == [
            b.owner(k) for k in KEYS[:200]
        ]

    @pytest.mark.parametrize("n", [3, 5, 8])
    def test_remove_moves_about_one_over_n(self, m, n):
        """Removing one member reassigns ONLY its keys (~1/N of the
        space), each to its rendezvous runner-up — never a reshuffle
        of keys the dead member did not own."""
        members = [f"replica-{i}" for i in range(n)]
        ring = m.HashRing(members)
        owners = {k: ring.owner(k) for k in KEYS}
        victim = members[0]
        shrunk = ring.without(victim)
        moved = 0
        for k, owner in owners.items():
            new_owner = shrunk.owner(k)
            if owner != victim:
                assert new_owner == owner  # untouched slice
            else:
                moved += 1
                # Straight to the runner-up.
                assert new_owner == ring.owners(k, 2)[1]
        fraction = moved / len(KEYS)
        assert 0.5 / n < fraction < 2.0 / n

    @pytest.mark.parametrize("n", [3, 5])
    def test_add_steals_about_one_over_n_plus_one(self, m, n):
        members = [f"replica-{i}" for i in range(n)]
        ring = m.HashRing(members)
        grown = ring.with_member("replica-new")
        moved = sum(
            1 for k in KEYS if grown.owner(k) != ring.owner(k)
        )
        for k in KEYS[:500]:
            if grown.owner(k) != ring.owner(k):
                assert grown.owner(k) == "replica-new"
        fraction = moved / len(KEYS)
        assert 0.5 / (n + 1) < fraction < 2.0 / (n + 1)

    def test_distribution_roughly_uniform(self, m):
        ring = m.HashRing(["r0", "r1", "r2", "r3"])
        counts = {}
        for k in KEYS:
            counts[ring.owner(k)] = counts.get(ring.owner(k), 0) + 1
        for member, count in counts.items():
            assert 0.6 * len(KEYS) / 4 < count < 1.4 * len(KEYS) / 4

    def test_versioning_and_immutability(self, m):
        ring = m.HashRing(["r0", "r1"], version=3)
        assert ring.version == 3
        shrunk = ring.without("r0")
        assert shrunk.version == 4 and ring.version == 3
        assert ring.without("missing") is ring
        assert ring.with_member("r1") is ring
        grown = ring.with_member("r2")
        assert grown.version == 4 and "r2" in grown

    def test_validation(self, m):
        with pytest.raises(ValueError):
            m.HashRing([])
        with pytest.raises(ValueError):
            m.HashRing([""])


# ------------------------------------------------------- failover


class TestFailover:
    def test_killed_replica_slice_fails_over_warm(self, m, tmp_path):
        cluster = m.LocalCluster(journal_root=str(tmp_path))
        try:
            idx = cluster.remote_index
            keys = KEYS[:300]
            idx.add(keys, keys, [m.POD_A, m.POD_B])
            assert cluster.sync_followers() > 0

            ring = cluster.membership.ring()
            victim = ring.owner(keys[0])
            owned = [k for k in keys if ring.owner(k) == victim]
            assert owned  # the victim owns a real slice
            before = idx.lookup(owned)

            cluster.kill(victim)
            after = idx.lookup(owned)
            # Warm failover: the runner-up serves the whole slice.
            assert set(after) == set(before)
            for k in owned:
                assert set(after[k]) == set(before[k])
            assert cluster.membership.failover_count() == 1
            assert (
                cluster.membership.ring().version
                == ring.version + 1
            )
        finally:
            cluster.close()

    def test_transport_failure_mid_call_triggers_failover(self, m, tmp_path):
        """No explicit notice: the first routed call that hits the dead
        replica marks it dead and retries on the new owner."""
        cluster = m.LocalCluster(journal_root=str(tmp_path))
        try:
            idx = cluster.remote_index
            keys = KEYS[300:400]
            idx.add(keys, keys, [m.POD_A])
            cluster.sync_followers()
            victim = cluster.membership.ring().owner(keys[0])
            owned = [
                k
                for k in keys
                if cluster.membership.ring().owner(k) == victim
            ]
            cluster.kill(victim, notice=False)
            found = idx.lookup(owned)  # discovers the death inline
            assert set(found) == set(owned)
            assert not cluster.membership.is_alive(victim)
        finally:
            cluster.close()

    def test_purge_is_not_resurrected_by_replay(self, m, tmp_path):
        """purge_pod is journaled (OP_PURGE) and replays in order: a
        follower syncing AFTER the purge must not resurrect the
        purged pod's entries from the earlier add records."""
        cluster = m.LocalCluster(journal_root=str(tmp_path))
        try:
            idx = cluster.remote_index
            keys = KEYS[400:500]
            idx.add(keys, keys, [m.POD_A, m.POD_B])
            assert idx.purge_pod(m.POD_B.pod_identifier) > 0
            cluster.sync_followers()  # adds AND the purge replay
            victim = cluster.membership.ring().owner(keys[0])
            cluster.kill(victim)
            found = idx.lookup(keys)
            for pods in found.values():
                assert all(
                    p.pod_identifier != m.POD_B.pod_identifier
                    for p in pods
                )
        finally:
            cluster.close()

    def test_last_replica_is_never_removed(self, m):
        cluster = m.LocalCluster(replica_ids=("only",))
        try:
            assert not cluster.membership.mark_dead("only", "test")
            assert cluster.membership.alive() == ["only"]
        finally:
            cluster.close()

    def test_heartbeat_marks_dead_then_revives(self, m):
        cluster = m.LocalCluster()
        try:
            monitor = m.HeartbeatMonitor(cluster.membership, misses=2)
            transport = cluster.transports["replica-1"]
            transport.kill()
            monitor.beat_once()
            assert cluster.membership.is_alive("replica-1")  # 1 miss
            monitor.beat_once()
            assert not cluster.membership.is_alive("replica-1")
            transport.revive()
            monitor.beat_once()
            assert cluster.membership.is_alive("replica-1")
        finally:
            cluster.close()


# ---------------------------------------------------- replication


class TestReplication:
    def test_bootstrap_then_tail_with_watermark_skip(self, m, tmp_path):
        """Follower warm-sync: sync_snapshot's dump covers everything
        below the boundary; tailing resumes there, numbered records
        BELOW the watermark are skipped (mirroring recovery), at or
        above replay."""
        primary_dir = str(tmp_path / "primary")
        primary = m.ClusterReplica(
            "primary",
            index=m.InMemoryIndex(),
            journal=m.Journal(primary_dir),
        )
        transport = m.LocalReplicaTransport(primary)
        # Seq-carrying history (the replica-local event-plane mode).
        primary.index.add([1], [11], [m.POD_A])
        primary.journal.record_add("pod-a", 5, [1], [11], [m.POD_A])

        follower_index = m.InMemoryIndex()
        follower = m.ReplicationFollower(
            "primary", primary_dir, follower_index
        )
        assert follower.bootstrap(transport) == 1
        assert follower_index.lookup([11]) == {11: [m.POD_A]}

        # Below-watermark record: its effect is ALREADY in the dump
        # (idempotent anyway); the skip path must classify it.
        primary.journal.record_add("pod-a", 3, [2], [12], [m.POD_A])
        # At/above watermark: replays.
        primary.journal.record_add("pod-a", 6, [3], [13], [m.POD_A])
        follower.sync_once()
        status = follower.status()
        assert status["applied"] == 1 and status["skipped"] == 1
        assert follower_index.lookup([13]) == {13: [m.POD_A]}
        assert follower_index.lookup([13, 12]).get(12) is None
        primary.close()

    def test_standby_filter_trims_to_slice(self, m):
        full_ring = m.HashRing(["replica-0", "replica-1", "replica-2"])
        record_filter = m.standby_record_filter(full_ring, "replica-1")

        keys = KEYS[:200]
        record = m.JournalRecord(
            op=m.OP_ADD,
            pod_identifier="pod-a",
            seq=0,
            ts_ns=0,
            engine_keys=list(keys),
            request_keys=list(keys),
            entries=[m.POD_A],
        )
        trimmed = record_filter(record)
        assert trimmed is not None
        expected = [
            k
            for k in keys
            if "replica-1" in full_ring.owners(k, 2)
        ]
        assert trimmed.request_keys == expected
        assert trimmed.engine_keys == expected  # pairs stay aligned
        # A record fully outside the slice drops.
        outside = [
            k
            for k in KEYS
            if "replica-1" not in full_ring.owners(k, 2)
        ][:5]
        record2 = m.JournalRecord(
            op=m.OP_ADD,
            pod_identifier="pod-a",
            seq=0,
            ts_ns=0,
            engine_keys=list(outside),
            request_keys=list(outside),
            entries=[m.POD_A],
        )
        assert record_filter(record2) is None

    def test_mappings_only_records_follow_engine_key_ownership(self, m):
        """A cross-owner engine->request mapping stub must reach the
        ENGINE-key owner's standby too: after that owner dies,
        get_request_key routes to the standby, and without the mapping
        the router would classify the eviction as 'already gone' and
        leave a stale entry scoring forever."""

        full_ring = m.HashRing(["replica-0", "replica-1", "replica-2"])
        # Find a pair owned on the rk side by someone whose top-2 does
        # NOT include replica-1, while replica-1 stands by the ek side.
        pair = next(
            (ek, rk)
            for ek in KEYS[:500]
            for rk in KEYS[500:600]
            if "replica-1" in full_ring.owners(ek, 2)
            and "replica-1" not in full_ring.owners(rk, 2)
        )
        record = m.JournalRecord(
            op=m.OP_ADD,
            pod_identifier="",
            seq=0,
            ts_ns=0,
            engine_keys=[pair[0]],
            request_keys=[pair[1]],
            entries=[],  # mappings-only
        )
        kept = m.standby_record_filter(full_ring, "replica-1")(record)
        assert kept is not None
        assert kept.engine_keys == [pair[0]]
        assert kept.request_keys == [pair[1]]

    def test_same_owner_pair_eviction_survives_failover(self, m, tmp_path):
        """A pair whose engine and request keys share a PRIMARY owner
        can still have different standbys: the engine-key standby must
        inherit the mapping (RemoteIndex.add publishes mappings for
        every pair, and the filter keys on either side), or a
        post-failover eviction reads 'already gone' and the stale
        entry scores forever."""
        cluster = m.LocalCluster(journal_root=str(tmp_path))
        full_ring = cluster.membership.full_ring
        pair = next(
            (ek, rk)
            for ek in KEYS[:300]
            for rk in KEYS[300:500]
            if full_ring.owner(ek) == full_ring.owner(rk)
            and full_ring.owners(ek, 2)[1] != full_ring.owners(rk, 2)[1]
        )
        try:
            idx = cluster.remote_index
            idx.add([pair[0]], [pair[1]], [m.POD_A])
            cluster.sync_followers()
            victim = full_ring.owner(pair[0])
            cluster.kill(victim)
            # The eviction must resolve through the failed-over
            # engine-key mapping and actually clear the entry.
            idx.evict(pair[0], [m.POD_A])
            assert idx.lookup([pair[1], KEYS[0]]).get(pair[1]) is None
        finally:
            cluster.close()

    def test_peer_purge_replay_is_slice_scoped(self, m, tmp_path):
        """Replaying a PEER's pod-wide purge against the whole local
        index would wipe admissions this replica applied to its OWN
        slice after the purge.  The follower scopes the replay to the
        peer's primary slice; the replica's own fresh entries
        survive."""
        cluster = m.LocalCluster(journal_root=str(tmp_path))
        try:
            idx = cluster.remote_index
            keys = KEYS[:200]
            idx.add(keys, keys, [m.POD_A])
            cluster.sync_followers()  # standby copies of the adds
            idx.purge_pod(m.POD_A.pod_identifier)
            # Fresh post-purge claims land on their owners directly.
            idx.add(keys, keys, [m.POD_A])
            # NOW the followers replay their peers' [adds, purge]
            # streams — the purge must only touch each peer's slice,
            # never the fresh entries of the follower's own slice.
            cluster.sync_followers()
            found = idx.lookup(keys)
            assert set(found) == set(keys)
            # And a failover still serves the slice (the standby
            # replay converged to the same state).
            victim = cluster.membership.ring().owner(keys[0])
            cluster.kill(victim)
            assert set(idx.lookup(keys)) == set(keys)
        finally:
            cluster.close()

    def test_followers_only_hold_standby_slice(self, m, tmp_path):
        cluster = m.LocalCluster(journal_root=str(tmp_path))
        try:
            keys = KEYS[:400]
            cluster.remote_index.add(keys, keys, [m.POD_A])
            cluster.sync_followers()
            full_ring = cluster.membership.full_ring
            for replica_id, replica in cluster.replicas.items():
                resident = {
                    k for k, _ in replica.index.dump_entries()[0]
                }
                for k in resident:
                    assert replica_id in full_ring.owners(k, 2)
        finally:
            cluster.close()


# --------------------------------------- kvevents routing to owners


def _stored_message(m,
    pod: str, seq: int, block_hashes, token_ids, parent=None
):
    batch = m.EventBatch(
        ts=1.0,
        events=[
            m.BlockStored(
                block_hashes=list(block_hashes),
                parent_block_hash=parent,
                token_ids=list(token_ids),
                block_size=4,
            )
        ],
    )
    return m.Message(
        topic=f"kv@{pod}@{MODEL}",
        payload=batch.encode(),
        pod_identifier=pod,
        model_name=MODEL,
        seq=seq,
    )


class TestEventRoutingToSliceOwners:
    def test_pool_applies_through_remote_index(self, m):
        """The unchanged kvevents pool drives the cluster: batched
        admissions land on slice owners, chained parents resolve
        across messages of one batch, evictions route two-hop."""
        cluster = m.LocalCluster()
        try:
            db = m.ChunkedTokenDatabase(m.TokenProcessorConfig(block_size=4))
            pool = m.Pool(
                cluster.remote_index, db, m.PoolConfig(concurrency=1)
            )
            pool.start()
            tokens = list(range(1, 13))  # 3 blocks, chained
            pool.add_task(
                _stored_message(m, "pod-a", 1, [101], tokens[:4])
            )
            pool.add_task(
                _stored_message(m,
                    "pod-a", 2, [102, 103], tokens[4:], parent=101
                )
            )
            pool.drain()

            expected_keys = db.tokens_to_kv_block_keys(
                m.EMPTY_BLOCK_HASH, tokens, MODEL
            )
            found = cluster.remote_index.lookup(expected_keys)
            assert set(found) == set(expected_keys)
            ring = cluster.membership.ring()
            for key in expected_keys:
                owner = ring.owner(key)
                local = cluster.replicas[owner].index.lookup([key])
                assert key in local  # admission landed on its owner

            # Evictions route through the engine-key mapping.
            removal = m.EventBatch(
                ts=2.0,
                events=[m.BlockRemoved(block_hashes=[103])],
            )
            pool.add_task(
                m.Message(
                    topic=f"kv@pod-a@{MODEL}",
                    payload=removal.encode(),
                    pod_identifier="pod-a",
                    model_name=MODEL,
                    seq=3,
                )
            )
            pool.drain()
            remaining = cluster.remote_index.lookup(expected_keys)
            assert expected_keys[2] not in remaining
            assert expected_keys[1] in remaining
            pool.shutdown()
        finally:
            cluster.close()


# ------------------------------------------------- parity oracle


def _make_indexer(m, index, fast=True):
    indexer = m.Indexer(
        m.IndexerConfig(
            token_processor_config=m.TokenProcessorConfig(block_size=4),
            kvblock_index_config=m.IndexConfig(
                in_memory_config=m.InMemoryIndexConfig(size=200_000)
            ),
            read_path_fast_lane=fast,
            lookup_chunk_size=8,
            score_memo_size=0,
            cache_stats=False,
        ),
        tokenizer=WordTokenizer(m),
        kv_block_index=index,
    )
    indexer.run()
    return indexer


class TestScoreParityOracle:
    @pytest.mark.parametrize("seed", [7, 41])
    def test_cluster_scores_bit_identical_to_in_memory(self, m, seed):
        """The acceptance oracle: a 3-replica in-process cluster must
        return BIT-IDENTICAL scores to the single-process
        InMemoryIndex on a randomized workload, through the real
        scoring read path (fast lane AND straight lane)."""
        rng = random.Random(seed)
        cluster = m.LocalCluster(strict_wire=True)
        single = _make_indexer(m, m.InMemoryIndex())
        clustered = _make_indexer(m, cluster.remote_index)
        straight = _make_indexer(m, cluster.remote_index, fast=False)
        try:
            db = single.token_processor
            pods = [
                m.PodEntry("pod-a", "hbm"),
                m.PodEntry("pod-b", "host"),
                m.PodEntry("pod-c", "shared_storage"),
            ]
            prompts = []
            for i in range(30):
                tokens = [
                    rng.randrange(1, 500)
                    for _ in range(rng.randrange(4, 40))
                ]
                prompts.append(tokens)
                # Random pods claim random prefixes of the chain.
                keys = db.tokens_to_kv_block_keys(
                    m.EMPTY_BLOCK_HASH, tokens, MODEL
                )
                if not keys:
                    continue
                for pod in rng.sample(pods, rng.randrange(0, 4)):
                    prefix = keys[: rng.randrange(1, len(keys) + 1)]
                    single.kv_block_index.add(
                        prefix, prefix, [pod]
                    )
                    cluster.remote_index.add(prefix, prefix, [pod])
            for tokens in prompts:
                prompt = words(tokens)
                want = single.get_pod_scores(prompt, MODEL)
                assert clustered.get_pod_scores(prompt, MODEL) == want
                assert straight.get_pod_scores(prompt, MODEL) == want
                # Pod-filtered scoring stays aligned too.
                subset = ["pod-a", "pod-c"]
                assert clustered.get_pod_scores(
                    prompt, MODEL, subset
                ) == single.get_pod_scores(prompt, MODEL, subset)
        finally:
            single.shutdown()
            clustered.shutdown()
            straight.shutdown()
            cluster.close()

    def test_scores_survive_failover(self, m, tmp_path):
        """Scores for a killed replica's slice keep flowing (served by
        the warm runner-up) — the cluster-smoke assertion in test
        form."""
        cluster = m.LocalCluster(journal_root=str(tmp_path))
        clustered = _make_indexer(m, cluster.remote_index)
        try:
            db = clustered.token_processor
            tokens = list(range(1, 41))
            keys = db.tokens_to_kv_block_keys(
                m.EMPTY_BLOCK_HASH, tokens, MODEL
            )
            cluster.remote_index.add(keys, keys, [m.POD_A])
            cluster.sync_followers()
            prompt = words(tokens)
            before = clustered.get_pod_scores(prompt, MODEL)
            assert before  # pod-a scored
            victim = cluster.membership.ring().owner(keys[0])
            cluster.kill(victim)
            assert clustered.get_pod_scores(prompt, MODEL) == before
        finally:
            clustered.shutdown()
            cluster.close()


# ------------------------------------------------- wire + http


class TestWireAndHttp:
    def test_unknown_method_is_application_error(self, m):
        replica = m.ClusterReplica("r0")
        transport = m.LocalReplicaTransport(replica, strict_wire=True)
        with pytest.raises(m.ReplicaError):
            transport.call("no_such_method", [])

    def test_http_transport_sends_the_token(self, m):
        """The client half of the token gate: with ``token=`` the
        transport authenticates; without it the endpoint's 403 is a
        transport failure.  (The gate itself is the HTTP service's.)"""
        replica = m.ClusterReplica("r0")
        server = ReplicaHttpServer(replica, token="secret")
        try:
            good = m.HttpReplicaTransport(server.url, token="secret")
            assert good.call("ping", []) == "r0"
            good.call("add", [[1], [11], [["pod-a", "hbm"]]])
            assert good.call("get_request_key", [1]) == [1, 11]
            bad = m.HttpReplicaTransport(server.url)
            with pytest.raises(m.ReplicaUnavailable) as failure:
                bad.call("ping", [])  # 403 without the token
            assert failure.value.kind == "http_status"
        finally:
            server.close()

    def test_remote_index_over_http_transport(self, m):
        replica = m.ClusterReplica("r0")
        server = ReplicaHttpServer(replica)
        try:
            membership = m.ClusterMembership(
                {"r0": m.HttpReplicaTransport(server.url)}
            )
            remote = m.RemoteIndex(membership)
            remote.add([1, 2], [11, 12], [m.POD_A])
            assert len(remote.lookup_chain([11, 12])) == 2
            remote.evict(1, [m.POD_A])
            assert remote.lookup([11, 12]).get(11) is None
            remote.close()
        finally:
            server.close()

    def test_http_replica_endpoint_with_token_gate(self, m):
        """The server half: the package's own ``serve(replica=...)``
        answers ``POST /replica`` behind the admin token and reports the
        cluster role on ``/debug/cluster``."""
        indexer = m.Indexer(m.IndexerConfig(cache_stats=False), tokenizer=WordTokenizer(m))
        replica = m.ClusterReplica("r0", index=indexer.kv_block_index)
        server = m.serve(
            indexer,
            host="127.0.0.1",
            port=0,
            admin_token="secret",
            replica=replica,
            cluster_status=lambda: {"role": "replica", "replica": "r0"},
        )
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            good = m.HttpReplicaTransport(url, token="secret")
            assert good.call("ping", []) == "r0"
            good.call("add", [[1], [11], [["pod-a", "hbm"]]])
            assert good.call("get_request_key", [1]) == [1, 11]

            bad = m.HttpReplicaTransport(url)
            with pytest.raises(m.ReplicaUnavailable):
                bad.call("ping", [])  # 403 without the token

            with urllib.request.urlopen(f"{url}/debug/cluster", timeout=30) as response:
                payload = json.load(response)
            assert payload["role"] == "replica"
        finally:
            server.shutdown()
            server.server_close()
            indexer.shutdown()

    def test_remote_index_over_http_transport_to_the_service(self, m):
        indexer = m.Indexer(m.IndexerConfig(cache_stats=False), tokenizer=WordTokenizer(m))
        replica = m.ClusterReplica("r0", index=indexer.kv_block_index)
        server = m.serve(indexer, host="127.0.0.1", port=0, replica=replica)
        try:
            membership = m.ClusterMembership(
                {"r0": m.HttpReplicaTransport(f"http://127.0.0.1:{server.server_address[1]}")}
            )
            remote = m.RemoteIndex(membership)
            remote.add([1, 2], [11, 12], [m.POD_A])
            assert len(remote.lookup_chain([11, 12])) == 2
            remote.evict(1, [m.POD_A])
            assert remote.lookup([11, 12]).get(11) is None
            remote.close()
        finally:
            server.shutdown()
            server.server_close()
            indexer.shutdown()


class TestDebugClusterRouterPayload:
    def test_local_cluster_status_shape(self, m, tmp_path):
        cluster = m.LocalCluster(journal_root=str(tmp_path))
        try:
            cluster.remote_index.add(KEYS[:10], KEYS[:10], [m.POD_A])
            cluster.sync_followers()
            status = cluster.status()
            assert status["membership"]["ring_version"] == 0
            assert len(status["membership"]["alive"]) == 3
            assert len(status["replication"]) == 6  # 3 replicas x 2 peers
            cluster.kill("replica-0")
            status = cluster.status()
            assert status["membership"]["failovers"] == 1
            assert "replica-0" not in status["membership"]["alive"]
            # Fan-out attribution panel (docs/observability.md): the
            # add above produced per-replica tallies, and the kill's
            # reason is retrievable as last-error context.
            assert status["rpc"]["replicas"], status["rpc"]
            for view in status["rpc"]["replicas"].values():
                assert view["calls"] >= 1
                assert "avg_ms" in view and "methods" in view
            assert "critical_path" in status["rpc"]
            last = status["membership"]["last_errors"]["replica-0"]
            assert last["reason"] == "killed"
        finally:
            cluster.close()


# ------------------------------------------------- the two packages, exactly

MEMBER_SETS = [
    ["replica-0", "replica-1", "replica-2"],
    ["r0", "r1", "r2", "r3", "r4"],
    ["replica-0", "replica-2"],
    [f"indexer-{i}.ns.svc:8080" for i in range(8)],
]
MANY_KEYS = [random.Random(9).getrandbits(64) for _ in range(10_000)]


@pytest.mark.parametrize("members", MEMBER_SETS, ids=lambda ms: f"{len(ms)}-members")
def test_ring_owners_are_equal_key_by_key(members):
    """For 10,000 random 64-bit keys, the port's ring names the same
    owner and the same runner-up as the reference's, on the ring and on
    the ring with one member removed and one added (exact)."""
    ours, theirs = mods("port").HashRing(members), mods("ref").HashRing(members)
    for a, b in ((ours, theirs), (ours.without(members[0]), theirs.without(members[0])),
                 (ours.with_member("late"), theirs.with_member("late"))):
        assert a.members == b.members and a.version == b.version
        assert [a.owners(k, 2) for k in MANY_KEYS] == [b.owners(k, 2) for k in MANY_KEYS]
        assert [a.owner(k) for k in MANY_KEYS[:2000]] == [b.owner(k) for k in MANY_KEYS[:2000]]


def test_port_ring_owners_do_not_depend_on_the_hash_seed(tmp_path):
    """Two interpreters with different ``PYTHONHASHSEED``s, each importing
    only the port, compute the same owners for 10,000 keys over every
    member set, and those are the reference's in this process (exact)."""
    keys_file = tmp_path / "keys.txt"
    keys_file.write_text("\n".join(map(str, MANY_KEYS)))
    script = (
        "import json, sys\n"
        f"from {PACKAGE}.cluster.ring import HashRing\n"
        f"keys = [int(k) for k in open({str(keys_file)!r}).read().split()]\n"
        f"owners = [[HashRing(ms).owner(k) for k in keys] for ms in {MEMBER_SETS!r}]\n"
        "loaded = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'llm_d_kv_cache_manager_tpu'))\n"
        "print(json.dumps({'owners': owners, 'loaded': loaded}))\n"
    )
    outs = []
    for seed in ("1", "987654321"):
        out = subprocess.run(
            [sys.executable, "-c", script], capture_output=True, text=True, check=True,
            env={"PYTHONHASHSEED": seed, "PATH": "/usr/bin:/bin",
                 "PYTHONPATH": ":".join(sys.path)},
        )
        outs.append(__import__("json").loads(out.stdout))
    assert outs[0]["loaded"] == outs[1]["loaded"] == []
    want = [[mods("ref").HashRing(ms).owner(k) for k in MANY_KEYS] for ms in MEMBER_SETS]
    assert outs[0]["owners"] == outs[1]["owners"] == want


_REF_CLOCKED = {"cluster.replica": ref_replica, "obs.trace": ref_trace,
                "persistence.journal": ref_journal}
TRACEPARENT = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"


def wire_requests():
    """One request of every method, in an order that leaves state for
    the reads after it."""
    pods = [["pod-a", "hbm"], ["pod-b", "host"]]
    return [
        ("ping", []),
        ("add", [[1, 2, 3], [11, 12, 13], pods]),
        ("add_mappings", [[4], [14]]),
        ("add_entries_batch", [[[[14, 15], [["pod-c", "shared_storage"]]]]]),
        ("lookup", [[11, 12, 13, 14, 99], None]),
        ("lookup", [[11, 14], ["pod-a"]]),
        ("lookup_chain", [[11, 12, 13, 99]]),
        ("get_request_key", [2]),
        ("get_request_key", [404]),
        ("evict", [3, [["pod-a", "hbm"]]]),
        ("touch_chain", [[11, 12]]),
        ("dump_entries", []),
        ("restore_entries", [[[21, [["pod-d", "hbm"]]]], [[31, 21]]]),
        ("version_vector", []),
        ("purge_pod", ["pod-b"]),
        ("sync_snapshot", []),
        ("no_such_method", []),
    ]


class CountingClock:
    """The ``time`` module as the replica, trace and journal modules see
    it: on the test's thread ``perf_counter`` counts from a fixed start
    (the spans' clock), and ``time_ns`` (the journal records' stamp) is
    fixed; other threads read the real clock."""

    def __init__(self) -> None:
        self._ticks = itertools.count()
        self._owner = threading.get_ident()

    def perf_counter(self) -> float:
        if threading.get_ident() != self._owner:
            return time.perf_counter()
        return 1000.0 + next(self._ticks) * 1e-4

    def time_ns(self) -> int:
        return 1_700_000_000_000_000_000

    def __getattr__(self, name):
        return getattr(time, name)


def counting_clock(monkeypatch):
    """A fresh ``CountingClock`` in both packages' replica, trace and
    journal modules."""
    clock = CountingClock()
    for side in SIDES:
        for name in ("cluster.replica", "obs.trace", "persistence.journal"):
            module = _REF_CLOCKED[name] if side == "ref" else port(name)
            monkeypatch.setattr(module, "time", clock)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("piggyback", [False, True], ids=["piggyback-off", "piggyback-on"])
def test_wire_frames_are_byte_equal_both_ways(trace, piggyback, tmp_path, monkeypatch):
    """Every method's request, encoded by each package, goes into the
    other package's ``ClusterReplica.handle_wire`` (each replica with a
    journal, trace and version piggybacks both on or both off): request
    bytes are equal, and so are the response frames of the two replicas,
    byte for byte, spans and version vectors included (the replicas' span
    clocks pinned to the same counter; exact)."""
    counting_clock(monkeypatch)
    replicas = {
        side: mods(side).ClusterReplica(
            "r0", journal=mods(side).Journal(str(tmp_path / side)),
            trace_piggyback=piggyback, version_piggyback=piggyback)
        for side in SIDES
    }
    try:
        for method, args in wire_requests():
            parent = TRACEPARENT if trace else None
            request = {side: mods(side).encode_request(method, args, parent) for side in SIDES}
            assert request["port"] == request["ref"], method
            response = {}
            for side, other in (("port", "ref"), ("ref", "port")):
                counting_clock(monkeypatch)
                response[side] = replicas[side].handle_wire(request[other])
            assert response["port"] == response["ref"], method
            if trace and piggyback and method != "no_such_method":
                _, spans, vector = mods("ref").decode_response_vv(response["port"])
                assert spans and vector is not None
        assert (tmp_path / "port").exists()
        for name in sorted(p.name for p in (tmp_path / "ref").iterdir()):
            assert (tmp_path / "port" / name).read_bytes() == (
                tmp_path / "ref" / name).read_bytes()
    finally:
        for replica in replicas.values():
            replica.close()


def _ref_single_indexer(fast):
    ref = mods("ref")
    return _make_indexer(ref, ref.InMemoryIndex(), fast=fast)


def test_port_cluster_scores_equal_the_references_single_index(tmp_path):
    """A 3-replica strict-wire port ``LocalCluster`` with followers,
    filled by the port's event pool, scores every prompt exactly as the
    reference's ``Indexer`` over one ``InMemoryIndex`` filled by the
    reference's pool, on both lanes; again after one replica is killed
    mid-traffic (ring version and failover counter step by one); and
    after a purge of one pod, which the followers' replay never
    resurrects (exact)."""
    port_m, ref_m = mods("port"), mods("ref")
    rng = random.Random(23)
    stream = []
    for seq in range(1, 61):
        pod = rng.choice(["pod-a", "pod-b", "pod-c"])
        tokens = [rng.randrange(1, 300) for _ in range(4 * rng.randint(1, 6))]
        stream.append((pod, seq, [rng.getrandbits(63) for _ in range(len(tokens) // 4)],
                       tokens))
    prompts = [tokens for _, _, _, tokens in stream] + [
        [rng.randrange(1, 300) for _ in range(12)] for _ in range(5)]
    cluster = port_m.LocalCluster(journal_root=str(tmp_path), strict_wire=True)
    pools, indexers = [], []
    try:
        for m, index in ((port_m, cluster.remote_index), (ref_m, None)):
            single = index is None
            indexer = _ref_single_indexer(True) if single else _make_indexer(m, index)
            straight = _make_indexer(m, indexer.kv_block_index, fast=False)
            indexers += [indexer, straight]
            pool = m.Pool(indexer.kv_block_index, indexer.token_processor,
                          m.PoolConfig(concurrency=1))
            pool.start()
            pools.append(pool)
            for pod, seq, hashes, tokens in stream:
                pool.add_task(_stored_message(m, pod, seq, hashes, tokens))
            pool.drain()
        port_fast, port_straight, ref_fast, ref_straight = indexers

        def all_scores(fast, straight):
            return [(fast.get_pod_scores(words(t), MODEL), straight.get_pod_scores(
                words(t), MODEL)) for t in prompts]

        want = all_scores(ref_fast, ref_straight)
        assert sum(1 for fast, _ in want if fast) > 50
        assert all_scores(port_fast, port_straight) == want
        cluster.sync_followers()
        victim = cluster.membership.ring().owner(
            port_fast.token_processor.tokens_to_kv_block_keys(
                port_m.EMPTY_BLOCK_HASH, prompts[0], MODEL)[0])
        failovers = cluster.membership.status()["failovers"]
        cluster.kill(victim, notice=False)
        assert all_scores(port_fast, port_straight) == want
        assert cluster.membership.ring().version == 1
        assert cluster.membership.status()["failovers"] == failovers + 1
        cluster.remote_index.purge_pod("pod-b")
        ref_fast.kv_block_index.purge_pod("pod-b")
        cluster.sync_followers()
        purged = all_scores(ref_fast, ref_straight)
        assert all("pod-b" not in fast for fast, _ in purged)
        assert all_scores(port_fast, port_straight) == purged
        assert all(entry.pod_identifier != "pod-b"
                   for _, entries in cluster.remote_index.dump_entries()[0]
                   for entry in entries)
    finally:
        for pool in pools:
            pool.shutdown()
        for indexer in indexers:
            indexer.shutdown()
        cluster.close()
