"""The port's persistence (``persistence/``) against the JAX package's, on
the CPU.

Every case of the reference's ``tests/test_persistence.py`` runs on both
packages (``m`` is either one's names) and holds each to that test's
expectations: snapshots publish atomically and a torn or foreign file is
never loaded, a journal replays up to its last whole record, and a snapshot
plus the journal's tail restores an index whose lookups equal the live
one's.  Then the two packages against each other, exactly: snapshot and
journal files are byte-equal with the clock pinned, each package recovers
from the other's files, and ``dump_entries()`` after recovery is equal,
torn tails included.  Last, the port's one addition: its recovery report
names the snapshots it passed over and where the journal stopped short.
"""

import itertools
import os
import random
import shutil
import time

import pytest

from llm_d_kv_cache_manager_tpu import persistence as ref_persistence
from llm_d_kv_cache_manager_tpu.kvcache import kvblock as ref_kvblock
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import cbor_canonical as ref_cbor_canonical
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import cost_aware as ref_cost_aware
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import in_memory as ref_in_memory
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import index as ref_index
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import instrumented as ref_instrumented
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import redis_index as ref_redis_index
from llm_d_kv_cache_manager_tpu.kvevents import events as ref_events
from llm_d_kv_cache_manager_tpu.kvevents import pool as ref_pool
from llm_d_kv_cache_manager_tpu.persistence import journal as ref_journal
from llm_d_kv_cache_manager_tpu.persistence import recovery as ref_recovery
from llm_d_kv_cache_manager_tpu.persistence import snapshot as ref_snapshot
from tests.helpers.miniresp import MiniRespServer
from tests.helpers.torch_port import namespace, port

SIDES = ("ref", "port")
_REF = {
    "kvcache.kvblock": ref_kvblock,
    "kvcache.kvblock.cbor_canonical": ref_cbor_canonical,
    "kvcache.kvblock.cost_aware": ref_cost_aware,
    "kvcache.kvblock.in_memory": ref_in_memory,
    "kvcache.kvblock.index": ref_index,
    "kvcache.kvblock.instrumented": ref_instrumented,
    "kvcache.kvblock.redis_index": ref_redis_index,
    "kvevents.events": ref_events,
    "kvevents.pool": ref_pool,
    "persistence": ref_persistence,
    "persistence.journal": ref_journal,
    "persistence.snapshot": ref_snapshot,
}
_NAMES = {
    "kvcache.kvblock": ("ChunkedTokenDatabase", "PodEntry", "TokenProcessorConfig"),
    "kvcache.kvblock.cbor_canonical": ("CborDecodeError", "decode_canonical",
                                       "encode_canonical"),
    "kvcache.kvblock.cost_aware": ("CostAwareMemoryIndex",),
    "kvcache.kvblock.in_memory": ("InMemoryIndex",),
    "kvcache.kvblock.index": ("CostAwareIndexConfig", "InMemoryIndexConfig",
                              "RedisIndexConfig"),
    "kvcache.kvblock.instrumented": ("InstrumentedIndex",),
    "kvcache.kvblock.redis_index": ("RedisIndex",),
    "kvevents.events": ("BlockRemoved", "BlockStored", "EventBatch"),
    "kvevents.pool": ("Message", "Pool", "PoolConfig"),
    "persistence": ("Journal", "PersistenceConfig", "PersistenceManager", "recover"),
    "persistence.journal": ("iter_journal", "list_segments", "tail"),
    "persistence.snapshot": ("SnapshotError", "load_latest_snapshot", "read_snapshot",
                             "write_snapshot"),
}


def mods(side):
    m = namespace(side, _REF, _NAMES)
    m.rec = ref_recovery if side == "ref" else port("persistence.recovery")
    m.POD_A = m.PodEntry("pod-a", "hbm")
    m.POD_B = m.PodEntry("pod-b", "host")
    return m


@pytest.fixture(params=SIDES)
def m(request):
    return mods(request.param)


def make_index(m, kind: str):
    if kind == "in_memory":
        return m.InMemoryIndex(m.InMemoryIndexConfig(size=10_000))
    if kind == "cost_aware":
        return m.CostAwareMemoryIndex(
            m.CostAwareIndexConfig(max_cost_bytes=64 * 1024 * 1024)
        )
    raise ValueError(kind)


def populate(m, index) -> list:
    """A small but non-trivial state: two pods, two tiers, a chain."""
    index.add([1, 2, 3], [11, 12, 13], [m.POD_A])
    index.add([2, 3], [12, 13], [m.POD_B])
    index.add([4], [14], [m.PodEntry("pod-a", "host")])
    index.evict(4, [m.PodEntry("pod-a", "host")])
    return [11, 12, 13, 14, 99]  # 14 evicted, 99 never present


class TestCborDecoder:
    def test_roundtrip(self, m):
        doc = [0, -5, 2**64 - 1, "pod", b"\x00\xff", [True, None, []]]
        assert m.decode_canonical(m.encode_canonical(doc)) == doc

    def test_truncation_raises(self, m):
        data = m.encode_canonical([1, [2, 3], "abc"])
        for cut in range(1, len(data)):
            with pytest.raises(m.CborDecodeError):
                m.decode_canonical(data[:cut])

    def test_trailing_garbage_raises(self, m):
        with pytest.raises(m.CborDecodeError):
            m.decode_canonical(m.encode_canonical([1]) + b"\x00")


@pytest.mark.parametrize("kind", ["in_memory", "cost_aware"])
class TestSnapshotRoundTrip:
    def test_dump_restore_identical_lookup(self, m, kind, tmp_path):
        source = make_index(m, kind)
        keys = populate(m, source)
        block_entries, engine_map = source.dump_entries()
        m.write_snapshot(str(tmp_path), {"pod-a": 7}, block_entries, engine_map)

        restored = make_index(m, kind)
        info, entries, emap = m.load_latest_snapshot(str(tmp_path))
        restored.restore_entries(entries, emap)
        assert restored.lookup(keys) == source.lookup(keys)
        assert info.watermarks == {"pod-a": 7}
        # Engine-key mappings survive too (parent resolution after
        # recovery depends on them).
        assert restored.get_request_key(1) == 11

    def test_restore_respects_capacity_bounds(self, m, kind, tmp_path):
        source = make_index(m, kind)
        for i in range(50):
            source.add([1000 + i], [2000 + i], [m.POD_A])
        block_entries, engine_map = source.dump_entries()
        if kind == "in_memory":
            bounded = m.InMemoryIndex(m.InMemoryIndexConfig(size=10))
        else:
            # Budget for roughly a handful of keys.
            bounded = m.CostAwareMemoryIndex(
                m.CostAwareIndexConfig(max_cost_bytes=2000)
            )
        bounded.restore_entries(block_entries, engine_map)
        found = bounded.lookup([2000 + i for i in range(50)])
        assert 0 < len(found) < 50
        # LRU-first dump order: the NEWEST keys are the survivors.
        assert 2049 in found


class TestSnapshotAtomicity:
    def test_partial_tmp_file_never_loaded(self, m, tmp_path):
        """A writer killed before the rename leaves only a .tmp file;
        the loader must not even consider it."""
        index = make_index(m, "in_memory")
        populate(m, index)
        entries, emap = index.dump_entries()
        info = m.write_snapshot(str(tmp_path), {}, entries, emap)
        # Simulate a killed second writer: a half-written tmp file.
        torn = os.path.join(
            str(tmp_path), "snapshot-99999999999999999999.snap.tmp.123.4"
        )
        with open(torn, "wb") as handle:
            handle.write(b"KVTPUSNP\x00\x01partial")
        loaded_info, _, _ = m.load_latest_snapshot(str(tmp_path))
        assert loaded_info.path == info.path

    def test_torn_published_file_falls_back_to_previous(self, m, tmp_path):
        index = make_index(m, "in_memory")
        populate(m, index)
        entries, emap = index.dump_entries()
        good = m.write_snapshot(str(tmp_path), {}, entries, emap)
        newer = m.write_snapshot(
            str(tmp_path), {}, entries, emap, retain=5
        )
        # Truncate the newer snapshot mid-body (torn write on a
        # non-atomic filesystem / disk corruption).
        size = os.path.getsize(newer.path)
        with open(newer.path, "r+b") as handle:
            handle.truncate(size - 10)
        with pytest.raises(m.SnapshotError):
            m.read_snapshot(newer.path)
        loaded_info, loaded_entries, _ = m.load_latest_snapshot(
            str(tmp_path)
        )
        assert loaded_info.path == good.path
        assert len(loaded_entries) == len(entries)

    def test_bad_magic_and_version_rejected(self, m, tmp_path):
        path = os.path.join(str(tmp_path), "snapshot-1.snap")
        with open(path, "wb") as handle:
            handle.write(b"NOTASNAP" + b"\x00" * 14)
        with pytest.raises(m.SnapshotError, match="magic"):
            m.read_snapshot(path)
        assert m.load_latest_snapshot(str(tmp_path)) is None

    def test_retention_prunes_old_snapshots(self, m, tmp_path):
        index = make_index(m, "in_memory")
        populate(m, index)
        entries, emap = index.dump_entries()
        for _ in range(4):
            m.write_snapshot(str(tmp_path), {}, entries, emap, retain=2)
        remaining = [
            name
            for name in os.listdir(str(tmp_path))
            if name.endswith(".snap")
        ]
        assert len(remaining) == 2


class TestJournal:
    def test_torn_final_record_replays_prefix(self, m, tmp_path):
        journal = m.Journal(str(tmp_path))
        journal.record_add("pod-a", 1, [1], [11], [m.POD_A])
        journal.record_add("pod-a", 2, [2], [12], [m.POD_A])
        journal.record_evict("pod-a", 3, [1], [m.POD_A])
        journal.close()
        (_, path), = m.list_segments(str(tmp_path))
        # Tear the tail mid-record: every prefix length must yield
        # exactly the records whose framing fully survived.
        full = open(path, "rb").read()
        with open(path, "r+b") as handle:
            handle.truncate(len(full) - 7)
        records = list(m.iter_journal(str(tmp_path)))
        assert [r.seq for r in records] == [1, 2]

    def test_corrupt_crc_stops_replay(self, m, tmp_path):
        journal = m.Journal(str(tmp_path))
        journal.record_add("pod-a", 1, [1], [11], [m.POD_A])
        journal.record_add("pod-a", 2, [2], [12], [m.POD_A])
        journal.close()
        (_, path), = m.list_segments(str(tmp_path))
        data = bytearray(open(path, "rb").read())
        data[-1] ^= 0xFF  # flip a byte in the LAST record's body
        with open(path, "wb") as handle:
            handle.write(bytes(data))
        records = list(m.iter_journal(str(tmp_path)))
        assert [r.seq for r in records] == [1]

    def test_rotation_and_fresh_segment_on_reopen(self, m, tmp_path):
        journal = m.Journal(str(tmp_path), segment_max_bytes=128)
        for i in range(10):
            journal.record_add("pod-a", i + 1, [i], [100 + i], [m.POD_A])
        journal.close()
        first_count = len(m.list_segments(str(tmp_path)))
        assert first_count > 1  # rotation happened
        # A new Journal never appends to a possibly-torn tail segment.
        journal2 = m.Journal(str(tmp_path), segment_max_bytes=128)
        journal2.record_add("pod-a", 11, [10], [110], [m.POD_A])
        journal2.close()
        assert len(m.list_segments(str(tmp_path))) == first_count + 1
        assert [r.seq for r in m.iter_journal(str(tmp_path))] == list(
            range(1, 12)
        )

    def test_watermarks_track_max_seq_per_pod(self, m, tmp_path):
        journal = m.Journal(str(tmp_path))
        journal.record_add("pod-a", 5, [1], [11], [m.POD_A])
        journal.record_add("pod-b", 2, [2], [12], [m.POD_B])
        journal.record_evict("pod-a", 7, [1], [m.POD_A])
        assert journal.watermarks() == {"pod-a": 7, "pod-b": 2}
        journal.close()


class TestRecovery:
    def test_cold_start_reports_cold(self, m, tmp_path):
        index = make_index(m, "in_memory")
        report = m.recover(
            index, m.PersistenceConfig(directory=str(tmp_path))
        )
        assert report.status == "cold"
        assert report.block_keys_restored == 0

    @pytest.mark.parametrize("kind", ["in_memory", "cost_aware"])
    def test_snapshot_plus_replay_round_trip(self, m, kind, tmp_path):
        """The acceptance round trip: snapshot at a boundary, more
        traffic journaled after it, recovery = snapshot + tail."""
        config = m.PersistenceConfig(directory=str(tmp_path))
        manager = m.PersistenceManager(config)
        source = make_index(m, kind)
        keys = populate(m, source)
        # Journal mirrors the applied ops (as the pool tap would).
        manager.journal.record_add(
            "pod-a", 1, [1, 2, 3], [11, 12, 13], [m.POD_A]
        )
        manager.journal.record_add("pod-b", 1, [2, 3], [12, 13], [m.POD_B])
        manager.snapshot(source)
        # Post-snapshot traffic lives only in the journal tail.
        source.add([5], [15], [m.POD_B])
        manager.journal.record_add("pod-b", 2, [5], [15], [m.POD_B])
        source.evict(2, [m.POD_A])
        manager.journal.record_evict("pod-a", 2, [2], [m.POD_A])
        manager.close()

        restored = make_index(m, kind)
        report = m.recover(restored, config)
        assert report.status == "warm"
        assert report.records_replayed == 2
        all_keys = keys + [15]
        assert restored.lookup(all_keys) == source.lookup(all_keys)

    def test_replay_applies_purge_in_order(self, m, tmp_path):
        """OP_PURGE closes a real gap: a purge_pod between the snapshot
        and the crash used to be lost on replay — the replayed adds
        resurrected exactly the entries the operator dropped.  The
        purge record must replay in journal order (adds before it come
        back, adds after it survive)."""
        config = m.PersistenceConfig(directory=str(tmp_path))
        manager = m.PersistenceManager(config)
        source = make_index(m, "in_memory")
        source.add([1, 2], [11, 12], [m.POD_A, m.POD_B])
        manager.journal.record_add(
            "pod-a", 1, [1, 2], [11, 12], [m.POD_A, m.POD_B]
        )
        source.purge_pod(m.POD_B.pod_identifier)
        manager.journal.record_purge(m.POD_B.pod_identifier)
        # POD_B re-claims one key AFTER the purge: must survive.
        source.add([2], [12], [m.POD_B])
        manager.journal.record_add("pod-b", 2, [2], [12], [m.POD_B])
        manager.close()

        restored = make_index(m, "in_memory")
        m.recover(restored, config)
        assert restored.lookup([11, 12]) == source.lookup([11, 12])
        assert all(
            p.pod_identifier != m.POD_B.pod_identifier
            for p in restored.lookup([11]).get(11, [])
        )
        assert m.POD_B in restored.lookup([12])[12]

    def test_boundary_skips_uncompacted_covered_segments(self, m, tmp_path):
        """Snapshots carry their journal boundary: when compaction
        failed (crash between publish and compact), the covered
        pre-boundary segments must be skipped WHOLESALE — an
        uncompacted pre-boundary purge would otherwise replay against
        restored state whose covering re-adds the watermark skip
        elides."""
        config = m.PersistenceConfig(directory=str(tmp_path))
        manager = m.PersistenceManager(config)
        source = make_index(m, "in_memory")
        # History: purge pod-a, then re-admit it with seq<=watermark.
        manager.journal.record_purge(m.POD_A.pod_identifier)
        source.add([1], [11], [m.POD_A])
        manager.journal.record_add("pod-a", 5, [1], [11], [m.POD_A])
        info = manager.snapshot(source)
        assert info.journal_boundary is not None
        # Simulate the failed compaction: resurrect a covered segment
        # below the boundary holding the purge + re-add.

        survivors = m.list_segments(config.journal_dir)
        stale = m.Journal(str(tmp_path / "stale"))
        stale.record_purge(m.POD_A.pod_identifier)
        stale.record_add("pod-a", 5, [1], [11], [m.POD_A])
        stale.close()
        for segment_id, path in m.list_segments(str(tmp_path / "stale")):
            low_id = info.journal_boundary - 1
            target = os.path.join(
                config.journal_dir,
                f"segment-{low_id:012d}.kvj",
            )
            assert all(sid != low_id for sid, _ in survivors)
            shutil.copy(path, target)
        manager.close()

        restored = make_index(m, "in_memory")
        report = m.recover(restored, config)
        # The covered segment (purge + watermark-skippable re-add)
        # never replays: pod-a's snapshot state survives.
        assert restored.lookup([11]) == {11: [m.POD_A]}
        assert report.records_replayed == 0

    def test_recovery_gates_on_durable_backend(self, m, tmp_path):
        """Startup recovery must never pipeline a file snapshot or a
        journal replay into a durable (server-side, shared) backend —
        the server is authoritative (docs/persistence.md §6)."""
        config = m.PersistenceConfig(directory=str(tmp_path))
        manager = m.PersistenceManager(config)
        stale_state = make_index(m, "in_memory")
        stale_state.add([1], [11], [m.POD_A])
        manager.journal.record_add("pod-a", 1, [1], [11], [m.POD_A])
        manager.snapshot(stale_state)
        manager.close()

        server = MiniRespServer()
        try:
            index = m.RedisIndex(m.RedisIndexConfig(address=server.address))
            report = m.recover(index, config)
            assert report.status == "cold"
            assert report.block_keys_restored == 0
            assert report.records_replayed == 0
            # Nothing was resurrected into the server.
            assert index.lookup([11]) == {}
        finally:
            server.close()

    def test_compact_keep_last_retains_newest_segments(self, m, tmp_path):
        journal = m.Journal(str(tmp_path), segment_max_bytes=1)
        for seq in range(1, 7):  # one segment per append at this size
            journal.record_add("pod-a", seq, [seq], [seq], [m.POD_A])

        assert len(m.list_segments(str(tmp_path))) >= 6
        removed = journal.compact_keep_last(2)
        assert removed >= 4
        assert len(m.list_segments(str(tmp_path))) == 2
        # The retained suffix still tails cleanly.
        records, _ = m.tail(str(tmp_path))
        assert [r.seq for r in records] == [5, 6]
        assert journal.compact_keep_last(0) == 0  # disabled
        journal.close()

    def test_replay_skips_records_strictly_below_watermark(
        self, m, tmp_path
    ):
        config = m.PersistenceConfig(directory=str(tmp_path))
        manager = m.PersistenceManager(config)
        index = make_index(m, "in_memory")
        index.add([1], [11], [m.POD_A])
        manager.journal.record_add("pod-a", 4, [1], [11], [m.POD_A])
        manager.snapshot(index)  # watermark pod-a=4, journal compacted
        # Late duplicate delivery BELOW the watermark (e.g. a replayed
        # publisher), a same-seq sibling AT the watermark (one
        # message's events share a seq and can straddle the snapshot
        # boundary — its effect may be missing from the dump, so it
        # MUST replay), and genuinely new traffic above it.
        manager.journal.record_add("pod-a", 3, [9], [19], [m.POD_A])
        manager.journal.record_add("pod-a", 4, [5], [15], [m.POD_A])
        manager.journal.record_add("pod-a", 6, [6], [16], [m.POD_A])
        manager.close()

        restored = make_index(m, "in_memory")
        report = m.recover(restored, config)
        assert report.records_skipped == 1
        assert report.records_replayed == 2
        found = restored.lookup([11, 15, 16, 19])
        assert set(found) == {11, 15, 16}

    def test_failed_snapshot_publish_keeps_lag_truthful(
        self, m, tmp_path, monkeypatch
    ):
        """A failed snapshot write (ENOSPC class) must not zero the
        journal-lag telemetry: the replay cost it reports is real
        until a snapshot actually publishes."""

        config = m.PersistenceConfig(directory=str(tmp_path))
        manager = m.PersistenceManager(config)
        index = make_index(m, "in_memory")
        index.add([1], [11], [m.POD_A])
        manager.journal.record_add("pod-a", 1, [1], [11], [m.POD_A])

        def boom(*a, **kw):
            raise OSError(28, "No space left on device")

        monkeypatch.setattr(m.rec, "write_snapshot", boom)
        with pytest.raises(OSError):
            manager.snapshot(index)
        assert manager.status()["journal_records_since_snapshot"] == 1
        monkeypatch.undo()
        manager.snapshot(index)
        assert manager.status()["journal_records_since_snapshot"] == 0
        manager.close()

    def test_compaction_removes_covered_segments(self, m, tmp_path):
        config = m.PersistenceConfig(
            directory=str(tmp_path), journal_segment_max_bytes=128
        )
        manager = m.PersistenceManager(config)
        index = make_index(m, "in_memory")
        for i in range(10):
            index.add([i], [100 + i], [m.POD_A])
            manager.journal.record_add(
                "pod-a", i + 1, [i], [100 + i], [m.POD_A]
            )
        assert len(m.list_segments(config.journal_dir)) > 1
        manager.snapshot(index)
        # Everything below the boundary is covered by the snapshot.
        assert m.list_segments(config.journal_dir) == []
        manager.close()
        restored = make_index(m, "in_memory")
        m.recover(restored, config)
        keys = [100 + i for i in range(10)]
        assert restored.lookup(keys) == index.lookup(keys)


class TestBackendContractExtensions:
    def test_instrumented_delegates(self, m):
        inner = make_index(m, "in_memory")
        wrapped = m.InstrumentedIndex(inner)
        wrapped.add([1], [11], [m.POD_A])
        entries, emap = wrapped.dump_entries()
        assert entries and emap
        other = m.InstrumentedIndex(make_index(m, "in_memory"))
        assert other.restore_entries(entries, emap) == 1
        assert other.lookup([11]) == inner.lookup([11])

    def test_redis_backend_answers_dump_restore(self, m):
        """The long-documented Redis no-op was replaced by a SCAN-based
        dump when the backend was promoted to replica duty
        (docs/replication.md); the round trip must hold like every
        other backend's."""
        server = MiniRespServer()
        try:
            index = m.RedisIndex(m.RedisIndexConfig(address=server.address))
            index.add([21, 22], [121, 122], [m.POD_A])
            entries, emap = index.dump_entries()
            assert {k for k, _ in entries} == {121, 122}
            assert dict(emap) == {21: 121, 22: 122}
            index._client.execute("FLUSHALL")
            assert index.restore_entries(entries, emap) == 2
            assert set(index.lookup([121, 122])) == {121, 122}
            assert index.get_request_key(21) == 121
        finally:
            server.close()


class TestPoolJournalTap:
    def test_applied_events_flow_to_journal_and_recover(self, m, tmp_path):
        """End to end through the real wire path: msgpack BlockStored/
        BlockRemoved -> sharded pool -> index apply -> journal tap ->
        recovery into a fresh index with identical lookups."""
        config = m.PersistenceConfig(directory=str(tmp_path))
        manager = m.PersistenceManager(config)
        index = m.InMemoryIndex(m.InMemoryIndexConfig(size=10_000))
        db = m.ChunkedTokenDatabase(m.TokenProcessorConfig(block_size=4))
        pool = m.Pool(
            index,
            db,
            m.PoolConfig(concurrency=2),
            journal=manager.journal,
        )
        pool.start()

        def deliver(pod, seq, *events):
            batch = m.EventBatch(ts=1.0, events=list(events))
            pool.add_task(
                m.Message(
                    topic=f"kv@{pod}@m",
                    payload=batch.encode(),
                    pod_identifier=pod,
                    model_name="m",
                    seq=seq,
                )
            )
            pool.drain()

        deliver(
            "pod-a",
            1,
            m.BlockStored(
                block_hashes=[101, 102],
                parent_block_hash=None,
                token_ids=[1, 2, 3, 4, 5, 6, 7, 8],
                block_size=4,
                medium="hbm",
            ),
        )
        deliver("pod-a", 2, m.BlockRemoved(block_hashes=[102]))
        pool.shutdown()
        manager.close()

        request_keys = db.tokens_to_kv_block_keys(
            0, [1, 2, 3, 4, 5, 6, 7, 8], "m"
        )
        restored = m.InMemoryIndex(m.InMemoryIndexConfig(size=10_000))
        report = m.recover(restored, config)
        assert report.records_replayed == 2
        assert report.pods == ["pod-a"]
        assert restored.lookup(request_keys) == index.lookup(request_keys)
        # The stored-then-removed second block is absent in both.
        assert request_keys[1] not in restored.lookup(request_keys)

    def test_failed_apply_is_not_journaled(self, m, tmp_path):
        """The tap sits AFTER the apply: an event whose parent cannot
        be resolved (skipped by the digest) must leave no record."""
        config = m.PersistenceConfig(directory=str(tmp_path))
        manager = m.PersistenceManager(config)
        index = m.InMemoryIndex(m.InMemoryIndexConfig(size=10_000))
        db = m.ChunkedTokenDatabase(m.TokenProcessorConfig(block_size=4))
        pool = m.Pool(
            index, db, m.PoolConfig(concurrency=1), journal=manager.journal
        )
        pool.start()
        batch = m.EventBatch(
            ts=1.0,
            events=[
                m.BlockStored(
                    block_hashes=[7],
                    parent_block_hash=999999,  # unknown parent: skipped
                    token_ids=[1, 2, 3, 4],
                    block_size=4,
                )
            ],
        )
        pool.add_task(
            m.Message(
                topic="kv@pod-a@m",
                payload=batch.encode(),
                pod_identifier="pod-a",
                model_name="m",
                seq=1,
            )
        )
        pool.drain()
        pool.shutdown()
        manager.close()
        assert list(m.iter_journal(config.journal_dir)) == []


class TestManagerStatus:
    def test_status_reflects_snapshot_and_lag(self, m, tmp_path):
        config = m.PersistenceConfig(directory=str(tmp_path))
        manager = m.PersistenceManager(config)
        status = manager.status()
        assert status["snapshot_path"] is None
        index = make_index(m, "in_memory")
        index.add([1], [11], [m.POD_A])
        manager.journal.record_add("pod-a", 1, [1], [11], [m.POD_A])
        assert manager.status()["journal_records_since_snapshot"] == 1
        manager.snapshot(index)
        status = manager.status()
        assert status["snapshot_path"]
        assert status["snapshot_bytes"] > 0
        assert status["journal_records_since_snapshot"] == 0
        manager.close()


# ------------------------------------------------- the two packages, exactly


def plain(dump):
    """``dump_entries()`` as plain tuples, comparable across packages."""
    blocks, engine_map = dump
    return ([(int(k), [(e.pod_identifier, e.device_tier) for e in es]) for k, es in blocks],
            [(int(ek), int(rk)) for ek, rk in engine_map])


def files_of(directory):
    """{relative path: bytes} of every file under ``directory``."""
    out = {}
    for root, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(root, name)
            out[os.path.relpath(path, directory)] = open(path, "rb").read()
    return out


class PinnedClock:
    """The ``time`` module as the snapshot and journal modules see it,
    with ``time_ns`` a counter from a fixed start: the snapshot's
    ``created_ns`` and every journal record's ``ts_ns`` come from it."""

    def __init__(self) -> None:
        self._ticks = itertools.count(1_700_000_000_000_000_000, 1_000_003)

    def time_ns(self) -> int:
        return next(self._ticks)

    def __getattr__(self, name):
        return getattr(time, name)


def pinned_clock(monkeypatch):
    """A fresh ``PinnedClock`` in both packages' snapshot and journal
    modules (only theirs: no other thread can take a tick)."""
    clock = PinnedClock()
    for module in (ref_snapshot, ref_journal, port("persistence.snapshot"),
                   port("persistence.journal")):
        monkeypatch.setattr(module, "time", clock)


def seeded_ops(seed: int, n: int):
    """A random history of applied operations over three pods: adds of
    short chains (two tiers), evictions of added engine keys, and one
    purge, each with its pod's next publisher seq."""
    rng = random.Random(seed)
    ops, added, seqs = [], [], {}
    for _ in range(n):
        pod = rng.choice(["pod-a", "pod-b", "pod-c"])
        seqs[pod] = seqs.get(pod, 0) + 1
        roll = rng.random()
        if roll < 0.02:
            ops.append(("purge", pod, seqs[pod]))
        elif roll < 0.25 and added:
            ek, tier, owner = added.pop(rng.randrange(len(added)))
            ops.append(("evict", owner, seqs[owner], ek, tier))
        else:
            length = rng.randint(1, 4)
            eks = [rng.getrandbits(64) for _ in range(length)]
            rks = [rng.getrandbits(64) for _ in range(length)]
            tier = rng.choice(["hbm", "host"])
            ops.append(("add", pod, seqs[pod], eks, rks, tier))
            added.extend((ek, tier, pod) for ek in eks)
    return ops


def apply_ops(m, index, journal, ops):
    """Apply ``ops`` to ``index`` and tap each into ``journal`` after
    the apply, as the event pool does."""
    for op in ops:
        if op[0] == "add":
            _, pod, seq, eks, rks, tier = op
            entries = [m.PodEntry(pod, tier)]
            index.add(eks, rks, entries)
            journal.record_add(pod, seq, eks, rks, entries)
        elif op[0] == "evict":
            _, pod, seq, ek, tier = op
            entries = [m.PodEntry(pod, tier)]
            index.evict(ek, entries)
            journal.record_evict(pod, seq, [ek], entries)
        else:
            _, pod, seq = op
            index.purge_pod(pod)
            journal.record_purge(pod, seq)


def write_history(m, directory, kind="in_memory", seed=0, n=400, segment_bytes=2048):
    """A live index, a snapshot at half the history and the rest in the
    journal (rotating every ``segment_bytes``); returns the live index."""
    config = m.PersistenceConfig(directory=str(directory),
                                 journal_segment_max_bytes=segment_bytes)
    manager = m.PersistenceManager(config)
    index = make_index(m, kind)
    ops = seeded_ops(seed, n)
    apply_ops(m, index, manager.journal, ops[: n // 2])
    manager.snapshot(index)
    apply_ops(m, index, manager.journal, ops[n // 2:])
    manager.close()
    return index


def report_fields(report):
    return (report.status, report.block_keys_restored, report.engine_mappings_restored,
            report.records_replayed, report.records_skipped, report.pods)


@pytest.mark.parametrize("kind", ["in_memory", "cost_aware"])
def test_snapshot_and_journal_bytes_are_equal_with_the_clock_pinned(kind, tmp_path,
                                                                      monkeypatch):
    """The same history through both packages' ``PersistenceManager``
    writes the same files, byte for byte (tolerance: exact): the snapshot
    (name, header, CRC, canonical-CBOR body with its journal boundary)
    and every journal segment, rotation included."""
    written = {}
    for side in SIDES:
        pinned_clock(monkeypatch)
        write_history(mods(side), tmp_path / side, kind=kind)
        written[side] = files_of(tmp_path / side)
    assert len([p for p in written["ref"] if p.startswith("journal")]) > 2  # rotated
    assert written["port"] == written["ref"]


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_recovers_from_the_others_files(writer, reader, tmp_path):
    """One package writes a snapshot and a journal; the other recovers a
    fresh index from them, and its ``dump_entries()`` equals the writer's
    live index and the writer's own recovery (exact)."""
    live = write_history(mods(writer), tmp_path)
    own, other = make_index(mods(writer), "in_memory"), make_index(mods(reader), "in_memory")
    config_of = lambda side: mods(side).PersistenceConfig(directory=str(tmp_path))
    own_report = mods(writer).recover(own, config_of(writer))
    other_report = mods(reader).recover(other, config_of(reader))
    assert plain(other.dump_entries()) == plain(own.dump_entries()) == plain(
        live.dump_entries())
    assert report_fields(other_report) == report_fields(own_report)
    assert own_report.status == "warm" and own_report.records_replayed > 0


@pytest.mark.parametrize("cut", [1, 5, 9, "half", "whole"])
def test_recovery_after_a_torn_tail_is_equal(cut, tmp_path):
    """The last journal record is cut short (by a few bytes, through its
    header, by half, or whole plus its predecessor's last byte): both
    packages replay the same prefix, and their indexes' ``dump_entries()``
    and reports are equal (exact)."""
    write_history(mods("port"), tmp_path / "src")
    segments = mods("ref").list_segments(str(tmp_path / "src" / "journal"))
    path = segments[-1][1]
    data = open(path, "rb").read()
    records = list(mods("ref").iter_journal(str(tmp_path / "src" / "journal")))
    last = len(records[-1].encode()) + 8
    drop = {"half": last // 2, "whole": last + 1}.get(cut, cut)
    with open(path, "r+b") as handle:
        handle.truncate(len(data) - drop)
    out = {}
    for side in SIDES:
        m = mods(side)
        index = make_index(m, "in_memory")
        report = m.recover(index, m.PersistenceConfig(directory=str(tmp_path / "src")))
        out[side] = (plain(index.dump_entries()), report_fields(report))
    assert out["port"] == out["ref"]
    replayed = out["port"][1][3] + out["port"][1][4]
    intact = len(list(mods("ref").iter_journal(str(tmp_path / "src" / "journal"))))
    assert intact == len(records) - (2 if cut == "whole" else 1)
    assert replayed == intact


def test_tail_positions_are_equal_through_rotation_and_compaction(tmp_path, monkeypatch):
    """Both packages' ``tail()`` follow the same history in bounded steps
    through rotation, a retention compaction and a boundary compaction:
    the records read and every ``TailPosition`` are equal at each step
    (exact)."""
    ops = seeded_ops(3, 120)
    pinned = {}
    for side in SIDES:
        pinned_clock(monkeypatch)
        m = mods(side)
        journal = m.Journal(str(tmp_path / side), segment_max_bytes=600)
        index = make_index(m, "in_memory")
        steps, position = [], None
        for start in range(0, len(ops), 20):
            apply_ops(m, index, journal, ops[start:start + 20])
            if start == 60:
                journal.compact_keep_last(3)
            if start == 100:
                boundary, _, _ = journal.snapshot_boundary()
                journal.compact_before(boundary - 1)
            for _ in range(2):
                records, position = m.tail(str(tmp_path / side), position, max_records=7)
                steps.append(([r.encode() for r in records],
                              (position.segment_id, position.offset)))
        journal.close()
        pinned[side] = steps
    assert pinned["port"] == pinned["ref"]
    assert len({pos[0] for _, pos in pinned["port"]}) > 3


def test_pool_taps_equal_journals(tmp_path, monkeypatch):
    """One seeded stream of KV events (stores with parents, removals)
    through both packages' event pools with a ``Journal`` tapped in: the
    journal files are byte-equal with the clock pinned and the indexes'
    ``dump_entries()`` are equal (exact).  Each message is applied before
    the next is queued: the pool drains its per-pod lanes round-robin, so
    a backlog (a loaded machine) would interleave the two pods' records
    differently in each package's run."""
    rng = random.Random(11)
    stream = []
    for i in range(60):
        pod = rng.choice(["pod-a", "pod-b"])
        tokens = [rng.randrange(1, 5000) for _ in range(4 * rng.randint(1, 4))]
        hashes = [rng.getrandbits(63) for _ in range(len(tokens) // 4)]
        stream.append((pod, i + 1, "store", hashes, tokens))
        if rng.random() < 0.3:
            stream.append((pod, i + 1, "remove", hashes[-1:], None))
    out = {}
    for side in SIDES:
        pinned_clock(monkeypatch)
        m = mods(side)
        journal = m.Journal(str(tmp_path / side))
        index = make_index(m, "in_memory")
        db = m.ChunkedTokenDatabase(m.TokenProcessorConfig(block_size=4))
        pool = m.Pool(index, db, m.PoolConfig(concurrency=1), journal=journal)
        pool.start()
        try:
            for pod, seq, kind, hashes, tokens in stream:
                event = (m.BlockStored(block_hashes=hashes, parent_block_hash=None,
                                       token_ids=tokens, block_size=4, medium="hbm")
                         if kind == "store" else m.BlockRemoved(block_hashes=hashes))
                batch = m.EventBatch(ts=1.0, events=[event])
                pool.add_task(m.Message(topic=f"kv@{pod}@m", payload=batch.encode(),
                                        pod_identifier=pod, model_name="m", seq=seq))
                pool.drain()
        finally:
            pool.shutdown()
            journal.close()
        out[side] = (files_of(tmp_path / side), plain(index.dump_entries()))
    assert out["port"] == out["ref"]
    assert len(out["port"][1][0]) > 50


def test_port_recovery_report_names_torn_tails_and_rejected_snapshots(tmp_path):
    """The port's addition to the report: a torn last record is named
    (its segment and offset) and a corrupt newest snapshot is named, while
    the replayed prefix and the fallback snapshot are what the reference
    recovers too."""
    write_history(mods("port"), tmp_path)
    m = mods("port")
    config = m.PersistenceConfig(directory=str(tmp_path))
    clean = m.recover(make_index(m, "in_memory"), config)
    assert clean.torn_tails == [] and clean.rejected_snapshots == []
    # A newer, corrupt snapshot, and a torn last record.
    (good,) = [n for n in os.listdir(config.snapshot_dir)]
    bad = os.path.join(config.snapshot_dir, "snapshot-" + "9" * 20 + ".snap")
    shutil.copy(os.path.join(config.snapshot_dir, good), bad)
    with open(bad, "r+b") as handle:
        handle.truncate(os.path.getsize(bad) - 3)
    (*_, (_, path)) = m.list_segments(config.journal_dir)
    size = os.path.getsize(path)
    with open(path, "r+b") as handle:
        handle.truncate(size - 4)
    out = {}
    for side in SIDES:
        index = make_index(mods(side), "in_memory")
        report = mods(side).recover(index, mods(side).PersistenceConfig(directory=str(tmp_path)))
        out[side] = (plain(index.dump_entries()), report_fields(report), report)
    assert out["port"][:2] == out["ref"][:2]
    report = out["port"][2]
    assert report.snapshot_path.endswith(good)
    assert len(report.rejected_snapshots) == 1 and report.rejected_snapshots[0].startswith(bad)
    assert "torn" in report.rejected_snapshots[0]
    (stop,) = report.torn_tails
    assert stop.startswith(path + "@") and "torn record" in stop
    assert report.records_replayed == clean.records_replayed - 1
    assert report.to_dict()["torn_tails"] == [stop]
