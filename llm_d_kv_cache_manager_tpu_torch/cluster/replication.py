"""Journal-fed replication: followers keep standby slices warm.

A :class:`ReplicationFollower` keeps a local index current with one
primary replica by (1) an optional warm-sync bootstrap — the primary's
``sync_snapshot`` RPC returns a journal boundary, its per-pod seq
watermarks, and a dump taken after the boundary — and (2) tailing the
primary's journal segments from that boundary with
``persistence.journal.tail`` (torn tails hold, rotation and compaction
are followed; see the tail contract).  Numbered records strictly below
the bootstrap watermark are skipped, mirroring recovery's replay rule;
unnumbered records (seq 0 — e.g. router-fed applies, whose publisher
seq died at the Index interface) always replay.  Replay is idempotent
either way.

**Standby slices.**  A follower normally applies only the keys it
would inherit if the primary died: ``standby_record_filter`` trims
each record to the keys whose rendezvous runner-up — computed on the
FULL configured ring, which never changes version — is this replica.
When the membership then removes the dead primary, the live ring's new
owner for those keys IS this replica (the rendezvous property), so the
failed-over slice is warm up to the follower's last poll: the pinned
hit-rate dip is bounded by ``poll_interval_s`` of traffic plus
anything holding at a torn tail.

Journal directories are the replication channel: in-process clusters
(tests, bench, smoke) share a tmpdir; multi-process deployments put
them on the shared filesystem the offload tier already mounts
(docs/replication.md).

Copied from the JAX reference's ``cluster/replication.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from llm_d_kv_cache_manager_tpu_torch.cluster.replica import (
    decode_entries,
)
from llm_d_kv_cache_manager_tpu_torch.cluster.ring import HashRing
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index
from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS, safe_label
from llm_d_kv_cache_manager_tpu_torch.persistence.journal import (
    OP_ADD,
    OP_PURGE,
    JournalRecord,
    TailPosition,
    tail,
)
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("cluster.replication")

# Leaf lock: position/stats bookkeeping only; applies into the local
# index happen outside it.
# kvlint: lock-order: ReplicationFollower._lock ascending
lockorder.declare_ascending("ReplicationFollower._lock")


def standby_record_filter(
    full_ring: HashRing, self_id: str
) -> Callable[[JournalRecord], Optional[JournalRecord]]:
    """Trim records to this replica's standby slice.

    Keeps the (engine_key, request_key) pairs whose request key lists
    this replica among its top-2 rendezvous owners on the FULL ring —
    as primary (re-applying local state is idempotent) or as standby
    (the failover inheritance).  Evict records carry no request keys
    and apply unconditionally: evicting an absent engine key is a
    no-op, and filtering them by engine-key ownership could strand a
    standby admission the evict was meant to clear.
    """

    def filter_record(
        record: JournalRecord,
    ) -> Optional[JournalRecord]:
        if record.op != OP_ADD or not record.request_keys:
            return record
        aligned = len(record.engine_keys) == len(record.request_keys)
        if aligned and not record.entries:
            # Mappings-only record: the standby must inherit it when it
            # stands by for EITHER side — the engine-key owner serves
            # get_request_key after a failover, and without the mapping
            # the router would classify post-failover evictions as
            # "already gone" and leave stale entries scoring forever.
            wanted = [
                i
                for i, (ek, rk) in enumerate(
                    zip(record.engine_keys, record.request_keys)
                )
                if self_id in full_ring.owners(rk, 2)
                or self_id in full_ring.owners(ek, 2)
            ]
        else:
            wanted = [
                i
                for i, rk in enumerate(record.request_keys)
                if self_id in full_ring.owners(rk, 2)
            ]
        if not wanted:
            return None
        if len(wanted) == len(record.request_keys):
            return record
        engine_keys = (
            [record.engine_keys[i] for i in wanted]
            if aligned
            else record.engine_keys
        )
        return JournalRecord(
            op=record.op,
            pod_identifier=record.pod_identifier,
            seq=record.seq,
            ts_ns=record.ts_ns,
            engine_keys=engine_keys,
            request_keys=[record.request_keys[i] for i in wanted],
            entries=record.entries,
        )

    return filter_record


def apply_record(index: Index, record: JournalRecord) -> bool:
    """Replay one journal record as the index call it logs; returns
    False when the record shape has nothing applicable (e.g. a batched
    admission against a backend without the batched surface)."""
    try:
        if record.op == OP_PURGE:
            # Replay in journal order so a standby slice never
            # resurrects entries the primary purged.
            index.purge_pod(record.pod_identifier)
            return True
        if record.op == OP_ADD:
            if not record.request_keys:
                return False
            if record.engine_keys and not record.entries:
                # Mappings-only record (the router's eager
                # add_mappings publication).
                add_mappings = getattr(index, "add_mappings", None)
                if not callable(add_mappings):
                    return False
                add_mappings(record.engine_keys, record.request_keys)
                return True
            if not record.entries:
                return False
            if record.engine_keys and len(record.engine_keys) == len(
                record.request_keys
            ):
                index.add(
                    record.engine_keys,
                    record.request_keys,
                    record.entries,
                )
                return True
            # Batched admission (no engine keys on the record).
            add_batch = getattr(index, "add_entries_batch", None)
            if not callable(add_batch):
                return False
            add_batch([(record.request_keys, record.entries)])
            return True
        applied = False
        for engine_key in record.engine_keys:
            index.evict(engine_key, record.entries)
            applied = True
        return applied
    except (KeyError, ValueError) as exc:
        # Same tolerance as recovery: a replayed op can race LRU
        # bounds on the standby side.
        logger.debug("skipping unreplayable record: %s", exc)
        return False


class ReplicationFollower:
    """Tails one primary's journal directory into a local index."""

    def __init__(
        self,
        peer_id: str,
        journal_dir: str,
        index: Index,
        record_filter: Optional[
            Callable[[JournalRecord], Optional[JournalRecord]]
        ] = None,
        poll_interval_s: float = 0.2,
        max_records_per_poll: int = 4096,
        purge_scope: Optional[Callable[[int], bool]] = None,
    ) -> None:
        if poll_interval_s <= 0:
            raise ValueError("poll interval must be positive")
        self.peer_id = peer_id
        self.journal_dir = journal_dir
        self.index = index
        self.record_filter = record_filter
        self.poll_interval_s = poll_interval_s
        self.max_records_per_poll = max(1, max_records_per_poll)
        # Slice scope for replaying the peer's OP_PURGE records (keys
        # the PEER's journal is authoritative for — its primary slice).
        # A pod-wide purge replayed against the whole local index would
        # wipe admissions this replica applied to its OWN slice after
        # the purge (every replica executes the router's purge directly
        # and journals it; each stream's purge must only touch the
        # slice that stream owns).  None falls back to the pod-wide
        # purge — correct for single-stream uses like disaster replay.
        self.purge_scope = purge_scope
        self._lock = lockorder.tracked(
            threading.Lock(), "ReplicationFollower._lock"
        )
        self._position: Optional[TailPosition] = None  # guarded-by: _lock
        self._watermarks: Dict[str, int] = {}  # guarded-by: _lock
        self._applied = 0  # guarded-by: _lock
        self._skipped = 0  # guarded-by: _lock
        self._last_lag = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- bootstrap ------------------------------------------------------

    def bootstrap(self, transport) -> int:
        """Warm-sync from the primary's ``sync_snapshot``: restore the
        dump (filtered to the standby slice), remember the watermarks,
        and park the tail cursor at the journal boundary.  Returns
        block keys restored."""
        boundary, raw_watermarks, raw_blocks, raw_map = transport.call(
            "sync_snapshot", []
        )
        block_entries = []
        for key, raw_entries in raw_blocks:
            entries = list(decode_entries(raw_entries))
            if self.record_filter is not None:
                trimmed = self.record_filter(
                    JournalRecord(
                        op=OP_ADD,
                        pod_identifier="",
                        seq=0,
                        ts_ns=0,
                        engine_keys=[],
                        request_keys=[key],
                        entries=entries,
                    )
                )
                if trimmed is None:
                    continue
            block_entries.append((key, entries))
        restored = self.index.restore_entries(
            block_entries, [(ek, rk) for ek, rk in raw_map]
        )
        with self._lock:
            self._position = TailPosition(boundary, 0)
            self._watermarks = {
                str(pod): int(seq) for pod, seq in raw_watermarks
            }
        logger.info(
            "follower of %s bootstrapped: %d block keys, journal "
            "boundary %d",
            self.peer_id,
            restored,
            boundary,
        )
        return restored

    # -- sync loop ------------------------------------------------------

    def sync_once(self) -> int:
        """One tail poll: read new records, apply the standby slice;
        returns records read (the lag this poll drained).  Callable
        directly so tests and the smoke never sleep-poll."""
        with self._lock:
            position = self._position
            watermarks = dict(self._watermarks)
        records, new_position = tail(
            self.journal_dir,
            position,
            max_records=self.max_records_per_poll,
        )
        applied = skipped = 0
        for record in records:
            watermark = watermarks.get(record.pod_identifier)
            # Strictly-below skip, mirroring recovery: equal-seq
            # records straddle the boundary and replay idempotently.
            if (
                watermark is not None
                and record.seq > 0
                and record.seq < watermark
            ):
                skipped += 1
                continue
            if self.record_filter is not None:
                record = self.record_filter(record)
                if record is None:
                    skipped += 1
                    continue
            if record.op == OP_PURGE and self._scoped_purge(record):
                applied += 1
                continue
            if apply_record(self.index, record):
                applied += 1
            else:
                skipped += 1
        with self._lock:
            # sync_once is single-consumer (one sync thread; tests
            # call it inline, never concurrently) — the lock only
            # publishes position/stats to status readers, so the
            # read-process-write spanning two acquisitions cannot
            # interleave with another advance.
            self._position = new_position  # kvlint: atomic-ok
            self._applied += applied
            self._skipped += skipped
            self._last_lag = len(records)
        peer = safe_label(self.peer_id)
        METRICS.cluster_replica_lag.labels(peer=peer).set(len(records))
        if applied:
            METRICS.cluster_replication_applied.labels(peer=peer).inc(
                applied
            )
        return len(records)

    def _scoped_purge(self, record: JournalRecord) -> bool:
        """Replay a peer's purge against its slice only; returns False
        when unscoped (caller falls back to the pod-wide purge)."""
        if self.purge_scope is None:
            return False
        purge_keys = getattr(self.index, "purge_pod_keys", None)
        list_keys = getattr(self.index, "request_keys", None)
        if not callable(purge_keys) or not callable(list_keys):
            return False
        # Keys-only walk — a full dump_entries here would serialize
        # every entry list just to throw it away, per replayed purge.
        candidates = [
            key for key in list_keys() if self.purge_scope(key)
        ]
        if candidates:
            purge_keys(record.pod_identifier, candidates)
        return True

    def start(self) -> None:
        if self._thread is not None:
            return
        # gil-atomic: lifecycle ref; start/close are control-plane
        self._thread = threading.Thread(
            target=self._run,
            name=f"kvtpu-cluster-follow-{self.peer_id}",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            # gil-atomic: lifecycle ref; start/close are control-plane
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                drained = self.sync_once()
            except Exception:  # noqa: BLE001 — the follower must survive
                logger.exception(
                    "follower of %s failed a sync poll", self.peer_id
                )
                drained = 0
            if drained < self.max_records_per_poll:
                # Caught up (or holding at a torn tail): wait a beat.
                self._stop.wait(self.poll_interval_s)

    def status(self) -> dict:
        with self._lock:
            return {
                "peer": self.peer_id,
                "applied": self._applied,
                "skipped": self._skipped,
                "last_poll_lag": self._last_lag,
                "position": (
                    [self._position.segment_id, self._position.offset]
                    if self._position is not None
                    else None
                ),
            }
