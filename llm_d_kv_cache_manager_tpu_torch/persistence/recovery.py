"""Warm-restart recovery orchestration + the PersistenceManager facade.

Recovery sequence (``recover``):

1. Load the newest *valid* snapshot (corrupt candidates fall back to
   older ones; none at all is a cold start).
2. ``index.restore_entries`` the dump through the backend's normal
   admission path (capacity bounds hold).
3. Replay the journal oldest-segment-first, skipping numbered records
   at or below the snapshot's per-pod watermark; stop at the first
   torn/corrupt record (``journal.read_segment``'s stop-don't-skip
   contract).
4. Return a :class:`RecoveryReport`.  Pods restored from disk may have
   changed state while the indexer was down — reconciliation of those
   *stale pods is deliberately NOT done here*: the existing machinery
   (the pod reconciler dropping dead pods' subscriptions plus
   ``Index.purge_pod``, and LRU/TTL churn) already owns that, and the
   report's ``pods`` list is exactly the input it needs.

``PersistenceManager`` owns the directory layout::

    <dir>/snapshots/snapshot-<ns>.snap
    <dir>/journal/segment-<id>.kvj

and the rotate -> dump -> publish -> compact snapshot ordering whose
correctness argument lives in ``Journal.snapshot_boundary``.

Copied from the JAX reference's ``persistence/recovery.py``.  One addition:
:class:`RecoveryReport` names the snapshots passed over as invalid
(``rejected_snapshots``) and where the journal replay stopped at a torn or
corrupt record (``torn_tails``); the reference only logs them.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index
from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.persistence.journal import (
    DEFAULT_SEGMENT_MAX_BYTES,
    OP_ADD,
    OP_PURGE,
    Journal,
    iter_journal,
)
from llm_d_kv_cache_manager_tpu_torch.persistence.snapshot import (
    SnapshotInfo,
    load_latest_snapshot,
    write_snapshot,
)
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("persistence.recovery")

# snapshot() holds _snapshot_lock across the journal boundary/compact
# calls, the index dump, and the _info_lock publish — the snapshot lock
# is the root of the persistence hierarchy.  Declared for KV006 and the
# runtime watchdog alike.
# kvlint: lock-order: PersistenceManager._snapshot_lock < Journal._lock
lockorder.declare_order(
    "PersistenceManager._snapshot_lock", "Journal._lock"
)
# kvlint: lock-order: PersistenceManager._snapshot_lock < PersistenceManager._info_lock
lockorder.declare_order(
    "PersistenceManager._snapshot_lock", "PersistenceManager._info_lock"
)
# kvlint: lock-order: PersistenceManager._snapshot_lock < LRUCache._lock
lockorder.declare_order(
    "PersistenceManager._snapshot_lock", "LRUCache._lock"
)
# kvlint: lock-order: PersistenceManager._snapshot_lock < CostAwareMemoryIndex._lock
lockorder.declare_order(
    "PersistenceManager._snapshot_lock", "CostAwareMemoryIndex._lock"
)


@dataclass
class PersistenceConfig:
    """Layout + durability knobs for the persistence subsystem."""

    directory: str
    journal_segment_max_bytes: int = DEFAULT_SEGMENT_MAX_BYTES
    # Journal fsync per record: off by default — a lost tail only
    # widens the replay gap the TTL/reconciler machinery tolerates.
    journal_fsync: bool = False
    snapshots_retained: int = 2

    @property
    def snapshot_dir(self) -> str:
        return os.path.join(self.directory, "snapshots")

    @property
    def journal_dir(self) -> str:
        return os.path.join(self.directory, "journal")


@dataclass
class RecoveryReport:
    """What a warm (or cold) start actually restored."""

    status: str  # "warm" | "cold"
    snapshot_path: Optional[str] = None
    snapshot_created_ns: Optional[int] = None
    block_keys_restored: int = 0
    engine_mappings_restored: int = 0
    records_replayed: int = 0
    records_skipped: int = 0
    pods: List[str] = field(default_factory=list)
    duration_s: float = 0.0
    # Snapshot files passed over as invalid, newest first, and where a
    # journal segment's replay stopped short (a torn or corrupt record),
    # each as "<path>[@<offset>]: <reason>".
    rejected_snapshots: List[str] = field(default_factory=list)
    torn_tails: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "status": self.status,
            "snapshot_path": self.snapshot_path,
            "snapshot_age_s": (
                round(
                    max(time.time_ns() - self.snapshot_created_ns, 0)
                    / 1e9,
                    1,
                )
                if self.snapshot_created_ns
                else None
            ),
            "block_keys_restored": self.block_keys_restored,
            "engine_mappings_restored": self.engine_mappings_restored,
            "records_replayed": self.records_replayed,
            "records_skipped": self.records_skipped,
            "pods": self.pods,
            "duration_s": round(self.duration_s, 3),
            "rejected_snapshots": self.rejected_snapshots,
            "torn_tails": self.torn_tails,
        }


def recover(index: Index, config: PersistenceConfig) -> RecoveryReport:
    """Warm-restart ``index`` from disk; see module docstring."""
    start = time.perf_counter()
    report = RecoveryReport(status="cold")
    pods: Dict[str, None] = {}  # ordered de-dup

    if getattr(index, "durable_backend", False):
        # The backend's state outlives the process (Redis/Valkey) and
        # is shared by sibling replicas: restoring a file snapshot or
        # replaying the journal would resurrect entries evicted or
        # purged server-side since the dump — the server IS the warm
        # state.  (The old dump_entries no-op used to make this
        # implicit; the gate became explicit when the backend was
        # promoted to the full dump/restore contract.)
        report.duration_s = time.perf_counter() - start
        METRICS.persistence_recoveries.labels(outcome="durable").inc()
        logger.info(
            "recovery skipped: %s is a durable backend (server state "
            "is authoritative; docs/persistence.md §6)",
            type(index).__name__,
        )
        return report

    watermarks: Dict[str, int] = {}
    min_segment_id = 0
    loaded = load_latest_snapshot(
        config.snapshot_dir, report.rejected_snapshots
    )
    if loaded is not None:
        info, block_entries, engine_map = loaded
        if info.journal_boundary is not None:
            # Segments below the boundary are fully covered by the
            # dump: skipping them wholesale is both cheaper and
            # CORRECT where per-record idempotence is not — an
            # uncompacted pre-boundary OP_PURGE would otherwise replay
            # against restored state whose covering re-adds the
            # watermark skip elides.
            min_segment_id = info.journal_boundary
        report.block_keys_restored = index.restore_entries(
            block_entries, engine_map
        )
        report.engine_mappings_restored = len(engine_map)
        report.snapshot_path = info.path
        report.snapshot_created_ns = info.created_ns
        report.status = "warm"
        watermarks = info.watermarks
        for _, entries in block_entries:
            for entry in entries:
                pods.setdefault(entry.pod_identifier, None)

    for record in iter_journal(
        config.journal_dir,
        min_segment_id=min_segment_id,
        stops=report.torn_tails,
    ):
        watermark = watermarks.get(record.pod_identifier)
        # Strictly below only: one message's events share one seq, and
        # a record with seq == watermark can have been appended AFTER
        # the boundary capture while a sibling record of the same
        # message landed before it (the dump then lacks this record's
        # effect).  Equal-seq replay is idempotent; skipping it would
        # silently drop that applied op.
        if (
            watermark is not None
            and record.seq > 0
            and record.seq < watermark
        ):
            report.records_skipped += 1
            continue
        try:
            if record.op == OP_ADD:
                if record.engine_keys and record.entries:
                    index.add(
                        record.engine_keys,
                        record.request_keys,
                        record.entries,
                    )
            elif record.op == OP_PURGE:
                # An operator/resync purge between the snapshot and the
                # crash: replaying the adds without it would resurrect
                # exactly the entries the purge dropped.
                index.purge_pod(record.pod_identifier)
            else:
                for engine_key in record.engine_keys:
                    index.evict(engine_key, record.entries)
        except (KeyError, ValueError) as exc:
            # A replayed op can race LRU bounds (its parent already
            # re-evicted); per-record skip, same as the live pool.
            logger.debug("skipping unreplayable record: %s", exc)
            continue
        pods.setdefault(record.pod_identifier, None)
        report.records_replayed += 1

    for stop in report.torn_tails:
        logger.warning("journal replay stopped short at %s", stop)
    if report.records_replayed:
        report.status = "warm"  # journal-only starts still count
    report.pods = list(pods)
    report.duration_s = time.perf_counter() - start
    METRICS.persistence_recoveries.labels(outcome=report.status).inc()
    METRICS.persistence_replayed_records.inc(report.records_replayed)
    logger.info(
        "recovery %s: %d block keys + %d journal records (%d skipped) "
        "across %d pods in %.3fs",
        report.status,
        report.block_keys_restored,
        report.records_replayed,
        report.records_skipped,
        len(report.pods),
        report.duration_s,
    )
    return report


class PersistenceManager:
    """Composes journal + snapshots over one directory tree."""

    def __init__(self, config: PersistenceConfig) -> None:
        self.config = config
        self.journal = Journal(
            config.journal_dir,
            segment_max_bytes=config.journal_segment_max_bytes,
            fsync=config.journal_fsync,
        )
        self._snapshot_lock = lockorder.tracked(
            threading.Lock(), "PersistenceManager._snapshot_lock"
        )
        # Separate from _snapshot_lock (held across the whole
        # dump+fsync): /healthz reads must never block on a slow
        # snapshot publish.
        self._info_lock = lockorder.tracked(
            threading.Lock(), "PersistenceManager._info_lock"
        )
        self.last_snapshot: Optional[SnapshotInfo] = None  # guarded-by: _info_lock

    def recover(self, index: Index) -> RecoveryReport:
        """Run recovery into ``index``.

        Call BEFORE wiring the journal into a live event pool: replay
        must not interleave with fresh appends into the same files.
        (The Journal itself already writes to a fresh segment, so this
        is about report coherence, not corruption.)
        """
        return recover(index, self.config)

    def snapshot(self, index: Index) -> SnapshotInfo:
        """Publish a snapshot of ``index`` and compact covered segments.

        Ordering: rotate the journal first (boundary + watermarks under
        one lock), THEN dump — every record below the boundary is
        already applied and therefore inside the dump; records above it
        survive compaction and replay idempotently.
        """
        with self._snapshot_lock:
            boundary, watermarks, covered = (
                self.journal.snapshot_boundary()
            )
            block_entries, engine_map = index.dump_entries()
            info = write_snapshot(
                self.config.snapshot_dir,
                watermarks,
                block_entries,
                engine_map,
                retain=self.config.snapshots_retained,
                journal_boundary=boundary,
            )
            self.journal.compact_before(boundary)
            self.journal.mark_snapshot_published(covered)
            with self._info_lock:
                self.last_snapshot = info
        METRICS.persistence_snapshot_timestamp.set(info.created_ns / 1e9)
        METRICS.persistence_snapshot_bytes.set(info.size_bytes)
        logger.info(
            "published snapshot %s (%d block keys, %d bytes)",
            info.path,
            info.block_keys,
            info.size_bytes,
        )
        return info

    def status(self) -> dict:
        """Health-endpoint view: snapshot age + journal lag."""
        with self._info_lock:
            info = self.last_snapshot
        return {
            "snapshot_path": info.path if info else None,
            "snapshot_age_s": (
                round(
                    max(time.time_ns() - info.created_ns, 0) / 1e9, 1
                )
                if info
                else None
            ),
            "snapshot_bytes": info.size_bytes if info else None,
            "journal_records_since_snapshot": (
                self.journal.records_since_snapshot()
            ),
        }

    def start_auto_snapshot(
        self, index: Index, interval_seconds: float = 300.0
    ) -> threading.Event:
        """Periodic snapshots on a daemon thread; returns a stop event
        (same shape as ``metrics.start_metrics_logging``)."""
        stop = threading.Event()

        def beat() -> None:
            while not stop.wait(interval_seconds):
                try:
                    self.snapshot(index)
                except Exception:  # noqa: BLE001 — beat must survive
                    logger.exception("periodic snapshot failed")

        thread = threading.Thread(
            target=beat, name="kvtpu-snapshot-beat", daemon=True
        )
        thread.start()
        return stop

    def close(self) -> None:
        self.journal.close()
