"""Append-only KV-event journal: segments, watermarks, torn-tail reads.

The journal records *applied index operations* (not raw wire events):
the event pool taps it immediately after ``index.add`` / ``index.evict``
succeeds, so replay needs no token re-hashing and no parent-block
resolution — a record replays as the exact index call it logs, which
makes replay idempotent and order-insensitive across pods (per-pod
order is preserved structurally: one pod always lands on one pool
shard, and appends happen in apply order).

Segment files ``segment-<id>.kvj`` (see docs/persistence.md):

    MAGIC(8) | version u16 BE
    repeated records: len u32 BE | crc32(body) u32 BE | body

``body`` is canonical CBOR:

    [op, pod, seq, ts_ns, engine_keys, request_keys,
     [[pod, tier], ...]]

with ``op`` 0=add, 1=evict (evict carries an empty request_keys list),
2=purge (an administrative ``purge_pod``; keys and entries empty, the
purged pod in the ``pod`` field — replay must not resurrect what an
operator dropped).
A reader stops at the first record that is short, oversized, or fails
CRC — the torn-tail contract: a crash mid-append loses at most the
record being written, never the ability to replay what preceded it.

Rotation: a segment is sealed once it exceeds ``segment_max_bytes``;
the writer then opens ``segment-<id+1>``.  A fresh ``Journal`` always
starts a NEW segment past the highest existing id — it never appends
to a file a previous process may have torn.  Compaction removes sealed
segments wholly covered by a published snapshot (see
``PersistenceManager.snapshot``'s rotate-then-dump ordering).

Watermarks: the journal tracks the highest publisher sequence number
appended per pod — the same per-pod seq stream the subscriber's
gap counters watch (``zmq_subscriber.py``).  Snapshots embed the
watermarks at their journal boundary; replay skips numbered records
strictly below them (equal-seq records replay — one message's events
share a seq and can straddle the boundary; unnumbered records, seq 0,
always replay.  Replay is idempotent either way).

Copied from the JAX reference's ``persistence/journal.py``; the two write and
follow the same segments byte for byte.  One addition: ``read_segment`` and
``iter_journal`` take a ``stops`` list that collects where a segment's
replay stopped short, which ``recover`` reports as torn tails.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.cbor_canonical import (
    CborDecodeError,
    decode_canonical,
    encode_canonical,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import PodEntry
from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("persistence.journal")

MAGIC = b"KVTPUJNL"
FORMAT_VERSION = 1
_FILE_HEADER = struct.Struct(">8sH")
_RECORD_HEADER = struct.Struct(">II")  # body length, crc32(body)
SEGMENT_SUFFIX = ".kvj"

OP_ADD = 0
OP_EVICT = 1
# Administrative pod purge (Index.purge_pod): engine/request keys and
# entries are empty; ``pod_identifier`` names the purged pod.  Without
# this record a replay (recovery, replication followers) would
# resurrect entries an operator explicitly dropped.
OP_PURGE = 2

# A single record is a few KB at most (one BlockStored batch); anything
# bigger is framing corruption, treated like a torn tail.
MAX_RECORD_BYTES = 16 * 1024 * 1024

DEFAULT_SEGMENT_MAX_BYTES = 4 * 1024 * 1024


@dataclass
class JournalRecord:
    """One applied index operation."""

    op: int
    pod_identifier: str
    seq: int
    ts_ns: int
    engine_keys: List[int]
    request_keys: List[int]
    entries: List[PodEntry] = field(default_factory=list)

    def encode(self) -> bytes:
        return encode_canonical(
            [
                self.op,
                self.pod_identifier,
                self.seq,
                self.ts_ns,
                [int(k) for k in self.engine_keys],
                [int(k) for k in self.request_keys],
                [
                    [e.pod_identifier, e.device_tier]
                    for e in self.entries
                ],
            ]
        )

    @staticmethod
    def decode(body: bytes) -> "JournalRecord":
        doc = decode_canonical(body)
        if not isinstance(doc, list) or len(doc) != 7:
            raise CborDecodeError("unexpected journal record shape")
        op, pod, seq, ts_ns, engine_keys, request_keys, entries = doc
        return JournalRecord(
            op=int(op),
            pod_identifier=str(pod),
            seq=int(seq),
            ts_ns=int(ts_ns),
            engine_keys=[int(k) for k in engine_keys],
            request_keys=[int(k) for k in request_keys],
            entries=[PodEntry(str(p), str(t)) for p, t in entries],
        )


def _segment_path(directory: str, segment_id: int) -> str:
    return os.path.join(
        directory, f"segment-{segment_id:012d}{SEGMENT_SUFFIX}"
    )


def list_segments(directory: str) -> List[Tuple[int, str]]:
    """(id, path) of every segment on disk, oldest first."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    out: List[Tuple[int, str]] = []
    for name in names:
        if not name.startswith("segment-") or not name.endswith(
            SEGMENT_SUFFIX
        ):
            continue
        try:
            segment_id = int(name[len("segment-") : -len(SEGMENT_SUFFIX)])
        except ValueError:
            continue
        out.append((segment_id, os.path.join(directory, name)))
    out.sort()
    return out


def read_segment(
    path: str, stops: Optional[List[str]] = None
) -> Iterator[JournalRecord]:
    """Yield valid records; stop at the first torn/corrupt one.

    The stop-don't-skip policy is deliberate: resuming past a corrupt
    record could replay a later ``add`` whose preceding ``evict`` was
    lost, resurrecting entries the engine no longer holds.  Everything
    past the first bad byte is left to TTL/reconciler healing.  A stop
    before a clean end of file is appended to ``stops`` (when given) as
    ``"<path>@<offset>: <reason>"``, the offset being that of the first
    record not replayed.
    """

    def stop(offset: int, reason: str) -> None:
        if stops is not None:
            stops.append(f"{path}@{offset}: {reason}")

    with open(path, "rb") as handle:
        header = handle.read(_FILE_HEADER.size)
        if len(header) < _FILE_HEADER.size:
            if header:
                stop(0, "torn segment header")
            return
        magic, version = _FILE_HEADER.unpack(header)
        if magic != MAGIC or version != FORMAT_VERSION:
            logger.warning("foreign journal segment %s; skipping", path)
            stop(0, "foreign segment")
            return
        while True:
            offset = handle.tell()
            rec_header = handle.read(_RECORD_HEADER.size)
            if len(rec_header) < _RECORD_HEADER.size:
                if rec_header:
                    stop(offset, "torn record header")
                return  # clean EOF or torn header
            length, crc = _RECORD_HEADER.unpack(rec_header)
            if length > MAX_RECORD_BYTES:
                logger.warning(
                    "implausible record length %d in %s; stopping",
                    length,
                    path,
                )
                stop(offset, f"implausible record length {length}")
                return
            body = handle.read(length)
            if len(body) < length:
                stop(offset, f"torn record ({len(body)} of {length} bytes)")
                return  # torn body at the tail
            if zlib.crc32(body) & 0xFFFFFFFF != crc:
                logger.warning("CRC mismatch in %s; stopping", path)
                stop(offset, "CRC mismatch")
                return
            try:
                yield JournalRecord.decode(body)
            except (CborDecodeError, TypeError, ValueError) as exc:
                logger.warning(
                    "undecodable record in %s (%s); stopping", path, exc
                )
                stop(offset, f"undecodable record: {exc}")
                return


class Journal:
    """Thread-safe append-only journal writer over rotating segments."""

    def __init__(
        self,
        directory: str,
        segment_max_bytes: int = DEFAULT_SEGMENT_MAX_BYTES,
        fsync: bool = False,
    ) -> None:
        if segment_max_bytes <= 0:
            raise ValueError("segment_max_bytes must be positive")
        self.directory = directory
        self.segment_max_bytes = segment_max_bytes
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)
        existing = list_segments(directory)
        # Never append to a segment a dead process may have torn.
        self._segment_id = (existing[-1][0] + 1) if existing else 0  # guarded-by: _lock
        self._handle = None  # guarded-by: _lock
        self._segment_bytes = 0  # guarded-by: _lock
        self._watermarks: Dict[str, int] = {}  # guarded-by: _lock
        self._records_since_snapshot = 0  # guarded-by: _lock
        # Leaf lock: appends/rotations never acquire anything else
        # while holding it (index apply happens before the journal tap).
        self._lock = lockorder.tracked(threading.Lock(), "Journal._lock")

    # -- append path ---------------------------------------------------

    def record_add(
        self,
        pod_identifier: str,
        seq: int,
        engine_keys: Sequence[int],
        request_keys: Sequence[int],
        entries: Sequence[PodEntry],
    ) -> None:
        self._append(
            JournalRecord(
                op=OP_ADD,
                pod_identifier=pod_identifier,
                seq=int(seq),
                ts_ns=time.time_ns(),
                engine_keys=list(engine_keys),
                request_keys=list(request_keys),
                entries=list(entries),
            )
        )

    def record_evict(
        self,
        pod_identifier: str,
        seq: int,
        engine_keys: Sequence[int],
        entries: Sequence[PodEntry],
    ) -> None:
        self._append(
            JournalRecord(
                op=OP_EVICT,
                pod_identifier=pod_identifier,
                seq=int(seq),
                ts_ns=time.time_ns(),
                engine_keys=list(engine_keys),
                request_keys=[],
                entries=list(entries),
            )
        )

    def record_purge(self, pod_identifier: str, seq: int = 0) -> None:
        self._append(
            JournalRecord(
                op=OP_PURGE,
                pod_identifier=pod_identifier,
                seq=int(seq),
                ts_ns=time.time_ns(),
                engine_keys=[],
                request_keys=[],
                entries=[],
            )
        )

    def _append(self, record: JournalRecord) -> None:
        body = record.encode()
        framed = (
            _RECORD_HEADER.pack(len(body), zlib.crc32(body) & 0xFFFFFFFF)
            + body
        )
        with self._lock:
            handle = self._ensure_segment_locked()
            handle.write(framed)
            handle.flush()
            if self.fsync:
                os.fsync(handle.fileno())
            self._segment_bytes += len(framed)
            if record.seq > self._watermarks.get(
                record.pod_identifier, -1
            ):
                self._watermarks[record.pod_identifier] = record.seq
            self._records_since_snapshot += 1
            lag = self._records_since_snapshot
            if self._segment_bytes >= self.segment_max_bytes:
                self._rotate_locked()
        METRICS.persistence_journal_records.labels(
            op={OP_ADD: "add", OP_EVICT: "evict"}.get(
                record.op, "purge"
            )
        ).inc()
        METRICS.persistence_journal_lag.set(lag)

    def _ensure_segment_locked(self):
        if self._handle is None:
            path = _segment_path(self.directory, self._segment_id)
            self._handle = open(path, "ab")
            if self._handle.tell() == 0:
                self._handle.write(
                    _FILE_HEADER.pack(MAGIC, FORMAT_VERSION)
                )
                self._handle.flush()
            self._segment_bytes = self._handle.tell()
        return self._handle

    def _rotate_locked(self) -> int:
        """Seal the current segment; returns the NEW active segment id."""
        if self._handle is not None:
            self._handle.close()
            self._handle = None
        self._segment_id += 1
        self._segment_bytes = 0
        return self._segment_id

    # -- snapshot coordination ----------------------------------------

    def snapshot_boundary(self) -> Tuple[int, Dict[str, int], int]:
        """Atomically rotate; returns ``(boundary_id, watermarks,
        records_at_boundary)``.

        Every record in segments ``< boundary_id`` was appended — and
        therefore applied to the index — before this call returned, so
        a dump taken *after* it covers them all.  The watermark copy is
        taken under the same lock, so no record with a seq above it can
        live below the boundary.  The lag counter is NOT reset here:
        callers deduct ``records_at_boundary`` via
        :meth:`mark_snapshot_published` only once the snapshot write
        actually succeeds — a failed publish (ENOSPC is the likeliest
        persistence failure) must keep reporting the true replay cost.
        """
        with self._lock:
            boundary = self._rotate_locked()
            watermarks = dict(self._watermarks)
            lag_at_boundary = self._records_since_snapshot
        return boundary, watermarks, lag_at_boundary

    def mark_snapshot_published(self, covered: int) -> None:
        """Deduct ``covered`` records (the lag at the boundary of a
        snapshot that PUBLISHED) from the lag counter; appends that
        raced past the boundary stay counted (conservative)."""
        with self._lock:
            self._records_since_snapshot = max(
                0, self._records_since_snapshot - covered
            )
            lag = self._records_since_snapshot
        METRICS.persistence_journal_lag.set(lag)

    def compact_keep_last(self, retain_segments: int) -> int:
        """Delete all but the newest ``retain_segments`` segment files;
        returns segments removed.  Size-based retention for journals
        with no snapshot boundary to compact against (cluster replicas'
        replication feeds — docs/replication.md): a follower lagging
        past the retention window loses the deleted records (the tail
        cursor skips the hole) and should re-bootstrap.  The active
        segment is always within the retained suffix."""
        if retain_segments <= 0:
            return 0
        removed = 0
        for _, path in list_segments(self.directory)[:-retain_segments]:
            try:
                os.unlink(path)
                removed += 1
            except OSError:  # pragma: no cover - concurrent compactor
                pass
        if removed:
            logger.info(
                "retention-compacted %d journal segment(s) in %s",
                removed,
                self.directory,
            )
        return removed

    def compact_before(self, boundary_id: int) -> int:
        """Delete sealed segments with id < boundary_id; returns count."""
        removed = 0
        for segment_id, path in list_segments(self.directory):
            if segment_id >= boundary_id:
                continue
            try:
                os.unlink(path)
                removed += 1
            except OSError:  # pragma: no cover - concurrent compactor
                pass
        if removed:
            logger.info(
                "compacted %d journal segment(s) below %d",
                removed,
                boundary_id,
            )
        return removed

    # -- introspection -------------------------------------------------

    def watermarks(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._watermarks)

    def records_since_snapshot(self) -> int:
        with self._lock:
            return self._records_since_snapshot

    def close(self) -> None:
        with self._lock:
            if self._handle is not None:
                self._handle.close()
                self._handle = None


def iter_journal(
    directory: str,
    min_segment_id: int = 0,
    stops: Optional[List[str]] = None,
) -> Iterator[JournalRecord]:
    """Replay every surviving record, oldest segment first.  Segments
    below ``min_segment_id`` (a snapshot's journal boundary — fully
    covered by the dump) are skipped wholesale.  ``stops`` collects
    where a segment's replay stopped short (see ``read_segment``)."""
    for segment_id, path in list_segments(directory):
        if segment_id < min_segment_id:
            continue
        yield from read_segment(path, stops)


# -- follow API (replication followers; docs/replication.md) ------------


@dataclass(frozen=True)
class TailPosition:
    """A resumable cursor into a journal directory.

    ``offset == 0`` means the segment's file header has not been
    validated yet; otherwise it is the byte offset just past the last
    fully-consumed record.  Positions are plain data — safe to persist
    or ship between processes.  ``TailPosition(boundary_id, 0)`` starts
    a follow at a snapshot boundary (every record in segments
    ``< boundary_id`` is covered by the snapshot; see
    ``Journal.snapshot_boundary``).
    """

    segment_id: int
    offset: int = 0


def tail(
    directory: str,
    position: Optional[TailPosition] = None,
    max_records: int = 0,
) -> Tuple[List[JournalRecord], TailPosition]:
    """Read records appended since ``position``; returns
    ``(records, new_position)``.

    The follow contract (regression-pinned in
    the follow-API tests):

    * **Torn tails hold, they don't lose.**  A partial record at the
      end of the ACTIVE (highest-id) segment — the writer's append may
      be partially visible — leaves the cursor at the last complete
      record; the next call re-reads from there and returns the record
      once it is whole.  In a SEALED segment (a higher-id segment
      exists) a torn or corrupt record can never complete: the rest of
      that segment is abandoned (same stop-don't-skip policy as
      ``read_segment``, logged) and the cursor moves to the next
      segment.
    * **Rotation is seamless.**  Clean EOF on a sealed segment advances
      to the next segment id present on disk; gaps in the id sequence
      (compaction, or a sealed segment deleted mid-follow) are skipped
      to the smallest surviving id.
    * **Decode-bad records skip.**  A CRC-valid record that fails CBOR
      decoding is fully written and will never change; holding would
      wedge the follower forever, so it is skipped with a warning.

    ``position=None`` starts at the oldest segment on disk.
    ``max_records`` bounds one call (0 = unbounded); a bounded call may
    return mid-segment and resumes exactly where it stopped.
    """
    segments = list_segments(directory)
    if position is None:
        start_id = segments[0][0] if segments else 0
        position = TailPosition(start_id, 0)
    if not segments:
        return [], position

    records: List[JournalRecord] = []
    segment_id = position.segment_id
    offset = position.offset
    latest_id = segments[-1][0]
    by_id = dict(segments)
    while True:
        if max_records and len(records) >= max_records:
            break
        path = by_id.get(segment_id)
        if path is None:
            successors = [sid for sid in by_id if sid > segment_id]
            if not successors:
                break  # nothing (yet) at or past the cursor
            segment_id = min(successors)
            offset = 0
            continue
        sealed = segment_id < latest_id
        consumed, segment_records, exhausted = _read_from(
            path,
            offset,
            max_records - len(records) if max_records else 0,
        )
        records.extend(segment_records)
        offset = consumed
        if not exhausted:
            break  # record budget reached mid-segment
        if not sealed:
            break  # active segment: hold at the last complete record
        # Sealed: whatever stopped us (clean EOF, torn tail, corrupt
        # record) can never change — move on.
        segment_id += 1
        offset = 0
    return records, TailPosition(segment_id, offset)


def _read_from(
    path: str, offset: int, max_records: int
) -> Tuple[int, List[JournalRecord], bool]:
    """Read complete records from ``offset``; returns
    ``(new_offset, records, exhausted)`` where ``exhausted`` means the
    stop was the segment itself (EOF/torn/corrupt), not the record
    budget.  ``new_offset`` never advances past a record that failed to
    read completely."""
    records: List[JournalRecord] = []
    try:
        handle = open(path, "rb")
    except FileNotFoundError:  # compacted between listing and open
        return offset, records, True
    with handle:
        if offset == 0:
            header = handle.read(_FILE_HEADER.size)
            if len(header) < _FILE_HEADER.size:
                return 0, records, True  # header not fully visible yet
            magic, version = _FILE_HEADER.unpack(header)
            if magic != MAGIC or version != FORMAT_VERSION:
                logger.warning(
                    "foreign journal segment %s in follow; skipping", path
                )
                # Report exhausted with the cursor parked at EOF-ish;
                # a sealed foreign file is skipped by the caller, an
                # active one holds (and is re-checked, staying cheap).
                return 0, records, True
            offset = _FILE_HEADER.size
        else:
            handle.seek(offset)
        while True:
            if max_records and len(records) >= max_records:
                return offset, records, False
            rec_header = handle.read(_RECORD_HEADER.size)
            if len(rec_header) < _RECORD_HEADER.size:
                return offset, records, True  # clean EOF or torn header
            length, crc = _RECORD_HEADER.unpack(rec_header)
            if length > MAX_RECORD_BYTES:
                logger.warning(
                    "implausible record length %d in %s at %d; stopping",
                    length,
                    path,
                    offset,
                )
                return offset, records, True
            body = handle.read(length)
            if len(body) < length:
                return offset, records, True  # torn body
            if zlib.crc32(body) & 0xFFFFFFFF != crc:
                logger.warning(
                    "CRC mismatch in %s at %d; stopping", path, offset
                )
                return offset, records, True
            consumed = offset + _RECORD_HEADER.size + length
            try:
                records.append(JournalRecord.decode(body))
            except (CborDecodeError, TypeError, ValueError) as exc:
                # Fully written (CRC passed) — will never change;
                # holding would wedge the follower forever.
                logger.warning(
                    "undecodable record in %s at %d (%s); skipping",
                    path,
                    offset,
                    exc,
                )
            offset = consumed
