"""Atomic index snapshots: versioned header, canonical CBOR, tmp+rename.

On-disk layout (see docs/persistence.md):

    MAGIC(8) | version u16 BE | crc32(body) u32 BE | len(body) u64 BE | body

``body`` is one canonical-CBOR document (the same deterministic encoder
the block-hash contract uses, ``kvblock/cbor_canonical.py``):

    [created_ns, [[pod, seq], ...], [[request_key, [[pod, tier], ...]],
     ...], [[engine_key, request_key], ...]]

Crash safety follows the ``native/`` file-I/O discipline: the writer
builds the whole file at a ``.tmp.<pid>.<tid>`` path, fsyncs, then
``os.replace``s it into place — a reader can never observe a partial
snapshot under its final name, and the loader's CRC + length checks
reject any torn file a crashed writer might leave if it died *during*
the rename-capable window on a non-atomic filesystem.  Tmp litter from
killed writers never matches the snapshot glob and is swept on the next
successful publish.

Snapshots are named ``snapshot-<created_ns>.snap``; the loader walks
newest-first and returns the first file that validates, so one corrupt
latest snapshot degrades to the previous one, never to a crash.

Copied from the JAX reference's ``persistence/snapshot.py``; the two write
and read the same files byte for byte.  One addition: ``load_latest_snapshot``
takes a ``rejected`` list that collects the files it passed over, which
``recover`` reports.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.cbor_canonical import (
    CborDecodeError,
    decode_canonical,
    encode_canonical,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import PodEntry
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("persistence.snapshot")

MAGIC = b"KVTPUSNP"
FORMAT_VERSION = 1
_HEADER = struct.Struct(">8sHIQ")  # magic, version, crc32, body length
SNAPSHOT_SUFFIX = ".snap"

# Defensive bound for the loader: a corrupt length field must not drive
# a multi-GB allocation.  Generous for real indexes (a 2 GiB-budget
# cost-aware dump is well under this).
MAX_SNAPSHOT_BYTES = 8 * 1024 * 1024 * 1024


class SnapshotError(ValueError):
    """A snapshot file failed validation (torn, corrupt, or foreign)."""


@dataclass
class SnapshotInfo:
    """Metadata of one published or loaded snapshot."""

    path: str
    created_ns: int
    size_bytes: int
    block_keys: int
    engine_mappings: int
    watermarks: Dict[str, int]
    # Journal boundary at the dump (Journal.snapshot_boundary): every
    # record in segments < this id is covered by the snapshot.  None
    # for snapshots written before the field existed (or without a
    # journal); recovery then falls back to replay-everything.
    journal_boundary: Optional[int] = None


def _encode_body(
    created_ns: int,
    watermarks: Dict[str, int],
    block_entries: Sequence[Tuple[int, Sequence[PodEntry]]],
    engine_map: Sequence[Tuple[int, int]],
    journal_boundary: Optional[int],
) -> bytes:
    doc = [
        created_ns,
        [[pod, int(seq)] for pod, seq in sorted(watermarks.items())],
        [
            [
                int(request_key),
                [[e.pod_identifier, e.device_tier] for e in pods],
            ]
            for request_key, pods in block_entries
        ],
        [[int(ek), int(rk)] for ek, rk in engine_map],
    ]
    if journal_boundary is not None:
        # Optional 5th element (decoder accepts 4 or 5): segments below
        # this journal id are fully covered by the snapshot, so
        # recovery skips them wholesale — without it, an uncompacted
        # pre-boundary OP_PURGE could replay against restored state
        # whose covering re-adds the watermark skip elides.
        doc.append(int(journal_boundary))
    return encode_canonical(doc)


def write_snapshot(
    directory: str,
    watermarks: Dict[str, int],
    block_entries: Sequence[Tuple[int, Sequence[PodEntry]]],
    engine_map: Sequence[Tuple[int, int]],
    retain: int = 2,
    journal_boundary: Optional[int] = None,
) -> SnapshotInfo:
    """Publish a snapshot atomically; prunes to the ``retain`` newest.

    The returned info's ``path`` is the final published name.  fsync on
    both the file and its directory entry: after this returns, the
    snapshot survives power loss (the journal's weaker flush-only
    default is acceptable because a lost journal tail only widens the
    replay gap the TTL/reconciler machinery already tolerates; a torn
    *snapshot* would lose the whole baseline).
    """
    os.makedirs(directory, exist_ok=True)
    created_ns = time.time_ns()
    body = _encode_body(
        created_ns, watermarks, block_entries, engine_map,
        journal_boundary,
    )
    header = _HEADER.pack(
        MAGIC, FORMAT_VERSION, zlib.crc32(body) & 0xFFFFFFFF, len(body)
    )
    final = os.path.join(
        directory, f"snapshot-{created_ns:020d}{SNAPSHOT_SUFFIX}"
    )
    tmp = f"{final}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as handle:
            handle.write(header)
            handle.write(body)
            handle.flush()
            os.fsync(handle.fileno())
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    _fsync_dir(directory)
    _prune(directory, retain=max(retain, 1), keep=final)
    return SnapshotInfo(
        path=final,
        created_ns=created_ns,
        size_bytes=len(header) + len(body),
        block_keys=len(block_entries),
        engine_mappings=len(engine_map),
        watermarks=dict(watermarks),
        journal_boundary=journal_boundary,
    )


def _fsync_dir(directory: str) -> None:
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def _candidates(directory: str) -> List[str]:
    """Published snapshot paths, newest first (name embeds created_ns).

    ``.tmp.*`` litter from killed writers never matches the suffix
    filter — the "partial tmp file never loaded" guarantee is
    structural, not a validation pass."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    return [
        os.path.join(directory, name)
        for name in sorted(names, reverse=True)
        if name.startswith("snapshot-") and name.endswith(SNAPSHOT_SUFFIX)
    ]


def _prune(directory: str, retain: int, keep: str) -> None:
    for stale in _candidates(directory)[retain:]:
        if stale == keep:  # never the one just published
            continue
        try:
            os.unlink(stale)
        except OSError:  # pragma: no cover - concurrent pruner
            pass
    # Sweep tmp litter from crashed writers (never loadable, but it
    # leaks disk one orphan per kill).
    try:
        names = os.listdir(directory)
    except FileNotFoundError:  # pragma: no cover
        return
    for name in names:
        if ".tmp." in name:
            try:
                os.unlink(os.path.join(directory, name))
            except OSError:  # pragma: no cover
                pass


def read_snapshot(
    path: str,
) -> Tuple[
    SnapshotInfo,
    List[Tuple[int, List[PodEntry]]],
    List[Tuple[int, int]],
]:
    """Validate and decode one snapshot file.

    Raises :class:`SnapshotError` on any structural problem — short
    header, wrong magic, unknown version, length/CRC mismatch (a torn
    or bit-rotted file), or a body that decodes to the wrong shape.
    """
    with open(path, "rb") as handle:
        header = handle.read(_HEADER.size)
        if len(header) < _HEADER.size:
            raise SnapshotError(f"{path}: truncated header")
        magic, version, crc, length = _HEADER.unpack(header)
        if magic != MAGIC:
            raise SnapshotError(f"{path}: bad magic {magic!r}")
        if version != FORMAT_VERSION:
            raise SnapshotError(f"{path}: unsupported version {version}")
        if length > MAX_SNAPSHOT_BYTES:
            raise SnapshotError(f"{path}: implausible length {length}")
        body = handle.read(length)
    if len(body) != length:
        raise SnapshotError(
            f"{path}: torn body ({len(body)} of {length} bytes)"
        )
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise SnapshotError(f"{path}: CRC mismatch")
    try:
        doc = decode_canonical(body)
    except CborDecodeError as exc:
        raise SnapshotError(f"{path}: undecodable body: {exc}") from exc
    if not isinstance(doc, list) or len(doc) not in (4, 5):
        raise SnapshotError(f"{path}: unexpected document shape")
    created_ns, raw_watermarks, raw_entries, raw_engine_map = doc[:4]
    raw_boundary = doc[4] if len(doc) == 5 else None
    try:
        watermarks = {
            str(pod): int(seq) for pod, seq in raw_watermarks
        }
        block_entries = [
            (
                int(request_key),
                [PodEntry(str(pod), str(tier)) for pod, tier in pods],
            )
            for request_key, pods in raw_entries
        ]
        engine_map = [(int(ek), int(rk)) for ek, rk in raw_engine_map]
        journal_boundary = (
            int(raw_boundary) if raw_boundary is not None else None
        )
    except (TypeError, ValueError) as exc:
        raise SnapshotError(f"{path}: type-confused body: {exc}") from exc
    info = SnapshotInfo(
        path=path,
        created_ns=int(created_ns),
        size_bytes=_HEADER.size + length,
        block_keys=len(block_entries),
        engine_mappings=len(engine_map),
        watermarks=watermarks,
        journal_boundary=journal_boundary,
    )
    return info, block_entries, engine_map


def load_latest_snapshot(
    directory: str,
    rejected: Optional[List[str]] = None,
) -> Optional[
    Tuple[
        SnapshotInfo,
        List[Tuple[int, List[PodEntry]]],
        List[Tuple[int, int]],
    ]
]:
    """The newest snapshot that validates, or None (cold start).

    A corrupt newest file logs and falls back to the next — recovery
    prefers an older baseline plus a longer journal replay over
    refusing to start.  Each file passed over is appended to
    ``rejected`` (when given) as ``"<path>: <reason>"``."""
    for path in _candidates(directory):
        try:
            return read_snapshot(path)
        except (SnapshotError, OSError) as exc:
            logger.warning("skipping invalid snapshot %s: %s", path, exc)
            if rejected is not None:
                rejected.append(f"{path}: {exc}")
    return None
