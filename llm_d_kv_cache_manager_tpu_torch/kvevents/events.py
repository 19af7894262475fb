"""KVEvents wire model: msgpack array-encoded structs, tagged unions.

Wire compatibility with vLLM's KV-event stream is a hard requirement — the
fleet publishes these, the indexer only listens.  Layout (reference:
pkg/kvevents/events.go):

* ``EventBatch``    -> ``[ts, [raw_event, ...], data_parallel_rank?]``
* ``BlockStored``   -> ``["BlockStored", block_hashes, parent_block_hash,
                         token_ids, block_size, lora_id?, medium?,
                         lora_name?]``
* ``BlockRemoved``  -> ``["BlockRemoved", block_hashes, medium?]``
* ``AllBlocksCleared`` -> ``["AllBlocksCleared"]``

Block hashes arrive as integers (legacy) or byte strings (``sha256_cbor``
engines); they are normalized to uint64 downstream
(``token_processor.engine_hash_to_uint64``).  Decoders tolerate missing
optional trailing fields and ignore unknown extra fields, matching the
reference's legacy-format handling (process_event_test.go:38-60).

Copied from the JAX reference's ``kvevents/events.py``; the payloads are
packed and parsed by the port's own codec (``kvevents/msgpack_codec``),
byte-equal and raise-equal to the ``msgpack`` library's calls the
reference makes, so the port needs no ``msgpack``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Union

from llm_d_kv_cache_manager_tpu_torch.kvevents import msgpack_codec

BLOCK_STORED_TAG = "BlockStored"
BLOCK_REMOVED_TAG = "BlockRemoved"
ALL_BLOCKS_CLEARED_TAG = "AllBlocksCleared"


@dataclass
class BlockStored:
    block_hashes: List[Any]
    parent_block_hash: Optional[Any]
    token_ids: List[int]
    block_size: int
    lora_id: Optional[int] = None
    medium: Optional[str] = None
    lora_name: Optional[str] = None

    def to_tagged_union(self) -> List[Any]:
        return [
            BLOCK_STORED_TAG,
            self.block_hashes,
            self.parent_block_hash,
            self.token_ids,
            self.block_size,
            self.lora_id,
            self.medium,
            self.lora_name,
        ]


@dataclass
class BlockRemoved:
    block_hashes: List[Any]
    medium: Optional[str] = None

    def to_tagged_union(self) -> List[Any]:
        return [BLOCK_REMOVED_TAG, self.block_hashes, self.medium]


@dataclass
class AllBlocksCleared:
    def to_tagged_union(self) -> List[Any]:
        return [ALL_BLOCKS_CLEARED_TAG]


Event = Union[BlockStored, BlockRemoved, AllBlocksCleared]


@dataclass
class EventBatch:
    ts: float
    events: List[Any]  # raw (undecoded) tagged-union arrays
    data_parallel_rank: Optional[int] = None

    def encode(self) -> bytes:
        """Encode with each event as a tagged-union array."""
        encoded_events = [
            e.to_tagged_union() if hasattr(e, "to_tagged_union") else e
            for e in self.events
        ]
        body: List[Any] = [self.ts, encoded_events]
        if self.data_parallel_rank is not None:
            body.append(self.data_parallel_rank)
        return msgpack_codec.packb(body)


class EventDecodeError(ValueError):
    pass


def decode_event_batch(payload: bytes) -> EventBatch:
    try:
        raw = msgpack_codec.unpackb(payload)
    except Exception as exc:  # malformed msgpack is a poison pill
        raise EventDecodeError(f"undecodable event batch: {exc}") from exc
    if not isinstance(raw, (list, tuple)) or len(raw) < 2:
        raise EventDecodeError(f"malformed event batch: {raw!r}")
    # Conversions guarded so type-confused payloads stay poison pills
    # (EventDecodeError) instead of escaping as TypeError/ValueError and
    # killing a pool worker.
    try:
        ts = float(raw[0])
    except (TypeError, ValueError) as exc:
        raise EventDecodeError(f"batch ts is not a number: {raw[0]!r}") from exc
    if not math.isfinite(ts):
        # ts is currently write-only in this codebase, but a nan/inf
        # timestamp is evidence the producer (or the wire) is corrupt —
        # the whole batch is treated as a poison pill rather than
        # trusting its events, and any future consumer of ts is
        # guaranteed a finite value.
        raise EventDecodeError(f"batch ts is not finite: {ts!r}")
    events = raw[1]
    if not isinstance(events, (list, tuple)):
        raise EventDecodeError("event batch events field is not an array")
    dp_rank = None
    if len(raw) >= 3 and raw[2] is not None:
        try:
            dp_rank = int(raw[2])
        except (TypeError, ValueError, OverflowError) as exc:
            raise EventDecodeError(
                f"batch dp rank is not an int: {raw[2]!r}"
            ) from exc
    return EventBatch(ts=ts, events=list(events), data_parallel_rank=dp_rank)


def _optional(fields: Sequence[Any], idx: int, default=None):
    if len(fields) > idx and fields[idx] is not None:
        return fields[idx]
    return default


def decode_event(raw: Any) -> Event:
    """Decode one tagged-union array into an event object."""
    if not isinstance(raw, (list, tuple)) or not raw:
        raise EventDecodeError(f"malformed tagged union: {raw!r}")
    tag = raw[0]
    if isinstance(tag, bytes):
        try:
            tag = tag.decode()
        except UnicodeDecodeError as exc:
            raise EventDecodeError(f"non-UTF-8 event tag: {tag!r}") from exc
    fields = raw[1:]

    try:
        if tag == BLOCK_STORED_TAG:
            if len(fields) < 4:
                raise EventDecodeError(
                    f"BlockStored requires 4 fields, got {len(fields)}"
                )
            medium = _optional(fields, 5)
            lora_name = _optional(fields, 6)
            return BlockStored(
                block_hashes=list(fields[0]),
                parent_block_hash=fields[1],
                token_ids=[int(t) for t in (fields[2] or [])],
                block_size=int(fields[3]),
                lora_id=_optional(fields, 4),
                medium=(
                    medium.decode() if isinstance(medium, bytes) else medium
                ),
                lora_name=(
                    lora_name.decode()
                    if isinstance(lora_name, bytes)
                    else lora_name
                ),
            )
        if tag == BLOCK_REMOVED_TAG:
            if len(fields) < 1:
                raise EventDecodeError("BlockRemoved requires a hash list")
            medium = _optional(fields, 1)
            return BlockRemoved(
                block_hashes=list(fields[0]),
                medium=(
                    medium.decode() if isinstance(medium, bytes) else medium
                ),
            )
    except (TypeError, ValueError, OverflowError, UnicodeDecodeError) as exc:
        # Field-level type confusion (an int where a list belongs, a
        # dict token id, non-UTF-8 medium bytes, int(inf) overflow, ...)
        # is a poison pill, not a worker-killing exception.
        if isinstance(exc, EventDecodeError):
            raise
        raise EventDecodeError(
            f"type-confused {tag} event: {exc}"
        ) from exc
    if tag == ALL_BLOCKS_CLEARED_TAG:
        return AllBlocksCleared()
    raise EventDecodeError(f"unknown event tag: {tag!r}")
