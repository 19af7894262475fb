"""The serving pods the benchmark stands in for: each a vLLM-style
prefix cache over its share of the block ids of one KV pool, and the KV
events its engine publishes.

A pod's blocks are refcounted.  A block that holds a full block of a
finished or running sequence stays cached after its last holder lets it
go, on an LRU of evictable blocks, until an allocation reuses it; a block
that a running sequence holds is never evicted.  Its engine's block
hashes are SHA-256 over the parent's hash and the block's tokens,
chained from the sequence's start, as vLLM's are.
"""

from __future__ import annotations

import hashlib
import struct
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np


def chain_hashes(tokens: Sequence[int], block_size: int, parent: bytes = b"") -> List[bytes]:
    """The engine's hash of each full block of ``tokens``, chained from
    ``parent`` (empty at a sequence's start)."""
    data = np.asarray(tokens, dtype="<i4")
    out = []
    for start in range(0, len(data) - block_size + 1, block_size):
        parent = hashlib.sha256(parent + data[start:start + block_size].tobytes()).digest()
        out.append(parent)
    return out


class Pod:
    """Block residency of one pod over the block ids ``ids``."""

    def __init__(self, name: str, ids: Sequence[int]) -> None:
        self.name = name
        self.capacity = len(ids)
        self.free: Deque[int] = deque(ids)
        self.cache: Dict[bytes, int] = {}  # engine hash -> block id, held or not
        self.owner: Dict[int, bytes] = {}  # block id -> engine hash, cached blocks
        self.ref: Dict[int, int] = {}
        self.lru: "OrderedDict[int, None]" = OrderedDict()  # cached, unheld; oldest first

    def cached_prefix(self, hashes: Sequence[bytes]) -> List[int]:
        """Block ids of the longest run of ``hashes`` cached here, from the first."""
        ids = []
        for h in hashes:
            bid = self.cache.get(h)
            if bid is None:
                break
            ids.append(bid)
        return ids

    def available(self) -> int:
        return len(self.free) + len(self.lru)

    def acquire(self, bid: int) -> None:
        self.ref[bid] = self.ref.get(bid, 0) + 1
        self.lru.pop(bid, None)

    def take(self, n: int) -> Optional[Tuple[List[int], List[bytes]]]:
        """``n`` fresh blocks, held once each, and the hashes this evicted
        (the least recently released cached blocks first); None where the
        pod has fewer than ``n`` it may reuse.  A caller that reuses cached
        blocks acquires them first, so that they cannot be evicted here."""
        if self.available() < n:
            return None
        ids, evicted = [], []
        while len(ids) < n and self.free:
            ids.append(self.free.popleft())
        while len(ids) < n:
            bid, _ = self.lru.popitem(last=False)
            h = self.owner.pop(bid)
            del self.cache[h]
            evicted.append(h)
            ids.append(bid)
        for bid in ids:
            self.ref[bid] = 1
        return ids, evicted

    def commit(self, bid: int, h: bytes) -> bool:
        """Cache the held block ``bid`` under ``h``; False where ``h`` is
        cached already (the block then stays private)."""
        if h in self.cache:
            return False
        self.cache[h] = bid
        self.owner[bid] = h
        return True

    def release(self, bid: int) -> None:
        left = self.ref[bid] - 1
        if left:
            self.ref[bid] = left
            return
        del self.ref[bid]
        if bid in self.owner:
            self.lru[bid] = None
        else:
            self.free.append(bid)

    def check(self) -> None:
        """The allocator's invariants: every block is free, cached or held,
        and no held block is on the evictable list."""
        held = set(self.ref)
        if held & set(self.lru):
            raise AssertionError(f"{self.name}: held blocks on the evictable list")
        if held & set(self.free) or set(self.owner) & set(self.free):
            raise AssertionError(f"{self.name}: a free block is held or cached")
        if not set(self.lru) <= set(self.owner):
            raise AssertionError(f"{self.name}: an evictable block is not cached")
        total = len(set(self.free) | set(self.owner) | held)
        if total != self.capacity:
            raise AssertionError(f"{self.name}: {total} blocks accounted of {self.capacity}")


@dataclass
class Stored:
    """One ``BlockStored``: blocks chained to ``parent`` (None at a
    sequence's start) and their tokens."""

    hashes: List[bytes]
    parent: Optional[bytes]
    tokens: List[int]


@dataclass
class Frame:
    """One published frame, as the reference replays it."""

    pod: str
    seq: int
    removed: List[bytes]
    stored: List[Stored]


@dataclass
class Publisher:
    """A pod engine's KV-event stream: ``[b"kv@<pod>@<model>", seq
    (u64 big-endian), msgpack(EventBatch)]``, seq counting from 1, the
    framing of the port's ``kvevents/publisher.py`` without its socket."""

    pod: str
    model: str
    block_size: int
    medium: str
    seq: int = 0
    log: List[Frame] = field(default_factory=list)

    def frame(self, events_mod, removed: List[bytes], stored: List[Stored]) -> Optional[list]:
        """The next frame: the evicted blocks as one ``BlockRemoved``, then
        each run of newly cached blocks as a ``BlockStored``; None where
        there is nothing to say."""
        events = []
        if removed:
            events.append(events_mod.BlockRemoved(block_hashes=list(removed), medium=self.medium))
        for run in stored:
            events.append(events_mod.BlockStored(
                block_hashes=list(run.hashes), parent_block_hash=run.parent,
                token_ids=list(run.tokens), block_size=self.block_size, medium=self.medium))
        if not events:
            return None
        self.seq += 1
        self.log.append(Frame(self.pod, self.seq, list(removed), list(stored)))
        payload = events_mod.EventBatch(ts=time.time(), events=events).encode()
        return [f"kv@{self.pod}@{self.model}".encode(), struct.pack(">Q", self.seq), payload]
