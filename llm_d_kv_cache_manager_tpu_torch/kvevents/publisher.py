"""ZMQ PUB helper publishing KVEvent batches the way engine pods do.

Used by demos and tests to simulate a fleet (reference pattern:
examples/helper/publisher.go:57-84).  Message = 3 parts:
``[topic, seq (u64 BE), msgpack(EventBatch)]``, topic
``kv@<pod-id>@<model>``.

**Lock discipline** (docs/event-plane.md): the seq lock covers ONLY
sequence assignment + enqueueing the encoded frame onto the send
queue; the socket send happens outside it, serialized by a separate
send lock draining the queue in FIFO (= seq) order.  Concurrent
publishers therefore never serialize on socket I/O — only on the
O(1) seq bump — while the wire still carries strictly increasing
seqs in order (the subscriber-side tracker sees no phantom
gaps/restarts).

**Coalescing** (``KVEVENTS_COALESCE_EVENTS`` / ``KVEVENTS_COALESCE_MS``,
or the constructor args): adjacent events from successive ``publish``
calls are buffered and shipped as ONE wire batch — one topic frame,
one seq, one msgpack envelope — shrinking the subscriber's per-message
demux + decode work at the source.  Events keep their identity inside
the batch (the pool digests them one by one, in order), so index
state, journal records, and seq/gap classification are bit-identical
to the uncoalesced stream — the parity the write-path tests pin.  A
buffered ``publish`` returns None; the flushing call (buffer full,
window elapsed, or explicit :meth:`flush`/:meth:`close`) returns the
seq the merged batch used; a background flusher bounds the age of a
trailing buffer when the producer goes idle (~2x the window).

Copied from the JAX reference's ``kvevents/publisher.py``; ``zmq`` is
imported when a publisher is made (``ImportError`` naming pyzmq where it
is not installed), not when this module is.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvevents.events import EventBatch
from llm_d_kv_cache_manager_tpu_torch.kvevents.zmq_subscriber import (
    TOPIC_PREFIX,
    import_zmq,
)
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder

# close() holds the send lock (no send may be mid-flight when the
# socket dies) and then the seq lock (no enqueue may race the closed
# flag); publish never nests them the other way — it releases the seq
# lock before draining sends.
# kvlint: lock-order: Publisher._send_lock < Publisher._lock
lockorder.declare_order("Publisher._send_lock", "Publisher._lock")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


class Publisher:
    def __init__(
        self,
        endpoint: str,
        pod_identifier: str,
        model_name: str,
        bind: bool = True,
        context: Optional[zmq.Context] = None,
        coalesce_events: Optional[int] = None,
        coalesce_ms: Optional[float] = None,
    ) -> None:
        self.pod_identifier = pod_identifier
        self.model_name = model_name
        zmq = self._zmq = import_zmq()
        self._context = context or zmq.Context.instance()
        self._socket = self._context.socket(zmq.PUB)
        self._socket.setsockopt(zmq.LINGER, 0)
        if bind:
            self._socket.bind(endpoint)
        else:
            self._socket.connect(endpoint)
        # Seq assignment + send-queue enqueue must be one atomic step:
        # two threads interleaving `_seq += 1` with their enqueues
        # would queue seqs out of order, which the subscriber-side
        # tracker reads as gaps/restarts that never happened.  The
        # actual socket send happens OUTSIDE this lock (see module
        # docstring).
        self._lock = lockorder.tracked(threading.Lock(), "Publisher._lock")
        self._seq = 0  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        # Encoded frames awaiting send, in seq order.  Deliberately NOT
        # single-lock guarded: appends happen under _lock (so FIFO
        # order IS seq order) while pops happen under _send_lock (one
        # drainer at a time keeps the wire ordered); deque append and
        # popleft are individually atomic, which is all the two-lock
        # discipline needs.
        self._pending: Deque[List[bytes]] = deque()
        self._send_lock = lockorder.tracked(
            threading.Lock(), "Publisher._send_lock"
        )
        # Coalescing buffer (None -> env; 0/1 disables).
        if coalesce_events is None:
            coalesce_events = _env_int("KVEVENTS_COALESCE_EVENTS", 0)
        if coalesce_ms is None:
            coalesce_ms = _env_float("KVEVENTS_COALESCE_MS", 2.0)
        self._coalesce_max = max(0, coalesce_events)
        self._coalesce_window_s = max(0.0, coalesce_ms) / 1000.0
        self._buffer: List[object] = []  # guarded-by: _lock
        self._buffer_since = 0.0  # guarded-by: _lock
        # Age-bound enforcement for an IDLE producer: publish() flushes
        # a stale buffer inline, but a trailing sub-max batch would
        # otherwise sit unsent forever — invisible staleness with no
        # seq gap to trigger resync.  A tiny daemon flusher (only when
        # coalescing is on) bounds it at ~2x the window.
        self._flusher_stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        if self._coalesce_max > 1:
            self._flusher = threading.Thread(
                target=self._flush_loop,
                name=f"kvtpu-pub-flush-{pod_identifier}",
                daemon=True,
            )
            self._flusher.start()

    @property
    def topic(self) -> str:
        return f"{TOPIC_PREFIX}{self.pod_identifier}@{self.model_name}"

    @property
    def endpoint(self) -> str:
        """The actual endpoint, post-bind — with the OS-assigned port when
        bound to port 0 (lets tests avoid fixed-port flakes)."""
        return self._socket.getsockopt(self._zmq.LAST_ENDPOINT).decode()

    @property
    def port(self) -> int:
        return int(self.endpoint.rsplit(":", 1)[1])

    def _enqueue_locked(self, events: Tuple[object, ...]) -> int:
        """Assign the next seq and queue the encoded frame; caller
        holds ``_lock``."""
        batch = EventBatch(ts=time.time(), events=list(events))
        payload = batch.encode()
        self._seq += 1
        seq = self._seq
        self._pending.append(
            [self.topic.encode(), struct.pack(">Q", seq), payload]
        )
        return seq

    def _drain_sends(self) -> None:
        """Send queued frames in FIFO order.  One drainer at a time;
        a caller returning from here is guaranteed every frame it
        enqueued beforehand has been sent (by itself or by the drainer
        it waited on)."""
        with self._send_lock:
            while True:
                try:
                    parts = self._pending.popleft()
                except IndexError:
                    return
                self._socket.send_multipart(parts)

    def publish(self, *events) -> Optional[int]:
        """Publish events; returns the seq of the wire batch they rode,
        or None when coalescing buffered them for a later flush.

        Thread-safe: concurrent publishers (fleet simulators drive one
        Publisher from several threads) get strictly increasing seqs
        with sends in seq order."""
        with self._lock:
            if self._closed:
                raise self._zmq.ZMQError(self._zmq.ENOTSOCK, "publisher is closed")
            if self._coalesce_max > 1:
                now = time.monotonic()
                if not self._buffer:
                    self._buffer_since = now
                self._buffer.extend(events)
                if (
                    len(self._buffer) < self._coalesce_max
                    and now - self._buffer_since < self._coalesce_window_s
                ):
                    return None
                merged, self._buffer = tuple(self._buffer), []
                seq = self._enqueue_locked(merged)
            else:
                seq = self._enqueue_locked(events)
        self._drain_sends()
        return seq

    def flush(self) -> Optional[int]:
        """Ship any coalescing-buffered events now; returns the seq
        used, or None when the buffer was empty."""
        with self._lock:
            if self._closed or not self._buffer:
                return None
            merged, self._buffer = tuple(self._buffer), []
            seq = self._enqueue_locked(merged)
        self._drain_sends()
        return seq

    def _flush_loop(self) -> None:
        interval = max(self._coalesce_window_s, 0.001)
        while not self._flusher_stop.wait(interval):
            stale_seq = None
            with self._lock:
                if self._closed:
                    return
                if self._buffer and (
                    time.monotonic() - self._buffer_since
                    >= self._coalesce_window_s
                ):
                    merged, self._buffer = tuple(self._buffer), []
                    stale_seq = self._enqueue_locked(merged)
            if stale_seq is not None:
                self._drain_sends()

    def advance_seq(self, count: int = 1) -> int:
        """Skip ``count`` sequence numbers WITHOUT sending — a test/bench
        hook that makes the next publish look like ``count`` lost events
        (forces a subscriber-side gap deterministically)."""
        with self._lock:
            self._seq += count
            return self._seq

    def close(self) -> None:
        """Flush buffered events + queued sends, then close the socket.
        The buffer flush happens INSIDE the locked section — a
        flush-then-lock sequence would let a concurrent publish buffer
        an event between the two and lose it silently.  Holding the
        send lock across the close keeps a concurrent publisher's
        drain from racing the socket teardown."""
        with self._send_lock:
            with self._lock:
                if self._closed:
                    return
                self._closed = True
                if self._buffer:
                    merged, self._buffer = tuple(self._buffer), []
                    self._enqueue_locked(merged)
                pending, self._pending = list(self._pending), deque()
            for parts in pending:
                self._socket.send_multipart(parts)
            self._socket.close()
        self._flusher_stop.set()
        if self._flusher is not None:
            self._flusher.join(timeout=5)
            # gil-atomic: lifecycle ref; start/close are control-plane
            self._flusher = None
