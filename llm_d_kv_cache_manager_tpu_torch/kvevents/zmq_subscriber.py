"""KV-event wire format: topic parsing, seq tracking, message demux.

Wire format (reference: pkg/kvevents/zmq_subscriber.go:135-155, matching
vLLM's event publisher): 3-part messages ``[topic, seq, payload]`` where
``topic = "kv@<pod-id>@<model>"``, ``seq`` is a big-endian uint64, and
``payload`` is a msgpack ``EventBatch``.

This module owns the *demultiplexing* half of the event plane — shared
by the consolidated poller (``kvevents/poller.py``, the production
subscription path: a fixed pool of poller threads multiplexing many SUB
sockets) and by the legacy one-thread-per-pod :class:`ZMQSubscriber`
kept below as the bench baseline.

Sequence numbers are parsed per topic (``TopicSeqTracker``) and
classified three ways:

* ``seq == last + 1`` (or first sighting) — in order;
* ``seq > last + 1`` — a **gap**: ``seq - last - 1`` events were lost;
  counted in ``kvtpu_kvevents_seq_gaps_total{pod=...}`` and surfaced to
  an optional ``on_gap`` callback so the anti-entropy resync path
  (``kvevents/resync.py``) can mark the pod suspect instead of silently
  serving stale scores;
* ``seq < last`` — a **publisher restart** (the engine restarted and
  its counter reset to 1): the watermark resets to the new seq, the
  restart is counted in ``kvtpu_kvevents_publisher_restarts_total`` and
  it is NOT folded into the gap counter — a restarted counter would
  otherwise inflate gaps by ~``last`` on every engine restart.
  ``seq == last`` is a duplicate delivery: dropped from accounting
  entirely (watermark unchanged, no gap, no restart).

Copied from the JAX reference's ``kvevents/zmq_subscriber.py``, with one
change: ``zmq`` is imported where a socket or context is made
(:func:`import_zmq`), never at import, so the topic and seq parsing and
:func:`parse_event_message` run where pyzmq is not installed.
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from llm_d_kv_cache_manager_tpu_torch.kvevents.pool import Message
from llm_d_kv_cache_manager_tpu_torch.metrics.collector import (
    METRICS,
    safe_label,
)
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger, trace

logger = get_logger("kvevents.zmq")

TOPIC_PREFIX = "kv@"
POLL_INTERVAL_MS = 250
RECONNECT_BACKOFF_SECONDS = 5.0

# on_gap(pod_identifier, topic, events_lost) — called inline on the
# polling thread; implementations must be fast and non-blocking (the
# resync manager's mark_suspect only flips a set entry + notifies).
GapListener = Callable[[str, str, int], None]


def import_zmq():
    """The ``zmq`` module, for the code that makes a socket or context;
    raises ``ImportError`` naming pyzmq where it is not installed."""
    try:
        import zmq
    except ImportError as exc:
        raise ImportError(
            "pyzmq is not installed: a ZMQ socket (publisher, subscriber, "
            "poller) needs it; parse_event_message -> Pool.add_tasks does not"
        ) from exc
    return zmq


def topic_filter_bytes(
    topic_filter: Optional[str], pod_identifier: str
) -> bytes:
    """The SUBSCRIBE prefix for one pod's channel: an explicit filter
    verbatim ("" = everything), else scoped to ``kv@<pod>@``."""
    if topic_filter is not None:
        return topic_filter.encode()
    return f"{TOPIC_PREFIX}{pod_identifier}@".encode()


def open_sub_socket(
    context: zmq.Context, endpoint: str, filter_: bytes, bind: bool
) -> zmq.Socket:
    """One pod's SUB socket, configured identically for the
    consolidated poller and the legacy per-pod subscriber (the bench
    A/Bs the two paths — their socket setup must never drift)."""
    zmq = import_zmq()
    sock = context.socket(zmq.SUB)
    sock.setsockopt(zmq.LINGER, 0)
    sock.setsockopt(zmq.SUBSCRIBE, filter_)
    if bind:
        sock.bind(endpoint)
    else:
        sock.connect(endpoint)
    return sock


def parse_topic(topic: str) -> Optional[tuple]:
    """``kv@<pod-id>@<model>`` -> (pod_id, model); None if malformed.

    Model names may themselves contain ``@`` (LoRA refs); split only twice.
    """
    if not topic.startswith(TOPIC_PREFIX):
        return None
    rest = topic[len(TOPIC_PREFIX):]
    pod_id, sep, model = rest.partition("@")
    if not sep or not pod_id or not model:
        return None
    return pod_id, model


@dataclass
class SeqObservation:
    """Classification of one (topic, seq) sighting."""

    gap: int = 0
    restarted: bool = False
    duplicate: bool = False


class TopicSeqTracker:
    """Per-topic sequence watermarks for one pod's event stream.

    NOT thread-safe by design: a tracker is owned by whichever single
    thread polls its pod's socket (one poller thread per socket in the
    consolidated pool; the dedicated thread in the legacy subscriber).
    Sequence numbers are independent per topic — model/LoRA streams
    from one pod each number from their own counter.
    """

    __slots__ = ("_last_seq_by_topic", "gap_count", "restart_count")

    def __init__(self) -> None:
        self._last_seq_by_topic: Dict[str, int] = {}
        self.gap_count = 0
        self.restart_count = 0

    def observe(self, topic: str, seq: int) -> SeqObservation:
        last = self._last_seq_by_topic.get(topic)
        if last is None or seq == last + 1:
            self._last_seq_by_topic[topic] = seq
            return SeqObservation()
        if seq > last + 1:
            gap = seq - last - 1
            self.gap_count += gap
            self._last_seq_by_topic[topic] = seq
            return SeqObservation(gap=gap)
        if seq == last:
            # Duplicate delivery (PUB fan-in quirk): not a restart, not
            # a gap — and the watermark must not move.
            return SeqObservation(duplicate=True)
        # seq < last: the publisher restarted and its counter reset.
        # Reset the watermark so the NEXT message is judged against the
        # new counter, and keep the gap metric honest.
        self.restart_count += 1
        self._last_seq_by_topic[topic] = seq
        return SeqObservation(restarted=True)


def parse_event_message(
    parts,
    endpoint: str,
    pod_identifier: str,
    tracker: Optional[TopicSeqTracker] = None,
    on_gap: Optional[GapListener] = None,
) -> Optional[Message]:
    """Decode one ``[topic, seq, payload]`` multipart into a Message.

    Shared by the consolidated poller and the legacy subscriber so both
    paths classify gaps/restarts identically.  Dropped frames are event
    loss (stale scores for that pod until re-store), so every drop path
    logs at warning with enough context to find the misbehaving
    publisher.  Returns None for malformed frames and duplicate seqs.

    ``payload`` may be any bytes-like object — the poller's zero-copy
    path passes a ``memoryview`` over the ZMQ frame, which rides the
    Message untouched into the (pre-)decode stage; topic and seq must
    be ``bytes`` (they are tiny and always copied out of the frame).
    """
    if len(parts) != 3:
        logger.warning(
            "dropping %d-part message from %s (want [topic, seq, payload])",
            len(parts),
            endpoint,
        )
        return None
    topic_raw, seq_raw, payload = parts
    try:
        topic = topic_raw.decode()
    except UnicodeDecodeError:
        logger.warning(
            "dropping message with undecodable topic from %s", endpoint
        )
        return None
    parsed = parse_topic(topic)
    if parsed is None:
        logger.warning(
            "dropping message with malformed topic %r from %s",
            topic,
            endpoint,
        )
        return None
    pod_id, model = parsed

    seq = 0
    gap = 0
    if len(seq_raw) == 8:
        seq = struct.unpack(">Q", seq_raw)[0]
        if tracker is not None:
            observed = tracker.observe(topic, seq)
            if observed.duplicate:
                trace(logger, "duplicate seq %d on %s; dropping", seq, topic)
                return None
            if observed.restarted:
                METRICS.kvevents_publisher_restarts.labels(
                    pod=safe_label(pod_id)
                ).inc()
                logger.info(
                    "publisher restart on %s: counter reset to %d "
                    "(watermark reset, not counted as a gap)",
                    topic,
                    seq,
                )
            elif observed.gap:
                gap = observed.gap
                METRICS.kvevents_seq_gaps.labels(pod=safe_label(pod_id)).inc(gap)
                logger.warning(
                    "sequence gap on %s: -> %d (%d events lost)",
                    topic,
                    seq,
                    gap,
                )
                if on_gap is not None:
                    try:
                        on_gap(pod_id, topic, gap)
                    except Exception:  # noqa: BLE001 — listener bugs
                        logger.exception(
                            "gap listener failed for pod %s", pod_id
                        )

    trace(logger, "message topic=%s seq=%d", topic, seq)
    # seq_gap rides the message so a sampled ingestion trace can
    # surface the publisher-side loss alongside queue/apply timing.
    return Message(
        topic=topic,
        payload=payload,
        pod_identifier=pod_id,
        model_name=model,
        seq=seq,
        seq_gap=gap,
    )


@dataclass
class ZMQSubscriberConfig:
    endpoint: str
    pod_identifier: str
    # Subscribe to this pod's topics only; "" subscribes to everything.
    topic_filter: Optional[str] = None
    # bind=True for local test endpoints, connect for remote pods
    # (reference: zmq_subscriber.go:92-105).
    bind: bool = False

    def filter_bytes(self) -> bytes:
        return topic_filter_bytes(self.topic_filter, self.pod_identifier)


class ZMQSubscriber:
    """LEGACY one SUB socket + dedicated polling thread per pod.

    Superseded by the consolidated poller pool (``kvevents/poller.py``)
    which multiplexes many pods' sockets onto a fixed thread pool —
    thread count and idle wakeups scale with ``KVEVENTS_POLLERS``, not
    fleet size.  This class is retained as the thread-per-pod baseline
    for the ``event_storm`` bench regime (the A/B the consolidation is
    measured against) and for single-socket tools; production paths go
    through :class:`~.subscriber_manager.SubscriberManager`, which no
    longer uses it.
    """

    def __init__(
        self,
        config: ZMQSubscriberConfig,
        sink: Callable[[Message], None],
        context: Optional[zmq.Context] = None,
        on_gap: Optional[GapListener] = None,
    ) -> None:
        self.config = config
        self._sink = sink
        self._context = context or import_zmq().Context.instance()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._on_gap = on_gap
        self.tracker = TopicSeqTracker()

    @property
    def gap_count(self) -> int:
        return self.tracker.gap_count

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run,
            name=f"kvtpu-zmq-{self.config.pod_identifier}",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _open_socket(self) -> zmq.Socket:
        return open_sub_socket(
            self._context,
            self.config.endpoint,
            self.config.filter_bytes(),
            self.config.bind,
        )

    def _run(self) -> None:
        while not self._stop.is_set():
            sock = None
            try:
                sock = self._open_socket()
                self._poll_loop(sock)
            except Exception as exc:  # noqa: BLE001 — thread must survive
                logger.warning(
                    "subscriber for %s errored (%s); reconnecting in %.0fs",
                    self.config.pod_identifier,
                    exc,
                    RECONNECT_BACKOFF_SECONDS,
                )
                self._stop.wait(RECONNECT_BACKOFF_SECONDS)
            finally:
                if sock is not None:
                    sock.close()

    def _poll_loop(self, sock: zmq.Socket) -> None:
        zmq = import_zmq()
        poller = zmq.Poller()
        poller.register(sock, zmq.POLLIN)
        while not self._stop.is_set():
            if not dict(poller.poll(POLL_INTERVAL_MS)):
                continue
            parts = sock.recv_multipart()
            message = self._parse_message(parts)
            if message is None:
                continue
            try:
                self._sink(message)
            except Exception:  # noqa: BLE001 — sink bugs must not kill us
                logger.exception(
                    "sink failed for a message from %s; dropping it",
                    self.config.pod_identifier,
                )

    def _parse_message(self, parts) -> Optional[Message]:
        return parse_event_message(
            parts,
            endpoint=self.config.endpoint,
            pod_identifier=self.config.pod_identifier,
            tracker=self.tracker,
            on_gap=self._on_gap,
        )


__all__ = [
    "GapListener",
    "POLL_INTERVAL_MS",
    "RECONNECT_BACKOFF_SECONDS",
    "SeqObservation",
    "TOPIC_PREFIX",
    "TopicSeqTracker",
    "ZMQSubscriber",
    "ZMQSubscriberConfig",
    "import_zmq",
    "open_sub_socket",
    "parse_event_message",
    "parse_topic",
    "topic_filter_bytes",
]
