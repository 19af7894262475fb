"""Consolidated event-plane poller: many pods, a fixed thread pool.

The legacy subscription model spent one SUB socket **plus one dedicated
250 ms-poll thread per pod**, so a 10k-pod fleet meant 10k threads and
40k idle wakeups/s before a single event arrived — a hard ceiling far
below fleet scale.  This module replaces it with a small fixed pool of
poller threads (default 1, ``KVEVENTS_POLLERS``), each multiplexing
*many* SUB sockets through one ``zmq.Poller``:

* **threads** scale with ``KVEVENTS_POLLERS``, not fleet size;
* **idle wakeups** are one per poller per ``poll_interval_ms``,
  amortized over every attached pod;
* **reconnect/backoff** is poller-scheduled (a due-time per channel,
  folded into the poll timeout) instead of a per-thread sleep;
* **per-topic seq tracking** (gap / publisher-restart classification)
  moves into the shared demux (``zmq_subscriber.parse_event_message``),
  one ``TopicSeqTracker`` per channel, owned by the channel's poller
  thread.

``SubscriberManager`` is the public face: it became a registry that
attaches/detaches :class:`ChannelConfig`\\ s to this pool.  The bench's
``event_storm`` regime A/Bs this pool against the legacy
thread-per-pod baseline (``ZMQSubscriber``).

Thread-safety model: each channel (socket + tracker) is owned by
exactly one poller thread.  Cross-thread mutation happens only through
the command queue (attach/detach/shutdown) and the ``detached`` flag —
a plain boolean flip that makes delivery stop *immediately* (checked
before every sink call), while the socket itself is unregistered and
closed by the owning poller on its next wakeup.

Copied from the JAX reference's ``kvevents/poller.py``, with one change:
the reference's ``PollerPool`` takes ``zmq.Context.instance()`` when it
is built; the port's takes it when the first channel attaches
(``_ensure_started``), and imports ``zmq`` only there and on the poller
threads.  The semantics do not change, and a manager with no
subscriptions never needs pyzmq.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from llm_d_kv_cache_manager_tpu_torch.kvevents.pool import (
    Message,
    resolve_lockfree_decode_env,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.zmq_subscriber import (
    GapListener,
    TopicSeqTracker,
    import_zmq,
    open_sub_socket,
    parse_event_message,
    topic_filter_bytes,
)
from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("kvevents.poller")

# Messages drained per ready socket per wakeup: bounds how long one
# chatty pod can monopolize its poller before the next socket is
# served.  The shard queues do the real per-pod flow control; this is
# only poll-loop fairness.
MAX_RECV_PER_SOCKET = 64


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


@dataclass
class PollerPoolConfig:
    # Fixed poller-thread count.  One poller comfortably multiplexes
    # thousands of idle pods; raise it when decode-free receive work
    # itself saturates a core.  None -> KVEVENTS_POLLERS env (default 1).
    pollers: Optional[int] = None
    # Idle poll timeout.  Also the worst-case latency for picking up an
    # attach/detach command; commands additionally take effect
    # immediately via the `detached` flag.  None -> KVEVENTS_POLL_MS
    # env (default 50).
    poll_interval_ms: Optional[int] = None
    # Reconnect backoff after a socket error, scheduled on the poller's
    # clock (no per-pod sleeping thread).
    reconnect_backoff_s: float = 5.0
    # Zero-copy receive: payload frames are passed downstream as
    # memoryviews over the ZMQ message (no bytes copy per event).
    # None -> the same KVEVENTS_LOCKFREE_DECODE env the pool's
    # pre-decode stage reads — one knob flips the whole fast lane.
    zero_copy: Optional[bool] = None

    def resolved_pollers(self) -> int:
        n = self.pollers
        if n is None:
            n = _env_int("KVEVENTS_POLLERS", 1)
        return max(1, n)

    def resolved_poll_ms(self) -> int:
        ms = self.poll_interval_ms
        if ms is None:
            ms = _env_int("KVEVENTS_POLL_MS", 50)
        return max(1, ms)

    def resolved_zero_copy(self) -> bool:
        if self.zero_copy is not None:
            return self.zero_copy
        return resolve_lockfree_decode_env()


@dataclass
class ChannelConfig:
    """One pod's subscription: where to connect and what to filter."""

    endpoint: str
    pod_identifier: str
    topic_filter: Optional[str] = None
    bind: bool = False

    def filter_bytes(self) -> bytes:
        return topic_filter_bytes(self.topic_filter, self.pod_identifier)


class Channel:
    """A pod's socket + demux state, owned by one poller thread.

    Created by the manager, handed to a poller via ``attach``; after
    ``detach`` the manager must drop its reference (a new subscription
    for the same pod is a NEW channel — generation safety without
    generation counters).
    """

    __slots__ = (
        "config",
        "sink",
        "sink_batch",
        "on_gap",
        "tracker",
        "sock",
        "reconnect_at",
        "detached",
        "poller_index",
    )

    def __init__(
        self,
        config: ChannelConfig,
        sink: Callable[[Message], None],
        on_gap: Optional[GapListener] = None,
        sink_batch: Optional[Callable[[List[Message]], None]] = None,
    ) -> None:
        self.config = config
        self.sink = sink
        # Batched delivery (``Pool.add_tasks``): one sink call per
        # socket burst instead of one per message — one shard-lock
        # round trip and one metrics pass for the whole burst.  When
        # None, messages are delivered one by one through ``sink``.
        self.sink_batch = sink_batch
        self.on_gap = on_gap
        self.tracker = TopicSeqTracker()
        self.sock: Optional[zmq.Socket] = None
        self.reconnect_at = 0.0  # 0 = connect on first wakeup
        # Flipped by detach() from any thread; checked before every
        # sink delivery, so no events are delivered after detach even
        # while the socket awaits its poller-side close.
        self.detached = False
        self.poller_index = -1


class _Poller:
    """One poller thread multiplexing many channels via ``zmq.Poller``."""

    def __init__(
        self,
        index: int,
        context: zmq.Context,
        poll_interval_ms: int,
        reconnect_backoff_s: float,
        zero_copy: bool = True,
    ) -> None:
        self.index = index
        self._context = context
        self._poll_ms = poll_interval_ms
        self._backoff_s = reconnect_backoff_s
        self._zero_copy = zero_copy
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Pending attach(+)/detach(-) commands from other threads; the
        # only cross-thread channel mutation besides `detached`.  Leaf
        # lock: nothing is acquired while holding it.
        self._cmd_lock = lockorder.tracked(
            threading.Lock(), "Poller._cmd_lock"
        )
        self._commands: List[tuple] = []  # guarded-by: _cmd_lock
        # Channel count, maintained by the MANAGER side at
        # attach/detach time for least-loaded placement (the poller
        # thread's own dict lags by up to one wakeup).
        self._assigned = 0  # guarded-by: _cmd_lock

    # -- manager-side API ------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        # gil-atomic: lifecycle ref; start/close are control-plane
        self._thread = threading.Thread(
            target=self._run,
            name=f"kvtpu-evplane-poller-{self.index}",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            # gil-atomic: lifecycle ref; start/close are control-plane
            self._thread = None

    def assigned(self) -> int:
        with self._cmd_lock:
            return self._assigned

    def alive(self) -> bool:
        """True while the poller thread is serving its channels."""
        thread = self._thread
        return thread is not None and thread.is_alive()

    def attach(self, channel: Channel) -> None:
        channel.poller_index = self.index
        with self._cmd_lock:
            self._commands.append(("attach", channel))
            self._assigned += 1

    def detach(self, channel: Channel) -> None:
        # Delivery stops NOW; the socket closes on the poller's next
        # wakeup (bounded by poll_interval_ms).
        channel.detached = True
        with self._cmd_lock:
            self._commands.append(("detach", channel))
            self._assigned -= 1

    # -- poller-thread internals ----------------------------------------

    def _open_socket(self, channel: Channel) -> zmq.Socket:
        return open_sub_socket(
            self._context,
            channel.config.endpoint,
            channel.config.filter_bytes(),
            channel.config.bind,
        )

    def _connect(
        self, channel: Channel, poller: zmq.Poller, now: float
    ) -> None:
        zmq = import_zmq()
        try:
            channel.sock = self._open_socket(channel)
            poller.register(channel.sock, zmq.POLLIN)
            channel.reconnect_at = 0.0
        except Exception as exc:  # noqa: BLE001 — endpoint may be bad
            channel.sock = None
            channel.reconnect_at = now + self._backoff_s
            logger.warning(
                "poller %d: connect to %s for pod %s failed (%s); "
                "retrying in %.0fs",
                self.index,
                channel.config.endpoint,
                channel.config.pod_identifier,
                exc,
                self._backoff_s,
            )

    def _teardown(
        self, channel: Channel, poller: zmq.Poller, now: float, exc: Exception
    ) -> None:
        """Socket error: close, schedule a poller-clock reconnect."""
        if channel.sock is not None:
            try:
                poller.unregister(channel.sock)
            except KeyError:
                pass
            channel.sock.close()
            channel.sock = None
        channel.reconnect_at = now + self._backoff_s
        logger.warning(
            "poller %d: socket for pod %s errored (%s); reconnecting "
            "in %.0fs",
            self.index,
            channel.config.pod_identifier,
            exc,
            self._backoff_s,
        )

    def _apply_commands(
        self,
        poller: zmq.Poller,
        channels: Dict[zmq.Socket, Channel],
        pending_connect: List[Channel],
    ) -> None:
        with self._cmd_lock:
            commands, self._commands = self._commands, []
        for op, channel in commands:
            if op == "attach":
                if channel.detached:  # attach/detach raced; never open
                    continue
                pending_connect.append(channel)
            else:  # detach
                if channel in pending_connect:
                    pending_connect.remove(channel)
                if channel.sock is not None:
                    try:
                        poller.unregister(channel.sock)
                    except KeyError:
                        pass
                    channels.pop(channel.sock, None)
                    channel.sock.close()
                    channel.sock = None

    def _run(self) -> None:
        zmq = import_zmq()
        poller = zmq.Poller()
        channels: Dict[zmq.Socket, Channel] = {}
        # Channels awaiting (re)connect, each with a due time on OUR
        # clock — the scheduled replacement for per-thread backoff
        # sleeps.
        pending_connect: List[Channel] = []
        sockets_gauge = METRICS.kvevents_poller_sockets.labels(
            poller=str(self.index)
        )
        last_socket_count = -1
        try:
            while not self._stop.is_set():
                self._apply_commands(poller, channels, pending_connect)
                now = time.monotonic()
                still_pending: List[Channel] = []
                for channel in pending_connect:
                    if channel.detached:
                        continue
                    if now >= channel.reconnect_at:
                        self._connect(channel, poller, now)
                        if channel.sock is not None:
                            channels[channel.sock] = channel
                            continue
                    still_pending.append(channel)
                pending_connect = still_pending
                if len(channels) != last_socket_count:
                    last_socket_count = len(channels)
                    sockets_gauge.set(last_socket_count)

                timeout_ms = self._poll_ms
                if pending_connect:
                    due = min(c.reconnect_at for c in pending_connect)
                    timeout_ms = min(
                        timeout_ms,
                        max(1, int((due - now) * 1000.0)),
                    )
                try:
                    ready = poller.poll(timeout_ms)
                except zmq.ZMQError:
                    if self._stop.is_set():
                        break
                    raise
                for sock, _flags in ready:
                    channel = channels.get(sock)
                    if channel is None:
                        continue
                    if channel.detached:
                        continue  # close happens via its command
                    try:
                        self._drain_socket(channel)
                    except zmq.ZMQError as exc:
                        channels.pop(sock, None)
                        self._teardown(
                            channel, poller, time.monotonic(), exc
                        )
                        pending_connect.append(channel)
        except Exception:  # noqa: BLE001 — a dead poller is fleet-wide loss
            logger.exception(
                "poller %d crashed; its pods stop receiving events "
                "until resubscribed",
                self.index,
            )
        finally:
            for sock in list(channels):
                sock.close()
            channels.clear()

    def _drain_socket(self, channel: Channel) -> None:
        """Receive up to MAX_RECV_PER_SOCKET messages without blocking,
        then deliver the burst in ONE batched sink call when the
        channel has one (``sink_batch`` -> ``Pool.add_tasks``: one
        shard-lock round trip for the whole burst, and the lock-free
        decode stage runs here on this poller thread).  Zero-copy mode
        hands the payload frame downstream as a memoryview — the tiny
        topic/seq frames are copied, the msgpack body is not."""
        assert channel.sock is not None
        zmq = import_zmq()
        batch: List[Message] = []
        for _ in range(MAX_RECV_PER_SOCKET):
            try:
                if self._zero_copy:
                    frames = channel.sock.recv_multipart(
                        zmq.NOBLOCK, copy=False
                    )
                    if len(frames) == 3:
                        parts = [
                            frames[0].bytes,
                            frames[1].bytes,
                            frames[2].buffer,
                        ]
                    else:
                        parts = [f.bytes for f in frames]
                else:
                    parts = channel.sock.recv_multipart(zmq.NOBLOCK)
            except zmq.Again:
                break
            if channel.detached:
                return
            message = parse_event_message(
                parts,
                endpoint=channel.config.endpoint,
                pod_identifier=channel.config.pod_identifier,
                tracker=channel.tracker,
                on_gap=channel.on_gap,
            )
            if message is None:
                continue
            batch.append(message)
        if not batch or channel.detached:
            return
        if channel.sink_batch is not None:
            try:
                channel.sink_batch(batch)
            except Exception:  # noqa: BLE001 — sink bugs must not kill us
                logger.exception(
                    "batch sink failed for %d messages from %s; dropping",
                    len(batch),
                    channel.config.pod_identifier,
                )
            return
        for message in batch:
            try:
                channel.sink(message)
            except Exception:  # noqa: BLE001 — sink bugs must not kill us
                logger.exception(
                    "sink failed for a message from %s; dropping it",
                    channel.config.pod_identifier,
                )


class PollerPool:
    """A fixed pool of :class:`_Poller` threads; channels attach to the
    least-loaded poller.  Threads start lazily on first attach so
    constructing a manager stays free."""

    def __init__(
        self,
        context: Optional[zmq.Context] = None,
        config: Optional[PollerPoolConfig] = None,
    ) -> None:
        self.config = config or PollerPoolConfig()
        # Taken at the first attach (``_ensure_started``).
        self._context = context  # guarded-by: _lock
        # Lifecycle lock (leaf): guards lazy start + shutdown flag; a
        # wedged poller join never happens under it.
        self._lock = lockorder.tracked(threading.Lock(), "PollerPool._lock")
        self._pollers: List[_Poller] = []  # guarded-by: _lock
        self._started = False  # guarded-by: _lock
        self._shutdown = False  # guarded-by: _lock

    def _new_poller(self, index: int) -> _Poller:  # kvlint: caller-locked
        poller = _Poller(
            index,
            self._context,
            self.config.resolved_poll_ms(),
            self.config.reconnect_backoff_s,
            zero_copy=self.config.resolved_zero_copy(),
        )
        poller.start()
        return poller

    def _ensure_started(self) -> List[_Poller]:
        with self._lock:
            if self._shutdown:
                raise RuntimeError("PollerPool is shut down")
            if not self._started:
                if self._context is None:
                    self._context = import_zmq().Context.instance()
                self._started = True
                for i in range(self.config.resolved_pollers()):
                    self._pollers.append(self._new_poller(i))
            else:
                for i, poller in enumerate(self._pollers):
                    if not poller.alive():
                        # A crashed poller's channels are already lost
                        # (its pods must resubscribe) — but left in the
                        # pool it would keep collecting NEW attach
                        # assignments that can never deliver.  Replace
                        # it so fresh subscriptions land on a live
                        # thread.
                        logger.warning(
                            "poller %d found dead; replacing it "
                            "(its previous pods need resubscribing)",
                            poller.index,
                        )
                        self._pollers[i] = self._new_poller(
                            poller.index
                        )
            return list(self._pollers)

    def attach(
        self,
        config: ChannelConfig,
        sink: Callable[[Message], None],
        on_gap: Optional[GapListener] = None,
        sink_batch: Optional[Callable[[List[Message]], None]] = None,
    ) -> Channel:
        pollers = self._ensure_started()
        channel = Channel(config, sink, on_gap=on_gap, sink_batch=sink_batch)
        target = min(pollers, key=lambda p: p.assigned())
        target.attach(channel)
        return channel

    def detach(self, channel: Channel) -> None:
        with self._lock:
            pollers = list(self._pollers)
        for poller in pollers:
            if poller.index == channel.poller_index:
                poller.detach(channel)
                return
        # Pool already torn down: just stop delivery.
        channel.detached = True

    def poller_count(self) -> int:
        with self._lock:
            if not self._started:
                return self.config.resolved_pollers()
            return len(self._pollers)

    def shutdown(self) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            pollers, self._pollers = self._pollers, []
        # Join outside the lock: a wedged poller must not stall the
        # caller's other teardown work behind the pool lock.
        for poller in pollers:
            poller.stop()
