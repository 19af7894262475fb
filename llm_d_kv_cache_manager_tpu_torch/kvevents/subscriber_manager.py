"""Registry of per-pod event subscriptions over the consolidated poller.

Where this class used to spawn one ``ZMQSubscriber`` thread per pod, it
is now a *registry*: ``ensure_subscriber`` attaches a pod's SUB-socket
channel to the shared :class:`~.poller.PollerPool` (a fixed pool of
``KVEVENTS_POLLERS`` threads multiplexing the whole fleet), an endpoint
change detaches the stale channel and attaches a fresh one, and
``remove_subscriber``/``shutdown`` detach cleanly.  Thread count is
O(pollers), not O(pods) — see docs/event-plane.md.

Semantics preserved from the thread-per-pod era: ``ensure_subscriber``
is idempotent; an endpoint change (pod rescheduled with a new IP)
restarts the subscription; driven by pod-discovery (the k8s reconciler
adapter) or manually in tests/demos.  (Capability parity:
pkg/kvevents/subscriber_manager.go.)

A detached channel stops delivering *immediately* (the poller checks
the channel's ``detached`` flag before every sink call); its socket is
closed by the owning poller within one poll interval.

Copied from the JAX reference's ``kvevents/subscriber_manager.py``; it
imports without ``zmq`` (its ``zmq`` annotations are strings), and
``ensure_subscriber`` raises ``ImportError`` naming pyzmq where pyzmq is
not installed, when the poller pool takes its context.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from llm_d_kv_cache_manager_tpu_torch.utils import lockorder

from llm_d_kv_cache_manager_tpu_torch.kvevents.pool import Message
from llm_d_kv_cache_manager_tpu_torch.kvevents.poller import (
    Channel,
    ChannelConfig,
    PollerPool,
    PollerPoolConfig,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.zmq_subscriber import GapListener
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("kvevents.subscriber_manager")

# The registry lock wraps channel attach/detach, which take the poller
# pool's lifecycle lock and the target poller's command lock (both
# leaves: nothing is acquired under them).  Declared so an inversion —
# e.g. a poller callback reaching back into the registry — trips both
# kvlint KV006 and the runtime watchdog.
# kvlint: lock-order: SubscriberManager._lock < PollerPool._lock
lockorder.declare_order("SubscriberManager._lock", "PollerPool._lock")
# kvlint: lock-order: SubscriberManager._lock < Poller._cmd_lock
lockorder.declare_order("SubscriberManager._lock", "Poller._cmd_lock")


class SubscriberManager:
    def __init__(
        self,
        sink: Callable[[Message], None],
        context: Optional["zmq.Context"] = None,  # noqa: F821
        bind: bool = False,
        pollers: Optional[int] = None,
        poll_interval_ms: Optional[int] = None,
        on_gap: Optional[GapListener] = None,
        sink_batch: Optional[Callable[[list], None]] = None,
    ) -> None:
        self._sink = sink
        # Batched delivery (``Pool.add_tasks``): a poller hands each
        # socket burst to this in ONE call — the write-path fast
        # lane's enqueue half (docs/event-plane.md).  None keeps
        # per-message delivery through ``sink``.
        self._sink_batch = sink_batch
        self._bind = bind
        # Sequence-gap listener plumbed into every channel's demux —
        # the resync manager's mark_suspect in production
        # (docs/event-plane.md).
        self._on_gap = on_gap
        self._pool = PollerPool(
            context=context,
            config=PollerPoolConfig(
                pollers=pollers, poll_interval_ms=poll_interval_ms
            ),
        )
        # Registry lock is a leaf: channel detach is flag-flip cheap
        # (no thread join anymore), but poller-pool shutdown still
        # happens OUTSIDE it.
        self._lock = lockorder.tracked(
            threading.Lock(), "SubscriberManager._lock"
        )
        self._channels: Dict[str, Channel] = {}  # guarded-by: _lock
        self._shutdown = False  # guarded-by: _lock

    def ensure_subscriber(
        self,
        pod_identifier: str,
        endpoint: str,
        topic_filter: Optional[str] = None,
    ) -> bool:
        """Attach (or re-attach on endpoint/filter change) a pod channel.

        ``topic_filter=None`` subscribes to ``kv@<pod_identifier>@`` only;
        pass ``"kv@"`` when the subscriber identity differs from the
        engine's published pod id (scheduler-plugin discovery, global
        socket mode — reference: EnsureSubscriber's topicFilter arg).
        Returns True if a new subscription was started.
        """
        with self._lock:
            if self._shutdown:
                return False
            existing = self._channels.get(pod_identifier)
            if existing is not None:
                if (
                    existing.config.endpoint == endpoint
                    and existing.config.topic_filter == topic_filter
                ):
                    return False
                logger.info(
                    "subscription change for pod %s: endpoint %s -> %s, "
                    "topic filter %r -> %r; reattaching",
                    pod_identifier,
                    existing.config.endpoint,
                    endpoint,
                    existing.config.topic_filter,
                    topic_filter,
                )
                self._pool.detach(existing)
                del self._channels[pod_identifier]

            channel = self._pool.attach(
                ChannelConfig(
                    endpoint=endpoint,
                    pod_identifier=pod_identifier,
                    topic_filter=topic_filter,
                    bind=self._bind,
                ),
                self._sink,
                on_gap=self._on_gap,
                sink_batch=self._sink_batch,
            )
            self._channels[pod_identifier] = channel
            logger.info(
                "subscribed to pod %s at %s (poller %d)",
                pod_identifier,
                endpoint,
                channel.poller_index,
            )
        return True

    def remove_subscriber(self, pod_identifier: str) -> bool:
        with self._lock:
            channel = self._channels.pop(pod_identifier, None)
            if channel is None:
                return False
            self._pool.detach(channel)
        logger.info("unsubscribed from pod %s", pod_identifier)
        return True

    def active_pods(self) -> list:
        with self._lock:
            return sorted(self._channels)

    def gap_count(self, pod_identifier: str) -> int:
        """Events lost to sequence gaps on this pod's live channel."""
        with self._lock:
            channel = self._channels.get(pod_identifier)
            return channel.tracker.gap_count if channel else 0

    def restart_count(self, pod_identifier: str) -> int:
        """Publisher restarts observed on this pod's live channel."""
        with self._lock:
            channel = self._channels.get(pod_identifier)
            return channel.tracker.restart_count if channel else 0

    def poller_count(self) -> int:
        return self._pool.poller_count()

    def shutdown(self) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            channels = list(self._channels.values())
            self._channels.clear()
        for channel in channels:
            self._pool.detach(channel)
        # Poller join happens outside the registry lock: a wedged
        # poller must not stall fleet-wide reconciliation.
        self._pool.shutdown()
