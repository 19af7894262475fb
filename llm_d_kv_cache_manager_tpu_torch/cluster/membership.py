"""Cluster membership: static replica config + heartbeat health.

The membership owns the live :class:`~.ring.HashRing`: the configured
replica set is static (``CLUSTER_REPLICAS``), the ALIVE subset is
dynamic.  A replica leaves the ring when a heartbeat times out or the
router observes a transport failure mid-request (``mark_dead``), and
rejoins when a later heartbeat answers (``mark_alive``) — each change
produces a new ring version, so per-version ownership caches in the
router invalidate wholesale.

Failover is therefore just ring math: removing a member re-routes each
of its keys to its rendezvous runner-up (``ring.owners(key, 2)[1]`` on
the full ring), which is exactly the slice replication followers keep
warm (``replication.py``).  ``failover_count`` and the
``kvtpu_cluster_*`` metric families track the churn.

Copied from the JAX reference's ``cluster/membership.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from llm_d_kv_cache_manager_tpu_torch.cluster.replica import ReplicaUnavailable
from llm_d_kv_cache_manager_tpu_torch.cluster.ring import HashRing
from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("cluster.membership")

# Leaf lock: membership state flips and ring rebuilds only — never a
# transport call or an index apply under it.
# kvlint: lock-order: ClusterMembership._lock ascending
lockorder.declare_ascending("ClusterMembership._lock")


class ClusterMembership:
    """Alive-set tracking + the versioned ring over it.

    ``transports`` maps replica id -> transport (an object with
    ``call(method, args)``); the full configured set never changes at
    runtime — only aliveness does.
    """

    def __init__(self, transports: Dict[str, object]) -> None:
        if not transports:
            raise ValueError("cluster needs at least one replica")
        self._transports = dict(transports)
        self._lock = lockorder.tracked(
            threading.Lock(), "ClusterMembership._lock"
        )
        self._alive = set(self._transports)  # guarded-by: _lock
        self._ring = HashRing(sorted(self._transports))  # guarded-by: _lock
        # Full ring over every CONFIGURED replica, version-frozen: the
        # standby assignment (owners(key, 2)[1]) must be stable across
        # failovers or followers would sync the wrong slice.
        self.full_ring = HashRing(sorted(self._transports))
        self._failover_count = 0  # guarded-by: _lock
        self._last_heartbeat: Dict[str, float] = {}  # guarded-by: _lock
        # replica -> (unix_ts, reason) of the last mark_dead — the
        # /debug/cluster "why did it leave the ring" context that
        # otherwise only existed as a log line.  guarded-by: _lock
        self._last_errors: Dict[str, Tuple[float, str]] = {}
        # Ring-change listeners (replica-local ingestion re-slices its
        # pod subscriptions on every version bump — cluster/ingest.py).
        # Invoked OUTSIDE the membership lock with the new ring.
        self._listeners: List[Callable[[HashRing], None]] = (
            []
        )  # guarded-by: _lock
        METRICS.cluster_ring_version.set(self._ring.version)
        METRICS.cluster_replicas_alive.set(len(self._alive))

    # -- reads ----------------------------------------------------------

    def ring(self) -> HashRing:
        """The current ring over alive replicas (immutable snapshot)."""
        with self._lock:
            return self._ring

    def transport(self, replica_id: str):
        return self._transports[replica_id]

    def members(self) -> List[str]:
        return sorted(self._transports)

    def alive(self) -> List[str]:
        with self._lock:
            return sorted(self._alive)

    def is_alive(self, replica_id: str) -> bool:
        with self._lock:
            return replica_id in self._alive

    def failover_count(self) -> int:
        with self._lock:
            return self._failover_count

    def status(self) -> dict:
        """The /debug/cluster membership block."""
        now = time.monotonic()
        wall = time.time()
        with self._lock:
            return {
                "members": sorted(self._transports),
                "alive": sorted(self._alive),
                "ring_version": self._ring.version,
                "failovers": self._failover_count,
                "heartbeat_age_s": {
                    replica: round(now - seen, 3)
                    for replica, seen in self._last_heartbeat.items()
                },
                "last_errors": {
                    replica: {
                        "age_s": round(wall - ts, 3),
                        "reason": reason,
                    }
                    for replica, (ts, reason) in self._last_errors.items()
                },
            }

    def add_listener(
        self, listener: Callable[[HashRing], None]
    ) -> None:
        """Register a ring-change listener, called with the NEW alive
        ring after every version bump (mark_dead/mark_alive), outside
        the membership lock.  Listener exceptions are swallowed (a
        broken consumer must not wedge failover)."""
        with self._lock:
            self._listeners.append(listener)

    def _notify_ring_change(self, ring: HashRing) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for listener in listeners:
            try:
                listener(ring)
            except Exception:  # noqa: BLE001 — consumer bugs stay theirs
                logger.exception("ring-change listener failed")

    # -- writes ---------------------------------------------------------

    def mark_dead(self, replica_id: str, reason: str = "") -> bool:
        """Remove a replica from the ring; True if it was alive.  The
        LAST alive replica is never removed — routing into an empty
        ring helps nobody; its calls keep failing loudly instead."""
        with self._lock:
            if replica_id not in self._alive:
                return False
            if len(self._alive) == 1:
                logger.error(
                    "replica %s unhealthy (%s) but it is the last one "
                    "alive; keeping it in the ring",
                    replica_id,
                    reason,
                )
                return False
            self._alive.discard(replica_id)
            self._ring = self._ring.without(replica_id)
            self._failover_count += 1
            self._last_errors[replica_id] = (
                time.time(),
                reason or "marked dead",
            )
            ring = self._ring
            version = ring.version
            alive = len(self._alive)
        METRICS.cluster_failovers.inc()
        METRICS.cluster_ring_version.set(version)
        METRICS.cluster_replicas_alive.set(alive)
        logger.warning(
            "replica %s removed from the ring (%s); ring v%d, %d alive",
            replica_id,
            reason or "marked dead",
            version,
            alive,
        )
        self._notify_ring_change(ring)
        return True

    def mark_alive(self, replica_id: str) -> bool:
        """(Re)admit a replica; True if it was dead.  A revived
        replica's slice routes back to it immediately — its index may
        be stale for the death window (heals via event flow / resync),
        which docs/replication.md calls out."""
        if replica_id not in self._transports:
            raise KeyError(f"unknown replica: {replica_id}")
        with self._lock:
            self._last_heartbeat[replica_id] = time.monotonic()
            if replica_id in self._alive:
                return False
            self._alive.add(replica_id)
            self._ring = self._ring.with_member(replica_id)
            ring = self._ring
            version = ring.version
            alive = len(self._alive)
        METRICS.cluster_ring_version.set(version)
        METRICS.cluster_replicas_alive.set(alive)
        logger.info(
            "replica %s rejoined the ring; ring v%d, %d alive",
            replica_id,
            version,
            alive,
        )
        self._notify_ring_change(ring)
        return True


class HeartbeatMonitor:
    """Background pinger: every ``interval_s`` each replica gets a
    ``ping``; ``misses`` consecutive failures mark it dead, one success
    marks it alive again.  Dead replicas keep being pinged — revival is
    how a restarted replica rejoins without operator action."""

    def __init__(
        self,
        membership: ClusterMembership,
        interval_s: float = 2.0,
        misses: int = 2,
    ) -> None:
        if interval_s <= 0:
            raise ValueError("heartbeat interval must be positive")
        self.membership = membership
        self.interval_s = interval_s
        self.misses = max(1, misses)
        self._miss_counts: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="kvtpu-cluster-heartbeat", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def beat_once(self) -> None:
        """One heartbeat round (the loop body; callable directly from
        tests and the smoke so they never sleep-poll)."""
        for replica_id in self.membership.members():
            transport = self.membership.transport(replica_id)
            try:
                transport.call("ping", [])
            except (ReplicaUnavailable, ConnectionError, OSError):
                count = self._miss_counts.get(replica_id, 0) + 1
                self._miss_counts[replica_id] = count
                if count >= self.misses:
                    self.membership.mark_dead(
                        replica_id,
                        f"heartbeat missed x{count}",
                    )
                continue
            self._miss_counts[replica_id] = 0
            self.membership.mark_alive(replica_id)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.beat_once()
            except Exception:  # noqa: BLE001 — the monitor must survive
                logger.exception("heartbeat round failed")
