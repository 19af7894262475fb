"""Replica-local ingestion: each replica subscribes to its pod slice.

Single-process ingestion funnels every pod's KVEvent stream through
ONE poller pool + ONE apply pool — fleet write throughput is capped by
one process however many replicas serve reads.  Replica-local
ingestion splits the *subscription* plane the same way the cluster splits
the index: the pod fleet is sliced over the alive ring (a deterministic
``pod -> replica`` rendezvous assignment, independent of the
block-key slicing reads use), and each replica runs its own poller
pool + kvevents pool over ONLY the pods it owns.  Aggregate ingest
throughput then scales with the replica count instead of one
process's ceiling (docs/event-plane.md has the topology diagram).

Correctness invariants:

* **Slicing is deterministic and process-independent** — FNV-64a of
  the pod id through the same rendezvous ring every replica computes
  (never Python's seeded ``hash()``), so N ingestors partition the
  fleet with no coordination: every pod has exactly one owner per
  ring version.
* **Applies route by KEY, not by slicer**: an ingestor digests its
  pods' events into whatever ``Index`` it was built over — in a
  cluster that is the ``RemoteIndex`` view, which routes each block
  key to the key's owner replica.  Pod-slicing the subscriptions and
  key-slicing the applies compose; routing truth is identical to the
  single-process pipeline (the cluster parity oracle stays
  bit-identical).
* **Ring version bumps re-slice subscriptions**: a
  :class:`~.membership.ClusterMembership` listener re-partitions the
  known fleet on every failover/rejoin.  Pods GAINED in a re-slice
  are resynced through the normal anti-entropy path (purge + inventory
  re-apply, ordered in the pod's shard lane, purge journaled before
  the re-applied claims — no purge-resurrection), because events
  published while nobody owned the pod are gone exactly like a seq
  gap's losses.
* **Gap/fairness/journal semantics are per replica**: each ingestor
  owns its channels' seq trackers, its pool's shard lanes and
  budgets, and its journal tap — the same contracts as the
  single-process plane, replicated N times over disjoint pod sets.
* **Event traces cross the replica boundary**: a sampled
  ``kvevents.message`` trace rides the pool worker into the
  ``RemoteIndex`` apply, whose per-owner RPCs record ``cluster.rpc``
  spans and stitch the replica-side ``replica.apply`` summaries off
  the wire — the ingest pipeline's write fan-out is attributable
  per owner exactly like the read path's
  (docs/observability.md "Fleet tracing").

Copied from the JAX reference's ``cluster/ingest.py``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from llm_d_kv_cache_manager_tpu_torch.cluster.membership import (
    ClusterMembership,
)
from llm_d_kv_cache_manager_tpu_torch.cluster.ring import HashRing
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    fnv1a_64,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.resync import ResyncManager
from llm_d_kv_cache_manager_tpu_torch.kvevents.subscriber_manager import (
    SubscriberManager,
)
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("cluster.ingest")

# Subscription (de)registration happens under the ingestor lock so a
# concurrent re-slice and reconciler update cannot interleave into a
# doubly-owned or orphaned pod; the registry/attach locks below it are
# flag-flip cheap.
# kvlint: lock-order: ReplicaIngestor._lock < SubscriberManager._lock
lockorder.declare_order(
    "ReplicaIngestor._lock", "SubscriberManager._lock"
)


def pod_slice_key(pod_identifier: str) -> int:
    """Deterministic 64-bit slicing key for a pod id.

    FNV-64a over the identifier bytes — the same process-independent
    hash family the block chain uses, so every replica (and the
    bench's subprocess ingestors) computes the identical pod
    partition whatever its ``PYTHONHASHSEED``."""
    return fnv1a_64(pod_identifier.encode())


def pod_owner(ring: HashRing, pod_identifier: str) -> str:
    """The replica owning ``pod_identifier``'s event stream on ``ring``."""
    return ring.owner(pod_slice_key(pod_identifier))


def slice_pods(
    ring: HashRing, replica_id: str, pods
) -> List[str]:
    """The subset of ``pods`` that ``replica_id`` owns on ``ring``."""
    return [
        pod for pod in pods if pod_owner(ring, pod) == replica_id
    ]


class ReplicaIngestor:
    """One replica's slice-scoped subscription registry.

    Drop-in for the surface pod discovery drives
    (``ensure_subscriber`` / ``remove_subscriber``): the reconciler
    keeps announcing the WHOLE fleet, and the ingestor subscribes its
    :class:`~..kvevents.subscriber_manager.SubscriberManager` to only
    the owned slice, remembering the rest for re-slices.  Wire a
    ``membership`` to re-slice automatically on ring version bumps, or
    drive :meth:`apply_ring` manually (static replica-mode
    deployments).
    """

    def __init__(
        self,
        replica_id: str,
        manager: SubscriberManager,
        ring: Optional[HashRing] = None,
        membership: Optional[ClusterMembership] = None,
        resync: Optional[ResyncManager] = None,
    ) -> None:
        if not replica_id:
            raise ValueError("replica_id required")
        if ring is None and membership is None:
            raise ValueError("need a ring or a membership")
        self.replica_id = replica_id
        self._manager = manager
        self._resync = resync
        self._lock = lockorder.tracked(
            threading.Lock(), "ReplicaIngestor._lock"
        )
        self._ring = ring if ring is not None else membership.ring()
        # guarded-by: _lock — everything below.
        self._known: Dict[str, Tuple[str, Optional[str]]] = {}
        self._owned: set = set()
        self._takeovers = 0
        self._reslices = 0
        if membership is not None:
            membership.add_listener(self.apply_ring)
            # A statically-configured ring (replica-mode env) may
            # predate failovers that fired before this constructor
            # ran; adopt the live alive-ring if it is newer.  Ordered
            # AFTER add_listener so a bump in the gap cannot be lost:
            # apply_ring is version-guarded, newest wins either way.
            self.apply_ring(membership.ring())

    # -- discovery surface (reconciler-compatible) ----------------------

    def ensure_subscriber(
        self,
        pod_identifier: str,
        endpoint: str,
        topic_filter: Optional[str] = None,
    ) -> bool:
        """Record the pod and subscribe iff this replica owns it.
        Returns True when a new subscription was started."""
        with self._lock:
            self._known[pod_identifier] = (endpoint, topic_filter)
            if pod_owner(self._ring, pod_identifier) != self.replica_id:
                # Not ours (any more): make sure no stale channel
                # lingers from a previous slice.
                if pod_identifier in self._owned:
                    self._owned.discard(pod_identifier)
                    self._manager.remove_subscriber(pod_identifier)
                return False
            self._owned.add(pod_identifier)
            return self._manager.ensure_subscriber(
                pod_identifier, endpoint, topic_filter
            )

    def remove_subscriber(self, pod_identifier: str) -> bool:
        """Forget the pod (it left the fleet) and drop its channel."""
        with self._lock:
            self._known.pop(pod_identifier, None)
            self._owned.discard(pod_identifier)
            return self._manager.remove_subscriber(pod_identifier)

    # -- slicing --------------------------------------------------------

    def owns(self, pod_identifier: str) -> bool:
        with self._lock:
            return (
                pod_owner(self._ring, pod_identifier) == self.replica_id
            )

    def owned_pods(self) -> List[str]:
        with self._lock:
            return sorted(self._owned)

    def known_pods(self) -> List[str]:
        with self._lock:
            return sorted(self._known)

    def active_pods(self) -> List[str]:
        """The discovery surface's prune view: the KNOWN fleet, not
        just the owned slice — the reconciler prunes pods that left
        the cluster by diffing this against its list response, and a
        departed-but-unowned pod must still be forgotten here or a
        later re-slice would resubscribe a ghost."""
        return self.known_pods()

    def apply_ring(self, ring: HashRing) -> None:
        """Re-slice the known fleet onto ``ring`` (the membership
        listener).  Gained pods attach AND resync — events published
        while their previous owner was dying are lost exactly like a
        seq gap's, so their index claims are suspect until the
        anti-entropy purge + inventory re-apply lands."""
        gained: List[str] = []
        lost: List[str] = []
        with self._lock:
            if (
                ring.version == self._ring.version
                and ring.members == self._ring.members
            ):
                return  # identical ring — nothing to re-slice
            if ring.version < self._ring.version:
                # Membership notifies listeners OUTSIDE its lock, so
                # two near-simultaneous failovers can deliver their
                # rings out of order; adopting the older one would
                # leave this replica sliced on stale ownership (pods
                # unsubscribed everywhere, no takeover resync) until
                # the next bump.  Newest version wins, always.
                logger.info(
                    "replica %s ignoring stale ring v%d (have v%d)",
                    self.replica_id,
                    ring.version,
                    self._ring.version,
                )
                return
            self._ring = ring
            self._reslices += 1
            for pod, (endpoint, topic_filter) in self._known.items():
                owned_now = (
                    pod_owner(ring, pod) == self.replica_id
                )
                was_owned = pod in self._owned
                if owned_now and not was_owned:
                    self._owned.add(pod)
                    self._manager.ensure_subscriber(
                        pod, endpoint, topic_filter
                    )
                    gained.append(pod)
                elif not owned_now and was_owned:
                    self._owned.discard(pod)
                    self._manager.remove_subscriber(pod)
                    lost.append(pod)
            self._takeovers += len(gained)
        if gained or lost:
            logger.info(
                "replica %s re-sliced on ring v%d: +%d pods, -%d pods "
                "(%d owned)",
                self.replica_id,
                ring.version,
                len(gained),
                len(lost),
                len(self._owned),
            )
        if self._resync is not None:
            for pod in gained:
                self._resync.request_resync(pod)

    def status(self) -> dict:
        """The /healthz event_plane ingestion block."""
        with self._lock:
            return {
                "replica": self.replica_id,
                "ring_version": self._ring.version,
                "known_pods": len(self._known),
                "owned_pods": len(self._owned),
                "takeovers": self._takeovers,
                "reslices": self._reslices,
            }
