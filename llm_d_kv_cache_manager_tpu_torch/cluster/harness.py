"""In-process cluster harness: N replicas + membership + replication.

One constructor for every consumer that wants a real cluster without
processes: the contract-parity tests, the parity oracle, the
``replica_scaleout`` bench regime, and ``chip_smoke.py``.  The
replicas are genuine :class:`~.replica.ClusterReplica` instances (own
``InMemoryIndex`` slice, own journal directory) wired through
:class:`~.replica.LocalReplicaTransport` — the same method table the
HTTP endpoint serves, so nothing here is test-only behavior.

With ``journal_root`` set, every replica journals its applied ops and
runs one :class:`~.replication.ReplicationFollower` per peer, filtered
to its standby slice; ``sync_followers()`` drains every follower once
(deterministic alternative to the background threads).  ``kill()``
makes a replica's transport refuse calls — the next heartbeat (or the
first routed call that hits it) removes it from the ring and its slice
fails over warm.

Copied from the JAX reference's ``cluster/harness.py``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.cluster.membership import (
    ClusterMembership,
    HeartbeatMonitor,
)
from llm_d_kv_cache_manager_tpu_torch.cluster.remote_index import RemoteIndex
from llm_d_kv_cache_manager_tpu_torch.cluster.replica import (
    ClusterReplica,
    LocalReplicaTransport,
)
from llm_d_kv_cache_manager_tpu_torch.cluster.replication import (
    ReplicationFollower,
    standby_record_filter,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.in_memory import (
    InMemoryIndex,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import (
    InMemoryIndexConfig,
)
from llm_d_kv_cache_manager_tpu_torch.persistence.journal import Journal


class LocalCluster:
    """See module docstring."""

    def __init__(
        self,
        replica_ids: Sequence[str] = ("replica-0", "replica-1", "replica-2"),
        journal_root: Optional[str] = None,
        index_config: Optional[InMemoryIndexConfig] = None,
        strict_wire: bool = False,
        heartbeat_interval_s: float = 0.5,
        follower_poll_s: float = 0.1,
        fanout_workers: Optional[int] = None,
        fanout_budget_s: Optional[float] = None,
        vv_ttl_s: Optional[float] = None,
        overlap_min_rpc_s: Optional[float] = None,
        transport_wrap=None,
    ) -> None:
        self.replicas: Dict[str, ClusterReplica] = {}
        self.transports: Dict[str, LocalReplicaTransport] = {}
        self.journal_dirs: Dict[str, str] = {}
        for replica_id in replica_ids:
            journal = None
            if journal_root is not None:
                directory = os.path.join(journal_root, replica_id)
                self.journal_dirs[replica_id] = directory
                journal = Journal(directory)
            replica = ClusterReplica(
                replica_id,
                index=InMemoryIndex(index_config),
                journal=journal,
            )
            self.replicas[replica_id] = replica
            self.transports[replica_id] = LocalReplicaTransport(
                replica, strict_wire=strict_wire
            )
        # transport_wrap(replica_id, transport) -> transport lets the
        # bench/chaos harnesses inject latency or faults on the wire
        # the ROUTER sees; kill()/revive() still drive the raw
        # transport underneath (shared killed-flag).
        routed = {
            replica_id: (
                transport
                if transport_wrap is None
                else transport_wrap(replica_id, transport)
            )
            for replica_id, transport in self.transports.items()
        }
        self.membership = ClusterMembership(routed)
        self.remote_index = RemoteIndex(
            self.membership,
            fanout_workers=fanout_workers,
            fanout_budget_s=fanout_budget_s,
            vv_ttl_s=vv_ttl_s,
            overlap_min_rpc_s=overlap_min_rpc_s,
        )
        self.heartbeat = HeartbeatMonitor(
            self.membership, interval_s=heartbeat_interval_s
        )
        self.followers: List[ReplicationFollower] = []
        if journal_root is not None:
            full_ring = self.membership.full_ring
            for replica_id, replica in self.replicas.items():
                for peer_id, peer_dir in self.journal_dirs.items():
                    if peer_id == replica_id:
                        continue
                    self.followers.append(
                        ReplicationFollower(
                            peer_id,
                            peer_dir,
                            replica.index,
                            record_filter=standby_record_filter(
                                full_ring, replica_id
                            ),
                            poll_interval_s=follower_poll_s,
                            # The peer's stream is authoritative for
                            # its primary slice only: its purges must
                            # not touch this replica's own slice.
                            purge_scope=(
                                lambda key, peer=peer_id: (
                                    full_ring.owner(key) == peer
                                )
                            ),
                        )
                    )

    # -- lifecycle ------------------------------------------------------

    def start(self, heartbeat: bool = True, followers: bool = True) -> None:
        if heartbeat:
            self.heartbeat.start()
        if followers:
            for follower in self.followers:
                follower.start()

    def close(self) -> None:
        self.heartbeat.close()
        self.remote_index.close()
        for follower in self.followers:
            follower.close()
        for transport in self.transports.values():
            transport.close()
        for replica in self.replicas.values():
            replica.close()

    # -- deterministic steps (no sleep-polling in tests) ----------------

    def sync_followers(self) -> int:
        """Drain every follower once; returns records read in total."""
        return sum(f.sync_once() for f in self.followers)

    def kill(self, replica_id: str, notice: bool = True) -> None:
        """Down a replica's transport; with ``notice`` the membership
        learns immediately (otherwise the next heartbeat or routed
        call discovers it)."""
        self.transports[replica_id].kill()
        if notice:
            self.membership.mark_dead(replica_id, "killed")

    def status(self) -> dict:
        """The /debug/cluster payload for an in-process cluster."""
        return {
            "membership": self.membership.status(),
            "replication": [f.status() for f in self.followers],
            "rpc": self.remote_index.rpc_stats(),
        }
