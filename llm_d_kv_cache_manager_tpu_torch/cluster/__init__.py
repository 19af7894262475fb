"""Replicated, consistent-hash-sharded index service.

The single-process indexer is fast, durable, and observable — and a
SPOF.  This package turns it into an N-replica service (the
inter-process analogue of the striped ``InMemoryIndex``):

* :mod:`ring` — deterministic, versioned rendezvous hashing over
  block-key space; adding/removing one replica moves ~1/N keys, never a
  full reshuffle.
* :mod:`remote_index` — an :class:`~..kvcache.kvblock.index.Index`
  implementation satisfying the existing ``lookup_chain`` /
  ``add_entries_batch`` / ``dump_entries`` contract that fans chunked
  lookups out to owner replicas (one RPC round per owner per chunk), so
  the read-path fast lane, score memo, analytics ledger, and tiering
  feed all work unchanged.
* :mod:`replica` — the replica-side apply surface (the RPC method
  table over a local backend, with a post-apply journal tap) plus the
  local and HTTP transports.
* :mod:`replication` — followers warm-sync from a primary's snapshot
  boundary and stay current by tailing its journal segments
  (``persistence.journal.tail``), so a killed replica's slice fails
  over to warm state with a bounded hit-rate dip.
* :mod:`membership` — static replica config + heartbeat health; a
  missed-heartbeat replica is removed from the ring (version bump,
  failover counter) and its keys route to their rendezvous runner-up.
* :mod:`ingest` — replica-local ingestion: the pod fleet's event
  streams are sliced over the same ring (pod-id rendezvous), each
  replica subscribing to only its slice, so write throughput scales
  with the replica count; ring bumps re-slice and takeover pods are
  resynced (docs/event-plane.md).

See docs/replication.md for the topology and the failover state
machine; ``CLUSTER_*`` env wiring lives in ``api/http_service.py``.

Copied from the JAX reference's ``cluster/__init__.py``, with the same names.
The ``CLUSTER_*`` environment wiring of the reference's HTTP service waits
for the port's ``api/`` (ROADMAP.md, Queue A).
"""

from llm_d_kv_cache_manager_tpu_torch.cluster.harness import (  # noqa: F401
    LocalCluster,
)
from llm_d_kv_cache_manager_tpu_torch.cluster.ingest import (  # noqa: F401
    ReplicaIngestor,
    pod_owner,
    pod_slice_key,
    slice_pods,
)
from llm_d_kv_cache_manager_tpu_torch.cluster.membership import (  # noqa: F401
    ClusterMembership,
    HeartbeatMonitor,
)
from llm_d_kv_cache_manager_tpu_torch.cluster.remote_index import (  # noqa: F401
    RemoteIndex,
)
from llm_d_kv_cache_manager_tpu_torch.cluster.replica import (  # noqa: F401
    ClusterReplica,
    HttpReplicaTransport,
    LocalReplicaTransport,
    ReplicaError,
    ReplicaUnavailable,
)
from llm_d_kv_cache_manager_tpu_torch.cluster.replication import (  # noqa: F401
    ReplicationFollower,
    standby_record_filter,
)
from llm_d_kv_cache_manager_tpu_torch.cluster.ring import HashRing  # noqa: F401
