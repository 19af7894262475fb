"""KV-block index contract and backend factory.

The index answers one question fast: *which pods hold which KV blocks, on
which memory tier?*  It is written by the KVEvents ingestion pool and read
by the scoring path.

Dual-key design (the subtle core, reference pkg/kvcache/kvblock/index.go and
pool.go:272-292): *engine keys* are whatever hashes an engine pod reports —
possibly seeded differently or sha256-truncated — while *request keys* are
recomputed locally from the event's token IDs with the indexer's own hash
chain.  Lookups from prompts produce request keys, so routing works
regardless of per-engine hash configuration; the engine->request mapping
exists so evictions (which carry engine keys) can find the entry.

TPU tier vocabulary: events from TPU pods carry ``Medium`` in
{"hbm", "host", "shared_storage"}; GPU-era names ("gpu", "cpu") are accepted
for wire compatibility and mapped by the scorer's weight table.

Copied from the JAX reference's ``kvcache/kvblock/index.py``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    EMPTY_BLOCK_HASH,
)

__all__ = [
    "EMPTY_BLOCK_HASH",
    "PodEntry",
    "Index",
    "IndexConfig",
    "InMemoryIndexConfig",
    "CostAwareIndexConfig",
    "RedisIndexConfig",
    "new_index",
]


@dataclass(frozen=True)
class PodEntry:
    """A (pod, device-tier) pair holding some KV block."""

    pod_identifier: str
    device_tier: str

    def __str__(self) -> str:
        return f"{self.pod_identifier}@{self.device_tier}"


class Index(ABC):
    """Pluggable KV-block index backend."""

    @abstractmethod
    def lookup(
        self,
        request_keys: Sequence[int],
        pod_identifier_set: Optional[Set[str]] = None,
    ) -> Dict[int, List[PodEntry]]:
        """Return pods per key, filtered to ``pod_identifier_set`` if given.

        Keys absent from the index are simply missing from the result; a key
        present with an empty pod set terminates the scan early (the prefix
        chain is broken there for every pod).
        """

    def lookup_chain(
        self, request_keys: Sequence[int]
    ) -> List[Sequence[PodEntry]]:
        """Aligned per-key pod entries for a consecutive prefix chain.

        The read-path fast lane's lookup shape: ``result[i]`` holds the
        (unfiltered) pods for ``request_keys[i]``; the walk stops at
        the first key with no resident pods, so the result may be
        shorter than the input — a truncated result means the prefix
        chain is dead there for every pod.  Pod filtering happens in
        the scorer (``LongestPrefixScorer.advance``), which never
        changes scores relative to ``lookup`` + ``score`` (pinned by
        the fast-lane parity tests).  Backends may override with a
        dict-free implementation; this default adapts :meth:`lookup`.
        """
        found = self.lookup(request_keys, None)
        out: List[Sequence[PodEntry]] = []
        for key in request_keys:
            pods = found.get(key)
            if not pods:
                break
            out.append(pods)
        return out

    @abstractmethod
    def add(
        self,
        engine_keys: Sequence[int],
        request_keys: Sequence[int],
        entries: Sequence[PodEntry],
    ) -> None:
        """Record that ``entries`` hold the blocks named by the key pairs."""

    @abstractmethod
    def evict(self, engine_key: int, entries: Sequence[PodEntry]) -> None:
        """Remove ``entries`` from the block named by ``engine_key``."""

    @abstractmethod
    def get_request_key(self, engine_key: int) -> int:
        """Map an engine key to its request key.

        Raises ``KeyError`` if the mapping is missing (e.g. already
        evicted).
        """

    @abstractmethod
    def dump_entries(
        self,
    ) -> Tuple[List[Tuple[int, List[PodEntry]]], List[Tuple[int, int]]]:
        """Serialize the index for a persistence snapshot.

        Returns ``(block_entries, engine_map)``: ``block_entries`` is
        ``[(request_key, [PodEntry, ...]), ...]`` and ``engine_map`` is
        ``[(engine_key, request_key), ...]``.  Both are ordered
        least-recently-used first so a capacity-bounded
        :meth:`restore_entries` re-evicts the same victims the live
        index would have.  The dump is a point-in-time snapshot taken
        under the backend's own locking discipline; concurrent writers
        may land either side of it (the persistence journal covers the
        gap — see ``persistence/``).

        Durable backends (Redis/Valkey) answer too — a SCAN-walked
        dump in server iteration order (no recency available) — so
        replica-duty surfaces (cluster parity, follower bootstrap, the
        index auditor) see one contract; snapshotting a durable server
        through the file layer is still usually redundant
        (docs/persistence.md).
        """

    @abstractmethod
    def restore_entries(
        self,
        block_entries: Sequence[Tuple[int, Sequence[PodEntry]]],
        engine_map: Sequence[Tuple[int, int]],
    ) -> int:
        """Load a :meth:`dump_entries` dump; returns block keys restored.

        Applies the dump through the backend's normal admission path, so
        capacity/budget bounds hold (an oversized dump is truncated by
        the same LRU policy as live traffic; Redis defers to the
        server's own maxmemory policy).  Safe on a non-empty index:
        restoring an entry that already exists is idempotent.
        """

    @abstractmethod
    def purge_pod(self, pod_identifier: str) -> int:
        """Drop every entry for one pod; returns entries removed.

        Administrative recovery operation (O(index size); not a hot
        path): when a pod dies or its event stream gaps badly, its
        stale entries keep attracting traffic until LRU churn clears
        them — the reference simply lets them linger.  Keys whose pod
        set empties are removed entirely so they cannot break other
        pods' prefix chains at lookup.  Engine-key mappings may
        linger, exactly as after an LRU eviction.
        """


@dataclass
class InMemoryIndexConfig:
    # Maximum number of block keys resident; TODO memory-based sizing.
    size: int = 100_000_000
    # Maximum pod entries tracked per key.
    pod_cache_size: int = 10
    # Lock stripes for the request-key map (rounded up to a power of
    # two).  Concurrent scoring reads and kvevents applies touching
    # different shards never share a lock; capacity is budgeted per
    # shard, so the global ``size`` bound is approximate unless
    # ``shards=1`` (exact single-LRU semantics).  See
    # docs/performance.md.
    shards: int = 8


@dataclass
class CostAwareIndexConfig:
    # Approximate memory budget for the index, in bytes (default 2 GiB).
    max_cost_bytes: int = 2 * 1024 * 1024 * 1024
    pod_cache_size: int = 10
    # Predictive eviction ranking (tiering/eviction.py): an object with
    # ``select_victim(candidates, now) -> index`` and a ``sample`` size,
    # called under the index lock with an LRU-ordered (key, byte-cost)
    # sample — it must take no locks of its own (it ranks against an
    # immutable policy snapshot).  None keeps the pristine
    # pop-LRU-first path, bit-identical to pre-tiering behavior (the
    # parity oracle; docs/tiering.md).
    eviction_policy: Optional[object] = None


@dataclass
class RedisIndexConfig:
    # Accepts bare host:port or redis:// | rediss:// | valkey:// |
    # valkeys:// | unix:// URLs, with optional user:pass@ credentials and
    # /db suffix (reference: redis.go:61-119 via go-redis ParseURL).
    address: str = "127.0.0.1:6379"
    # "redis" or "valkey"; valkey:// URLs are rewritten to redis:// with the
    # same host/port (valkeys:// to rediss://).
    flavor: str = "redis"
    # TLS options for rediss:// endpoints.
    tls_ca_file: Optional[str] = None
    tls_insecure_skip_verify: bool = False


@dataclass
class IndexConfig:
    """Backend selection; priority cost-aware > redis > in-memory
    (reference: kvblock/index.go:59-105)."""

    in_memory_config: Optional[InMemoryIndexConfig] = field(
        default_factory=InMemoryIndexConfig
    )
    cost_aware_config: Optional[CostAwareIndexConfig] = None
    redis_config: Optional[RedisIndexConfig] = None
    enable_metrics: bool = False


def new_index(config: Optional[IndexConfig] = None) -> Index:
    """Build the configured index backend, optionally metrics-wrapped."""
    if config is None:
        config = IndexConfig()

    index: Index
    if config.cost_aware_config is not None:
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.cost_aware import (
            CostAwareMemoryIndex,
        )

        index = CostAwareMemoryIndex(config.cost_aware_config)
    elif config.redis_config is not None:
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.redis_index import (
            RedisIndex,
        )

        index = RedisIndex(config.redis_config)
    else:
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.in_memory import (
            InMemoryIndex,
        )

        index = InMemoryIndex(config.in_memory_config)

    if config.enable_metrics:
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.instrumented import (
            InstrumentedIndex,
        )

        index = InstrumentedIndex(index)
    return index
