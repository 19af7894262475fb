"""Metrics decorator for any Index backend.

Decorator-pattern instrumentation emitting admissions / evictions / lookup
counters and a lookup-latency histogram, plus the per-lookup max-hits-per-pod
gauge the scorer's telemetry relies on (capability parity:
pkg/kvcache/kvblock/instrumented_index.go).

Copied from the JAX reference's ``kvcache/kvblock/instrumented.py``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Set

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index, PodEntry
from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS


class InstrumentedIndex(Index):
    def __init__(self, inner: Index) -> None:
        self._inner = inner

    @property
    def inner(self) -> Index:
        return self._inner

    def lookup(
        self,
        request_keys: Sequence[int],
        pod_identifier_set: Optional[Set[str]] = None,
    ) -> Dict[int, List[PodEntry]]:
        METRICS.index_lookup_requests.inc()
        start = time.perf_counter()
        try:
            result = self._inner.lookup(request_keys, pod_identifier_set)
        finally:
            METRICS.index_lookup_latency.observe(time.perf_counter() - start)
        if result:
            METRICS.index_lookup_hits.inc()
            hits_per_pod: Dict[str, int] = {}
            for pods in result.values():
                for pod in pods:
                    hits_per_pod[pod.pod_identifier] = (
                        hits_per_pod.get(pod.pod_identifier, 0) + 1
                    )
            if hits_per_pod:
                METRICS.index_max_pod_hits.inc(max(hits_per_pod.values()))
        return result

    def lookup_chain(
        self, request_keys: Sequence[int]
    ) -> List[Sequence[PodEntry]]:
        # Deliberately un-instrumented: the fast lane calls this once
        # per CHUNK, and counting per call would silently inflate the
        # lookup counters relative to the straight path (one logical
        # lookup per scoring request).  The Indexer records one
        # request-granularity observation per chunked drive instead
        # (record_chain_lookup below).
        return self._inner.lookup_chain(request_keys)

    @staticmethod
    def record_chain_lookup(
        latency_s: float, max_pod_hits: int
    ) -> None:
        """One scoring request's chunked lookup, request-granular —
        the same meaning lookup() records per call: requests +1, hits
        +1 when any pod matched, total lookup latency, and the max
        per-pod hit count across the whole chain."""
        METRICS.index_lookup_requests.inc()
        METRICS.index_lookup_latency.observe(latency_s)
        if max_pod_hits:
            METRICS.index_lookup_hits.inc()
            METRICS.index_max_pod_hits.inc(max_pod_hits)

    def add(
        self,
        engine_keys: Sequence[int],
        request_keys: Sequence[int],
        entries: Sequence[PodEntry],
    ) -> None:
        self._inner.add(engine_keys, request_keys, entries)
        METRICS.index_admissions.inc(len(request_keys))

    # Batched-apply capability passthrough: kvevents/pool.py probes for
    # add_mappings/add_entries_batch with getattr, so the wrapper must
    # neither mask a backend that has them nor fake them on a backend
    # that does not — hence __getattr__ (which only fires for names NOT
    # defined on this class) instead of plain methods.

    def __getattr__(self, name: str):
        if name in (
            "add_mappings",
            "version_vector",
            "touch_chain",
            "lookup_chain_async",
            "record_speculation",
        ):
            # version_vector/touch_chain: the indexer's score memo
            # probes for the optimistic-validation surface the same
            # way (getattr), and neither needs metrics of its own.
            # lookup_chain_async/record_speculation: the pipelined
            # chunk drive probes for the async surface the same way;
            # like lookup_chain, the async variant is deliberately
            # un-instrumented — the fast lane records one
            # request-granular observation itself
            # (record_chain_lookup).
            return getattr(self._inner, name)
        if name == "add_entries_batch":
            inner_batch = getattr(self._inner, name)

            def add_entries_batch(items) -> None:
                inner_batch(items)
                METRICS.index_admissions.inc(
                    sum(len(request_keys) for request_keys, _ in items)
                )

            return add_entries_batch
        raise AttributeError(name)

    def evict(self, engine_key: int, entries: Sequence[PodEntry]) -> None:
        self._inner.evict(engine_key, entries)
        METRICS.index_evictions.inc()

    def get_request_key(self, engine_key: int) -> int:
        return self._inner.get_request_key(engine_key)

    def dump_entries(self):
        return self._inner.dump_entries()

    def restore_entries(self, block_entries, engine_map) -> int:
        restored = self._inner.restore_entries(block_entries, engine_map)
        if restored:
            METRICS.index_admissions.inc(restored)
        return restored

    def purge_pod(self, pod_identifier: str) -> int:
        removed = self._inner.purge_pod(pod_identifier)
        if removed:
            METRICS.index_evictions.inc(removed)
        return removed
