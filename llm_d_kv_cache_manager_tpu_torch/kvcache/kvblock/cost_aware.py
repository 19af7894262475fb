"""Cost-aware (byte-budgeted) in-memory index.

Capability parity with the reference's ristretto-backed backend
(pkg/kvcache/kvblock/cost_aware_memory.go): instead of bounding the *count*
of keys, bound the approximate *bytes* resident, evicting
least-recently-used keys until under budget.  Default budget 2 GiB.

Copied from the JAX reference's ``kvcache/kvblock/cost_aware.py``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Set, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import (
    CostAwareIndexConfig,
    Index,
    PodEntry,
)
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder, victim
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("kvcache.cost_aware")

# Fixed per-entry overheads (dict slots, key ints, bookkeeping).  These are
# estimates in the same spirit as the reference's per-entry cost model
# (cost_aware_memory.go:125-157); exactness is not required, stability is.
_KEY_OVERHEAD = 64
_POD_ENTRY_OVERHEAD = 48


def _entry_cost(entry: PodEntry) -> int:
    return (
        _POD_ENTRY_OVERHEAD
        + len(entry.pod_identifier.encode())
        + len(entry.device_tier.encode())
    )


class CostAwareMemoryIndex(Index):
    def __init__(self, config: Optional[CostAwareIndexConfig] = None) -> None:
        self.config = config or CostAwareIndexConfig()
        # Leaf of the lock hierarchy: nothing else is acquired while
        # held (the watchdog asserts that under the storm tests).
        self._lock = lockorder.tracked(
            threading.Lock(), "CostAwareMemoryIndex._lock"
        )
        # request_key -> OrderedDict[PodEntry, cost]; outer dict is LRU.
        self._data: "OrderedDict[int, OrderedDict]" = OrderedDict()  # guarded-by: _lock
        self._engine_to_request: Dict[int, int] = {}  # guarded-by: _lock
        self._request_to_engines: Dict[int, Set[int]] = {}  # guarded-by: _lock
        self._cost = 0  # guarded-by: _lock

    @property
    def resident_cost_bytes(self) -> int:
        with self._lock:
            return self._cost

    def _evict_to_budget_locked(self) -> None:
        policy = self.config.eviction_policy
        while self._cost > self.config.max_cost_bytes and self._data:
            if policy is None:
                # The parity oracle: pristine pop-LRU-first, exactly
                # the pre-tiering eviction order (docs/tiering.md).
                key, pods = self._data.popitem(last=False)
            else:
                key = self._select_victim_locked(policy)
                pods = self._data.pop(key)
            self._cost -= _KEY_OVERHEAD + sum(pods.values())
            for engine_key in self._request_to_engines.pop(key, ()):  # type: ignore[arg-type]
                self._engine_to_request.pop(engine_key, None)

    def _select_victim_locked(self, policy) -> int:
        """Predictive victim selection over an LRU-ordered sample.

        The policy ranks ``(key, byte-cost)`` pairs against its own
        immutable snapshot (no locks taken under ours); the shared
        guard (utils/victim.py) bounds-checks the answer and falls
        back to the LRU-first victim on any policy failure."""
        sample = []
        limit = victim.sample_limit(policy)
        for key in self._data:  # insertion order == LRU order
            pods = self._data[key]
            sample.append((key, _KEY_OVERHEAD + sum(pods.values())))
            if len(sample) >= limit:
                break
        return sample[victim.guarded_select(policy, sample, logger)][0]

    def _admit_locked(
        self, request_key: int, entries: Sequence[PodEntry]
    ) -> None:
        """Shared admission path for add() and restore_entries():
        get-or-create the key's pod map, charge per-entry costs,
        refresh recency, and trim to pod_cache_size — the single place
        the cost accounting lives, so live adds and recovery restores
        can never drift apart."""
        pods = self._data.get(request_key)
        if pods is None:
            pods = OrderedDict()
            self._data[request_key] = pods
            self._cost += _KEY_OVERHEAD
        else:
            self._data.move_to_end(request_key)
        for entry in entries:
            if entry not in pods:
                cost = _entry_cost(entry)
                pods[entry] = cost
                self._cost += cost
            else:
                pods.move_to_end(entry)
        # Bound pods per key like the in-memory backend.
        while len(pods) > self.config.pod_cache_size:
            _, cost = pods.popitem(last=False)
            self._cost -= cost

    def lookup(
        self,
        request_keys: Sequence[int],
        pod_identifier_set: Optional[Set[str]] = None,
    ) -> Dict[int, List[PodEntry]]:
        if not request_keys:
            raise ValueError("no request keys provided for lookup")
        result: Dict[int, List[PodEntry]] = {}
        with self._lock:
            for key in request_keys:
                pods = self._data.get(key)
                if pods is None:
                    continue
                self._data.move_to_end(key)
                if not pods:
                    return result
                selected = [
                    p
                    for p in pods
                    if not pod_identifier_set
                    or p.pod_identifier in pod_identifier_set
                ]
                if selected:
                    result[key] = selected
        return result

    def add(
        self,
        engine_keys: Sequence[int],
        request_keys: Sequence[int],
        entries: Sequence[PodEntry],
    ) -> None:
        if not engine_keys or not request_keys or not entries:
            raise ValueError("no keys or entries provided for add")
        if len(engine_keys) != len(request_keys):
            raise ValueError("engine/request key length mismatch")

        with self._lock:
            for engine_key, request_key in zip(engine_keys, request_keys):
                self._engine_to_request[engine_key] = request_key
                self._request_to_engines.setdefault(request_key, set()).add(
                    engine_key
                )
                self._admit_locked(request_key, entries)
            self._evict_to_budget_locked()

    def evict(self, engine_key: int, entries: Sequence[PodEntry]) -> None:
        if not entries:
            raise ValueError("no entries provided for eviction")
        with self._lock:
            request_key = self._engine_to_request.get(engine_key)
            if request_key is None:
                return
            pods = self._data.get(request_key)
            if pods is None:
                self._engine_to_request.pop(engine_key, None)
                return
            for entry in entries:
                cost = pods.pop(entry, None)
                if cost is not None:
                    self._cost -= cost
            if not pods:
                del self._data[request_key]
                self._cost -= _KEY_OVERHEAD
                for ek in self._request_to_engines.pop(request_key, ()):
                    self._engine_to_request.pop(ek, None)

    def get_request_key(self, engine_key: int) -> int:
        with self._lock:
            request_key = self._engine_to_request.get(engine_key)
        if request_key is None:
            raise KeyError(f"engine key not found: {engine_key:#x}")
        return request_key

    def dump_entries(
        self,
    ) -> Tuple[List[Tuple[int, List[PodEntry]]], List[Tuple[int, int]]]:
        with self._lock:
            block_entries = [
                (request_key, list(pods))
                for request_key, pods in self._data.items()
            ]
            engine_map = list(self._engine_to_request.items())
        return block_entries, engine_map

    def restore_entries(
        self,
        block_entries: Sequence[Tuple[int, Sequence[PodEntry]]],
        engine_map: Sequence[Tuple[int, int]],
    ) -> int:
        restored = 0
        with self._lock:
            for request_key, entries in block_entries:
                if not entries:
                    continue
                self._admit_locked(request_key, entries)
                restored += 1
            for engine_key, request_key in engine_map:
                self._engine_to_request[engine_key] = request_key
                self._request_to_engines.setdefault(request_key, set()).add(
                    engine_key
                )
            self._evict_to_budget_locked()
        return restored

    def purge_pod(self, pod_identifier: str) -> int:
        removed = 0
        with self._lock:
            for request_key in list(self._data):
                pods = self._data[request_key]
                victims = [
                    entry
                    for entry in pods
                    if entry.pod_identifier == pod_identifier
                ]
                for entry in victims:
                    self._cost -= pods.pop(entry)
                removed += len(victims)
                if not pods:
                    del self._data[request_key]
                    self._cost -= _KEY_OVERHEAD
                    for ek in self._request_to_engines.pop(
                        request_key, ()
                    ):
                        self._engine_to_request.pop(ek, None)
        return removed
