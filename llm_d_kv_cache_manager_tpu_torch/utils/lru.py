"""Thread-safe LRU cache used by the index and prefix-store backends.

Capability parity with the hashicorp/golang-lru caches the reference builds
on (reference: pkg/kvcache/kvblock/in_memory.go:24,
pkg/tokenization/prefixstore/lru_store.go:26) — but implemented on
``OrderedDict`` with a single lock, which is the idiomatic CPython shape.
Copied from the JAX reference's ``utils/lru.py``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import (
    Callable,
    Generic,
    Hashable,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
    TypeVar,
)

from llm_d_kv_cache_manager_tpu_torch.utils import lockorder

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")

_MISSING = object()


class LRUCache(Generic[K, V]):
    """A bounded mapping that evicts the least-recently-used entry.

    ``get`` and ``put`` both refresh recency.  All operations are O(1) and
    thread-safe.  An optional ``on_evict`` callback observes capacity
    evictions (not explicit removals).
    """

    def __init__(
        self,
        capacity: int,
        on_evict: Optional[Callable[[K, V], None]] = None,
        *,
        lock_rank: Optional[int] = None,
    ) -> None:
        if capacity <= 0:
            raise ValueError(f"LRU capacity must be positive, got {capacity}")
        self._capacity = capacity
        self._data: "OrderedDict[K, V]" = OrderedDict()  # guarded-by: _lock
        # ``lock_rank`` orders instances under the lock-order watchdog
        # (utils/lockorder.py): striped owners pass their stripe index
        # so same-name nesting asserts ascending acquisition.  With the
        # watchdog off, tracked() returns the bare Lock unchanged.
        self._lock = lockorder.tracked(
            threading.Lock(), "LRUCache._lock", lock_rank
        )
        self._on_evict = on_evict

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key: K) -> bool:
        with self._lock:
            return key in self._data

    @property
    def capacity(self) -> int:
        return self._capacity

    def get(self, key: K, default: Optional[V] = None) -> Optional[V]:
        with self._lock:
            value = self._data.get(key, _MISSING)
            if value is _MISSING:
                return default
            self._data.move_to_end(key)
            return value  # type: ignore[return-value]

    def peek(self, key: K, default: Optional[V] = None) -> Optional[V]:
        """Read without refreshing recency."""
        with self._lock:
            value = self._data.get(key, _MISSING)
            return default if value is _MISSING else value  # type: ignore[return-value]

    def peek_many(
        self, keys: Sequence[K], default: Optional[V] = None
    ) -> List[Optional[V]]:
        """Batched ``peek``: ONE lock acquisition for the whole key
        list (a per-key call costs a lock round-trip each — on the
        scoring hot path a 500-block prompt chain paid 500 of them).
        No recency refresh: callers that consume only a prefix of the
        chain follow up with :meth:`touch_many` on what they used.
        ``default`` marks missing keys — pass a sentinel when the
        cache legitimately stores ``None`` values (``peek``'s own
        contract, kept for the batched form)."""
        out: List[Optional[V]] = []
        with self._lock:
            data = self._data
            for key in keys:
                value = data.get(key, _MISSING)
                out.append(default if value is _MISSING else value)
        return out

    def touch_many(self, keys: Sequence[K]) -> None:
        """Batched recency refresh for keys the caller actually
        consumed (missing keys are ignored)."""
        with self._lock:
            data = self._data
            for key in keys:
                if key in data:
                    data.move_to_end(key)

    def put(self, key: K, value: V) -> None:
        evicted: Optional[Tuple[K, V]] = None
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = value
            if len(self._data) > self._capacity:
                evicted = self._data.popitem(last=False)
        if evicted is not None and self._on_evict is not None:
            self._on_evict(*evicted)

    def put_many(self, items: Sequence[Tuple[K, V]]) -> None:
        """Batched ``put``: ONE lock acquisition for the whole item
        list (the kvevents write path inserts a key pair per block —
        a 100-block store event paid 100 lock round-trips)."""
        evicted: List[Tuple[K, V]] = []
        with self._lock:
            data = self._data
            capacity = self._capacity
            for key, value in items:
                if key in data:
                    data.move_to_end(key)
                data[key] = value
                if len(data) > capacity:
                    evicted.append(data.popitem(last=False))
        if evicted and self._on_evict is not None:
            for key, value in evicted:
                self._on_evict(key, value)

    def get_or_create_many(
        self, keys: Sequence[K], factory: Callable[[], V]
    ) -> List[V]:
        """Batched ``get``-or-``put_if_absent``: one lock round-trip
        returns the resident (or freshly created) value per key, with
        recency refreshed — the grouped-per-shard admission primitive
        of the kvevents batched apply path.  ``factory`` runs under
        the lock, so it must be cheap and side-effect-free."""
        out: List[V] = []
        evicted: List[Tuple[K, V]] = []
        with self._lock:
            data = self._data
            capacity = self._capacity
            for key in keys:
                resident = data.get(key, _MISSING)
                if resident is _MISSING:
                    resident = factory()
                    data[key] = resident
                    if len(data) > capacity:
                        evicted.append(data.popitem(last=False))
                else:
                    data.move_to_end(key)
                out.append(resident)  # type: ignore[arg-type]
        if evicted and self._on_evict is not None:
            for key, value in evicted:
                self._on_evict(key, value)
        return out

    def put_if_absent(self, key: K, value: V) -> V:
        """Insert ``value`` unless ``key`` exists; return the resident value.

        The atomic check-and-set the reference approximates with
        double-checked locking (in_memory.go:183-197) is a single locked
        operation here.
        """
        evicted: Optional[Tuple[K, V]] = None
        with self._lock:
            resident = self._data.get(key, _MISSING)
            if resident is not _MISSING:
                self._data.move_to_end(key)
                result = resident
            else:
                self._data[key] = value
                result = value
                if len(self._data) > self._capacity:
                    evicted = self._data.popitem(last=False)
        if evicted is not None and self._on_evict is not None:
            self._on_evict(*evicted)
        return result  # type: ignore[return-value]

    def remove(self, key: K) -> bool:
        with self._lock:
            return self._data.pop(key, _MISSING) is not _MISSING

    def keys(self) -> list:
        """Snapshot of keys, least-recently-used first."""
        with self._lock:
            return list(self._data.keys())

    def items(self) -> Iterator[Tuple[K, V]]:
        with self._lock:
            snapshot = list(self._data.items())
        return iter(snapshot)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
