"""TTL cache with eviction callbacks.

Small, dependency-free equivalent of the ``ttlcache`` library the
reference's scheduler plugin uses for subscriber lifecycle
(examples/kv_cache_aware_scorer/kvcache_aware_scorer.go:126-140): every
``set`` refreshes the key's deadline, expired keys fire ``on_evict``,
and an optional background thread sweeps periodically.

Copied from the JAX reference's ``utils/ttl_cache.py``, on the port's
``lockorder``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Generic, Optional, TypeVar

from llm_d_kv_cache_manager_tpu_torch.utils import lockorder

K = TypeVar("K")
V = TypeVar("V")

# Both static KV006 and the runtime watchdog assert this: the callback
# serializer wraps the entry lock (set/_fire_eviction), never the
# other way around.
# kvlint: lock-order: TTLCache._cb_lock < TTLCache._lock
lockorder.declare_order("TTLCache._cb_lock", "TTLCache._lock")


class TTLCache(Generic[K, V]):
    def __init__(
        self,
        ttl_seconds: float,
        on_evict: Optional[Callable[[K, V], None]] = None,
    ) -> None:
        self.ttl_seconds = ttl_seconds
        self._on_evict = on_evict
        # key -> (value, deadline)
        self._entries: Dict[K, tuple] = {}  # guarded-by: _lock
        self._lock = lockorder.tracked(
            threading.Lock(), "TTLCache._lock"
        )
        # Serializes set() against expiry callbacks so a re-insert can
        # never interleave between the is-it-still-absent check and the
        # on_evict call (which would tear down the fresh state).  RLock
        # so an on_evict callback may itself call set().
        self._cb_lock = lockorder.tracked(
            threading.RLock(), "TTLCache._cb_lock"
        )
        self._sweeper: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def set(self, key: K, value: V, ttl_seconds: Optional[float] = None):
        """Insert or refresh; refreshing resets the deadline."""
        deadline = time.monotonic() + (ttl_seconds or self.ttl_seconds)
        with self._cb_lock:
            with self._lock:
                self._entries[key] = (value, deadline)

    def get(self, key: K) -> Optional[V]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            value, deadline = entry
            if deadline < time.monotonic():
                del self._entries[key]
            else:
                return value
        self._fire_eviction(key, value)
        return None

    def delete(self, key: K) -> bool:
        """Remove without firing ``on_evict`` (explicit removal, not
        expiry — mirrors ttlcache's EvictionReason distinction)."""
        with self._lock:
            return self._entries.pop(key, None) is not None

    def keys(self) -> list:
        with self._lock:
            return list(self._entries)

    def sweep(self) -> int:
        """Evict every expired key now; returns the eviction count.

        A raising ``on_evict`` must not abort the sweep (the remaining
        expired keys were already removed from the map — skipping their
        callbacks would leak whatever the callback tears down) nor kill
        the background sweeper thread.
        """
        now = time.monotonic()
        expired = []
        with self._lock:
            for key, (value, deadline) in list(self._entries.items()):
                if deadline < now:
                    del self._entries[key]
                    expired.append((key, value))
        for key, value in expired:
            try:
                self._fire_eviction(key, value)
            except Exception:  # noqa: BLE001 - callback bugs stay local
                from llm_d_kv_cache_manager_tpu_torch.utils.logging import (
                    get_logger,
                )

                get_logger("utils.ttl_cache").exception(
                    "on_evict callback failed for %r", key
                )
        return len(expired)

    def _fire_eviction(self, key: K, value: V) -> None:
        """Run ``on_evict`` outside the entry lock, skipping it if the
        key was re-inserted between removal and now — otherwise a
        concurrent ``set`` has its fresh state torn down by the stale
        eviction.  Holding ``_cb_lock`` across check+callback makes the
        skip airtight: ``set`` cannot land in between."""
        if self._on_evict is None:
            return
        with self._cb_lock:
            with self._lock:
                if key in self._entries:
                    return
            self._on_evict(key, value)

    def start_sweeper(self, interval_seconds: Optional[float] = None) -> None:
        """Spawn the periodic cleaner (idempotent)."""
        if self._sweeper is not None:
            return
        interval = interval_seconds or self.ttl_seconds

        def loop() -> None:
            while not self._stop.wait(interval):
                self.sweep()

        # gil-atomic: lifecycle ref; start/close are control-plane
        self._sweeper = threading.Thread(
            target=loop, name="kvtpu-ttl-sweeper", daemon=True
        )
        self._sweeper.start()

    def stop_sweeper(self) -> None:
        self._stop.set()
        if self._sweeper is not None:
            self._sweeper.join(timeout=5)
            # gil-atomic: lifecycle ref; start/close are control-plane
            self._sweeper = None
        self._stop.clear()

    def close(self) -> None:
        """Canonical shutdown: stop the sweeper thread (idempotent).

        Callers that only ever used :meth:`stop_sweeper` keep working;
        owners tearing a subsystem down get the conventional name (and
        KV008's reachable-closer check keys on it).
        """
        self.stop_sweeper()
