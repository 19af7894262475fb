"""Host-DRAM KV tier: the middle rung of the offload ladder.

The scorer's tier ladder is hbm(1.0) > host(0.8) > shared_storage(0.5)
(kvcache/scorer.py); this module supplies the middle tier the reference
ladder implies (backend.go:19-31 weighted gpu > cpu): offloaded block
groups stay resident in the pod's host RAM inside a byte-budgeted LRU,
so a re-admitted prefix pages back HBM<-DRAM without touching the
filesystem.  The shared-storage files remain the durable, cross-pod
medium underneath; the host tier is a per-pod read accelerator.

Thread-safe: the worker handlers insert from I/O completion threads
while the serving thread probes.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from llm_d_kv_cache_manager_tpu_torch.utils import victim

logger = logging.getLogger(__name__)

DEFAULT_BUDGET_BYTES = 1 << 30  # 1 GiB


class HostTierCache:
    """file_hash -> block-major group bytes, LRU-evicted to a budget.

    ``on_evict(file_hash)`` fires (outside the lock) whenever the LRU
    drops an entry, so the pod can retract its ``host``-tier
    advertisement (a BlockRemoved event) and the fleet index stays
    truthful about DRAM residency."""

    def __init__(
        self,
        max_bytes: int = DEFAULT_BUDGET_BYTES,
        on_evict: Optional["callable"] = None,
        eviction_policy: Optional[object] = None,
    ) -> None:
        self.max_bytes = max_bytes
        self._on_evict = on_evict
        # Pluggable eviction ranking (tiering/eviction.py's policies):
        # called under our lock with an LRU-ordered (file_hash, nbytes)
        # sample, takes no locks of its own.  None = pristine
        # pop-LRU-first (the parity oracle).
        self._eviction_policy = eviction_policy
        self._entries: "OrderedDict[int, np.ndarray]" = OrderedDict()  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        # Leaf lock: on_evict deliberately fires OUTSIDE it, so no
        # other lock is ever acquired while this one is held.
        self._lock = threading.Lock()
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def put(self, file_hash: int, group: np.ndarray) -> bool:
        """Insert/refresh a group; oldest entries fall off the budget.

        Returns False when the group exceeds the whole budget (not
        admitted) — callers must not advertise it as host-resident."""
        nbytes = group.nbytes
        if nbytes > self.max_bytes:
            return False
        evicted_hashes = []
        with self._lock:
            old = self._entries.pop(file_hash, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[file_hash] = group
            self._bytes += nbytes
            policy = self._eviction_policy
            while self._bytes > self.max_bytes:
                if policy is None:
                    evicted_hash, evicted = self._entries.popitem(
                        last=False
                    )
                else:
                    evicted_hash = self._select_victim_locked(
                        policy, file_hash
                    )
                    evicted = self._entries.pop(evicted_hash)
                self._bytes -= evicted.nbytes
                evicted_hashes.append(evicted_hash)
        if self._on_evict is not None:
            for evicted_hash in evicted_hashes:
                self._on_evict(evicted_hash)
        return True

    def _select_victim_locked(self, policy, incoming_hash: int) -> int:
        """Predictive victim over an LRU-ordered sample; the group
        just inserted is never its own victim (the budget loop would
        livelock admitting and evicting the same entry).  The shared
        guard (utils/victim.py) bounds-checks the policy's answer and
        falls back to the LRU-first victim on any failure."""
        sample = []
        limit = victim.sample_limit(policy)
        for file_hash, group in self._entries.items():
            if file_hash == incoming_hash:
                continue
            sample.append((file_hash, group.nbytes))
            if len(sample) >= limit:
                break
        if not sample:
            # Only the incoming entry remains; it must go (same as the
            # pristine path when the budget cannot hold one group).
            return incoming_hash
        return sample[victim.guarded_select(policy, sample, logger)][0]

    def get(self, file_hash: int) -> Optional[np.ndarray]:
        """Fetch + refresh recency; None on miss."""
        with self._lock:
            group = self._entries.get(file_hash)
            if group is None:
                self.misses += 1
                return None
            self._entries.move_to_end(file_hash)
            self.hits += 1
            return group

    def contains(self, file_hash: int) -> bool:
        with self._lock:
            return file_hash in self._entries

    def lookup_consecutive(self, file_hashes: List[int]) -> int:
        """Length of the resident consecutive prefix (manager-side
        probe, mirroring the file-existence lookup)."""
        count = 0
        with self._lock:
            for file_hash in file_hashes:
                if file_hash not in self._entries:
                    break
                count += 1
        return count

    def evict(self, file_hash: int) -> bool:
        with self._lock:
            group = self._entries.pop(file_hash, None)
            if group is None:
                return False
            self._bytes -= group.nbytes
            return True

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
            }
