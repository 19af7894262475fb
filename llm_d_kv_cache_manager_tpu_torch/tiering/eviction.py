"""Predictive eviction ranking: predicted-next-use x byte-cost.

The cost-aware index and the host-tier cache both evict
least-recently-used first.  Recency is a one-bit prediction ("used
recently => used again soon"); the ledger's per-family inter-arrival
EWMA is a real one — a block whose family returns every 2 seconds is
worth more than a same-cost block whose family returns hourly, however
recently the latter was touched.

Contract (what lets this run inside index locks):

* the backend hands :meth:`select_victim` a small LRU-ordered sample
  of ``(key, byte_cost)`` candidates (it already holds its own lock);
* the policy ranks them against the feed's latest immutable
  :class:`~..tiering.policy_feed.PolicySnapshot` — **no locks, no
  allocation beyond a few floats**, so the backend's lock-order leaf
  status is preserved (kvlint KV006: these backends stay leaves);
* score = ``expected_next_use_s x max(byte_cost, 1)``; the candidate
  with the **highest** score (needed farthest away, holding the most
  bytes) is evicted.  Keys the snapshot cannot predict fall back to an
  LRU-position proxy: the oldest unknown candidate gets the largest
  unknown score, so with no predictions at all the policy degrades to
  (byte-cost-weighted) LRU rather than noise.

``policy=None`` in the backends is the escape hatch AND the parity
oracle: the pristine pop-LRU-first code path runs, bit-identical to
pre-tiering behavior (tests/test_torch_tiering.py holds it).
:data:`LRU_POLICY` exercises the policy plumbing while still always
choosing the LRU-first victim — useful for asserting the plumbing
itself changes nothing.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("tiering.eviction")

DEFAULT_SAMPLE = 8
DEFAULT_UNKNOWN_NEXT_USE_S = 600.0


class LRUEvictionPolicy:
    """Escape hatch: always evicts the LRU-first candidate.

    Drives the exact same victim choice as ``policy=None`` (the
    backends' pristine pop-first path) through the policy plumbing —
    the parity oracle for the plumbing itself.
    """

    sample = 1

    def select_victim(
        self,
        candidates: Sequence[Tuple[int, int]],
        now: Optional[float] = None,
    ) -> int:
        return 0


LRU_POLICY = LRUEvictionPolicy()


class PredictiveEvictionPolicy:
    """Ranks eviction candidates by predicted-next-use x byte-cost.

    One instance per backend (its counters label a backend name); all
    instances share the engine's feed, reading whatever snapshot is
    current when an eviction happens.
    """

    def __init__(
        self,
        feed,
        backend: str = "cost_aware",
        sample: int = DEFAULT_SAMPLE,
        unknown_next_use_s: float = DEFAULT_UNKNOWN_NEXT_USE_S,
    ) -> None:
        if sample <= 0:
            raise ValueError("sample must be positive")
        self.feed = feed
        self.backend = backend
        self.sample = sample
        self.unknown_next_use_s = unknown_next_use_s
        # Racy-tolerant counters (read for /debug/tiering; increments
        # happen under the owning backend's lock, one writer at a time
        # per backend).
        self.predicted_choices = 0
        self.fallback_choices = 0
        self._predicted_child = METRICS.tiering_evictions.labels(
            backend=backend, mode="predicted"
        )
        self._fallback_child = METRICS.tiering_evictions.labels(
            backend=backend, mode="fallback_lru"
        )

    def select_victim(
        self,
        candidates: Sequence[Tuple[int, int]],
        now: Optional[float] = None,
    ) -> int:
        """Index (into ``candidates``) of the entry to evict.

        ``candidates`` are LRU-ordered (oldest first) ``(key,
        byte_cost)`` pairs.  Runs under the calling backend's lock:
        reads only the immutable snapshot, takes no locks itself.
        """
        if len(candidates) == 1:
            self.fallback_choices += 1
            self._fallback_child.inc()
            return 0
        if now is None:
            now = time.monotonic()
        snapshot = self.feed.snapshot()
        unknown_s = self.unknown_next_use_s
        n = len(candidates)
        best_index = 0
        best_score = -1.0
        any_prediction = False
        for i, (key, cost) in enumerate(candidates):
            expected = snapshot.expected_next_use_s(key, now)
            if expected is None:
                # LRU proxy: oldest unknown ranks as farthest away.
                expected = unknown_s * (n - i) / n
            else:
                any_prediction = True
                expected = max(0.0, expected)
            score = expected * max(cost, 1)
            if score > best_score:
                best_score = score
                best_index = i
        if any_prediction:
            self.predicted_choices += 1
            self._predicted_child.inc()
        else:
            self.fallback_choices += 1
            self._fallback_child.inc()
        return best_index

    def stats(self) -> dict:
        return {
            "backend": self.backend,
            "sample": self.sample,
            "unknown_next_use_s": self.unknown_next_use_s,
            "predicted_choices": self.predicted_choices,
            "fallback_choices": self.fallback_choices,
        }
