"""PolicyFeed: the stable reuse-prediction contract over the ledger.

The cachestats ledger (analytics/ledger.py) already keeps a per-family
inter-arrival EWMA, the eviction signal.  This module is the contract that makes the signal
consumable by policy code (eviction ranking, the demotion worker, the
compute-or-load advisor) without coupling any of them to ledger
internals or the ``/debug/cachestats`` payload shape:

* :class:`ReusePrediction` — one family's prediction: its EWMA of
  inter-arrival seconds, when it was last seen, and how the prediction
  was derived (own history vs its cluster's);
* :class:`PolicySnapshot` — an immutable point-in-time export: block
  key -> family, family -> prediction, cluster fallbacks.  Policy code
  (which often runs under index/cache locks) reads snapshots
  **lock-free**; only :meth:`PolicyFeed.refresh` touches ledger
  stripe locks, and never while holding the feed lock;
* :class:`PolicyFeed` — the live side: the scoring path calls
  :meth:`observe_chain` after each sampled request (outside index
  locks) so the feed learns which block keys belong to which family,
  and which coarse cluster each family belongs to.

Clustering (the HashEvict adaptation, PAPERS.md): chained block keys
ARE locality-sensitive hashes of the token prefix — two prompts share
a chain key iff they share every token up to it — so the key at block
``cluster_blocks - 1`` (coarser than the family key at
``family_blocks - 1``) clusters similar prefixes with zero extra
hashing and without storing token text.  A family seen only once has
no EWMA of its own; its cluster's EWMA is the fallback prediction, so
brand-new variants of a hot prefix inherit the family-of-families
rhythm instead of looking cold.

Key-space agnosticism: the feed never hashes anything itself — callers
observe whatever chain they score with (the indexer feeds request
keys; an engine-side user can feed its own engine hashes; the demotion
worker registers offload file hashes via :meth:`observe_keys`).  All
keys in one feed must share a key space, which the single-writer
wiring guarantees.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("tiering.policy_feed")

DEFAULT_CLUSTER_BLOCKS = 2
DEFAULT_KEY_MAP_SIZE = 65536
DEFAULT_MAX_CLUSTERS = 4096
DEFAULT_MAX_FAMILIES = 8192

# Same smoothing as the ledger's family EWMA (analytics/ledger.py):
# the last ~6-7 arrivals dominate.
EWMA_ALPHA = 0.3

# The feed lock is a leaf: observe() does dict surgery only, and
# refresh() pulls the ledger BEFORE taking it (never nested).
# kvlint: lock-order: PolicyFeed._lock ascending
lockorder.declare_ascending("PolicyFeed._lock")


@dataclass(frozen=True)
class ReusePrediction:
    """One family's reuse forecast at a point in time."""

    family: int
    # EWMA of seconds between consecutive encounters.
    predicted_interarrival_s: float
    # time.monotonic() of the last encounter.
    last_seen: float
    # Encounters contributing ("family" source) or the cluster's count.
    requests: int
    # "family" = the family's own history; "cluster" = inherited from
    # its coarse-prefix cluster (the family was seen < 2 times).
    source: str = "family"

    def expected_next_use_s(self, now: float) -> float:
        """Seconds until the predicted next encounter.

        ``last_seen + ewma - now`` while the family is inside its
        rhythm; once overdue, the estimate backs off linearly — the
        longer a family stays silent past its own rhythm, the farther
        away (more likely never) its next use:
        ``max(last_seen + ewma - now, (now - last_seen) - ewma)``.
        Always >= 0 only at the exact due instant; callers clamp if
        they need non-negative values.
        """
        idle = now - self.last_seen
        ewma = self.predicted_interarrival_s
        return max(ewma - idle, idle - ewma)


@dataclass
class PolicyFeedConfig:
    # Coarse-prefix cluster identity: the chain key at this block - 1.
    # Must be <= the ledger's family_blocks for the containment to hold.
    cluster_blocks: int = DEFAULT_CLUSTER_BLOCKS
    # LRU bound on the block-key -> family map.
    key_map_size: int = DEFAULT_KEY_MAP_SIZE
    # LRU bound on tracked clusters.
    max_clusters: int = DEFAULT_MAX_CLUSTERS
    # LRU bound on the family -> cluster map (and so on snapshot
    # prediction size); sized past the ledger's own family LRU
    # (CACHESTATS_MAX_FAMILIES, default 4096) so the two evict in
    # roughly the same working set.
    max_families: int = DEFAULT_MAX_FAMILIES


class _ClusterStats:
    __slots__ = ("last_seen", "ewma_interarrival_s", "requests")

    def __init__(self, now: float) -> None:
        self.last_seen = now
        self.ewma_interarrival_s: Optional[float] = None
        self.requests = 1


class PolicySnapshot:
    """Immutable export of the feed + ledger state.

    Built by :meth:`PolicyFeed.refresh`; consumers hold a reference and
    read without any lock (the dicts are never mutated after
    construction).  ``expected_next_use_s`` is the one call policy code
    makes per candidate: key -> family -> prediction, with the cluster
    fallback applied at refresh time.
    """

    __slots__ = ("at", "key_family", "predictions")

    def __init__(
        self,
        at: float,
        key_family: Dict[int, int],
        predictions: Dict[int, ReusePrediction],
    ) -> None:
        self.at = at
        self.key_family = key_family
        self.predictions = predictions

    def family_of(self, key: int) -> Optional[int]:
        return self.key_family.get(key)

    def prediction_for_key(self, key: int) -> Optional[ReusePrediction]:
        family = self.key_family.get(key)
        if family is None:
            return None
        return self.predictions.get(family)

    def expected_next_use_s(
        self, key: int, now: Optional[float] = None
    ) -> Optional[float]:
        """Predicted seconds until the block named by ``key`` is needed
        again; None when the key's family (or its prediction) is
        unknown."""
        prediction = self.prediction_for_key(key)
        if prediction is None:
            return None
        if now is None:
            now = time.monotonic()
        return prediction.expected_next_use_s(now)

    def stats(self) -> dict:
        return {
            "keys_mapped": len(self.key_family),
            "families_predicted": len(self.predictions),
            "age_s": round(time.monotonic() - self.at, 3),
        }


_EMPTY_SNAPSHOT = PolicySnapshot(at=0.0, key_family={}, predictions={})


class PolicyFeed:
    """Live observation surface + snapshot factory.

    One feed per key space.  ``observe_chain`` is the per-request hook
    (called by the indexer after scoring, outside index locks, only
    for ledger-sampled requests — the feed's learning rate follows
    ``CACHESTATS_SAMPLE_RATE``); ``refresh`` is the periodic bulk
    export (called by the engine's throttle or the demotion worker's
    cycle, never per request).
    """

    def __init__(
        self,
        ledger=None,
        config: Optional[PolicyFeedConfig] = None,
    ) -> None:
        self.config = config or PolicyFeedConfig()
        if self.config.cluster_blocks <= 0:
            raise ValueError("cluster_blocks must be positive")
        self._ledger = ledger
        self._lock = lockorder.tracked(
            threading.Lock(), "PolicyFeed._lock"
        )
        # Insertion order == recency (move-to-end on repeat), the
        # ledger-stripe LRU idiom.
        self._key_family: Dict[int, int] = {}  # guarded-by: _lock
        self._family_cluster: Dict[int, int] = {}  # guarded-by: _lock
        self._clusters: Dict[int, _ClusterStats] = {}  # guarded-by: _lock
        self._observed = 0  # guarded-by: _lock
        # Latest snapshot; atomic reference swap, read lock-free.
        self._snapshot: PolicySnapshot = _EMPTY_SNAPSHOT
        self._refreshes = 0

    def bind_ledger(self, ledger) -> None:
        """Late ledger attachment (the Indexer constructs its own
        ledger; the engine binds after)."""
        # gil-atomic: late-bind wiring; single ref store before traffic
        self._ledger = ledger

    @property
    def ledger(self):
        return self._ledger

    # -- observation (hot-ish path: once per sampled scored request) --

    def observe_chain(
        self,
        chain_keys: Sequence[int],
        family: Optional[int],
        now: Optional[float] = None,
    ) -> None:
        """Learn from one scored request's chained block keys.

        Registers every chain key under ``family`` and folds the
        arrival into the family's cluster rhythm.  ``family`` is the
        ledger's family id for the same request (``family_key``); when
        None (empty chain) nothing is learned.
        """
        if family is None or not chain_keys:
            return
        if now is None:
            now = time.monotonic()
        cluster = chain_keys[
            min(self.config.cluster_blocks, len(chain_keys)) - 1
        ]
        with self._lock:
            self._observed += 1
            self._register_keys_locked(chain_keys, family)
            # Bounded family -> cluster map: move-to-end keeps
            # insertion order == recency, oldest evicts at the cap.
            if family in self._family_cluster:
                del self._family_cluster[family]
            elif len(self._family_cluster) >= self.config.max_families:
                del self._family_cluster[next(iter(self._family_cluster))]
            self._family_cluster[family] = cluster
            stats = self._clusters.get(cluster)
            if stats is None:
                if len(self._clusters) >= self.config.max_clusters:
                    del self._clusters[next(iter(self._clusters))]
                self._clusters[cluster] = _ClusterStats(now)
            else:
                # Move-to-end keeps insertion order == recency.
                del self._clusters[cluster]
                self._clusters[cluster] = stats
                interarrival = max(0.0, now - stats.last_seen)
                stats.ewma_interarrival_s = (
                    interarrival
                    if stats.ewma_interarrival_s is None
                    else EWMA_ALPHA * interarrival
                    + (1.0 - EWMA_ALPHA) * stats.ewma_interarrival_s
                )
                stats.last_seen = now
                stats.requests += 1

    def observe_keys(self, keys: Iterable[int], family: int) -> None:
        """Register extra keys under an already-observed family (the
        demotion worker maps offload file hashes to the family whose
        blocks it is moving, so host-tier eviction can rank them)."""
        with self._lock:
            self._register_keys_locked(list(keys), family)

    def _register_keys_locked(
        self, keys: Sequence[int], family: int
    ) -> None:
        """Insert/refresh key -> family mappings with LRU eviction.

        Room is made only for keys NOT already mapped (re-observing an
        at-capacity map's own keys must not evict unrelated entries —
        their predictions would silently degrade to the LRU proxy);
        already-present keys just move to the recency tail."""
        key_map = self._key_family
        overflow = (
            len(key_map)
            + sum(1 for key in keys if key not in key_map)
            - self.config.key_map_size
        )
        while overflow > 0 and key_map:
            del key_map[next(iter(key_map))]
            overflow -= 1
        for key in keys:
            if key in key_map:
                del key_map[key]
            key_map[key] = family
        # Final clamp: pre-eviction can undercount when an evicted
        # oldest key is simultaneously being re-observed.
        while len(key_map) > self.config.key_map_size:
            del key_map[next(iter(key_map))]

    # -- export ----------------------------------------------------------

    def prediction(
        self, family: int, now: Optional[float] = None
    ) -> Optional[ReusePrediction]:
        """Live per-family prediction: the family's own ledger EWMA
        when it has one, else its cluster's rhythm, else None.  Takes
        one ledger stripe lock; snapshot readers should prefer
        :meth:`snapshot`."""
        if now is None:
            now = time.monotonic()
        ledger = self._ledger
        if ledger is not None:
            detail = ledger.family_detail(family, now)
            if detail is not None and detail["ewma_interarrival_s"] is not None:
                return ReusePrediction(
                    family=family,
                    predicted_interarrival_s=detail["ewma_interarrival_s"],
                    last_seen=now - detail["idle_s"],
                    requests=detail["requests"],
                    source="family",
                )
        with self._lock:
            cluster = self._family_cluster.get(family)
            stats = self._clusters.get(cluster) if cluster is not None else None
            if stats is None or stats.ewma_interarrival_s is None:
                return None
            return ReusePrediction(
                family=family,
                predicted_interarrival_s=stats.ewma_interarrival_s,
                last_seen=stats.last_seen,
                requests=stats.requests,
                source="cluster",
            )

    def refresh(self, now: Optional[float] = None) -> PolicySnapshot:
        """Build + install a fresh snapshot.

        Ledger stripe locks are taken by ``reuse_predictions()``
        BEFORE the feed lock (one at a time, never nested with it), so
        the lock graph stays a forest of leaves.
        """
        if now is None:
            now = time.monotonic()
        ledger = self._ledger
        family_rows: Sequence[Tuple[int, float, float, int]] = (
            ledger.reuse_predictions() if ledger is not None else ()
        )
        predictions: Dict[int, ReusePrediction] = {}
        for family, ewma, last_seen, requests in family_rows:
            predictions[family] = ReusePrediction(
                family=family,
                predicted_interarrival_s=ewma,
                last_seen=last_seen,
                requests=requests,
                source="family",
            )
        with self._lock:
            key_family = dict(self._key_family)
            family_cluster = dict(self._family_cluster)
            clusters = {
                cluster: (
                    stats.ewma_interarrival_s,
                    stats.last_seen,
                    stats.requests,
                )
                for cluster, stats in self._clusters.items()
            }
        # Cluster fallback resolved AT REFRESH so snapshot reads stay
        # one dict hit: families the ledger has no EWMA for (seen once,
        # or evicted from the family table) inherit their cluster's.
        for family, cluster in family_cluster.items():
            if family in predictions:
                continue
            row = clusters.get(cluster)
            if row is None or row[0] is None:
                continue
            predictions[family] = ReusePrediction(
                family=family,
                predicted_interarrival_s=row[0],
                last_seen=row[1],
                requests=row[2],
                source="cluster",
            )
        snapshot = PolicySnapshot(
            at=now, key_family=key_family, predictions=predictions
        )
        # gil-atomic: immutable snapshot swap; readers see old or new
        self._snapshot = snapshot
        # gil-atomic: stats counter; refresh is single-threaded
        self._refreshes += 1
        return snapshot

    def snapshot(self) -> PolicySnapshot:
        """Latest refreshed snapshot (possibly the empty sentinel before
        the first refresh); never blocks, never takes locks."""
        return self._snapshot

    def stats(self) -> dict:
        with self._lock:
            observed = self._observed
            keys = len(self._key_family)
            clusters = len(self._clusters)
            families = len(self._family_cluster)
        out = {
            "observed_chains": observed,
            "keys_mapped": keys,
            "families_mapped": families,
            "clusters": clusters,
            "refreshes": self._refreshes,
            "snapshot": self._snapshot.stats(),
        }
        return out
