"""Pod scoring: longest consecutive resident prefix, tier-weighted.

Semantics follow the reference scorer (pkg/kvcache/kvblock_scorer.go:108-151):
starting from block 0, a pod accrues score while it appears for every
consecutive block key; the per-block increment is the maximum tier weight
among the pod's entries for that key.  Pods missing from block 0 score 0.

TPU tier weights default to HBM > host DRAM > shared storage, with the
GPU-era names accepted as aliases so mixed fleets and recorded event streams
keep scoring correctly.

Copied from the JAX reference's ``kvcache/scorer.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import PodEntry
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("kvcache.scorer")

LONGEST_PREFIX_MATCH = "longest-prefix-match"

# Tiers absent from the weight table score this (the most-valuable
# weight): unknown > known keeps new tier strings from zeroing scores
# on old deployments, at the cost of over-valuing them until the
# deployment learns the tier.  Logged once per unknown tier name —
# demotion events introduce new tier strings to fleets whose scorer
# config predates them (docs/configuration.md §Scoring).
UNKNOWN_TIER_WEIGHT = 1.0


@dataclass(frozen=True)
class TierConfig:
    """One device tier and its scoring weight."""

    name: str
    weight: float


def default_tier_configs() -> List[TierConfig]:
    """TPU memory hierarchy weights (capability parity: pkg/kvcache/
    backend.go:19-31, which weighted gpu=1.0 > cpu=0.8)."""
    return [
        TierConfig("hbm", 1.0),
        TierConfig("host", 0.8),
        TierConfig("shared_storage", 0.5),
        # GPU-era aliases for wire compatibility with existing fleets.
        TierConfig("gpu", 1.0),
        TierConfig("cpu", 0.8),
    ]


@dataclass
class ScorerConfig:
    scoring_strategy: str = LONGEST_PREFIX_MATCH
    tier_configs: List[TierConfig] = field(default_factory=default_tier_configs)


class ScoreChain:
    """Resumable longest-prefix scoring state (the fast lane's chunked
    drive): ``scores`` accumulates per-pod totals, ``active`` is the
    set of pods still alive on every consecutive block so far (``None``
    until block 0 has been fed).

    ``matched_blocks`` counts blocks on which at least one candidate
    accrued — i.e. the best pod's consecutive matched-block count, the
    analytics ledger's attribution input; always tracked (one integer
    increment per block).  Two opt-in provenance modes cost only when
    requested: ``track_tiers`` splits matched blocks by the best
    resident tier per block (the ledger's per-tier hit split) and
    ``track_deaths`` records each pod's chain-break index (the span
    attrs a traced request carries, matching ``explain``'s
    ``break_index`` exactly — both are pinned by property tests)."""

    __slots__ = ("scores", "active", "matched_blocks", "position",
                 "tier_counts", "deaths")

    def __init__(
        self, track_tiers: bool = False, track_deaths: bool = False
    ) -> None:
        self.scores: Dict[str, float] = {}
        self.active = None  # type: ignore[assignment]
        self.matched_blocks = 0
        self.position = 0  # blocks examined (including a killing block)
        self.tier_counts: Optional[Dict[str, int]] = (
            {} if track_tiers else None
        )
        self.deaths: Optional[Dict[str, int]] = (
            {} if track_deaths else None
        )

    @property
    def alive(self) -> bool:
        """True while feeding more blocks could still change scores."""
        return self.active is None or bool(self.active)

    def provenance(self) -> Dict[str, dict]:
        """Per-pod ``{blocks_matched, break_index}`` for the walked
        chain (requires ``track_deaths``): a pod that broke at block i
        matched blocks 0..i-1; survivors matched every examined block
        and carry ``break_index None`` — the same semantics as
        ``LongestPrefixScorer.explain``."""
        deaths = self.deaths if self.deaths is not None else {}
        return {
            pod: {
                "blocks_matched": deaths.get(pod, self.matched_blocks),
                "break_index": deaths.get(pod),
            }
            for pod in self.scores
        }


class LongestPrefixScorer:
    def __init__(self, tier_weights: Mapping[str, float]) -> None:
        self.tier_weights = dict(tier_weights)
        # Canonical tier name per weight, first declaration wins: with
        # the default table both "hbm" and its "gpu" alias weigh 1.0,
        # and the ledger's per-tier split normalizes aliases to the
        # canonical TPU names.  Unknown tiers resolve through the same
        # 1.0 default the scoring loops use.
        self._weight_to_tier: Dict[float, str] = {}
        for name, weight in self.tier_weights.items():
            self._weight_to_tier.setdefault(weight, name)
        self._default_tier = self._weight_to_tier.get(1.0, "other")
        # Unknown tiers warn ONCE per tier name (set adds are
        # GIL-atomic; a racy duplicate log is harmless).
        self._warned_tiers: set = set()
        # Per-snapshot weight resolution, keyed on entry-tuple IDENTITY
        # (the in-memory index hands out one cached snapshot tuple per
        # pod cache until it mutates, so steady-state requests re-see
        # the same objects).  Entries hold a strong ref to the keyed
        # object and validate with ``is`` before use, so id() reuse
        # after GC can never alias.  Bounded by wholesale clear; benign
        # under concurrent readers (single-key dict ops only).
        self._resolve_cache: Dict[int, tuple] = {}

    _RESOLVE_CACHE_MAX = 8192

    def _resolve(self, pods: Sequence[PodEntry]) -> Dict[str, float]:
        """{pod: max tier weight} over one block's entries, memoized
        per snapshot identity.  Only TUPLES are cached: the in-memory
        index hands out stable snapshot tuples that recur across
        requests, while dict-adapted backends produce fresh lists per
        request — caching those would churn the table (and pin dead
        lists) for zero hits."""
        is_tuple = type(pods) is tuple
        if is_tuple:
            cached = self._resolve_cache.get(id(pods))
            if cached is not None and cached[0] is pods:
                return cached[1]
        weights = self.tier_weights
        best: Dict[str, float] = {}
        for entry in pods:
            pod = entry.pod_identifier
            weight = weights.get(entry.device_tier)
            if weight is None:
                weight = self._unknown_tier_weight(entry.device_tier)
            prev = best.get(pod)
            if prev is None or weight > prev:
                best[pod] = weight
        if is_tuple:
            cache = self._resolve_cache
            if len(cache) >= self._RESOLVE_CACHE_MAX:
                cache.clear()
            cache[id(pods)] = (pods, best)
        return best

    def _best_entry(
        self, entries: Sequence[PodEntry], pod_id: str
    ) -> tuple:
        """(max weight, its tier) for one pod's entries on one block.
        ``explain`` resolves tiers through here; ``score``/``advance``
        resolve through ``_resolve`` — both route unknown tiers
        through the same warn-once ``_unknown_tier_weight`` fallback,
        and the explain≡score property test pins the two against
        drifting."""
        best, tier = 0.0, None
        for entry in entries:
            if entry.pod_identifier != pod_id:
                continue
            weight = self.tier_weights.get(entry.device_tier)
            if weight is None:
                weight = self._unknown_tier_weight(entry.device_tier)
            if tier is None or weight > best:
                best, tier = weight, entry.device_tier
        return best, tier

    def _unknown_tier_weight(self, tier: str) -> float:
        """Fallback for tiers absent from the weight table: score
        UNKNOWN_TIER_WEIGHT, logging once per tier name so a fleet
        rollout that introduces a new medium string is visible in the
        indexer's logs instead of silently shifting scores."""
        if tier not in self._warned_tiers:
            self._warned_tiers.add(tier)
            logger.warning(
                "unknown device tier %r in index entries: scoring with "
                "fallback weight %s; add it to ScorerConfig.tier_configs "
                "to weight it deliberately (docs/configuration.md)",
                tier,
                UNKNOWN_TIER_WEIGHT,
            )
        return UNKNOWN_TIER_WEIGHT

    def begin(
        self, track_tiers: bool = False, track_deaths: bool = False
    ) -> ScoreChain:
        return ScoreChain(
            track_tiers=track_tiers, track_deaths=track_deaths
        )

    def advance(
        self,
        chain: ScoreChain,
        pods_per_key: Sequence[Sequence[PodEntry]],
        pod_identifier_set=None,
    ) -> bool:
        """Feed the next consecutive blocks' pod entries into ``chain``.

        ``pods_per_key[i]`` holds the entries for the chain's next
        block ``i`` (in order).  Entries outside ``pod_identifier_set``
        (when given) are ignored without allocating filtered copies.
        Returns False once the prefix chain is dead for every candidate
        pod — the caller can stop hashing and looking up further
        blocks; feeding more after that is a no-op.
        """
        scores = chain.scores
        active = chain.active
        resolve = self._resolve
        tier_counts = chain.tier_counts
        deaths = chain.deaths
        weight_to_tier = self._weight_to_tier
        default_tier = self._default_tier
        start = 0
        if active is None:
            if not pods_per_key:
                return True
            # Block 0 defines the candidate set.  The pod filter only
            # needs applying here: later blocks intersect with
            # ``active``, which is already a subset of the filter.
            pods = pods_per_key[0]
            best = resolve(pods) if pods else {}
            if pod_identifier_set is not None and best:
                best = {
                    pod: weight
                    for pod, weight in best.items()
                    if pod in pod_identifier_set
                }
            scores.update(best)
            chain.active = active = set(best)
            chain.position = 1
            if not active:
                return False
            chain.matched_blocks = 1
            if tier_counts is not None:
                tier = weight_to_tier.get(
                    max(best.values()), default_tier
                )
                tier_counts[tier] = tier_counts.get(tier, 0) + 1
            start = 1
        elif not active:
            return False
        for index in range(start, len(pods_per_key)):
            pods = pods_per_key[index]
            position = chain.position
            chain.position = position + 1
            if not pods:
                if deaths is not None:
                    for pod in active:
                        deaths[pod] = position
                active.clear()
                return False
            best = resolve(pods)
            best_keys = best.keys()
            if best_keys == active:
                # Steady state: every active pod present — accrue.
                if tier_counts is None:
                    for pod, weight in best.items():
                        scores[pod] += weight
                else:
                    # Fused max: the accrue loop already visits every
                    # weight, so tier attribution costs one compare per
                    # pod, not a second pass.
                    best_weight = 0.0
                    for pod, weight in best.items():
                        scores[pod] += weight
                        if weight > best_weight:
                            best_weight = weight
                    tier = weight_to_tier.get(best_weight, default_tier)
                    tier_counts[tier] = tier_counts.get(tier, 0) + 1
                chain.matched_blocks += 1
                continue
            survivors = active & best_keys
            if deaths is not None:
                for pod in active - survivors:
                    deaths[pod] = position
            chain.active = active = survivors
            if not survivors:
                return False
            if tier_counts is None:
                for pod in survivors:
                    scores[pod] += best[pod]
            else:
                best_weight = 0.0
                for pod in survivors:
                    weight = best[pod]
                    scores[pod] += weight
                    if weight > best_weight:
                        best_weight = weight
                tier = weight_to_tier.get(best_weight, default_tier)
                tier_counts[tier] = tier_counts.get(tier, 0) + 1
            chain.matched_blocks += 1
        return True

    def score(
        self,
        keys: Sequence[int],
        key_to_pods: Mapping[int, Sequence[PodEntry]],
    ) -> Dict[str, float]:
        if not keys:
            return {}
        chain = self.begin()
        self.advance(
            chain, [key_to_pods.get(key, ()) for key in keys]
        )
        return chain.scores

    def explain(
        self,
        keys: Sequence[int],
        key_to_pods: Mapping[int, Sequence[PodEntry]],
    ) -> Dict[str, dict]:
        """Score with per-pod provenance (the ``explain=1`` surface).

        For each pod appearing on block 0: its score (identical to
        ``score()``), how many consecutive blocks matched, the block
        index where its prefix chain broke (``None`` when it survived
        every looked-up block), and per-tier counts of the blocks that
        scored (which memory tier each hit came from).  Pods missing
        from block 0 score 0 in ``score()`` and are omitted here, same
        as there.
        """
        if not keys:
            return {}

        first_pods = key_to_pods.get(keys[0], ())
        active = {p.pod_identifier for p in first_pods}
        result: Dict[str, dict] = {}
        for pod in active:
            weight, tier = self._best_entry(first_pods, pod)
            result[pod] = {
                "score": weight,
                "blocks_matched": 1,
                "break_index": None,
                "tiers": {tier: 1},
            }

        for i, key in enumerate(keys[1:], start=1):
            if not active:
                break
            pods = key_to_pods.get(key, ())
            present = {p.pod_identifier for p in pods}
            for pod in active - present:
                result[pod]["break_index"] = i
            active &= present
            for pod in active:
                weight, tier = self._best_entry(pods, pod)
                entry = result[pod]
                entry["score"] += weight
                entry["blocks_matched"] += 1
                entry["tiers"][tier] = entry["tiers"].get(tier, 0) + 1
        return result


def new_scorer(config: ScorerConfig) -> LongestPrefixScorer:
    if config.scoring_strategy != LONGEST_PREFIX_MATCH:
        raise ValueError(
            f"unsupported scoring strategy: {config.scoring_strategy}"
        )
    return LongestPrefixScorer(
        {tier.name: tier.weight for tier in config.tier_configs}
    )
