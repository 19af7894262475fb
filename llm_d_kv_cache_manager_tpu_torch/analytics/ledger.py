"""Hit-attribution ledger: the fleet-level cache-efficiency aggregator.

The scoring read path answers one request at a time; this ledger turns
that stream into the fleet-level questions the per-request explain
cannot: *what fraction of scored prefixes actually hit, per prefix
family and per tier, and how quickly do families come back?*

One :meth:`record` per scored request, keyed by **prefix family** —
the chained block key at block ``family_blocks-1``.  Block keys are
chained hashes, so that single key already commits to the whole first-k
token prefix: two prompts share a family iff they share their first
``family_blocks`` blocks, without the ledger storing any token text
(the HashEvict observation from PAPERS.md — cheap structural identity
from hashes the read path already computed).

Per family the ledger keeps rolling hit/partial/miss counts, block
match totals, per-tier hit splits, a reuse **inter-arrival EWMA** (the
predictive-eviction signal ROADMAP item 4 needs), and last-seen
bookkeeping; globally it keeps the same counts windowed (1m/10m/1h
rings of CBOR-serializable frames, ``windows.py``) plus a
**reuse-distance histogram** (distinct scored requests between
re-encounters of a family — the classic working-set signal).

Hot-path contract (the tentpole's constraint):

* ``record`` is called by the indexer AFTER scoring completes, outside
  every index shard lock;
* the family table is **lock-striped** (``stripes`` locks, key-masked)
  and LRU-bounded (``max_families``), so memory is bounded and
  concurrent scoring threads rarely share a stripe lock;
* the aggregate windows take one short leaf lock per record;
* ``sample_rate`` (env ``CACHESTATS_SAMPLE_RATE``) gates everything —
  an unsampled request costs one RNG draw, exactly the tracer's
  pattern.  At rates < 1 the ledger is an unbiased sample, not a total
  count (same caveat as ``kvtpu_stage_latency_seconds``).

Classification: a request **hit** when its best pod's consecutive
matched blocks reached ``hit_ratio`` of the prompt's full block chain
(default 1.0: the whole chain), **partial** when anything matched,
**miss** otherwise.  The bench's ``cache_analytics`` regime validates
the reported hit rate against engine-side ground truth (±2%).

Copied from the JAX reference's ``analytics/ledger.py``.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from llm_d_kv_cache_manager_tpu_torch.analytics.windows import (
    Frame,
    standard_windows,
)
from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("analytics.ledger")

DEFAULT_SAMPLE_RATE = 1.0
DEFAULT_FAMILY_BLOCKS = 4
DEFAULT_MAX_FAMILIES = 4096
DEFAULT_STRIPES = 8
# Per-tier attribution walks every scored block, the one analytics
# cost that scales with prompt length; by default every 4th sampled
# request pays it (the split is an unbiased sample, like
# kvtpu_stage_latency_seconds).  1 = every sampled request.
DEFAULT_TIER_SAMPLE = 4

# Inter-arrival EWMA smoothing: ~the last 6-7 arrivals dominate.
EWMA_ALPHA = 0.3

# Prometheus-side flush cadence: record() accumulates outcome/tier/
# reuse deltas in plain ints and drains them to the registry every
# this-many records (and on every snapshot/stats read), so the hot
# path never pays a labels() resolution or histogram observe.  The
# exposition lags the ledger by at most one batch.
METRICS_FLUSH_EVERY = 32

# Reuse-distance histogram bucket upper bounds (requests), power-of-two
# ladder; the last bucket is open-ended.
REUSE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096, 16384)

# Stripe locks are leaves acquired one at a time (never nested with
# each other, the aggregate lock, or anything else — the family table
# is a plain dict, no inner lock); the ascending rank arms the
# watchdog in case that ever changes.
# kvlint: lock-order: CacheStatsLedger._stripe_lock ascending
lockorder.declare_ascending("CacheStatsLedger._stripe_lock")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("invalid %s=%r; using %s", name, raw, default)
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        value = int(raw)
        if value <= 0:
            raise ValueError(raw)
        return value
    except ValueError:
        logger.warning("invalid %s=%r; using %s", name, raw, default)
        return default


@dataclass
class LedgerConfig:
    # Fraction of scored requests recorded (0 disables recording).
    sample_rate: float = DEFAULT_SAMPLE_RATE
    # Prefix-family identity: the chained key at this block index - 1
    # (shorter prompts use their last key).
    family_blocks: int = DEFAULT_FAMILY_BLOCKS
    # LRU bound on tracked families (total across stripes).
    max_families: int = DEFAULT_MAX_FAMILIES
    # Lock stripes for the family table (rounded up to a power of two).
    stripes: int = DEFAULT_STRIPES
    # Track the per-tier hit split on every Nth sampled request (the
    # only analytics cost proportional to prompt length); 1 = always.
    tier_sample: int = DEFAULT_TIER_SAMPLE
    # A request "hit" when best matched blocks >= hit_ratio * total
    # blocks; 1.0 = the full chain.
    hit_ratio: float = 1.0
    # Absolute override: when set, a request "hit" when best matched
    # blocks >= hit_blocks regardless of the prompt's total (workloads
    # with a known shared-prefix length, e.g. the bench's churn regime
    # where the engine's own hit criterion is the 512-block prefix).
    hit_blocks: Optional[int] = None

    @classmethod
    def from_env(cls) -> "LedgerConfig":
        sample_rate = _env_float(
            "CACHESTATS_SAMPLE_RATE", DEFAULT_SAMPLE_RATE
        )
        if not 0.0 <= sample_rate <= 1.0:
            # Env knobs warn-and-default, never crash the Indexer
            # construction path (the ledger is default-on there).
            logger.warning(
                "CACHESTATS_SAMPLE_RATE=%s outside [0, 1]; using %s",
                sample_rate,
                DEFAULT_SAMPLE_RATE,
            )
            sample_rate = DEFAULT_SAMPLE_RATE
        return cls(
            sample_rate=sample_rate,
            family_blocks=_env_int(
                "CACHESTATS_FAMILY_BLOCKS", DEFAULT_FAMILY_BLOCKS
            ),
            max_families=_env_int(
                "CACHESTATS_MAX_FAMILIES", DEFAULT_MAX_FAMILIES
            ),
            tier_sample=_env_int(
                "CACHESTATS_TIER_SAMPLE", DEFAULT_TIER_SAMPLE
            ),
        )


class FamilyStats:
    """Rolling per-prefix-family counters."""

    __slots__ = (
        "requests",
        "hits",
        "partials",
        "misses",
        "blocks_matched",
        "blocks_total",
        "tiers",
        "first_seen",
        "last_seen",
        "last_seq",
        "ewma_interarrival_s",
        "model",
    )

    def __init__(self, now: float, seq: int, model: str) -> None:
        self.requests = 0
        self.hits = 0
        self.partials = 0
        self.misses = 0
        self.blocks_matched = 0
        self.blocks_total = 0
        self.tiers: Dict[str, int] = {}
        self.first_seen = now
        self.last_seen = now
        self.last_seq = seq
        self.ewma_interarrival_s: Optional[float] = None
        self.model = model

    def to_dict(self, now: float) -> dict:
        requests = self.requests
        return {
            "requests": requests,
            "hits": self.hits,
            "partials": self.partials,
            "misses": self.misses,
            "hit_rate": round(self.hits / requests, 4) if requests else None,
            "blocks_matched": self.blocks_matched,
            "blocks_total": self.blocks_total,
            "block_hit_rate": (
                round(self.blocks_matched / self.blocks_total, 4)
                if self.blocks_total
                else None
            ),
            "tiers": dict(self.tiers),
            "ewma_interarrival_s": (
                round(self.ewma_interarrival_s, 4)
                if self.ewma_interarrival_s is not None
                else None
            ),
            "idle_s": round(now - self.last_seen, 3),
            "model": self.model,
        }


class CacheStatsLedger:
    """Lock-striped online aggregator over the scoring stream."""

    def __init__(self, config: Optional[LedgerConfig] = None) -> None:
        self.config = config or LedgerConfig.from_env()
        if not 0.0 <= self.config.sample_rate <= 1.0:
            raise ValueError("sample_rate must be in [0, 1]")
        if self.config.family_blocks <= 0:
            raise ValueError("family_blocks must be positive")
        n = 1
        while n < max(1, self.config.stripes):
            n <<= 1
        self._mask = n - 1
        self._per_stripe = max(1, -(-self.config.max_families // n))
        # Plain insertion-ordered dicts with move-to-end on repeat:
        # true LRU semantics at two dict ops per touch instead of a
        # full LRUCache (whose internal lock would be redundant under
        # the stripe lock — and measurable on the scoring path).
        self._stripes: List[Dict[int, FamilyStats]] = [
            {} for _ in range(n)
        ]
        self._stripe_locks = [
            lockorder.tracked(
                threading.Lock(), "CacheStatsLedger._stripe_lock", rank=i
            )
            for i in range(n)
        ]
        # Aggregate state: windows, totals, the request sequence that
        # reuse distance is measured in, and the reuse histogram.  One
        # leaf lock, never nested with stripe locks (record() releases
        # the stripe before touching the aggregate side).
        self._agg_lock = lockorder.tracked(
            threading.Lock(), "CacheStatsLedger._agg_lock"
        )
        self._windows = standard_windows()  # guarded-by: _agg_lock
        # 1-second accumulator: record() lands counts here (one Frame
        # update) and the completed second is absorbed into all three
        # rings on roll-over — three ring walks per second, not per
        # record.  Slot -1 = empty sentinel (folded lazily).
        self._acc = Frame(-1)  # guarded-by: _agg_lock
        self._seq = 0  # guarded-by: _agg_lock
        self._recorded = 0  # guarded-by: _agg_lock
        self._hits = 0  # guarded-by: _agg_lock
        self._partials = 0  # guarded-by: _agg_lock
        self._misses = 0  # guarded-by: _agg_lock
        self._blocks_matched = 0  # guarded-by: _agg_lock
        self._blocks_total = 0  # guarded-by: _agg_lock
        self._tiers: Dict[str, int] = {}  # guarded-by: _agg_lock
        self._tier_untracked = 0  # guarded-by: _agg_lock
        self._reuse_hist = [0] * (len(REUSE_BUCKETS) + 1)  # guarded-by: _agg_lock
        self._families_evicted = 0  # guarded-by: _agg_lock
        # Prometheus deltas pending flush (see METRICS_FLUSH_EVERY).
        self._pending_outcomes = {
            "hit": 0, "partial": 0, "miss": 0
        }  # guarded-by: _agg_lock
        self._pending_tiers: Dict[str, int] = {}  # guarded-by: _agg_lock
        # Reuse-distance deltas pending flush, per bucket (+ the sum of
        # distances, for the histogram's _sum series).
        self._pending_reuse = [0] * (len(REUSE_BUCKETS) + 1)  # guarded-by: _agg_lock
        self._pending_reuse_sum = 0  # guarded-by: _agg_lock
        self._since_flush = 0  # guarded-by: _agg_lock
        # Pre-resolved metric children: labels() resolution costs more
        # than the increment itself, so the flush path resolves each
        # child once.
        self._outcome_children = {
            outcome: METRICS.cachestats_requests.labels(outcome=outcome)
            for outcome in ("hit", "partial", "miss")
        }
        self._tier_children: Dict[str, object] = {}
        # Config reads hoisted off the per-record path.
        self._hit_blocks = (
            max(1, self.config.hit_blocks)
            if self.config.hit_blocks is not None
            else None
        )
        self._hit_ratio = self.config.hit_ratio
        self._tier_tick = 0  # lock-free by design (see tier_detail_due)
        # Written once (False -> True) under _agg_lock by close();
        # deliberately read lock-free on the record path — the flag
        # only ever advances, and the stripe section re-checks it
        # inside the stripe lock, which close()'s sweep also takes, so
        # a post-sweep insert can never slip through.
        self._closed = False

    # -- hot-path surface ------------------------------------------------

    def should_sample(self) -> bool:
        """The indexer's cheap per-request gate: when False, the
        request contributes nothing (and pays nothing beyond this RNG
        draw)."""
        rate = self.config.sample_rate
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        return random.random() < rate

    def family_key(self, chain_keys, total_blocks: int) -> Optional[int]:
        """Prefix-family id for a request's chained block keys: the key
        at ``family_blocks - 1`` (chained, so it commits to the whole
        first-k prefix), clamped to the chain actually available."""
        if not chain_keys:
            return None
        index = min(self.config.family_blocks, total_blocks, len(chain_keys))
        return chain_keys[index - 1]

    def classify(self, matched_blocks: int, total_blocks: int) -> str:
        if total_blocks <= 0:
            return "miss"
        threshold = self._hit_blocks
        if threshold is None:
            # Round-half-up in int math (the hot path calls this per
            # request; round() costs a surprising amount here).
            threshold = int(self._hit_ratio * total_blocks + 0.5) or 1
        if matched_blocks >= threshold:
            return "hit"
        if matched_blocks > 0:
            return "partial"
        return "miss"

    def record(
        self,
        family: Optional[int],
        model: str,
        total_blocks: int,
        matched_blocks: int,
        tiers: Optional[Dict[str, int]] = None,
        now: Optional[float] = None,
    ) -> str:
        """Fold one scored request into the ledger; returns the
        hit/partial/miss classification.  Called outside every index
        lock; takes the aggregate lock and one stripe lock
        sequentially (never nested)."""
        if now is None:
            now = time.monotonic()
        outcome = self.classify(matched_blocks, total_blocks)
        if self._closed:
            # Late record after close() (racing shutdown): classified
            # but not folded, so the returned-to-gauge family count
            # stays exact.  Cheap unlocked read; the stripe section
            # re-checks under its lock to close the race with the
            # sweep itself.
            return outcome

        # Aggregate side first: it owns the request sequence number the
        # reuse distance below is measured in.
        with self._agg_lock:
            self._seq += 1
            seq = self._seq
            self._recorded += 1
            if outcome == "hit":
                self._hits += 1
            elif outcome == "partial":
                self._partials += 1
            else:
                self._misses += 1
            self._blocks_matched += matched_blocks
            self._blocks_total += total_blocks
            self._pending_outcomes[outcome] += 1
            if tiers:
                agg = self._tiers
                pending = self._pending_tiers
                for tier, count in tiers.items():
                    agg[tier] = agg.get(tier, 0) + count
                    pending[tier] = pending.get(tier, 0) + count
            elif matched_blocks:
                self._tier_untracked += 1
            acc = self._acc
            slot = int(now)
            if acc.slot != slot:
                self._fold_acc_locked()
                acc = self._acc = Frame(slot)
            acc.record(outcome, matched_blocks, total_blocks, tiers)

        evicted = 0
        reuse_distance = None
        if family is not None:
            stripe_index = family & self._mask
            with self._stripe_locks[stripe_index]:
                stripe = self._stripes[stripe_index]
                # close() sets _closed BEFORE sweeping the stripes, so
                # an insert that would land after the sweep (leaking a
                # gauge increment forever) sees the flag here.
                if self._closed:
                    return outcome
                stats: Optional[FamilyStats] = stripe.get(family)
                if stats is None:
                    if len(stripe) >= self._per_stripe:
                        # Insertion order IS recency order (repeats
                        # re-insert below), so the first key is LRU.
                        del stripe[next(iter(stripe))]
                        evicted = 1
                    stats = FamilyStats(now, seq, model)
                    stripe[family] = stats
                    membership_changed = True
                else:
                    # Move-to-end: keeps insertion order == recency.
                    del stripe[family]
                    stripe[family] = stats
                    membership_changed = False
                    reuse_distance = max(1, seq - stats.last_seq)
                    interarrival = max(0.0, now - stats.last_seen)
                    stats.ewma_interarrival_s = (
                        interarrival
                        if stats.ewma_interarrival_s is None
                        else EWMA_ALPHA * interarrival
                        + (1.0 - EWMA_ALPHA) * stats.ewma_interarrival_s
                    )
                    stats.last_seen = now
                    stats.last_seq = seq
                stats.requests += 1
                if outcome == "hit":
                    stats.hits += 1
                elif outcome == "partial":
                    stats.partials += 1
                else:
                    stats.misses += 1
                stats.blocks_matched += matched_blocks
                stats.blocks_total += total_blocks
                if tiers:
                    mine = stats.tiers
                    for tier, count in tiers.items():
                        mine[tier] = mine.get(tier, 0) + count
        else:
            membership_changed = False

        flush = None
        with self._agg_lock:
            if reuse_distance is not None:
                bucket = self._observe_reuse_locked(reuse_distance)
                self._pending_reuse[bucket] += 1
                self._pending_reuse_sum += reuse_distance
            if evicted:
                self._families_evicted += evicted
            self._since_flush += 1
            if self._since_flush >= METRICS_FLUSH_EVERY:
                flush = self._drain_pending_locked()
        if flush is not None:
            self._apply_flush(flush)
        if membership_changed and not evicted:
            # Delta, not set(): the gauge is process-global and several
            # ledgers may share it (one per Indexer) — deltas aggregate
            # to the true total where absolute writes would clobber
            # last-writer-wins.  Insert-with-evict nets to zero; the
            # ledger's close() gives the families back.
            METRICS.cachestats_families.inc()
        return outcome

    def close(self) -> None:
        """Retire this ledger: flush pending metric deltas and return
        its tracked families to the process-global gauge (deltas would
        otherwise overstate forever after an Indexer teardown).
        Idempotent; called by ``Indexer.shutdown()``."""
        with self._agg_lock:
            if self._closed:
                return
            self._closed = True
            flush = self._drain_pending_locked()
        self._apply_flush(flush)
        tracked = 0
        for stripe_index, stripe in enumerate(self._stripes):
            with self._stripe_locks[stripe_index]:
                tracked += len(stripe)
                stripe.clear()
        if tracked:
            METRICS.cachestats_families.dec(tracked)

    def _observe_reuse_locked(self, distance: int) -> int:
        for i, bound in enumerate(REUSE_BUCKETS):
            if distance <= bound:
                self._reuse_hist[i] += 1
                return i
        self._reuse_hist[-1] += 1
        return len(REUSE_BUCKETS)

    def _fold_acc_locked(self) -> None:
        """Absorb the accumulator into every ring and reset it (same
        slot, so a mid-second read folds what exists and later records
        in that second merge into the same ring frames)."""
        acc = self._acc
        if acc.slot < 0 or not acc.requests:
            return
        at = float(acc.slot)
        for _, ring in self._windows:
            ring.absorb(at, acc)
        self._acc = Frame(acc.slot)

    # -- Prometheus flush ------------------------------------------------

    def _drain_pending_locked(self):
        """Swap out the pending Prometheus deltas (caller applies them
        outside the lock)."""
        self._since_flush = 0
        pending = (
            dict(self._pending_outcomes),
            self._pending_tiers,
            self._pending_reuse,
            self._pending_reuse_sum,
        )
        for outcome in self._pending_outcomes:
            self._pending_outcomes[outcome] = 0
        self._pending_tiers = {}
        self._pending_reuse = [0] * (len(REUSE_BUCKETS) + 1)
        self._pending_reuse_sum = 0
        return pending

    def _apply_flush(self, flush) -> None:
        outcomes, tiers, reuse, reuse_sum = flush
        for outcome, count in outcomes.items():
            if count:
                self._outcome_children[outcome].inc(count)
        for tier, count in tiers.items():
            child = self._tier_children.get(tier)
            if child is None:
                child = METRICS.cachestats_tier_hits.labels(tier=tier)
                # gil-atomic: idempotent memo; racing put re-derives the same value
                self._tier_children[tier] = child
            child.inc(count)
        if any(reuse):
            self._flush_reuse(reuse, reuse_sum)

    def _flush_reuse(self, per_bucket, total) -> None:
        """Batch-apply reuse-distance deltas.

        The public Histogram API only offers per-value ``observe`` —
        at one observe per repeat request that was the single biggest
        analytics cost — so the flush increments the bucket values
        directly (our bucket ladder is the histogram's, asserted at
        construction below).  Exposition parity with observe() is
        pinned by tests/test_cache_analytics.py; if the private layout
        ever changes, the fallback is the plain observe loop.
        """
        hist = METRICS.cachestats_reuse_distance
        buckets = getattr(hist, "_buckets", None)
        hist_sum = getattr(hist, "_sum", None)
        if buckets is None or hist_sum is None or len(buckets) != len(
            per_bucket
        ):
            observe = hist.observe
            for i, count in enumerate(per_bucket[:-1]):
                for _ in range(count):
                    observe(REUSE_BUCKETS[i])
            for _ in range(per_bucket[-1]):
                observe(REUSE_BUCKETS[-1] + 1)
            return
        # prometheus_client stores non-cumulative per-bucket counts and
        # accumulates at collect(); our ladder (+inf tail) aligns 1:1.
        for i, count in enumerate(per_bucket):
            if count:
                buckets[i].inc(count)
        hist_sum.inc(total)

    def flush_metrics(self) -> None:
        """Drain pending Prometheus deltas now (scrape consistency for
        tests and snapshot readers; record() flushes every
        METRICS_FLUSH_EVERY records on its own)."""
        with self._agg_lock:
            flush = self._drain_pending_locked()
        self._apply_flush(flush)

    # -- read surface ----------------------------------------------------

    def families_tracked(self) -> int:
        return sum(len(stripe) for stripe in self._stripes)

    def predicted_interarrival_s(self, family: int) -> Optional[float]:
        """The reuse signal for future eviction/admission policy
        (ROADMAP item 4): this family's EWMA of inter-arrival times, or
        None when it has been seen at most once (or was evicted)."""
        stripe_index = family & self._mask
        with self._stripe_locks[stripe_index]:
            stats = self._stripes[stripe_index].get(family)
            return stats.ewma_interarrival_s if stats is not None else None

    def predicted_matched_blocks(self, family: int) -> Optional[float]:
        """Average matched blocks per request for a tracked family —
        the read path's chain-speculation depth signal: a multi-turn
        family that historically matched deep justifies dispatching
        the next chunk's lookups before the current chunk resolves
        (docs/replication.md "Pipelined read path").  None when the
        family is untracked."""
        stripe_index = family & self._mask
        with self._stripe_locks[stripe_index]:
            stats = self._stripes[stripe_index].get(family)
            if stats is None or not stats.requests:
                return None
            return stats.blocks_matched / stats.requests

    def reuse_predictions(self):
        """Bulk export of the reuse signal: ``(family,
        ewma_interarrival_s, last_seen, requests)`` for every tracked
        family seen at least twice — the PolicyFeed's snapshot input
        (tiering/policy_feed.py).  One stripe lock at a time, never
        nested; O(families tracked), for periodic refreshes rather
        than per-request calls."""
        out = []
        for stripe_index, stripe in enumerate(self._stripes):
            with self._stripe_locks[stripe_index]:
                for family, stats in stripe.items():
                    ewma = stats.ewma_interarrival_s
                    if ewma is not None:
                        out.append(
                            (family, ewma, stats.last_seen, stats.requests)
                        )
        return out

    def tier_detail_due(self) -> bool:
        """Cheap modulo gate for per-tier attribution (every Nth
        sampled request pays the per-block tier walk; see
        ``LedgerConfig.tier_sample``).  Deliberately lock-free: a racy
        tick merely shifts which request carries the detail."""
        sample = self.config.tier_sample
        if sample <= 1:
            return True
        tick = self._tier_tick + 1
        if tick >= sample:
            # gil-atomic: sampling tick; a lost update only shifts the sampled request
            self._tier_tick = 0
            return True
        # gil-atomic: sampling tick; a lost update only shifts the sampled request
        self._tier_tick = tick
        return False

    def stats_summary(self) -> dict:
        """Compact totals for /healthz."""
        self.flush_metrics()
        with self._agg_lock:
            recorded = self._recorded
            hits = self._hits
            summary = {
                "sample_rate": self.config.sample_rate,
                "recorded": recorded,
                "hit_rate": round(hits / recorded, 4) if recorded else None,
                "block_hit_rate": (
                    round(self._blocks_matched / self._blocks_total, 4)
                    if self._blocks_total
                    else None
                ),
            }
        summary["families_tracked"] = self.families_tracked()
        return summary

    def snapshot(self, now: Optional[float] = None, top: int = 20) -> dict:
        """The /debug/cachestats payload: totals, windows, reuse
        distances, and the top families by request count."""
        if now is None:
            now = time.monotonic()
        self.flush_metrics()
        with self._agg_lock:
            self._fold_acc_locked()
            out = {
                "config": {
                    "sample_rate": self.config.sample_rate,
                    "family_blocks": self.config.family_blocks,
                    "max_families": self.config.max_families,
                    "hit_ratio": self.config.hit_ratio,
                    "hit_blocks": self.config.hit_blocks,
                },
                "totals": {
                    "recorded": self._recorded,
                    "hits": self._hits,
                    "partials": self._partials,
                    "misses": self._misses,
                    "hit_rate": (
                        round(self._hits / self._recorded, 4)
                        if self._recorded
                        else None
                    ),
                    "blocks_matched": self._blocks_matched,
                    "blocks_total": self._blocks_total,
                    "block_hit_rate": (
                        round(self._blocks_matched / self._blocks_total, 4)
                        if self._blocks_total
                        else None
                    ),
                    "tiers": dict(self._tiers),
                    "tier_untracked": self._tier_untracked,
                    "families_evicted": self._families_evicted,
                },
                "windows": {
                    name: ring.totals(now) for name, ring in self._windows
                },
                "reuse_distance": self._reuse_view_locked(),
            }
        out["families_tracked"] = self.families_tracked()
        out["top_families"] = self.top_families(now, top)
        return out

    def _reuse_view_locked(self) -> dict:
        view = {}
        for i, bound in enumerate(REUSE_BUCKETS):
            if self._reuse_hist[i]:
                view[f"le_{bound}"] = self._reuse_hist[i]
        if self._reuse_hist[-1]:
            view["inf"] = self._reuse_hist[-1]
        return view

    def top_families(self, now: Optional[float] = None, top: int = 20) -> list:
        """Most-requested families, for the drill-down listing."""
        if now is None:
            now = time.monotonic()
        entries = []
        for stripe_index, stripe in enumerate(self._stripes):
            with self._stripe_locks[stripe_index]:
                for family, stats in stripe.items():
                    entries.append((stats.requests, family, stats.to_dict(now)))
        entries.sort(key=lambda item: (-item[0], item[1]))
        return [
            dict(detail, family=f"{family:016x}")
            for _, family, detail in entries[: max(0, top)]
        ]

    def family_detail(self, family: int, now: Optional[float] = None) -> Optional[dict]:
        """One family's stats (the ?family=<hex> drill-down), or None."""
        if now is None:
            now = time.monotonic()
        stripe_index = family & self._mask
        with self._stripe_locks[stripe_index]:
            stats = self._stripes[stripe_index].get(family)
            if stats is None:
                return None
            detail = stats.to_dict(now)
        detail["family"] = f"{family:016x}"
        return detail

    def window_frames_cbor(self, now: Optional[float] = None) -> Dict[str, bytes]:
        """Canonical-CBOR frame snapshots per window (the snapshottable
        artifact future eviction policy consumes)."""
        if now is None:
            now = time.monotonic()
        with self._agg_lock:
            self._fold_acc_locked()
            return {name: ring.to_cbor(now) for name, ring in self._windows}

    def window_totals(self, name: str, now: Optional[float] = None) -> Optional[dict]:
        if now is None:
            now = time.monotonic()
        with self._agg_lock:
            self._fold_acc_locked()
            for window_name, ring in self._windows:
                if window_name == name:
                    return ring.totals(now)
        return None
