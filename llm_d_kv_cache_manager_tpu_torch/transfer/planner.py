"""TransferPlanner: price pod-to-pod KV movement against recompute.

The scorer answers "who already holds the longest prefix"; the planner
answers the enterprise follow-up "who could *cheaply get it*".  Given
the scorer's per-pod provenance (``LongestPrefixScorer.explain``
detail: score, blocks matched, tier histogram), per-pod load signals
(queue depths, the same signal ``LOAD_BLEND`` folds into routing), and
the tiering advisor's measured read- AND write-side RTT estimators, it
produces a :class:`TransferPlan`: move the matched block chain from
the overloaded holder to an underloaded target, priced as

    transfer_s  = rtt.estimate(nbytes) + estimate_store_s(nbytes)
    recompute_s = blocks * block_tokens / prefill_tokens_per_s

and only planned when ``transfer_s < recompute_s * (1 - margin)``
(the compute-or-load split, write side included because the target
must *store* what the source streams out).  No RTT observations yet
means no plan — recompute is the only priced option, exactly the
advisor's "no-rtt-observations" posture.

Plans live in a bounded registry with a TTL so a dead scheduler never
leaks them; ``invalidate_pod`` kills every plan touching a departed
pod before the executor can publish phantom index entries.

Decision outcomes (the ``kvtpu_transfer_plans_total`` label values)::

    planned                a plan was produced
    holder-not-overloaded  best holder below TRANSFER_LOAD_THRESHOLD
    no-holder              no pod scored above zero
    no-target              no pod both less loaded than the holder
                           and with real headroom (load below half
                           the threshold) — copying onto a busy pod
                           spreads overload instead of relieving it
    too-few-blocks         matched prefix below TRANSFER_MIN_BLOCKS
    no-block-bytes         bytes-per-block unconfigured (can't price)
    no-rtt-observations    read estimator has no signal -> recompute
    recompute-cheaper      priced, and recompute won
    in-flight              a live plan for this chain already exists
    recently-transferred   this chain landed on this target within
                           TRANSFER_REPLAN_COOLDOWN_S
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("transfer.planner")

# Plan lifecycle states (docs/transfer.md).
PLANNED = "planned"
EXECUTING = "executing"
DONE = "done"
INVALIDATED = "invalidated"
EXPIRED = "expired"

# Deterministic tier preference when a holder spans several tiers: the
# executor reads the *current* tier at execute time anyway, this only
# seeds the directive.
_TIER_ORDER = ("hbm", "host", "shared_storage")

# TransferPlanner._lock is a leaf: metrics and planning math happen
# outside it; only the registry mutates under it.
# kvlint: lock-order: TransferPlanner._lock ascending
lockorder.declare_ascending("TransferPlanner._lock")


@dataclass
class TransferPlan:
    """One priced pod-to-pod block movement."""

    plan_id: int
    source_pod: str
    target_pod: str
    # Request-chain keys (index keys) for the matched prefix.
    block_keys: List[int]
    # Engine-side hashes as the KVEvents will carry them (default: the
    # request keys themselves — the ingestion pool re-derives request
    # keys from token_ids, so any stable engine id works).
    engine_hashes: List[int]
    token_ids: List[int]
    block_size: int
    # Source-side tier the chain was observed on at plan time.
    tier: str
    blocks: int
    nbytes: int
    est_transfer_s: Optional[float]
    est_recompute_s: Optional[float]
    reason: str
    state: str = PLANNED
    created_at: float = 0.0

    def to_dict(self) -> dict:
        return {
            "plan_id": self.plan_id,
            "source_pod": self.source_pod,
            "target_pod": self.target_pod,
            "blocks": self.blocks,
            "nbytes": self.nbytes,
            "tier": self.tier,
            "est_transfer_s": self.est_transfer_s,
            "est_recompute_s": self.est_recompute_s,
            "reason": self.reason,
            "state": self.state,
        }

    def to_directive(self) -> dict:
        """The wire form riding the scoring response: everything a
        scheduler needs to route to ``target_pod`` with a fetch
        instruction, nothing that only the executor needs."""
        return {
            "plan_id": self.plan_id,
            "source_pod": self.source_pod,
            "target_pod": self.target_pod,
            "block_keys": list(self.block_keys),
            "blocks": self.blocks,
            "nbytes": self.nbytes,
            "tier": self.tier,
            "est_transfer_s": self.est_transfer_s,
            "est_recompute_s": self.est_recompute_s,
            "reason": self.reason,
        }


def _pick_tier(tiers: Optional[Dict[str, int]]) -> str:
    """Deterministic dominant tier from an explain histogram."""
    if not tiers:
        return _TIER_ORDER[0]
    best = max(
        tiers.items(),
        key=lambda kv: (
            kv[1],
            # Prefer the faster tier on a count tie (stable order).
            -_TIER_ORDER.index(kv[0]) if kv[0] in _TIER_ORDER else -99,
        ),
    )
    return best[0]


class TransferPlanner:
    """Produce and track :class:`TransferPlan` instances.

    Deterministic by construction: plan ids come from a counter, the
    holder is the max-score pod with a lexicographic tiebreak, the
    target the min-load pod with the same tiebreak, and no wall-clock
    or randomness enters the directive — the plan-determinism test
    pins this.
    """

    def __init__(
        self,
        advisor,
        load_threshold: float = 4.0,
        min_blocks: int = 2,
        price_margin: float = 0.1,
        max_plans: int = 256,
        ttl_s: float = 30.0,
        replan_cooldown_s: float = 5.0,
    ) -> None:
        self.advisor = advisor
        self.load_threshold = load_threshold
        self.min_blocks = min_blocks
        self.price_margin = price_margin
        self.max_plans = max_plans
        self.ttl_s = ttl_s
        self.replan_cooldown_s = replan_cooldown_s
        self._lock = lockorder.tracked(
            threading.Lock(), "TransferPlanner._lock"
        )
        # guarded-by: _lock — insertion-ordered for bounded eviction.
        self._plans: "OrderedDict[int, TransferPlan]" = OrderedDict()
        self._next_id = 1  # guarded-by: _lock
        self._outcomes: Dict[str, int] = {}  # guarded-by: _lock

    # -- pricing ---------------------------------------------------------

    def _prefill_rate(self) -> float:
        cfg_rate = getattr(self.advisor.config, "prefill_tokens_per_s", 0.0)
        if cfg_rate and cfg_rate > 0:
            return cfg_rate
        measured = self.advisor.prefill_tokens_per_s
        return measured if measured else 0.0

    def price(self, blocks: int) -> Tuple[Optional[float], Optional[float]]:
        """(est_transfer_s, est_recompute_s) for a ``blocks`` chain;
        either side is None when its estimator has no signal."""
        bpb = getattr(self.advisor.config, "bytes_per_block", 0)
        transfer_s: Optional[float] = None
        if bpb and bpb > 0:
            nbytes = blocks * bpb
            read_s = self.advisor.rtt.estimate(nbytes)
            if read_s is not None:
                store_s = self.advisor.estimate_store_s(nbytes) or 0.0
                transfer_s = read_s + store_s
        rate = self._prefill_rate()
        recompute_s = (
            blocks * self.advisor.config.block_tokens / rate
            if rate > 0
            else None
        )
        return transfer_s, recompute_s

    # -- the decision ----------------------------------------------------

    def plan(
        self,
        per_pod: Dict[str, dict],
        pod_loads: Dict[str, float],
        block_keys: Sequence[int],
        token_ids: Optional[Sequence[int]] = None,
        block_size: int = 16,
        engine_hashes: Optional[Sequence[int]] = None,
        now: Optional[float] = None,
    ) -> Tuple[Optional[TransferPlan], str]:
        """Decide for one scored request.

        ``per_pod`` is the scorer-explain provenance (``score``,
        ``blocks_matched``, ``tiers`` per pod); ``pod_loads`` maps pod
        to queue depth.  Returns ``(plan, outcome)`` — plan is None for
        every outcome except ``"planned"``.
        """
        if now is None:
            now = time.monotonic()
        outcome = self._decide(per_pod, pod_loads)
        if isinstance(outcome, str):
            self._count(outcome)
            return None, outcome
        holder, target, detail = outcome
        damped = self._damped(list(block_keys), target, now)
        if damped is not None:
            self._count(damped)
            return None, damped
        blocks = int(detail.get("blocks_matched") or 0)
        transfer_s, recompute_s = self.price(blocks)
        bpb = getattr(self.advisor.config, "bytes_per_block", 0)
        if not bpb or bpb <= 0:
            self._count("no-block-bytes")
            return None, "no-block-bytes"
        if transfer_s is None:
            # Zero-RTT edge: no measurements yet -> recompute is the
            # only priced option; never plan on a guess.
            self._count("no-rtt-observations")
            return None, "no-rtt-observations"
        reason = "priced"
        if recompute_s is None:
            # Transfer measurable, recompute unknown: plan, flagged.
            reason = "no-prefill-rate"
        elif transfer_s >= recompute_s * (1.0 - self.price_margin):
            self._count("recompute-cheaper")
            return None, "recompute-cheaper"
        keys = list(block_keys)[:blocks]
        tokens = list(token_ids or [])[: blocks * block_size]
        plan = self._register(
            TransferPlan(
                plan_id=0,  # assigned under the lock
                source_pod=holder,
                target_pod=target,
                block_keys=keys,
                engine_hashes=(
                    list(engine_hashes)[:blocks]
                    if engine_hashes is not None
                    else list(keys)
                ),
                token_ids=tokens,
                block_size=block_size,
                tier=_pick_tier(detail.get("tiers")),
                blocks=blocks,
                nbytes=blocks * bpb,
                est_transfer_s=transfer_s,
                est_recompute_s=recompute_s,
                reason=reason,
            ),
            now=now,
        )
        self._count("planned")
        return plan, "planned"

    def _decide(self, per_pod, pod_loads):
        """Holder/target selection; returns an outcome string or
        ``(holder, target, holder_detail)``."""
        scored = {
            pod: d for pod, d in per_pod.items() if d.get("score", 0) > 0
        }
        if not scored:
            return "no-holder"
        holder = min(
            scored, key=lambda p: (-scored[p].get("score", 0.0), p)
        )
        detail = scored[holder]
        holder_load = float(pod_loads.get(holder, 0.0))
        if holder_load < self.load_threshold:
            return "holder-not-overloaded"
        if int(detail.get("blocks_matched") or 0) < self.min_blocks:
            return "too-few-blocks"
        # A target must have real headroom, not merely be less loaded
        # than the holder: when the whole fleet is saturated, copying a
        # family onto a busy pod evicts that pod's own hot blocks and
        # spreads the overload instead of relieving it.
        headroom = self.load_threshold / 2.0
        candidates = [
            pod
            for pod in set(per_pod) | set(pod_loads)
            if pod != holder
            and float(pod_loads.get(pod, 0.0)) < holder_load
            and float(pod_loads.get(pod, 0.0)) < headroom
        ]
        if not candidates:
            return "no-target"
        target = min(
            candidates, key=lambda p: (float(pod_loads.get(p, 0.0)), p)
        )
        return holder, target, detail

    def _damped(
        self, block_keys: List[int], target: str, now: float
    ) -> Optional[str]:
        """Replan damping: scoring is per-request but a hot chain is
        scored thousands of times a second, and without idempotency
        every call would mint another copy of the same transfer —
        thrashing the fleet's pools with duplicate replicas.  One live
        plan per chain at a time; after it lands, the same chain goes
        to the same target at most once per cooldown window."""
        if not block_keys:
            return None
        head = block_keys[0]
        with self._lock:
            for plan in self._plans.values():
                if not plan.block_keys or plan.block_keys[0] != head:
                    continue
                if plan.state in (PLANNED, EXECUTING):
                    return "in-flight"
                if (
                    plan.state == DONE
                    and plan.target_pod == target
                    and now - plan.created_at < self.replan_cooldown_s
                ):
                    return "recently-transferred"
        return None

    def plan_warmup(
        self,
        source_pod: str,
        target_pod: str,
        block_keys: Sequence[int],
        engine_hashes: Optional[Sequence[int]] = None,
        token_ids: Optional[Sequence[int]] = None,
        block_size: int = 16,
        tier: str = "hbm",
        now: Optional[float] = None,
    ) -> TransferPlan:
        """Bulk pre-placement plan for a cold pod: the decision is
        already made (the warm-up worker ranked the family hot), so no
        load/price gate — pricing is recorded for reporting only."""
        blocks = len(block_keys)
        bpb = getattr(self.advisor.config, "bytes_per_block", 0) or 0
        transfer_s, recompute_s = self.price(blocks)
        plan = self._register(
            TransferPlan(
                plan_id=0,
                source_pod=source_pod,
                target_pod=target_pod,
                block_keys=list(block_keys),
                engine_hashes=(
                    list(engine_hashes)
                    if engine_hashes is not None
                    else list(block_keys)
                ),
                token_ids=list(token_ids or []),
                block_size=block_size,
                tier=tier,
                blocks=blocks,
                nbytes=blocks * bpb,
                est_transfer_s=transfer_s,
                est_recompute_s=recompute_s,
                reason="warmup",
            ),
            now=now,
        )
        self._count("warmup")
        return plan

    # -- registry --------------------------------------------------------

    def _register(
        self, plan: TransferPlan, now: Optional[float] = None
    ) -> TransferPlan:
        if now is None:
            now = time.monotonic()
        plan.created_at = now
        with self._lock:
            plan.plan_id = self._next_id
            self._next_id += 1
            self._plans[plan.plan_id] = plan
            while len(self._plans) > self.max_plans:
                self._plans.popitem(last=False)
        return plan

    def _count(self, outcome: str) -> None:
        with self._lock:
            self._outcomes[outcome] = self._outcomes.get(outcome, 0) + 1
        METRICS.transfer_plans.labels(outcome=outcome).inc()

    def get(self, plan_id: int) -> Optional[TransferPlan]:
        with self._lock:
            return self._plans.get(plan_id)

    def mark(self, plan_id: int, state: str) -> None:
        with self._lock:
            plan = self._plans.get(plan_id)
            if plan is not None:
                plan.state = state

    def invalidate_pod(self, pod_identifier: str) -> int:
        """Kill every live plan touching a departed pod (source gone:
        nothing to copy; target gone: nowhere to put it).  Returns the
        number invalidated."""
        n = 0
        with self._lock:
            for plan in self._plans.values():
                if plan.state not in (PLANNED, EXECUTING):
                    continue
                if pod_identifier in (plan.source_pod, plan.target_pod):
                    plan.state = INVALIDATED
                    n += 1
        if n:
            METRICS.transfer_plans.labels(outcome="pod-invalidated").inc(n)
        return n

    def expire(self, now: Optional[float] = None) -> int:
        """TTL sweep: planned-but-never-executed plans go stale."""
        if now is None:
            now = time.monotonic()
        n = 0
        with self._lock:
            for plan in self._plans.values():
                if (
                    plan.state == PLANNED
                    and now - plan.created_at >= self.ttl_s
                ):
                    plan.state = EXPIRED
                    n += 1
        if n:
            METRICS.transfer_plans.labels(outcome="expired").inc(n)
        return n

    def stats(self) -> dict:
        with self._lock:
            by_state: Dict[str, int] = {}
            for plan in self._plans.values():
                by_state[plan.state] = by_state.get(plan.state, 0) + 1
            recent = [
                p.to_dict() for p in list(self._plans.values())[-8:]
            ]
            return {
                "config": {
                    "load_threshold": self.load_threshold,
                    "min_blocks": self.min_blocks,
                    "price_margin": self.price_margin,
                    "max_plans": self.max_plans,
                    "ttl_s": self.ttl_s,
                    "replan_cooldown_s": self.replan_cooldown_s,
                },
                "plans": len(self._plans),
                "by_state": by_state,
                "outcomes": dict(self._outcomes),
                "recent": recent,
            }
