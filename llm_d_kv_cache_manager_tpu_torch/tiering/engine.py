"""PolicyEngine: one handle over the four tiering engines.

Embedding applications construct one engine, bind it to the indexer's
cachestats ledger, and get:

* ``feed`` — the PolicyFeed (per-family reuse predictions + clusters);
* ``eviction_policy(backend)`` — a predictive ranker to hand to
  ``CostAwareIndexConfig.eviction_policy`` / ``HostTierCache``;
* ``advisor`` — the compute-or-load advisor (fed by the offload
  worker's load completions through ``observe_load``);
* ``start_demotion(target)`` — the proactive demotion worker.

The indexer calls :meth:`observe_scored` after each sampled scoring
request (outside index locks): it feeds the chain into the feed and
refreshes the policy snapshot at most every ``refresh_s`` seconds — a
cheap monotonic compare on the hot path, the full ledger export only
on the throttle's cadence (or the demotion worker's own cycles).

Wired by ``PrecisePrefixCacheScorerConfig.tiering`` in the scheduler
plugin, by ``TPUOffloadConnector(policy_engine=...)`` on the offload
side, and directly by embedding code.  Every knob is env-resolvable
(docs/configuration.md §Tiering, the JAX package's names).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.tiering.advisor import (
    AdvisorConfig,
    ComputeOrLoadAdvisor,
)
from llm_d_kv_cache_manager_tpu_torch.tiering.demotion import (
    DemotionConfig,
    DemotionWorker,
)
from llm_d_kv_cache_manager_tpu_torch.tiering.eviction import (
    DEFAULT_SAMPLE,
    DEFAULT_UNKNOWN_NEXT_USE_S,
    PredictiveEvictionPolicy,
)
from llm_d_kv_cache_manager_tpu_torch.tiering.policy_feed import (
    DEFAULT_CLUSTER_BLOCKS,
    DEFAULT_KEY_MAP_SIZE,
    PolicyFeed,
    PolicyFeedConfig,
)
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("tiering.engine")

DEFAULT_REFRESH_S = 1.0


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
        return int(raw)
    except ValueError:
        logger.warning("invalid %s=%r; using %s", name, raw, default)
        return default


@dataclass
class TieringConfig:
    # Minimum seconds between policy-snapshot refreshes triggered from
    # the scoring path (the demotion worker refreshes on its own
    # cycles regardless).
    refresh_s: float = DEFAULT_REFRESH_S
    feed: PolicyFeedConfig = field(default_factory=PolicyFeedConfig)
    # Predictive-eviction candidate sample + the unknown-key horizon.
    eviction_sample: int = DEFAULT_SAMPLE
    unknown_next_use_s: float = DEFAULT_UNKNOWN_NEXT_USE_S
    advisor: AdvisorConfig = field(default_factory=AdvisorConfig)
    demotion: DemotionConfig = field(default_factory=DemotionConfig)

    @classmethod
    def from_env(cls) -> "TieringConfig":
        return cls(
            refresh_s=_env_float("TIERING_REFRESH_S", DEFAULT_REFRESH_S),
            feed=PolicyFeedConfig(
                cluster_blocks=_env_int(
                    "TIERING_CLUSTER_BLOCKS", DEFAULT_CLUSTER_BLOCKS
                ),
                key_map_size=_env_int(
                    "TIERING_KEY_MAP_SIZE", DEFAULT_KEY_MAP_SIZE
                ),
            ),
            eviction_sample=_env_int(
                "TIERING_EVICTION_SAMPLE", DEFAULT_SAMPLE
            ),
            unknown_next_use_s=_env_float(
                "TIERING_UNKNOWN_NEXT_USE_S", DEFAULT_UNKNOWN_NEXT_USE_S
            ),
            advisor=AdvisorConfig(
                bytes_per_block=_env_int("TIERING_BLOCK_BYTES", 0),
                block_tokens=_env_int("BLOCK_SIZE", 16),
                prefill_tokens_per_s=_env_float(
                    "TIERING_PREFILL_TOKENS_PER_S", 0.0
                ),
                hybrid=os.environ.get("TIERING_HYBRID", "1").lower()
                not in ("0", "false", "off"),
            ),
            demotion=DemotionConfig(
                interval_s=_env_float("TIERING_DEMOTION_INTERVAL_S", 5.0),
                demote_host_idle_s=_env_float(
                    "TIERING_DEMOTE_HOST_IDLE_S", 30.0
                ),
                demote_storage_idle_s=_env_float(
                    "TIERING_DEMOTE_STORAGE_IDLE_S", 120.0
                ),
                pressure_watermark=_env_float(
                    "TIERING_PRESSURE_WATERMARK", 0.85
                ),
            ),
        )


class PolicyEngine:
    """Composition root for the tiering subsystem."""

    def __init__(
        self,
        ledger=None,
        config: Optional[TieringConfig] = None,
    ) -> None:
        self.config = config or TieringConfig.from_env()
        self.feed = PolicyFeed(ledger=ledger, config=self.config.feed)
        self.advisor = ComputeOrLoadAdvisor(self.config.advisor)
        self._workers = []
        self._policies = []
        # Lock-free throttle (GIL-atomic float store): a racy double
        # refresh is harmless, a missed one is caught next request.
        self._last_refresh = 0.0

    def bind_ledger(self, ledger) -> None:
        self.feed.bind_ledger(ledger)

    # -- scoring-path hook ----------------------------------------------

    def observe_scored(
        self,
        chain_keys: Sequence[int],
        family: Optional[int],
        now: Optional[float] = None,
    ) -> None:
        """Called by the indexer after each sampled scored request,
        outside every index lock.  Must never raise into scoring."""
        try:
            if now is None:
                now = time.monotonic()
            self.feed.observe_chain(chain_keys, family, now)
            self.maybe_refresh(now)
        except Exception:  # noqa: BLE001 — policy bugs stay out of scoring
            logger.exception("tiering observe failed")

    def maybe_refresh(self, now: Optional[float] = None) -> None:
        if now is None:
            now = time.monotonic()
        if now - self._last_refresh >= self.config.refresh_s:
            self._last_refresh = now
            self.feed.refresh(now)
            METRICS.tiering_snapshot_age.set(0.0)

    # -- factories -------------------------------------------------------

    def eviction_policy(
        self, backend: str = "cost_aware"
    ) -> PredictiveEvictionPolicy:
        policy = PredictiveEvictionPolicy(
            self.feed,
            backend=backend,
            sample=self.config.eviction_sample,
            unknown_next_use_s=self.config.unknown_next_use_s,
        )
        self._policies.append(policy)
        return policy

    def start_demotion(
        self,
        target,
        config: Optional[DemotionConfig] = None,
        start: bool = True,
    ) -> DemotionWorker:
        worker = DemotionWorker(
            target, self.feed, config or self.config.demotion
        )
        self._workers.append(worker)
        if start:
            worker.start()
        return worker

    def close(self) -> None:
        for worker in self._workers:
            worker.close()

    # -- status (the /debug/tiering payload) -----------------------------

    def status(self) -> dict:
        snapshot = self.feed.snapshot()
        METRICS.tiering_snapshot_age.set(
            max(0.0, time.monotonic() - snapshot.at)
            if snapshot.at
            else 0.0
        )
        return {
            "config": {
                "refresh_s": self.config.refresh_s,
                "cluster_blocks": self.config.feed.cluster_blocks,
                "key_map_size": self.config.feed.key_map_size,
                "eviction_sample": self.config.eviction_sample,
                "unknown_next_use_s": self.config.unknown_next_use_s,
            },
            "feed": self.feed.stats(),
            "advisor": self.advisor.stats(),
            "eviction": [policy.stats() for policy in self._policies],
            "demotion": [worker.stats() for worker in self._workers],
        }
