"""TransferEngine: one handle over the KV-transfer planning plane.

Composition root mirroring tiering's :class:`PolicyEngine`: embedding
code constructs one engine, attaches it to an ``Indexer``
(``set_transfer_engine``), and gets:

* ``planner`` — the priced pod-to-pod :class:`TransferPlanner`;
* ``catalog`` — the hot-family holder registry, fed automatically
  from scored traffic through :meth:`plan_for_chain`;
* ``attach_executor(index, pool, model_name)`` — binds the event
  channel (the kvevents ingestion pool) and builds the executor +
  warm-up worker;
* ``plan_for_chain(...)`` — the scoring-path hook: given scorer
  provenance + pod loads, return a transfer directive (or None), and
  note the holder in the catalog either way.  Must never raise into
  scoring, same contract as ``PolicyEngine.observe_scored``.

Every knob is env-resolvable (docs/configuration.md §KV-transfer, the
JAX package's names):
``TRANSFER_LOAD_THRESHOLD``, ``TRANSFER_MIN_BLOCKS``,
``TRANSFER_PRICE_MARGIN``, ``TRANSFER_MAX_PLANS``, ``TRANSFER_TTL_S``,
``TRANSFER_REPLAN_COOLDOWN_S``, ``TRANSFER_WARMUP_FAMILIES``,
``TRANSFER_WARMUP_INTERVAL_S``, ``TRANSFER_WARMUP_MOVES``.

When tiering is also enabled the engines share one
``ComputeOrLoadAdvisor`` (pass it in), so transfer pricing rides the
same measured RTT models the offload plane feeds; standalone, the
engine builds its own from the ``TIERING_*`` advisor knobs.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.tiering.advisor import ComputeOrLoadAdvisor
from llm_d_kv_cache_manager_tpu_torch.tiering.engine import TieringConfig
from llm_d_kv_cache_manager_tpu_torch.transfer.directives import TransferExecutor
from llm_d_kv_cache_manager_tpu_torch.transfer.planner import (
    TransferPlanner,
    _pick_tier,
)
from llm_d_kv_cache_manager_tpu_torch.transfer.warmup import (
    HotFamilyCatalog,
    WarmupWorker,
)
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("transfer.engine")

DEFAULT_LOAD_THRESHOLD = 4.0
DEFAULT_MIN_BLOCKS = 2
DEFAULT_PRICE_MARGIN = 0.1
DEFAULT_MAX_PLANS = 256
DEFAULT_TTL_S = 30.0
DEFAULT_REPLAN_COOLDOWN_S = 5.0
DEFAULT_WARMUP_FAMILIES = 8
DEFAULT_WARMUP_INTERVAL_S = 1.0
DEFAULT_WARMUP_MOVES = 4


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
class TransferConfig:
    # Queue depth at (or above) which the best holder counts as
    # overloaded and a transfer is considered.
    load_threshold: float = DEFAULT_LOAD_THRESHOLD
    # Smallest matched prefix worth moving.
    min_blocks: int = DEFAULT_MIN_BLOCKS
    # Transfer must beat recompute by this fraction to be planned.
    price_margin: float = DEFAULT_PRICE_MARGIN
    max_plans: int = DEFAULT_MAX_PLANS
    ttl_s: float = DEFAULT_TTL_S
    # A hot chain gets one live plan at a time, and after one lands it
    # is not re-planned to the same target within this window.
    replan_cooldown_s: float = DEFAULT_REPLAN_COOLDOWN_S
    warmup_families: int = DEFAULT_WARMUP_FAMILIES
    warmup_interval_s: float = DEFAULT_WARMUP_INTERVAL_S
    warmup_moves: int = DEFAULT_WARMUP_MOVES

    @classmethod
    def from_env(cls) -> "TransferConfig":
        return cls(
            load_threshold=_env_float(
                "TRANSFER_LOAD_THRESHOLD", DEFAULT_LOAD_THRESHOLD
            ),
            min_blocks=_env_int(
                "TRANSFER_MIN_BLOCKS", DEFAULT_MIN_BLOCKS
            ),
            price_margin=_env_float(
                "TRANSFER_PRICE_MARGIN", DEFAULT_PRICE_MARGIN
            ),
            max_plans=_env_int("TRANSFER_MAX_PLANS", DEFAULT_MAX_PLANS),
            ttl_s=_env_float("TRANSFER_TTL_S", DEFAULT_TTL_S),
            replan_cooldown_s=_env_float(
                "TRANSFER_REPLAN_COOLDOWN_S", DEFAULT_REPLAN_COOLDOWN_S
            ),
            warmup_families=_env_int(
                "TRANSFER_WARMUP_FAMILIES", DEFAULT_WARMUP_FAMILIES
            ),
            warmup_interval_s=_env_float(
                "TRANSFER_WARMUP_INTERVAL_S", DEFAULT_WARMUP_INTERVAL_S
            ),
            warmup_moves=_env_int(
                "TRANSFER_WARMUP_MOVES", DEFAULT_WARMUP_MOVES
            ),
        )


class TransferEngine:
    """Composition root for the transfer subsystem."""

    def __init__(
        self,
        advisor: Optional[ComputeOrLoadAdvisor] = None,
        ledger=None,
        config: Optional[TransferConfig] = None,
    ) -> None:
        self.config = config or TransferConfig.from_env()
        if advisor is None:
            # Standalone: own advisor from the shared TIERING_* knobs
            # (the pricing inputs are the same measured RTT models).
            advisor = ComputeOrLoadAdvisor(TieringConfig.from_env().advisor)
        self.advisor = advisor
        self.ledger = ledger
        self.planner = TransferPlanner(
            advisor,
            load_threshold=self.config.load_threshold,
            min_blocks=self.config.min_blocks,
            price_margin=self.config.price_margin,
            max_plans=self.config.max_plans,
            ttl_s=self.config.ttl_s,
            replan_cooldown_s=self.config.replan_cooldown_s,
        )
        self.catalog = HotFamilyCatalog()
        self.executor: Optional[TransferExecutor] = None
        self.warmup: Optional[WarmupWorker] = None

    def bind_ledger(self, ledger) -> None:
        self.ledger = ledger
        if self.warmup is not None:
            self.warmup.ledger = ledger

    def attach_executor(
        self,
        index,
        pool,
        model_name: str,
        start_warmup: bool = True,
        device_medium: str = "hbm",
    ) -> TransferExecutor:
        """Bind the event channel; builds executor + warm-up worker.

        ``device_medium`` is the fleet's name for its device tier
        (``gpu`` for vLLM pods on GPUs); transferred chains land there.
        """
        self.executor = TransferExecutor(
            index, pool, model_name, device_medium=device_medium
        )
        self.warmup = WarmupWorker(
            self.catalog,
            self.planner,
            self.executor,
            ledger=self.ledger,
            warmup_families=self.config.warmup_families,
            interval_s=self.config.warmup_interval_s,
            moves_per_cycle=self.config.warmup_moves,
        )
        if start_warmup:
            self.warmup.start()
        return self.executor

    # -- scoring-path hook ----------------------------------------------

    def plan_for_chain(
        self,
        per_pod: Dict[str, dict],
        pod_loads: Optional[Dict[str, float]],
        block_keys: Sequence[int],
        token_ids: Optional[Sequence[int]] = None,
        block_size: int = 16,
    ) -> Optional[dict]:
        """Called by the indexer on the planned/explained scoring path,
        outside every index lock.  Notes the holder in the hot-family
        catalog, runs the planner, returns a directive dict (or None).
        Must never raise into scoring."""
        try:
            self._note_holder(per_pod, block_keys, token_ids, block_size)
            self.planner.expire()
            plan, outcome = self.planner.plan(
                per_pod,
                dict(pod_loads or {}),
                block_keys,
                token_ids=token_ids,
                block_size=block_size,
            )
            if plan is None:
                return {"planned": False, "outcome": outcome}
            return dict(plan.to_directive(), planned=True, outcome=outcome)
        except Exception:  # noqa: BLE001 — planner bugs stay out of scoring
            logger.exception("transfer planning failed")
            return None

    def _note_holder(
        self, per_pod, block_keys, token_ids, block_size
    ) -> None:
        if not block_keys:
            return
        holders = {
            pod: d for pod, d in per_pod.items() if d.get("score", 0) > 0
        }
        if not holders:
            return
        holder = min(
            holders, key=lambda p: (-holders[p].get("score", 0.0), p)
        )
        blocks = int(holders[holder].get("blocks_matched") or 0)
        if blocks <= 0:
            return
        family = self._family(block_keys)
        if family is None:
            return
        self.catalog.note(
            family,
            holder,
            list(block_keys)[:blocks],
            token_ids=list(token_ids or [])[: blocks * block_size],
            block_size=block_size,
            tier=_pick_tier(holders[holder].get("tiers")),
        )

    def _family(self, block_keys: Sequence[int]) -> Optional[int]:
        if self.ledger is not None:
            try:
                return self.ledger.family_key(
                    list(block_keys), len(block_keys)
                )
            except Exception:  # noqa: BLE001 — fall back to the
                # key-based family id below; the catalog stays usable
                # even if the ledger's keyspace disagrees.
                logger.debug(
                    "ledger family_key failed; using chain head",
                    exc_info=True,
                )
        # No ledger: the chain's first key identifies the family well
        # enough for the catalog (chained hashing commits to prefixes).
        return block_keys[0] if block_keys else None

    # -- warm-up passthroughs -------------------------------------------

    def register_cold_pod(self, pod_identifier: str) -> int:
        if self.warmup is None:
            raise RuntimeError(
                "attach_executor() before register_cold_pod()"
            )
        return self.warmup.register_cold_pod(pod_identifier)

    def run_warmup_cycle(self) -> int:
        if self.warmup is None:
            return 0
        return self.warmup.run_cycle()

    def invalidate_pod(self, pod_identifier: str) -> int:
        return self.planner.invalidate_pod(pod_identifier)

    def close(self) -> None:
        if self.warmup is not None:
            self.warmup.close()

    # -- status (the /debug/transfer payload) ----------------------------

    def status(self) -> dict:
        return {
            "config": {
                "load_threshold": self.config.load_threshold,
                "min_blocks": self.config.min_blocks,
                "price_margin": self.config.price_margin,
                "max_plans": self.config.max_plans,
                "ttl_s": self.config.ttl_s,
                "warmup_families": self.config.warmup_families,
                "warmup_interval_s": self.config.warmup_interval_s,
                "warmup_moves": self.config.warmup_moves,
            },
            "planner": self.planner.stats(),
            "catalog": self.catalog.stats(),
            "advisor": self.advisor.stats(),
            "executor": (
                self.executor.stats() if self.executor else None
            ),
            "warmup": self.warmup.status() if self.warmup else None,
        }
