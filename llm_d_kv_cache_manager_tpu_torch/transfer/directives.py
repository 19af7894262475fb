"""Transfer execution: the directive channel's write side.

A :class:`TransferPlan` is advice until something moves bytes.  The
executor is that something for the in-repo path (the bytes themselves
are the caller's to move before it runs): it validates the plan against
the *live* index, then publishes real ``BlockStored``/``BlockRemoved``
KVEvents through the same ingestion-pool sink the demotion worker uses
(:func:`tiering.demotion.pool_event_sink`), so the index, the
cachestats ledger, and the cluster journal all observe the move
through the ordinary decode/apply path — no side door.

Two safety properties the tests pin:

* **No phantom entries.**  Before publishing anything the executor
  re-reads the source pod's residency.  A source that died (or evicted
  the chain) after planning invalidates the plan and publishes
  NOTHING; a partially-evicted chain executes only the surviving
  prefix.
* **Demotion-race safe.**  The source tier recorded at plan time may
  be stale — a demotion worker can move the chain down a rung between
  plan and execute.  The executor re-reads the *current* tier from the
  index at execute time, so a "move" removes from the tier the source
  actually holds, never the tier the plan remembered.

The target's ``BlockStored`` carries ``device_medium``, the name under
which the fleet's engines publish their device tier (``hbm`` on TPU
pods, ``gpu`` on vLLM pods on GPUs), so the target engine's own later
``BlockRemoved`` takes the entry out again.

``mode="copy"`` (the default, and all warm-up uses) leaves the source
untouched: pod-to-pod replication.  ``mode="move"`` also removes the
source entries — store-before-remove, same as demotion, so a scorer
racing the transfer never sees an empty window.
"""

from __future__ import annotations

from typing import Optional

from llm_d_kv_cache_manager_tpu_torch.kvevents.events import (
    BlockRemoved,
    BlockStored,
)
from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.tiering.demotion import pool_event_sink
from llm_d_kv_cache_manager_tpu_torch.transfer.planner import (
    DONE,
    EXECUTING,
    INVALIDATED,
    PLANNED,
    TransferPlan,
)
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("transfer.directives")


class TransferExecutor:
    """Execute plans against a kvblock index via a kvevents pool."""

    def __init__(
        self, index, pool, model_name: str, device_medium: str = "hbm"
    ) -> None:
        self.index = index
        self.pool = pool
        self.model_name = model_name
        self.device_medium = device_medium
        self._executed = 0
        self._invalidated = 0

    def _surviving_prefix(self, plan: TransferPlan) -> int:
        """How many leading blocks the source still holds, per the
        live index (0 = chain gone or source dead)."""
        found = self.index.lookup(
            plan.block_keys, {plan.source_pod}
        )
        n = 0
        for key in plan.block_keys:
            entries = found.get(key)
            if not entries:
                break
            n += 1
        return n

    def _current_source_tier(self, plan: TransferPlan) -> Optional[str]:
        found = self.index.lookup(
            plan.block_keys[:1], {plan.source_pod}
        )
        for entries in found.values():
            for entry in entries:
                if entry.pod_identifier == plan.source_pod:
                    return entry.device_tier
        return None

    def execute(self, plan: TransferPlan, mode: str = "copy") -> bool:
        """Run one plan; True iff events were published."""
        if plan.state != PLANNED:
            METRICS.transfer_executions.labels(outcome="stale").inc()
            return False
        plan.state = EXECUTING
        surviving = self._surviving_prefix(plan)
        if surviving == 0:
            # Source died (or evicted the chain) after planning: the
            # plan is void and NO events flow — publishing would plant
            # phantom residency at the target for bytes nobody holds.
            plan.state = INVALIDATED
            self._invalidated += 1
            METRICS.transfer_executions.labels(outcome="invalidated").inc()
            logger.warning(
                "plan %d invalidated: %s no longer holds the chain",
                plan.plan_id,
                plan.source_pod,
            )
            return False
        # Re-read the tier NOW — a demotion may have moved the chain
        # since plan time (the transfer-vs-demotion race).
        source_tier = self._current_source_tier(plan) or plan.tier
        hashes = list(plan.engine_hashes[:surviving])
        tokens = list(plan.token_ids[: surviving * plan.block_size])
        stored = BlockStored(
            block_hashes=hashes,
            parent_block_hash=None,
            token_ids=tokens,
            block_size=plan.block_size,
            # The target receives into device memory: transfers warm
            # the fast tier, that is their point.
            medium=self.device_medium,
        )
        pool_event_sink(self.pool, plan.target_pod, self.model_name)(
            [stored]
        )
        if mode == "move":
            pool_event_sink(
                self.pool, plan.source_pod, self.model_name
            )([BlockRemoved(block_hashes=hashes, medium=source_tier)])
        plan.state = DONE
        self._executed += 1
        nbytes = (
            plan.nbytes * surviving // plan.blocks
            if plan.blocks
            else 0
        )
        outcome = "moved" if mode == "move" else "copied"
        if surviving < plan.blocks:
            outcome = f"partial-{outcome}"
        METRICS.transfer_executions.labels(outcome=outcome).inc()
        METRICS.transfer_bytes.inc(nbytes)
        return True

    def stats(self) -> dict:
        return {
            "executed": self._executed,
            "invalidated": self._invalidated,
        }
