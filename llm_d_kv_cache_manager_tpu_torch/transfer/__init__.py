"""KV-transfer planning plane: transfer-aware routing, pod-to-pod
block movement, instant-warm scale-out.

The scorer (kvcache/scorer.py) answers "who already holds the longest
prefix"; this package answers "who could *cheaply get it*" — the
planning plane between scoring and the tier/offload machinery:

* :mod:`planner` — :class:`TransferPlanner` prices pod-to-pod block
  movement against recompute using the tiering advisor's measured
  read- and write-side RTT estimators, and tracks plans in a bounded
  TTL registry;
* :mod:`directives` — :class:`TransferExecutor` validates a plan
  against the live index and publishes real ``BlockStored`` /
  ``BlockRemoved`` KVEvents through the ingestion-pool sink, so the
  index, ledger, and cluster journal observe the move through the
  ordinary decode/apply path (the port's codec and event pool);
* :mod:`warmup` — instant-warm scale-out: a cold pod registers, the
  planner bulk-plans its share of hot families (ranked by cachestats
  ``reuse_predictions()``), and a budgeted worker drains the queue;
* :mod:`engine` — :class:`TransferEngine`, the composition root that
  embedding code attaches to an ``Indexer`` (``set_transfer_engine``).

This is the JAX package's ``transfer/`` over the port's index and event
pool; docs/transfer.md describes the plan lifecycle, the pricing
formula, and the warm-up state machine of both.
"""

from llm_d_kv_cache_manager_tpu_torch.transfer.directives import TransferExecutor
from llm_d_kv_cache_manager_tpu_torch.transfer.engine import (
    TransferConfig,
    TransferEngine,
)
from llm_d_kv_cache_manager_tpu_torch.transfer.planner import (
    DONE,
    EXECUTING,
    EXPIRED,
    INVALIDATED,
    PLANNED,
    TransferPlan,
    TransferPlanner,
)
from llm_d_kv_cache_manager_tpu_torch.transfer.warmup import (
    HotFamilyCatalog,
    HotFamilyRecord,
    WarmupWorker,
)

__all__ = [
    "DONE",
    "EXECUTING",
    "EXPIRED",
    "INVALIDATED",
    "PLANNED",
    "HotFamilyCatalog",
    "HotFamilyRecord",
    "TransferConfig",
    "TransferEngine",
    "TransferExecutor",
    "TransferPlan",
    "TransferPlanner",
    "WarmupWorker",
]
