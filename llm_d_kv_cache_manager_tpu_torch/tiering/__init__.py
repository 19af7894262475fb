"""Predictive tiering: the policy brain between analytics and the
offload/index planes.

The hit-attribution ledger's per-family reuse EWMA, the per-tier score
explain and the offload jobs' measured transfers are measurement; this
package turns them into decisions, behind one :class:`PolicyEngine`:

* :mod:`policy_feed` — the stable contract exporting per-family reuse
  predictions from the cachestats ledger (plus the hash-chain
  clustering signal per HashEvict), consumed as immutable snapshots so
  policy reads never take analytics locks;
* :mod:`eviction` — predicted-next-use x byte-cost eviction ranking,
  plugged into ``CostAwareMemoryIndex`` and ``HostTierCache`` (LRU
  remains the escape hatch and the parity oracle);
* :mod:`demotion` — the proactive HBM -> host -> shared_storage
  demotion worker, publishing ``medium``-tagged KVEvents so the
  scorer's tier weights finally rank real residency;
* :mod:`staged_target` — the demotion target whose rungs move a GPU
  pool's bytes: a device gather into the host tier, then a file write;
* :mod:`advisor` — the compute-or-load advisor: measured readback RTT
  vs the model's prefill rate, per prefix chunk, returning
  load / recompute / hybrid-overlap.

This is the JAX package's ``tiering/`` over the port's ledger, index,
event pool, host tier and ``KVCachePool``; docs/tiering.md describes
the contract, the eviction formula, the demotion state machine, and the
compute-or-load decision rule of both.
"""

from llm_d_kv_cache_manager_tpu_torch.tiering.advisor import (
    Advice,
    AdvisorConfig,
    ComputeOrLoadAdvisor,
    RttEstimator,
)
from llm_d_kv_cache_manager_tpu_torch.tiering.demotion import (
    DemotionConfig,
    DemotionWorker,
    PodTierState,
    pool_event_sink,
)
from llm_d_kv_cache_manager_tpu_torch.tiering.engine import (
    PolicyEngine,
    TieringConfig,
)
from llm_d_kv_cache_manager_tpu_torch.tiering.eviction import (
    LRU_POLICY,
    PredictiveEvictionPolicy,
)
from llm_d_kv_cache_manager_tpu_torch.tiering.policy_feed import (
    PolicyFeed,
    PolicyFeedConfig,
    PolicySnapshot,
    ReusePrediction,
)
from llm_d_kv_cache_manager_tpu_torch.tiering.staged_target import (
    StagedDemotionTarget,
)

__all__ = [
    "Advice",
    "AdvisorConfig",
    "ComputeOrLoadAdvisor",
    "DemotionConfig",
    "DemotionWorker",
    "LRU_POLICY",
    "PodTierState",
    "PolicyEngine",
    "PolicyFeed",
    "PolicyFeedConfig",
    "PolicySnapshot",
    "PredictiveEvictionPolicy",
    "ReusePrediction",
    "RttEstimator",
    "StagedDemotionTarget",
    "TieringConfig",
    "pool_event_sink",
]
