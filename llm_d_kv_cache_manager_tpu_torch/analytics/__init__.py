"""Cache-efficiency analytics: the hit-attribution ledger
(docs/observability.md).  The reference's index-truth auditor
(``analytics/auditor.py``) is not ported yet (ROADMAP.md, Queue A).
"""

from llm_d_kv_cache_manager_tpu_torch.analytics.ledger import (
    CacheStatsLedger,
    LedgerConfig,
)
from llm_d_kv_cache_manager_tpu_torch.analytics.windows import (
    Frame,
    WindowRing,
    standard_windows,
)

__all__ = [
    "CacheStatsLedger",
    "LedgerConfig",
    "Frame",
    "WindowRing",
    "standard_windows",
]
