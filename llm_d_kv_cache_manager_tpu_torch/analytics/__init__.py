"""Cache-efficiency analytics: hit-attribution ledger + index-truth
auditor (docs/observability.md).

The auditor names are lazy (PEP 562), as in the reference: they pull
the kvevents stack for the ``InventorySource`` contract, which the
ledger (constructed by every ``Indexer``) does not drag onto the
scoring path's import graph.
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

_AUDITOR_EXPORTS = ("AuditorConfig", "AuditReport", "IndexAuditor")

__all__ = [
    "CacheStatsLedger",
    "LedgerConfig",
    "Frame",
    "WindowRing",
    "standard_windows",
    *_AUDITOR_EXPORTS,
]


def __getattr__(name):
    if name in _AUDITOR_EXPORTS:
        from llm_d_kv_cache_manager_tpu_torch.analytics import auditor

        return getattr(auditor, name)
    raise AttributeError(name)
