from llm_d_kv_cache_manager_tpu_torch.metrics.collector import (  # noqa: F401
    METRICS,
    KVCacheMetrics,
    start_metrics_logging,
)
