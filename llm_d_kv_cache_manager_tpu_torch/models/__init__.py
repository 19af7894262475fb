from llm_d_kv_cache_manager_tpu_torch.models.kv_cache_pool import (  # noqa: F401
    KVCachePool,
    KVCachePoolConfig,
)
