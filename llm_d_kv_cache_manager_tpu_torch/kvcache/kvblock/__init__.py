"""Block keys, the block index contract and its in-memory backend."""

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import (  # noqa: F401
    EMPTY_BLOCK_HASH,
    Index,
    IndexConfig,
    PodEntry,
    new_index,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (  # noqa: F401
    ChunkedTokenDatabase,
    TokenProcessor,
    TokenProcessorConfig,
)
