from llm_d_kv_cache_manager_tpu_torch.tokenization.prefixstore.lru_store import (  # noqa: F401
    LRUStoreConfig,
    LRUTokenStore,
)
from llm_d_kv_cache_manager_tpu_torch.tokenization.prefixstore.trie_store import (  # noqa: F401
    TrieTokenStore,
)
