from llm_d_kv_cache_manager_tpu_torch.tokenization.pool import (  # noqa: F401
    TokenizationPool,
    TokenizationPoolConfig,
)
from llm_d_kv_cache_manager_tpu_torch.tokenization.tokenizers import (  # noqa: F401
    CompositeTokenizer,
    Encoding,
    LocalFastTokenizer,
    Tokenizer,
    TransformersTokenizer,
)
