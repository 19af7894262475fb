"""Inference-scheduler integration (reference: examples/kv_cache_aware_scorer).

Copied from the JAX reference's ``scheduler/__init__.py``."""

from llm_d_kv_cache_manager_tpu_torch.scheduler.precise_scorer import (
    ChatCompletionsBody,
    ChatMessage,
    CompletionsBody,
    LLMRequest,
    Pod,
    PrecisePrefixCacheScorer,
    PrecisePrefixCacheScorerConfig,
)

__all__ = [
    "ChatCompletionsBody",
    "ChatMessage",
    "CompletionsBody",
    "LLMRequest",
    "Pod",
    "PrecisePrefixCacheScorer",
    "PrecisePrefixCacheScorerConfig",
]
