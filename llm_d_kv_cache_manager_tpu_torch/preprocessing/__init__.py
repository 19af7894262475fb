from llm_d_kv_cache_manager_tpu_torch.preprocessing.chat_templating import (  # noqa: F401
    ApplyChatTemplateRequest,
    ChatTemplatingProcessor,
)
