"""Chat-template preprocessing.

Chat-completions requests must be rendered to the *exact* prompt string the
serving engine will tokenize, or block hashes diverge and the hit rate
silently zeroes.  The reference pays a heavy tax for this — a Go process
embedding a CPython interpreter through cgo to reach
``tokenizer.apply_chat_template`` (pkg/preprocessing/chat_completions/,
~950 LoC across three languages; SURVEY §7.2 calls it the biggest
complexity tax).  This framework's host language is Python, so the same
capability is a direct call into ``transformers``; tokenizers are cached
per ``(model, revision, is_local)`` like the reference's wrapper
(tokenizer_wrapper.py:104-118).

Copied from the JAX reference's ``preprocessing/chat_templating.py``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ApplyChatTemplateRequest:
    """Mirror of the OpenAI chat-completions preprocessing surface
    (reference: cgo_functions.go:51-62)."""

    conversation: List[Dict[str, Any]] = field(default_factory=list)
    tools: Optional[List[Dict[str, Any]]] = None
    documents: Optional[List[Dict[str, Any]]] = None
    chat_template: Optional[str] = None
    add_generation_prompt: bool = True
    continue_final_message: bool = False
    chat_template_kwargs: Optional[Dict[str, Any]] = None
    model: Optional[str] = None
    revision: Optional[str] = None


class ChatTemplatingProcessor:
    """Renders chat conversations to prompt strings via transformers."""

    def __init__(self) -> None:
        self._tokenizers: Dict[str, Any] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def tokenizer_key(
        self, model: str, revision: Optional[str] = None
    ) -> str:
        return f"{model}:{revision or 'main'}"

    def _get_tokenizer(self, model: str, revision: Optional[str]):
        key = self.tokenizer_key(model, revision)
        with self._lock:
            tokenizer = self._tokenizers.get(key)
        if tokenizer is None:
            from llm_d_kv_cache_manager_tpu_torch.tokenization.tokenizers import (
                load_auto_tokenizer,
            )

            loaded = load_auto_tokenizer(model, revision=revision)
            with self._lock:
                # Two threads may both load; setdefault re-decides
                # under the lock so the first insert wins and both
                # callers share one instance.  # kvlint: atomic-ok
                tokenizer = self._tokenizers.setdefault(key, loaded)
        return tokenizer

    def register_tokenizer(
        self, model: str, tokenizer, revision: Optional[str] = None
    ) -> None:
        """Inject a pre-built tokenizer (local models, tests)."""
        with self._lock:
            self._tokenizers[self.tokenizer_key(model, revision)] = tokenizer

    def apply_chat_template(
        self, model: str, request: ApplyChatTemplateRequest
    ) -> str:
        """Render to a prompt string (never tokenized here — the
        tokenization pool owns that, with add_special_tokens=False)."""
        tokenizer = self._get_tokenizer(
            request.model or model, request.revision
        )
        kwargs: Dict[str, Any] = dict(request.chat_template_kwargs or {})
        return tokenizer.apply_chat_template(
            request.conversation,
            tools=request.tools,
            documents=request.documents,
            chat_template=request.chat_template,
            add_generation_prompt=request.add_generation_prompt,
            continue_final_message=request.continue_final_message,
            tokenize=False,
            **kwargs,
        )
