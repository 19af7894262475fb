"""UDS gRPC tokenizer client backend.

Counterpart of the reference's Go client
(pkg/tokenization/uds_tokenizer.go:58-182): connects to the tokenizer
sidecar over a Unix-domain socket, 100 MB message caps, keepalive, and a
5-attempt exponential-backoff init.  Implements the ``Tokenizer``
protocol so it slots into ``CompositeTokenizer`` ahead of or behind the
in-process backends.

Copied from the JAX reference's ``tokenization/uds_tokenizer.py``.  It
imports ``grpc``, so ``kvcache.indexer`` imports it only when an
``IndexerConfig`` names a ``uds_tokenizer_path``.
"""

from __future__ import annotations

import time
from typing import Optional

import grpc

from llm_d_kv_cache_manager_tpu_torch.api import tokenizer_pb2
from llm_d_kv_cache_manager_tpu_torch.api.grpc_services import (
    TokenizationServiceStub,
)
from llm_d_kv_cache_manager_tpu_torch.tokenization.tokenizers import (
    Encoding,
    char_offsets_to_byte_offsets,
)
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("tokenization.uds")

MAX_MESSAGE_BYTES = 100 * 1024 * 1024
INIT_RETRIES = 5
INIT_BACKOFF_SECONDS = 0.2


class UdsTokenizer:
    """Tokenizes via the sidecar service (services/uds_tokenizer.py)."""

    def __init__(
        self,
        uds_path: str = "/tmp/kvcache_tokenizer.sock",
        timeout_seconds: float = 30.0,
    ) -> None:
        self.uds_path = uds_path
        self.timeout_seconds = timeout_seconds
        self._channel = grpc.insecure_channel(
            f"unix://{uds_path}",
            options=[
                ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
                ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                ("grpc.keepalive_time_ms", 30_000),
                ("grpc.keepalive_timeout_ms", 10_000),
            ],
        )
        self._stub = TokenizationServiceStub(self._channel)

    def type(self) -> str:
        return "uds"

    def close(self) -> None:
        self._channel.close()

    def initialize_model(self, model_name: str) -> None:
        """Pre-warm with retry/backoff (uds_tokenizer.go:113-142)."""
        last_error: Optional[Exception] = None
        for attempt in range(INIT_RETRIES):
            try:
                response = self._stub.InitializeTokenizer(
                    tokenizer_pb2.InitializeTokenizerRequest(
                        model_name=model_name
                    ),
                    timeout=self.timeout_seconds,
                )
                if response.success:
                    return
                last_error = RuntimeError(response.error_message)
            except grpc.RpcError as exc:
                last_error = exc
            if attempt < INIT_RETRIES - 1:
                time.sleep(INIT_BACKOFF_SECONDS * (2**attempt))
        raise RuntimeError(
            f"tokenizer init failed for {model_name!r} after "
            f"{INIT_RETRIES} attempts: {last_error}"
        )

    def encode(
        self, prompt: str, model_name: str, add_special_tokens: bool
    ) -> Encoding:
        response = self._stub.Tokenize(
            tokenizer_pb2.TokenizeRequest(
                input=prompt,
                model_name=model_name,
                add_special_tokens=add_special_tokens,
            ),
            timeout=self.timeout_seconds,
        )
        if not response.success:
            raise RuntimeError(
                f"sidecar tokenize failed: {response.error_message}"
            )
        pairs = list(response.offset_pairs)
        offsets = list(zip(pairs[0::2], pairs[1::2]))
        return Encoding(
            tokens=list(response.input_ids),
            offsets=char_offsets_to_byte_offsets(prompt, offsets),
        )
