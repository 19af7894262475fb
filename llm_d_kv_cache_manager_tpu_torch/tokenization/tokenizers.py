"""Tokenizer backends.

The reference reaches HF's Rust tokenizers through cgo and a UDS sidecar
(pkg/tokenization/tokenizer.go, services/uds_tokenizer) because its host
language is Go.  Here the host *is* Python, so the Rust tokenizers bind in
directly — one process model, no sidecar tax (SURVEY §7.2).  Backends:

* ``LocalFastTokenizer`` — ``tokenizer.json`` from disk, with the same
  auto-discovery the reference does (direct path, ``<dir>/<model>/``, and
  HF-cache ``models--org--name/snapshots/*`` layouts,
  tokenizer.go:163-257).
* ``TransformersTokenizer`` — ``AutoTokenizer`` (hub or cache).
* ``CompositeTokenizer`` — ordered fallback with error accumulation and
  per-backend latency/token metrics (tokenizer.go:458-529).

All backends return byte-unit offsets (converted from the HF library's
char units) because the prefix store chunks UTF-8 bytes.

Copied from the JAX reference's ``tokenization/tokenizers.py``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("tokenization")


@dataclass
class Encoding:
    tokens: List[int]
    # Byte offsets (start, end) of each token in the UTF-8 prompt.
    offsets: List[Tuple[int, int]]


def load_auto_tokenizer(
    model_name: str,
    revision: Optional[str] = None,
    auth_token: Optional[str] = None,
):
    """Cache-first ``AutoTokenizer`` load.

    Tries the local HF cache before touching the hub: in zero-egress
    deployments the hub path burns minutes in connection retries per model
    before failing (observed in verification), and the local path is also
    faster when the model is cached.
    """
    from transformers import AutoTokenizer

    try:
        return AutoTokenizer.from_pretrained(
            model_name,
            revision=revision,
            token=auth_token,
            use_fast=True,
            local_files_only=True,
        )
    except Exception:
        if os.environ.get("HF_HUB_OFFLINE"):
            raise
        return AutoTokenizer.from_pretrained(
            model_name, revision=revision, token=auth_token, use_fast=True
        )


def char_offsets_to_byte_offsets(
    text: str, offsets: Sequence[Tuple[int, int]]
) -> List[Tuple[int, int]]:
    """Convert char-unit offsets (HF convention) to byte units."""
    if len(text) == len(text.encode("utf-8")):
        # Pure ASCII: char offsets already are byte offsets.
        return list(offsets)
    byte_at: List[int] = [0] * (len(text) + 1)
    total = 0
    for i, ch in enumerate(text):
        total += len(ch.encode("utf-8"))
        byte_at[i + 1] = total
    n = len(text)
    return [
        (byte_at[min(start, n)], byte_at[min(end, n)])
        for start, end in offsets
    ]


class Tokenizer(Protocol):
    def encode(
        self, prompt: str, model_name: str, add_special_tokens: bool
    ) -> Encoding:
        ...

    def type(self) -> str:
        ...


class LocalFastTokenizer:
    """Loads ``tokenizer.json`` files from a local directory tree."""

    def __init__(self, tokenizers_dir: str) -> None:
        self.tokenizers_dir = tokenizers_dir
        self._cache: Dict[str, object] = {}

    def type(self) -> str:
        return "local"

    def _discover(self, model_name: str) -> Optional[str]:
        base = self.tokenizers_dir
        candidates = [
            os.path.join(base, model_name, "tokenizer.json"),
            os.path.join(base, model_name.replace("/", "--"), "tokenizer.json"),
        ]
        # HF cache layout: models--org--name/snapshots/<rev>/tokenizer.json
        hub_dir = os.path.join(
            base, "models--" + model_name.replace("/", "--"), "snapshots"
        )
        if os.path.isdir(hub_dir):
            for revision in sorted(os.listdir(hub_dir)):
                candidates.append(
                    os.path.join(hub_dir, revision, "tokenizer.json")
                )
        if model_name.endswith(".json"):
            candidates.append(os.path.join(base, model_name))
        for path in candidates:
            if os.path.isfile(path):
                return path
        return None

    def _load(self, model_name: str):
        cached = self._cache.get(model_name)
        if cached is not None:
            return cached
        path = self._discover(model_name)
        if path is None:
            raise FileNotFoundError(
                f"no tokenizer.json for {model_name!r} under "
                f"{self.tokenizers_dir!r}"
            )
        from tokenizers import Tokenizer as FastTokenizer

        tokenizer = FastTokenizer.from_file(path)
        self._cache[model_name] = tokenizer
        logger.info("loaded local tokenizer for %s from %s", model_name, path)
        return tokenizer

    def encode(
        self, prompt: str, model_name: str, add_special_tokens: bool
    ) -> Encoding:
        tokenizer = self._load(model_name)
        encoding = tokenizer.encode(
            prompt, add_special_tokens=add_special_tokens
        )
        return Encoding(
            tokens=list(encoding.ids),
            offsets=char_offsets_to_byte_offsets(prompt, encoding.offsets),
        )


class TransformersTokenizer:
    """``AutoTokenizer``-based backend (hub download or local cache)."""

    def __init__(self, auth_token: Optional[str] = None) -> None:
        self._auth_token = auth_token or os.environ.get("HF_TOKEN")
        self._cache: Dict[str, object] = {}

    def type(self) -> str:
        return "transformers"

    def _load(self, model_name: str):
        cached = self._cache.get(model_name)
        if cached is not None:
            return cached
        tokenizer = load_auto_tokenizer(
            model_name, auth_token=self._auth_token
        )
        self._cache[model_name] = tokenizer
        return tokenizer

    def encode(
        self, prompt: str, model_name: str, add_special_tokens: bool
    ) -> Encoding:
        tokenizer = self._load(model_name)
        output = tokenizer(
            prompt,
            add_special_tokens=add_special_tokens,
            return_offsets_mapping=True,
        )
        return Encoding(
            tokens=list(output["input_ids"]),
            offsets=char_offsets_to_byte_offsets(
                prompt, output["offset_mapping"]
            ),
        )


class CompositeTokenizer:
    """Ordered fallback across backends, with per-backend metrics."""

    def __init__(self, backends: Sequence[Tokenizer]) -> None:
        if not backends:
            raise ValueError("composite tokenizer needs at least one backend")
        self.backends = list(backends)

    def type(self) -> str:
        return "composite(" + ",".join(b.type() for b in self.backends) + ")"

    def encode(
        self, prompt: str, model_name: str, add_special_tokens: bool
    ) -> Encoding:
        errors: List[str] = []
        for backend in self.backends:
            start = time.perf_counter()
            try:
                encoding = backend.encode(
                    prompt, model_name, add_special_tokens
                )
            except Exception as exc:  # try the next backend
                errors.append(f"{backend.type()}: {exc}")
                continue
            METRICS.tokenization_latency.labels(backend.type()).observe(
                time.perf_counter() - start
            )
            METRICS.tokenization_tokens.labels(backend.type()).inc(
                len(encoding.tokens)
            )
            return encoding
        raise RuntimeError(
            f"all tokenizer backends failed for {model_name!r}: "
            + "; ".join(errors)
        )
