"""Tokenizer sidecar: TokenizationService over a Unix-domain socket.

Counterpart of the reference's Python sidecar
(services/uds_tokenizer/tokenizer_grpc_service.py:32-160): per-model
cached HF tokenizers, ``Tokenize`` with offset mapping, chat-template
rendering, and an init RPC that pre-warms a model.  The reference runs
this to give its Go indexer tokenizer access across a process boundary;
here it exists for the same fleet topology (a shared tokenizer sidecar
serving many indexer replicas) and for reference-client compat — the
in-process backends (tokenization/tokenizers.py) remain the default.

Message caps mirror the reference client's 100 MB limits
(pkg/tokenization/uds_tokenizer.go:64-77).

Copied from the JAX reference's ``services/uds_tokenizer.py``; hub and
ModelScope downloads go through the same lazily imported
``snapshot_download``.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
import threading
from concurrent import futures
from typing import Dict, Optional

import grpc

from llm_d_kv_cache_manager_tpu_torch.api import tokenizer_pb2
from llm_d_kv_cache_manager_tpu_torch.api.grpc_services import (
    TokenizationServiceServicer,
    add_tokenization_servicer,
    struct_map_to_dict,
)
from llm_d_kv_cache_manager_tpu_torch.tokenization.tokenizers import (
    load_auto_tokenizer,
)
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("services.uds_tokenizer")

MAX_MESSAGE_BYTES = 100 * 1024 * 1024

_HUB_SEGMENT = re.compile(r"[A-Za-z0-9_.\-]+")

# Download hygiene (reference: tokenizer_service/tokenizer.py:150-178):
# a tokenizer sidecar must never pull model weights — snapshot downloads
# are restricted to tokenizer-related files.  `tokenizer.model` is added
# beyond the reference's list so sentencepiece-only models work too.
TOKENIZER_FILE_PATTERNS = [
    "tokenizer.json",
    "tokenizer_config.json",
    "special_tokens_map.json",
    "vocab.json",
    "merges.txt",
    "config.json",
    "generation_config.json",
    "tokenizer.model",
]

# A usable cached download: config plus either a fast-tokenizer json or
# a sentencepiece model (reference tokenizer.py:84-88 requires
# tokenizer.json only, which would re-download sentencepiece-only
# models forever).
REQUIRED_CACHED_FILE = "config.json"
ANY_OF_CACHED_FILES = ("tokenizer.json", "tokenizer.model")


def _is_cached(local_path: str) -> bool:
    return os.path.exists(
        os.path.join(local_path, REQUIRED_CACHED_FILE)
    ) and any(
        os.path.exists(os.path.join(local_path, f))
        for f in ANY_OF_CACHED_FILES
    )


def is_remote_model(model_identifier: str) -> bool:
    """Remote hub name (``org/model``) vs local filesystem path
    (reference tokenizer.py:196-214)."""
    if os.path.isabs(model_identifier):
        return False
    if model_identifier.startswith(("./", "../")):
        return False
    if os.path.exists(model_identifier):
        return False
    return True


def _validate_hub_id(model_identifier: str) -> None:
    """Hub ids name the cache subdirectory; refuse anything that could
    traverse out of it (a UDS client controls this string)."""
    parts = model_identifier.split("/")
    if len(parts) > 2 or not all(
        part and part.strip(".") and _HUB_SEGMENT.fullmatch(part)
        for part in parts
    ):
        raise ValueError(
            f"invalid hub model identifier {model_identifier!r}"
        )


def _default_cache_dir() -> str:
    return os.environ.get(
        "TOKENIZER_CACHE_DIR",
        os.path.join(
            os.path.expanduser("~"), ".cache", "kvtpu", "tokenizers"
        ),
    )


def fetch_tokenizer_files(
    model_identifier: str, cache_dir: Optional[str] = None
) -> str:
    """Materialize ONLY tokenizer-related files locally; return the path.

    Resolution order (reference tokenizer.py:60-104):

    1. Local path: returned as-is, nothing downloaded.
    2. Sidecar cache hit (config + tokenizer.json/.model present): reused.
    3. Snapshot download restricted to ``TOKENIZER_FILE_PATTERNS`` from
       ModelScope when ``USE_MODELSCOPE=true``, else Hugging Face.

    Downloads land in a temp directory and are renamed into place only
    when complete, so a half-written download (network blip mid-snapshot)
    can never masquerade as a cache hit on the next call.
    """
    if not is_remote_model(model_identifier):
        return model_identifier
    _validate_hub_id(model_identifier)

    local_path = os.path.join(
        cache_dir or _default_cache_dir(), *model_identifier.split("/")
    )
    if _is_cached(local_path):
        logger.info("using cached tokenizer files at %s", local_path)
        return local_path

    use_modelscope = (
        os.environ.get("USE_MODELSCOPE", "false").lower() == "true"
    )
    if use_modelscope:
        from modelscope import snapshot_download
    else:
        from huggingface_hub import snapshot_download
    # A UNIQUE temp dir per call (mkdtemp, not a pid suffix): concurrent
    # fetches of the same model — two RPC threads, or two sidecar
    # replicas on a shared volume — must never share a staging dir, or
    # one's rename publishes the other's half-written files.
    parent = os.path.dirname(local_path)
    os.makedirs(parent, exist_ok=True)
    tmp_path = tempfile.mkdtemp(
        dir=parent, prefix=f".{os.path.basename(local_path)}.tmp-"
    )
    # mkdtemp's fixed 0700 would survive os.replace and lock other UIDs
    # (shared-volume sidecar replicas) out of the published cache dir.
    os.chmod(tmp_path, 0o755)
    try:
        snapshot_download(
            model_identifier,
            local_dir=tmp_path,
            allow_patterns=TOKENIZER_FILE_PATTERNS,
        )
    except Exception:
        shutil.rmtree(tmp_path, ignore_errors=True)
        logger.exception(
            "tokenizer-file download failed for %s (%s)",
            model_identifier,
            "modelscope" if use_modelscope else "huggingface",
        )
        raise
    try:
        os.replace(tmp_path, local_path)
    except OSError:
        # Lost the publish race (target created between our cache check
        # and now, e.g. ENOTEMPTY); the winner's copy serves everyone.
        shutil.rmtree(tmp_path, ignore_errors=True)
        if not _is_cached(local_path):
            raise
    logger.info(
        "downloaded tokenizer files for %s to %s",
        model_identifier,
        local_path,
    )
    return local_path


def load_sidecar_tokenizer(model_identifier: str):
    """Tokenizer-files-only load for the sidecar.

    Cache-first like ``load_auto_tokenizer``: the standard HF cache is
    tried before any network touch (zero-egress pods with warm caches
    must keep working), then the tokenizer-files-only download, then the
    full ``AutoTokenizer`` path as a last resort.
    """
    from transformers import AutoTokenizer

    if is_remote_model(model_identifier):
        try:
            return AutoTokenizer.from_pretrained(
                model_identifier, use_fast=True, local_files_only=True
            )
        except Exception as exc:
            # Expected on cold pods; the sidecar download path follows.
            logger.debug(
                "%s not in the local HF cache (%s); trying the sidecar "
                "download path",
                model_identifier,
                exc,
            )
    try:
        path = fetch_tokenizer_files(model_identifier)
    except ImportError:  # no hub client available
        return load_auto_tokenizer(model_identifier)
    if path == model_identifier:
        return load_auto_tokenizer(model_identifier)
    return AutoTokenizer.from_pretrained(path, use_fast=True)


class TokenizerRegistry:
    """Thread-safe per-model tokenizer cache (reference:
    tokenizer_service/tokenizer.py:104-140)."""

    def __init__(self, loader=load_sidecar_tokenizer) -> None:
        self._tokenizers: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._loader = loader

    def register(self, model_name: str, tokenizer) -> None:
        """Inject a pre-built tokenizer (tests, local models)."""
        with self._lock:
            self._tokenizers[model_name] = tokenizer

    def get(self, model_name: str):
        with self._lock:
            tokenizer = self._tokenizers.get(model_name)
        if tokenizer is None:
            tokenizer = self._loader(model_name)
            with self._lock:
                self._tokenizers[model_name] = tokenizer
        return tokenizer


class TokenizationGrpcService(TokenizationServiceServicer):
    def __init__(self, registry: Optional[TokenizerRegistry] = None) -> None:
        self.registry = registry or TokenizerRegistry()

    def Tokenize(self, request, context):
        response = tokenizer_pb2.TokenizeResponse()
        try:
            tokenizer = self.registry.get(request.model_name)
            output = tokenizer(
                request.input,
                add_special_tokens=request.add_special_tokens,
                return_offsets_mapping=True,
            )
            response.input_ids.extend(output["input_ids"])
            for start, end in output["offset_mapping"]:
                response.offset_pairs.extend((start, end))
            response.success = True
        except Exception as exc:
            logger.exception("Tokenize failed for %s", request.model_name)
            response.success = False
            response.error_message = str(exc)
        return response

    def RenderChatTemplate(self, request, context):
        response = tokenizer_pb2.ChatTemplateResponse()
        try:
            tokenizer = self.registry.get(request.model_name)
            # Turns are a wire-batching artifact; the template sees one
            # flat message list (HF batch mode would otherwise return a
            # list of strings for multi-turn requests).
            conversation = [
                {"role": m.role, "content": m.content}
                for turn in request.conversation_turns
                for m in turn.messages
            ]
            tools = [
                struct_map_to_dict(tool.tool) for tool in request.tools
            ] or None
            documents = [
                struct_map_to_dict(doc.document) for doc in request.documents
            ] or None
            kwargs = struct_map_to_dict(request.chat_template_kwargs)
            rendered = tokenizer.apply_chat_template(
                conversation,
                tools=tools,
                documents=documents,
                chat_template=request.chat_template or None,
                add_generation_prompt=request.add_generation_prompt,
                continue_final_message=request.continue_final_message,
                tokenize=False,
                **kwargs,
            )
            response.rendered_prompt = rendered
            response.success = True
        except Exception as exc:
            logger.exception(
                "RenderChatTemplate failed for %s", request.model_name
            )
            response.success = False
            response.error_message = str(exc)
        return response

    def InitializeTokenizer(self, request, context):
        response = tokenizer_pb2.InitializeTokenizerResponse()
        try:
            self.registry.get(request.model_name)
            response.success = True
        except Exception as exc:
            logger.exception(
                "InitializeTokenizer failed for %s", request.model_name
            )
            response.success = False
            response.error_message = str(exc)
        return response


def serve(
    uds_path: str = "/tmp/kvcache_tokenizer.sock",
    max_workers: Optional[int] = None,
    registry: Optional[TokenizerRegistry] = None,
) -> grpc.Server:
    """Start the sidecar on a UDS endpoint; returns the server."""
    if os.path.exists(uds_path):
        os.unlink(uds_path)
    server = grpc.server(
        futures.ThreadPoolExecutor(
            max_workers=max_workers or os.cpu_count() or 4,
            thread_name_prefix="kvtpu-uds-tokenizer",
        ),
        options=[
            ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
            ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
        ],
    )
    add_tokenization_servicer(TokenizationGrpcService(registry), server)
    server.add_insecure_port(f"unix://{uds_path}")
    server.start()
    logger.info("uds tokenizer service listening on %s", uds_path)
    return server


def main() -> None:  # pragma: no cover - CLI entry
    import signal

    uds_path = os.environ.get("UDS_PATH", "/tmp/kvcache_tokenizer.sock")
    server = serve(uds_path)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    server.stop(grace=5)


if __name__ == "__main__":  # pragma: no cover
    main()
