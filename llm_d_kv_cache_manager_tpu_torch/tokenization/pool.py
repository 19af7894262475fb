"""Tokenization worker pool: the prompt -> tokens stage of the read path.

Sync (``tokenize`` blocks on a future) and async (``enqueue_tokenization``
fire-and-forget, warming the prefix store) modes over a bounded queue and N
worker threads, mirroring the reference pool's shape
(pkg/tokenization/pool.go).

Fast path: the prefix store resolves the prompt's cached prefix; a full
tokenizer run happens only when coverage < ``min_prefix_overlap_ratio``
(default 0.8).  Chat-completions requests are rendered to a prompt string
first, after which special tokens are NOT re-added (the template already
placed them — matching vLLM's serving behavior, pool.go:220-231).

Failed tasks retry up to 3 times, then fail the caller.

Copied from the JAX reference's ``tokenization/pool.py``.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.obs.trace import (
    Trace,
    current_trace,
    profiler_range,
    span as obs_span,
    use_trace,
)
from llm_d_kv_cache_manager_tpu_torch.preprocessing.chat_templating import (
    ApplyChatTemplateRequest,
    ChatTemplatingProcessor,
)
from llm_d_kv_cache_manager_tpu_torch.tokenization.prefixstore.lru_store import (
    LRUTokenStore,
)
from llm_d_kv_cache_manager_tpu_torch.tokenization.tokenizers import Tokenizer
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger, trace

logger = get_logger("tokenization.pool")

DEFAULT_WORKERS = 5
DEFAULT_MIN_PREFIX_OVERLAP_RATIO = 0.8
DEFAULT_MAX_RETRIES = 3


@dataclass
class TokenizationPoolConfig:
    workers: int = DEFAULT_WORKERS
    min_prefix_overlap_ratio: float = DEFAULT_MIN_PREFIX_OVERLAP_RATIO
    max_retries: int = DEFAULT_MAX_RETRIES
    queue_size: int = 10_000
    model_name: str = ""


@dataclass
class TokenizedPrompt:
    """One resolved tokenization: the token stream, the final prompt
    text it came from (chat-rendered when a template applied), and —
    when the prefix store carried a block-key memoization record — the
    already-chained block keys for the first ``len(memo_keys)`` full
    blocks of ``tokens`` (see docs/performance.md)."""

    tokens: List[int]
    text: str
    memo_keys: Tuple[int, ...] = field(default=())


@dataclass
class _Task:
    prompt: str
    model_name: str
    render_req: Optional[ApplyChatTemplateRequest]
    future: Optional["Future[TokenizedPrompt]"]
    attempts: int = 0
    # Token-processor hash-space identity for block-key memoization;
    # None skips the memo read on the worker-side store probe.
    key_space: Optional[tuple] = None
    # True when the submitting thread already probed the prefix store
    # for this exact prompt and missed: the worker skips its own probe
    # (one store read per miss, not two).  Chat-rendered and
    # fire-and-forget tasks were never pre-probed, so they keep the
    # worker-side probe.
    store_probed: bool = False
    # Explicit trace propagation across the pool boundary: the
    # submitting thread's active trace rides the task so worker-side
    # spans (queue wait, chat render, encode) land on the same trace.
    trace: Optional[Trace] = None
    submitted_at: float = 0.0


class TokenizationPool:
    def __init__(
        self,
        tokenizer: Tokenizer,
        prefix_store: LRUTokenStore,
        config: Optional[TokenizationPoolConfig] = None,
        chat_processor: Optional[ChatTemplatingProcessor] = None,
    ) -> None:
        self.config = config or TokenizationPoolConfig()
        if self.config.workers <= 0:
            raise ValueError("pool workers must be positive")
        self._tokenizer = tokenizer
        self._prefix_store = prefix_store
        self._chat_processor = chat_processor or ChatTemplatingProcessor()
        self._queue: "queue.Queue[Optional[_Task]]" = queue.Queue(
            self.config.queue_size
        )
        self._threads: List[threading.Thread] = []  # guarded-by: _lock
        # Lifecycle-only lock (start/shutdown); worker tokenization
        # never runs under it, so it stays a hierarchy leaf.
        self._lock = lockorder.tracked(
            threading.Lock(), "TokenizationPool._lock"
        )
        self._started = False  # guarded-by: _lock

    def set_tokenizer(self, tokenizer: Tokenizer, model_name: str) -> None:
        # gil-atomic: wiring-time single ref store before start()
        self._tokenizer = tokenizer
        self.config.model_name = model_name

    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
            for i in range(self.config.workers):
                thread = threading.Thread(
                    target=self._worker,
                    name=f"kvtpu-tokenize-{i}",
                    daemon=True,
                )
                thread.start()
                self._threads.append(thread)

    def shutdown(self) -> None:
        with self._lock:
            if not self._started:
                return
            for _ in self._threads:
                self._queue.put(None)
            for thread in self._threads:
                thread.join(timeout=10)
            self._threads.clear()
            self._started = False

    def tokenize(
        self,
        prompt: str,
        model_name: Optional[str] = None,
        render_req: Optional[ApplyChatTemplateRequest] = None,
        timeout: Optional[float] = 60.0,
    ) -> List[int]:
        """Synchronous tokenization through the pool (tokens only)."""
        return self.tokenize_with_keys(
            prompt, model_name, render_req, None, timeout
        ).tokens

    def tokenize_with_keys(
        self,
        prompt: str,
        model_name: Optional[str] = None,
        render_req: Optional[ApplyChatTemplateRequest] = None,
        key_space: Optional[tuple] = None,
        timeout: Optional[float] = 60.0,
    ) -> TokenizedPrompt:
        """Synchronous tokenization, with block-key memoization.

        Plain prompts probe the prefix store in the CALLING thread
        first: a steady-state scoring request whose stream is cached
        skips the queue + worker round-trip entirely (the pool exists
        to parallelize the SLOW full tokenizer, not a store read —
        the store is already read concurrently by the workers, so the
        extra reader is safe).  A miss carries ``store_probed`` on the
        queued task so the worker does not pay a second store read for
        the same prompt (the store could have been warmed while the
        task sat queued, but trading that sliver of extra coverage for
        one probe per miss is the right call on the hot path).
        Chat-rendered prompts must render first and stay on the
        queue.  ``key_space`` (the token processor's hash-space
        identity) opts the probe into returning the prefix's
        already-chained block keys alongside the tokens (the read-path
        fast lane; see docs/performance.md)."""
        probed = False
        if render_req is None:
            served = self._try_prefix_fast_path(
                prompt, model_name or self.config.model_name, key_space
            )
            if served is not None:
                return served
            probed = True
        future: "Future[TokenizedPrompt]" = Future()
        # The caller's wait for the pool (its queue and the worker's
        # encode), on a recording torch profiler's timeline.
        with profiler_range("tokenize.queue_wait"):
            self._submit(
                prompt,
                model_name,
                render_req,
                future,
                store_probed=probed,
                key_space=key_space,
            )
            return future.result(timeout=timeout)

    def _try_prefix_fast_path(
        self,
        prompt: str,
        model_name: str,
        key_space: Optional[tuple] = None,
    ) -> Optional[TokenizedPrompt]:
        """The cached token stream when store coverage clears the
        fast-path threshold; None otherwise.  Shared by the sync
        caller path and the worker (_process)."""
        with obs_span("tokenize.prefix_probe", parent="tokenize") as s:
            probe = self._prefix_store.probe(prompt, model_name, key_space)
            s.set_attr("coverage", round(probe.coverage, 4))
        if probe.coverage >= self.config.min_prefix_overlap_ratio:
            METRICS.tokenization_prefix_fast_path.inc()
            trace(
                logger,
                "prefix-store fast path: %d tokens at %.2f coverage "
                "(%d memoized blocks)",
                len(probe.tokens),
                probe.coverage,
                probe.blocks,
            )
            return TokenizedPrompt(probe.tokens, prompt, probe.keys)
        return None

    def enqueue_tokenization(
        self,
        prompt: str,
        model_name: Optional[str] = None,
        render_req: Optional[ApplyChatTemplateRequest] = None,
    ) -> None:
        """Fire-and-forget: warm the prefix store off the hot path."""
        self._submit(prompt, model_name, render_req, None)

    def _submit(
        self,
        prompt,
        model_name,
        render_req,
        future,
        store_probed=False,
        key_space=None,
    ) -> None:
        self.start()
        # Waiting callers (future set) carry their trace to the worker;
        # fire-and-forget warmers are not request-scoped.
        task_trace = current_trace() if future is not None else None
        self._queue.put(
            _Task(
                prompt=prompt,
                model_name=model_name or self.config.model_name,
                render_req=render_req,
                future=future,
                store_probed=store_probed,
                key_space=key_space,
                trace=task_trace,
                submitted_at=(
                    time.perf_counter() if task_trace is not None else 0.0
                ),
            )
        )

    def _worker(self) -> None:
        while True:
            task = self._queue.get()
            try:
                if task is None:
                    return
                self._run_task(task)
            finally:
                self._queue.task_done()

    def _run_task(self, task: _Task) -> None:
        # Queue wait recorded once, before the retry loop (retries are
        # worker-inline, not re-queued).
        if task.trace is not None:
            task.trace.add_completed(
                "tokenize.queue_wait", task.submitted_at, parent="tokenize"
            )
        # Retries run inline on this worker: re-enqueueing would block on a
        # full queue (deadlocking the pool under backend outage) and could
        # strand the task behind shutdown sentinels with its future
        # forever pending.
        while True:
            try:
                result = self._process(task)
            except Exception as exc:  # noqa: BLE001 — retried below
                task.attempts += 1
                if task.attempts < self.config.max_retries:
                    trace(
                        logger,
                        "tokenization attempt %d failed (%s); retrying",
                        task.attempts,
                        exc,
                    )
                    continue
                logger.error(
                    "tokenization failed after %d attempts: %s",
                    task.attempts,
                    exc,
                )
                if task.future is not None:
                    task.future.set_exception(exc)
                return
            if task.future is not None:
                task.future.set_result(result)
            return

    def _process(self, task: _Task) -> TokenizedPrompt:
        # Re-enter the submitter's trace on this worker thread so stage
        # spans (template, probe, encode) attach to the request.
        with use_trace(task.trace):
            return self._process_in_context(task)

    def _process_in_context(self, task: _Task) -> TokenizedPrompt:
        prompt = task.prompt
        # vLLM adds special tokens to raw completion prompts but not to
        # chat-rendered ones (the template already placed them).
        add_special_tokens = True
        if task.render_req is not None:
            with obs_span("tokenize.chat_template", parent="tokenize") as s:
                prompt = self._chat_processor.apply_chat_template(
                    task.model_name, task.render_req
                )
                s.set_attr("rendered_chars", len(prompt))
            add_special_tokens = False

        if not task.store_probed:
            served = self._try_prefix_fast_path(
                prompt, task.model_name, task.key_space
            )
            if served is not None:
                return served

        with obs_span("tokenize.encode", parent="tokenize") as s:
            encoding = self._tokenizer.encode(
                prompt, task.model_name, add_special_tokens
            )
            s.set_attr("tokens", len(encoding.tokens))
        self._prefix_store.add_tokenization(
            prompt, encoding.tokens, encoding.offsets, task.model_name
        )
        return TokenizedPrompt(encoding.tokens, prompt)
