"""Precise prefix-cache scorer: the scheduler-plugin adapter.

Counterpart of the reference's `PrecisePrefixCacheScorer` for the
llm-d inference scheduler (examples/kv_cache_aware_scorer/
kvcache_aware_scorer.go:63-314): owns the whole indexing stack (indexer +
event pool + subscriber manager), keeps per-pod event subscriptions alive
through a TTL cache refreshed on every scoring cycle, handles both
completions and chat-completions request bodies, and returns 0-1
max-normalized scores for the scheduler's weighted sum.

A scheduler embeds this as a scorer plugin:

    scorer = PrecisePrefixCacheScorer(PrecisePrefixCacheScorerConfig())
    ...
    scores = scorer.score(request, pods)   # every scheduling cycle

Copied from the JAX reference's ``scheduler/precise_scorer.py``:
``tiering=True`` attaches a ``tiering.PolicyEngine`` on the indexer's
ledger (``scorer.policy_engine``).  With ``discover_pods=False`` and no
``zmq_endpoint`` the scorer never makes a socket: its pool is fed by
whoever calls ``events_pool.add_tasks``
(``zmq_subscriber.parse_event_message`` -> ``Pool.add_tasks``, what a
poller does).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import Indexer, IndexerConfig
from llm_d_kv_cache_manager_tpu_torch.kvevents.pool import Pool, PoolConfig
from llm_d_kv_cache_manager_tpu_torch.kvevents.subscriber_manager import (
    SubscriberManager,
)
from llm_d_kv_cache_manager_tpu_torch.obs.trace import TRACER, use_trace
from llm_d_kv_cache_manager_tpu_torch.preprocessing.chat_templating import (
    ApplyChatTemplateRequest,
)
from llm_d_kv_cache_manager_tpu_torch.tiering import PolicyEngine
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger
from llm_d_kv_cache_manager_tpu_torch.utils.ttl_cache import TTLCache

logger = get_logger("scheduler.precise_scorer")

PLUGIN_TYPE = "precise-prefix-cache-scorer"


# ----------------------------- request model ------------------------------


@dataclass
class ChatMessage:
    role: str
    content: str


@dataclass
class CompletionsBody:
    prompt: str


@dataclass
class ChatCompletionsBody:
    messages: List[ChatMessage] = field(default_factory=list)
    tools: Optional[List[Dict[str, Any]]] = None
    documents: Optional[List[Dict[str, Any]]] = None
    chat_template: Optional[str] = None
    return_assistant_tokens_mask: bool = False
    continue_final_message: bool = False
    add_generation_prompt: bool = True
    chat_template_kwargs: Optional[Dict[str, Any]] = None


@dataclass
class LLMRequest:
    """What the scheduler hands each scorer per cycle (types.LLMRequest).

    Exactly one body should be set; if both are, chat semantics win
    (matching the reference's defensive priority,
    kvcache_aware_scorer.go:263-267).
    """

    target_model: str
    completions: Optional[CompletionsBody] = None
    chat_completions: Optional[ChatCompletionsBody] = None


@dataclass(frozen=True)
class Pod:
    """Candidate endpoint (types.Pod projection)."""

    namespaced_name: str  # "namespace/name" — the subscriber identity
    address: str  # IP the index's pod entries are keyed by


# ----------------------------- configuration ------------------------------


@dataclass
class PrecisePrefixCacheScorerConfig:
    indexer_config: IndexerConfig = field(default_factory=IndexerConfig)
    events_pool_config: PoolConfig = field(default_factory=PoolConfig)
    # Subscribe to each scored pod's ZMQ endpoint, expiring idle pods.
    discover_pods: bool = True
    pod_socket_port: int = 5557
    subscription_ttl_seconds: float = 600.0
    # Subscriber ids here are scheduler-side namespaced names, not the
    # engines' published pod ids — subscribe to every kv topic.
    topic_filter: str = "kv@"
    # Global-socket mode: one static endpoint carrying every pod's
    # events (kvcache_aware_scorer.go:141-147); None disables.
    zmq_endpoint: Optional[str] = None
    # When a pod's subscription expires (TTL: it stopped being scored,
    # i.e. the scheduler no longer sees it), also purge its index
    # entries so stale claims stop attracting traffic.  Off by default:
    # the reference lets entries linger and rebuild from live events,
    # which is the right call for brief pod blips.
    purge_index_on_expiry: bool = False
    # Attach a predictive-tiering PolicyEngine (tiering/engine.py) to
    # the embedded indexer: the scoring stream feeds its PolicyFeed
    # and embedding schedulers can read compute-or-load advice from
    # ``scorer.policy_engine.advisor``.  Env-configured
    # (TIERING_* knobs, docs/tiering.md).
    tiering: bool = False


# ------------------------------- the scorer -------------------------------


class PrecisePrefixCacheScorer:
    def __init__(
        self,
        config: Optional[PrecisePrefixCacheScorerConfig] = None,
        indexer: Optional[Indexer] = None,
    ) -> None:
        self.config = config or PrecisePrefixCacheScorerConfig()
        self.indexer = indexer or Indexer(self.config.indexer_config)
        self.indexer.run()

        self.policy_engine = None
        if self.config.tiering:
            self.policy_engine = PolicyEngine(
                ledger=self.indexer.cache_stats
            )
            self.indexer.set_policy_engine(self.policy_engine)

        self.events_pool = Pool(
            self.indexer.kv_block_index,
            self.indexer.token_processor,
            self.config.events_pool_config,
        )
        self.events_pool.start()
        self.subscribers = SubscriberManager(sink=self.events_pool.add_task)

        self._subscriptions: Optional[TTLCache[str, str]] = None
        if self.config.discover_pods:
            self._subscriptions = TTLCache(
                self.config.subscription_ttl_seconds,
                on_evict=self._on_subscription_expired,
            )
            self._subscriptions.start_sweeper(
                self.config.subscription_ttl_seconds
            )
        if self.config.zmq_endpoint:
            self.subscribers.ensure_subscriber(
                "local-subscriber",
                self.config.zmq_endpoint,
                topic_filter=self.config.topic_filter,
            )

    def shutdown(self) -> None:
        if self._subscriptions is not None:
            self._subscriptions.stop_sweeper()
        self.subscribers.shutdown()
        self.events_pool.shutdown()
        if self.policy_engine is not None:
            self.policy_engine.close()
        self.indexer.shutdown()

    # -- subscriber lifecycle --

    def _on_subscription_expired(self, pod: str, address: str) -> None:
        self.subscribers.remove_subscriber(pod)
        if self.config.purge_index_on_expiry:
            # Off-thread: the expiry callback runs under the TTL cache's
            # callback lock, which every scoring cycle's subscription
            # refresh also takes — an O(index) purge (network I/O on the
            # Redis backend) inline here would stall the hot path.
            threading.Thread(
                target=self._purge_expired_pod,
                args=(pod, address),
                name=f"kvtpu-purge-{pod}",
                daemon=True,
            ).start()

    def _purge_expired_pod(self, pod: str, address: str) -> None:
        try:
            removed = self.indexer.kv_block_index.purge_pod(address)
            logger.info(
                "purged %d index entries for expired pod %s (%s)",
                removed,
                pod,
                address,
            )
        except Exception:  # noqa: BLE001 - purge failure must stay local
            logger.exception(
                "index purge for expired pod %s (%s) failed", pod, address
            )

    def _refresh_subscriptions(self, pods: Sequence[Pod]) -> None:
        """Seen pods stay subscribed; unseen ones age out via TTL."""
        assert self._subscriptions is not None
        for pod in pods:
            self._subscriptions.set(pod.namespaced_name, pod.address)
            self.subscribers.ensure_subscriber(
                pod.namespaced_name,
                f"tcp://{pod.address}:{self.config.pod_socket_port}",
                topic_filter=self.config.topic_filter,
            )

    # -- scoring --

    def score(
        self, request: Optional[LLMRequest], pods: Sequence[Pod]
    ) -> Dict[Pod, float]:
        """One scheduling cycle: returns 0-1 normalized scores per pod."""
        if self.config.discover_pods:
            self._refresh_subscriptions(pods)

        if request is None:
            logger.debug("request is nil; skipping scoring")
            return {}

        # Sampled cycle trace: the embedded stack has no HTTP layer to
        # ingest a traceparent, so the scheduler cycle is the trace root
        # and the indexer's stage spans attach beneath it.
        cycle_trace = TRACER.start_trace("scheduler.score")
        if cycle_trace is not None:
            cycle_trace.set_attr("model", request.target_model)
            cycle_trace.set_attr("candidate_pods", len(pods))
        start = time.perf_counter()
        try:
            with use_trace(cycle_trace):
                raw = self._get_scores(request)
        except Exception as exc:
            if cycle_trace is not None:
                cycle_trace.set_error(repr(exc))
                cycle_trace.finish("error")
            logger.exception("failed to get pod scores")
            return {}
        if cycle_trace is not None:
            cycle_trace.set_attr("scored_pods", len(raw))
            cycle_trace.finish()
        logger.debug(
            "scored %d pods in %.1f ms",
            len(raw),
            (time.perf_counter() - start) * 1e3,
        )
        return self._normalize(raw, pods)

    def _get_scores(self, request: LLMRequest) -> Dict[str, float]:
        if request.chat_completions is not None:
            if request.completions is not None:
                logger.debug(
                    "both bodies present; defaulting to chat/completions"
                )
            body = request.chat_completions
            render_req = ApplyChatTemplateRequest(
                conversation=[
                    {"role": m.role, "content": m.content}
                    for m in body.messages
                ],
                tools=body.tools,
                documents=body.documents,
                chat_template=body.chat_template,
                add_generation_prompt=body.add_generation_prompt,
                continue_final_message=body.continue_final_message,
                chat_template_kwargs=body.chat_template_kwargs,
            )
            return self.indexer.get_pod_scores(
                prompt="",
                model_name=request.target_model,
                pod_identifiers=None,
                render_req=render_req,
            )
        if request.completions is not None:
            return self.indexer.get_pod_scores(
                prompt=request.completions.prompt,
                model_name=request.target_model,
                pod_identifiers=None,
            )
        raise ValueError("no valid input found in request")

    @staticmethod
    def _normalize(
        raw: Dict[str, float], pods: Sequence[Pod]
    ) -> Dict[Pod, float]:
        """Index scores (keyed by pod address) -> 0-1 per candidate pod,
        highest raw score = 1.0; unknown pods score 0."""
        top = max(raw.values(), default=0.0)
        if top <= 0:
            return {pod: 0.0 for pod in pods}
        return {pod: raw.get(pod.address, 0.0) / top for pod in pods}
