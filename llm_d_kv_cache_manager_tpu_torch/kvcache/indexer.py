"""The Indexer: orchestration of the scoring read path.

``get_pod_scores(prompt, model, pods)`` answers the scheduler's question —
*which pod holds the longest consecutive prefix of this prompt's KV
blocks?* — by composing the subsystem stack (reference:
pkg/kvcache/indexer.go:124-165):

    tokenize (pool + prefix store [+ chat render])
      -> token chain -> request block keys (ChunkedTokenDatabase)
      -> index lookup (pluggable backend)
      -> longest-prefix tier-weighted score

One ``Config`` composes every module's config with defaults, so embedding
applications construct the whole stack from a single literal.

Read-path fast lane (docs/performance.md): by default ``get_pod_scores``
runs a chunked drive of the stack — the prefix store returns memoized
block keys alongside tokens (a multi-turn conversation only hashes its
new suffix), and hashing + index lookups proceed in chunks that stop as
soon as the prefix chain is dead for every candidate pod (an 8k-token
cold prompt stops paying for its unreachable suffix).  Scores are
bit-identical to the straight-line path (pinned by property tests);
``READ_PATH_FAST_LANE=0`` or ``IndexerConfig.read_path_fast_lane=False``
restores the straight-line path.

Against a backend that fans lookups out over the wire (the cluster
``RemoteIndex``), the chunked drive additionally pipelines: chunk N+1
is hashed and dispatched while chunk N's owner RPCs are in flight, and
predicted-deep chains (score memo / analytics ledger) speculate further
ahead (``CLUSTER_PIPELINE_DEPTH`` / ``CLUSTER_SPECULATE``; scores stay
bit-identical — docs/replication.md).

Copied from the JAX reference's ``kvcache/indexer.py``; its scores are
bit-identical to the reference's for the same index contents and
tokenizer (tests/test_torch_indexer.py).  ``IndexerConfig.uds_tokenizer_path``
puts the port's sidecar client (``tokenization.uds_tokenizer``) in the
tokenizer chain, imported only then, so ``grpc`` is needed only when a
UDS path is configured.  The port's
``tiering.PolicyEngine`` and ``transfer.TransferEngine`` attach through
``set_policy_engine`` and ``set_transfer_engine``; a capture engine
attaches through ``set_capture`` as any object with the reference's
methods.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import (
    Index,
    IndexConfig,
    new_index,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    EMPTY_BLOCK_HASH,
    ChunkedTokenDatabase,
    TokenProcessor,
    TokenProcessorConfig,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.scorer import (
    LongestPrefixScorer,
    ScorerConfig,
    new_scorer,
)
from llm_d_kv_cache_manager_tpu_torch.obs.trace import (
    current_trace,
    span as obs_span,
)
from llm_d_kv_cache_manager_tpu_torch.preprocessing.chat_templating import (
    ApplyChatTemplateRequest,
    ChatTemplatingProcessor,
)
from llm_d_kv_cache_manager_tpu_torch.tokenization.pool import (
    TokenizationPool,
    TokenizationPoolConfig,
)
from llm_d_kv_cache_manager_tpu_torch.tokenization.prefixstore.lru_store import (
    LRUStoreConfig,
    LRUTokenStore,
)
from llm_d_kv_cache_manager_tpu_torch.tokenization.tokenizers import (
    CompositeTokenizer,
    LocalFastTokenizer,
    Tokenizer,
    TransformersTokenizer,
)
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger, trace

logger = get_logger("kvcache.indexer")

# Block keys hashed + looked up per fast-lane round trip; the early-exit
# granularity (a dead chain stops within one chunk of the break).
DEFAULT_LOOKUP_CHUNK = 32

# Entries in the request score memo (exact-prompt results validated by
# the index's per-shard version vector); 0 disables.
DEFAULT_SCORE_MEMO = 256

# Chunks the fast lane keeps in flight against an async-capable index
# backend (the cluster RemoteIndex): chunk N+1 is hashed and dispatched
# while chunk N's owner RPCs are on the wire.  0 forces the sequential
# drive (the bit-identical parity oracle; docs/replication.md).
DEFAULT_PIPELINE_DEPTH = 3

# One-shot guard for the memo-self-disable warning (every Indexer over
# the same memo-incapable backend hits the same condition; one line per
# process is the signal, N lines is noise).
_MEMO_DISABLED_WARNED = False


def _env_fast_lane_default() -> Optional[bool]:
    raw = os.environ.get("READ_PATH_FAST_LANE")
    if raw is None:
        return None
    return raw.strip().lower() not in ("0", "false", "off")


def _env_cache_stats_default() -> bool:
    """CACHESTATS: "0"/"false"/"off" disables the hit-attribution
    ledger; unset/anything else keeps it on (sampling is governed
    separately by CACHESTATS_SAMPLE_RATE — docs/observability.md)."""
    raw = os.environ.get("CACHESTATS")
    if raw is None:
        return True
    return raw.strip().lower() not in ("0", "false", "off")


def _env_load_blend_default() -> float:
    """LOAD_BLEND: coefficient folding per-pod queue depth into
    scores (``score / (1 + blend * depth)``); 0 (the default)
    disables blending and keeps scores bit-identical to today's."""
    raw = os.environ.get("LOAD_BLEND", "")
    if not raw:
        return 0.0
    try:
        return max(0.0, float(raw))
    except ValueError:
        logger.warning("invalid LOAD_BLEND=%r; using 0", raw)
        return 0.0


def _env_score_memo_default() -> Optional[int]:
    """READ_PATH_SCORE_MEMO: "0"/"false"/"off" disables, a positive
    integer sizes the memo, unset defers to the config default."""
    raw = os.environ.get("READ_PATH_SCORE_MEMO")
    if raw is None:
        return None
    text = raw.strip().lower()
    if text in ("0", "false", "off"):
        return 0
    try:
        return max(0, int(text))
    except ValueError:
        return DEFAULT_SCORE_MEMO


def _env_pipeline_depth_default() -> int:
    """CLUSTER_PIPELINE_DEPTH: fast-lane chunks in flight at once when
    the index backend exposes ``lookup_chain_async`` (the cluster
    RemoteIndex); 0 keeps the strictly sequential chunk drive — the
    bit-identical parity oracle (docs/replication.md)."""
    raw = os.environ.get("CLUSTER_PIPELINE_DEPTH", "")
    if not raw:
        return DEFAULT_PIPELINE_DEPTH
    try:
        return max(0, int(raw))
    except ValueError:
        logger.warning(
            "invalid CLUSTER_PIPELINE_DEPTH=%r; using %d",
            raw,
            DEFAULT_PIPELINE_DEPTH,
        )
        return DEFAULT_PIPELINE_DEPTH


def _env_speculate_default() -> bool:
    """CLUSTER_SPECULATE: "0"/"false"/"off" restricts the pipeline to
    plain one-ahead overlap; on (the default) lets a predicted-deep
    chain (score memo / analytics ledger) dispatch further ahead."""
    raw = os.environ.get("CLUSTER_SPECULATE")
    if raw is None:
        return True
    return raw.strip().lower() not in ("0", "false", "off")


class _ScoreMemoEntry:
    """One memoized scoring result: the scores computed by a full
    fast-lane walk, the two validators that prove a re-walk would
    reproduce them — the index version vector captured BEFORE that walk
    (equal vectors at hit time mean no score-relevant mutation landed
    since) and the exact token stream tokenization served the walk
    (compared by value: a prefix-store chunk overwritten by an
    overlapping prompt's different split can change the served token
    VALUES while preserving their count, and stale tokens mean stale
    block keys) — and the chain keys the walk consumed (touched on
    every hit so LRU recency, hence eviction order, stays identical to
    the walk the memo elides).  Entries also carry the walk's analytics
    attribution (family key, matched blocks, tier split) so a memo hit
    replays the same ledger record the elided walk would have
    produced."""

    __slots__ = (
        "scores",
        "version",
        "tokens",
        "touch_keys",
        "max_pod_hits",
        "family",
        "matched_blocks",
        "tier_counts",
    )

    def __init__(
        self,
        scores: Dict[str, float],
        version: tuple,
        tokens: tuple,
        touch_keys: tuple,
        max_pod_hits: int,
        family: Optional[int] = None,
        matched_blocks: int = 0,
        tier_counts: Optional[Dict[str, int]] = None,
    ) -> None:
        self.scores = scores
        self.version = version
        self.tokens = tokens
        self.touch_keys = touch_keys
        self.max_pod_hits = max_pod_hits
        self.family = family
        self.matched_blocks = matched_blocks
        self.tier_counts = tier_counts


# Traced provenance attr is bounded: past this many candidate pods the
# attr keeps the best matchers (the ones a slow-trace reader needs).
_PROVENANCE_MAX_PODS = 32


def _provenance_attr(chain) -> Dict[str, dict]:
    """Per-pod ``{blocks_matched, break_index}`` span attribute for a
    traced scoring request (cross-link: a slow trace in /debug/traces
    is diagnosable without re-issuing ``?explain=1``), size-capped."""
    provenance = chain.provenance()
    if len(provenance) <= _PROVENANCE_MAX_PODS:
        return provenance
    top = sorted(
        provenance.items(),
        key=lambda item: (-item[1]["blocks_matched"], item[0]),
    )[:_PROVENANCE_MAX_PODS]
    return dict(top)


def _ledger_record(ledger, family, model_name, total, matched, tiers) -> None:
    """Analytics must never fail a scoring request: a ledger bug is
    loud (logged with stack) but non-fatal."""
    try:
        ledger.record(family, model_name, total, matched, tiers)
    except Exception:  # noqa: BLE001 - scoring outlives analytics bugs
        logger.exception("cache-stats record failed")


@dataclass
class IndexerConfig:
    prefix_store_config: LRUStoreConfig = field(default_factory=LRUStoreConfig)
    token_processor_config: TokenProcessorConfig = field(
        default_factory=TokenProcessorConfig
    )
    kvblock_index_config: IndexConfig = field(default_factory=IndexConfig)
    scorer_config: ScorerConfig = field(default_factory=ScorerConfig)
    tokenizers_pool_config: TokenizationPoolConfig = field(
        default_factory=TokenizationPoolConfig
    )
    # Directory searched by the local tokenizer backend; None disables it.
    local_tokenizers_dir: Optional[str] = None
    # UDS path of a tokenizer sidecar (services/uds_tokenizer); None
    # disables that backend.  Composite order mirrors the reference's
    # local -> uds -> hf fallback chain (pkg/tokenization/pool.go:97-145).
    uds_tokenizer_path: Optional[str] = None
    # Read-path fast lane (memoized block keys + chunked early-exit
    # lookup).  None resolves from READ_PATH_FAST_LANE (default on);
    # scores are identical either way (docs/performance.md).
    read_path_fast_lane: Optional[bool] = None
    # Keys hashed + looked up per fast-lane chunk.
    lookup_chunk_size: int = DEFAULT_LOOKUP_CHUNK
    # Entries in the request score memo (fast lane only): a repeat of
    # an exact prompt returns its memoized scores when the index's
    # per-shard version vector is unchanged since they were computed —
    # any add/evict/purge/restore invalidates.  0 disables; None
    # resolves from READ_PATH_SCORE_MEMO (default 256).  Requires an
    # index backend exposing version_vector/touch_chain (the in-memory
    # backend and the cluster RemoteIndex; others silently run without
    # the memo).  Entries pin their prompt strings, so memory is
    # O(size x prompt length).
    score_memo_size: Optional[int] = None
    # Read-path chunk pipelining (docs/replication.md): against a
    # backend exposing lookup_chain_async (the cluster RemoteIndex),
    # the fast lane keeps up to this many chunks in flight — chunk N+1
    # is hashed and dispatched while chunk N's owner RPCs are on the
    # wire, and a chain dead for every pod drops the speculative
    # in-flight results on the floor.  0 forces the sequential drive
    # (the bit-identical parity oracle); None resolves from
    # CLUSTER_PIPELINE_DEPTH (default 3).  Scores are bit-identical
    # either way (tests/test_cluster_pipeline.py pins it).
    pipeline_depth: Optional[int] = None
    # Chain speculation: depth > 1 dispatch ahead is gated on a
    # likely-alive-deep prediction (the score memo's last matched
    # depth for this exact prompt, or the analytics ledger's average
    # matched blocks for the family).  None resolves from
    # CLUSTER_SPECULATE (default on); False limits the pipeline to
    # one-ahead overlap.
    speculate: Optional[bool] = None
    # Cache-efficiency analytics (analytics/ledger.py): every scored
    # request feeds the hit-attribution ledger, outside index locks,
    # gated by CACHESTATS_SAMPLE_RATE.  None resolves from the
    # CACHESTATS env knob (default on); False disables.
    cache_stats: Optional[bool] = None
    # Predictive tiering (tiering/engine.py): when a PolicyEngine is
    # attached (constructor arg or set_policy_engine), sampled scoring
    # requests feed its PolicyFeed (outside index locks) and the
    # explain surface carries compute-or-load advice.  Config-only
    # construction stays None; the engine is wired by the embedding
    # application (TIERING=1 in the HTTP service).
    #
    # Load-blended scoring (docs/transfer.md): when callers pass
    # per-pod queue depths to get_pod_scores, each score is divided by
    # ``1 + load_blend * depth`` so the router and the transfer
    # planner's "holder overloaded" trigger share one signal.  None
    # resolves from LOAD_BLEND (default 0.0 = off; with no pod_loads
    # or a zero coefficient the returned dict is the identical object
    # the unblended path computes).
    load_blend: Optional[float] = None


class Indexer:
    """Composes the read-path stack; see module docstring."""

    def __init__(
        self,
        config: Optional[IndexerConfig] = None,
        token_processor: Optional[TokenProcessor] = None,
        tokenizer: Optional[Tokenizer] = None,
        chat_processor: Optional[ChatTemplatingProcessor] = None,
        cache_stats_ledger=None,
        policy_engine=None,
        kv_block_index: Optional[Index] = None,
        capture_recorder=None,
    ) -> None:
        self.config = config or IndexerConfig()
        self.token_processor = token_processor or ChunkedTokenDatabase(
            self.config.token_processor_config
        )
        # An injected backend wins over config — the remote/cluster
        # unlock (cluster/remote_index.py) and any embedding that
        # builds its own Index: the whole read path only ever speaks
        # the lookup/lookup_chain contract, so a remote backend slots
        # in unchanged (the score memo self-disables when the backend
        # lacks version_vector/touch_chain, see below).
        self.kv_block_index: Index = (
            kv_block_index
            if kv_block_index is not None
            else new_index(self.config.kvblock_index_config)
        )
        self.scorer: LongestPrefixScorer = new_scorer(
            self.config.scorer_config
        )
        self.prefix_store = LRUTokenStore(self.config.prefix_store_config)
        self.chat_processor = chat_processor or ChatTemplatingProcessor()

        fast_lane = self.config.read_path_fast_lane
        if fast_lane is None:
            env_default = _env_fast_lane_default()
            fast_lane = True if env_default is None else env_default
        if fast_lane and not (
            hasattr(self.token_processor, "block_size")
            and callable(
                getattr(self.token_processor, "extend_block_keys", None)
            )
        ):
            # A custom TokenProcessor only promises the Protocol
            # (tokens_to_kv_block_keys); the fast lane needs the
            # chunked-resume surface, so fall back to the straight
            # path rather than crash on the first request.
            logger.info(
                "token processor %s lacks the fast-lane surface "
                "(block_size/extend_block_keys); using the straight "
                "read path",
                type(self.token_processor).__name__,
            )
            fast_lane = False
        self._fast_lane = fast_lane
        if self.config.lookup_chunk_size <= 0:
            raise ValueError("lookup_chunk_size must be positive")
        self._lookup_chunk = self.config.lookup_chunk_size
        pipeline_depth = self.config.pipeline_depth
        if pipeline_depth is None:
            pipeline_depth = _env_pipeline_depth_default()
        self._pipeline_depth = max(0, int(pipeline_depth))
        speculate = self.config.speculate
        if speculate is None:
            speculate = _env_speculate_default()
        self._speculate = bool(speculate)
        # Hash-space identity for block-key memoization; None when the
        # token processor does not expose one (custom TokenProcessor
        # implementations) — the fast lane then runs without memo.
        self._key_space = getattr(self.token_processor, "key_space", None)
        # A metrics-wrapped index records lookups per call; the fast
        # lane makes one call per chunk, so it records ONE
        # request-granular observation itself instead (see
        # InstrumentedIndex.record_chain_lookup).
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.instrumented import (
            InstrumentedIndex,
        )

        self._record_chain_lookup = (
            InstrumentedIndex.record_chain_lookup
            if isinstance(self.kv_block_index, InstrumentedIndex)
            else None
        )

        memo_size = self.config.score_memo_size
        if memo_size is None:
            env_memo = _env_score_memo_default()
            memo_size = DEFAULT_SCORE_MEMO if env_memo is None else env_memo
        from llm_d_kv_cache_manager_tpu_torch.utils.lru import LRUCache

        self._score_memo: Optional[LRUCache] = None
        memo_wanted = self._fast_lane and memo_size > 0
        memo_supported = callable(
            getattr(self.kv_block_index, "version_vector", None)
        ) and callable(getattr(self.kv_block_index, "touch_chain", None))
        if memo_wanted and memo_supported:
            self._score_memo = LRUCache(memo_size)
        # The silent self-disable was invisible to operators: a
        # deployment over a backend without version_vector pays the
        # full walk on warm repeats while a memo-capable one (the
        # in-memory backend, the cluster RemoteIndex) memoizes — the
        # gauge + one-shot warning make that difference diagnosable
        # (docs/observability.md).  The gauge LATCHES to 1
        # (never written back to 0): it is process-wide, and a later
        # memo-capable Indexer construction — embedders and tests
        # build several — must not wipe the serving indexer's signal.
        if memo_wanted and not memo_supported:
            from llm_d_kv_cache_manager_tpu_torch.metrics.collector import (
                METRICS,
            )

            METRICS.score_memo_disabled.set(1)
            global _MEMO_DISABLED_WARNED
            if not _MEMO_DISABLED_WARNED:
                _MEMO_DISABLED_WARNED = True
                logger.warning(
                    "request score memo disabled: index backend %s "
                    "lacks version_vector/touch_chain — warm repeat "
                    "prompts pay the full walk; "
                    "kvtpu_score_memo_disabled=1",
                    type(self.kv_block_index).__name__,
                )

        # Hit-attribution ledger (analytics/ledger.py): an explicit
        # ledger always wins (tests, bench A/B share one ledger across
        # indexers); otherwise construct from env unless disabled.
        # Only a ledger this Indexer constructed is closed by its
        # shutdown — an injected one belongs to the caller.
        self.cache_stats = cache_stats_ledger
        self._owns_ledger = False
        if self.cache_stats is None:
            enabled = self.config.cache_stats
            if enabled is None:
                enabled = _env_cache_stats_default()
            if enabled:
                from llm_d_kv_cache_manager_tpu_torch.analytics.ledger import (
                    CacheStatsLedger,
                )

                self.cache_stats = CacheStatsLedger()
                self._owns_ledger = True

        # Input flight recorder (obs/capture.py): every scored request
        # lands in the capture ring — model, SERVED token chain, pod
        # filter, returned scores — after scoring, outside index
        # locks, so an incident bundle can replay the read path to a
        # divergence (obs/replay.py).  None (the default and the
        # CAPTURE=0 path) costs one ``is None`` check per request.
        self.capture = capture_recorder

        # Predictive-tiering hook (tiering/engine.py): sampled scoring
        # requests feed the engine's PolicyFeed, and explain carries
        # compute-or-load advice.  Attached, never constructed here.
        self.policy_engine = None
        if policy_engine is not None:
            self.set_policy_engine(policy_engine)

        # KV-transfer planning hook (transfer/engine.py): the planned
        # scoring variant and the explain surface carry transfer
        # directives when an engine is attached (set_transfer_engine;
        # TRANSFER=1 in the HTTP service).  Attached, never
        # constructed here — same contract as the policy engine.
        self.transfer_engine = None
        load_blend = self.config.load_blend
        if load_blend is None:
            load_blend = _env_load_blend_default()
        self._load_blend = max(0.0, float(load_blend))

        if tokenizer is None:
            backends: List[Tokenizer] = []
            if self.config.local_tokenizers_dir:
                backends.append(
                    LocalFastTokenizer(self.config.local_tokenizers_dir)
                )
            if self.config.uds_tokenizer_path:
                from llm_d_kv_cache_manager_tpu_torch.tokenization.uds_tokenizer import (  # noqa: E501 - lazy: grpc only when configured
                    UdsTokenizer,
                )

                backends.append(UdsTokenizer(self.config.uds_tokenizer_path))
            backends.append(TransformersTokenizer())
            tokenizer = CompositeTokenizer(backends)
        self.tokenization_pool = TokenizationPool(
            tokenizer,
            self.prefix_store,
            self.config.tokenizers_pool_config,
            chat_processor=self.chat_processor,
        )

    def run(self) -> None:
        """Start background workers (idempotent)."""
        self.tokenization_pool.start()

    def shutdown(self) -> None:
        self.tokenization_pool.shutdown()
        if self._owns_ledger:
            self.cache_stats.close()

    def set_tokenizer(self, tokenizer: Tokenizer, model_name: str) -> None:
        self.tokenization_pool.set_tokenizer(tokenizer, model_name)

    def set_capture(self, capture_recorder) -> None:
        """Attach/detach the input flight recorder after construction
        (obs/capture.py).  Racy-benign: scoring threads read the
        attribute once per request."""
        self.capture = capture_recorder

    def _capture_score(
        self,
        model_name: str,
        tokens: Sequence[int],
        pod_identifiers: Optional[Sequence[str]],
        scores: Dict[str, float],
    ) -> None:
        """Capture must never fail a scoring request (same contract
        as the analytics ledger).  Scores are copied — the caller owns
        the returned dict and may mutate it."""
        try:
            self.capture.record_score(
                model_name, tokens, pod_identifiers, dict(scores)
            )
        except Exception:  # noqa: BLE001 - scoring outlives capture bugs
            logger.exception("input capture record failed")

    def set_policy_engine(self, policy_engine) -> None:
        """Attach a tiering PolicyEngine after construction (binds the
        indexer's ledger to its feed)."""
        self.policy_engine = policy_engine
        if policy_engine is None:
            return
        if self.cache_stats is not None:
            policy_engine.bind_ledger(self.cache_stats)
        else:
            # Dead configuration (e.g. TIERING=1 with CACHESTATS=0):
            # every scoring hook gates on the ledger, so the engine
            # would sit inert — zeros in /debug/tiering, LRU-only
            # eviction — with nothing explaining why.  Be loud once.
            logger.warning(
                "tiering PolicyEngine attached to an indexer without a "
                "cachestats ledger (CACHESTATS disabled?): the policy "
                "feed will learn nothing and predictive eviction "
                "degrades to LRU (docs/tiering.md)"
            )

    def set_transfer_engine(self, transfer_engine) -> None:
        """Attach a TransferEngine after construction (binds the
        indexer's ledger for hot-family ranking)."""
        self.transfer_engine = transfer_engine
        if transfer_engine is None:
            return
        if self.cache_stats is not None:
            transfer_engine.bind_ledger(self.cache_stats)
        else:
            # Same dead-configuration trap as tiering: without the
            # ledger the warm-up ranking has no reuse signal and falls
            # back to catalog insertion order.  Be loud once.
            logger.warning(
                "TransferEngine attached to an indexer without a "
                "cachestats ledger (CACHESTATS disabled?): warm-up "
                "family ranking degrades to catalog order "
                "(docs/transfer.md)"
            )

    def _fill_filtered_zero(
        self,
        scores: Dict[str, float],
        pod_identifiers: Optional[Sequence[str]],
    ) -> Dict[str, float]:
        """Unknown-pod filter fix-up: pods named in the request filter
        but absent from the index get an explicit 0.0 entry (not a
        silently missing key) so planner, ledger, and explain agree on
        the candidate set.  Mutates and returns ``scores`` (fresh per
        request in every lane)."""
        if pod_identifiers:
            for pod in pod_identifiers:
                scores.setdefault(pod, 0.0)
        return scores

    def _blend_loads(
        self,
        scores: Dict[str, float],
        pod_loads: Optional[Dict[str, float]],
    ) -> Dict[str, float]:
        """Fold per-pod queue depth into scores: ``score / (1 + blend
        * depth)``.  With no loads or a zero coefficient the INPUT
        dict is returned unchanged — planner-off parity stays
        bit-identical to the unblended path."""
        blend = self._load_blend
        if not pod_loads or blend <= 0.0:
            return scores
        return {
            pod: score
            / (1.0 + blend * max(0.0, float(pod_loads.get(pod, 0.0))))
            for pod, score in scores.items()
        }

    def _tokens_and_block_keys(
        self,
        prompt: str,
        model_name: str,
        render_req: Optional[ApplyChatTemplateRequest],
    ) -> Tuple[List[int], List[int]]:
        """Straight-line front half of the read path: prompt -> tokens
        -> chained block keys, with per-stage spans when a trace is
        active (the tokenization pool adds its own sub-spans under
        "tokenize").  Used by the explain surface and by
        ``get_pod_scores`` when the fast lane is disabled."""
        with obs_span("tokenize") as s:
            tokens = self.tokenization_pool.tokenize(
                prompt, model_name, render_req
            )
            s.set_attr("tokens", len(tokens))
        trace(logger, "tokenized prompt to %d tokens", len(tokens))

        with obs_span("hash_blocks") as s:
            block_keys = self.token_processor.tokens_to_kv_block_keys(
                EMPTY_BLOCK_HASH, tokens, model_name
            )
            s.set_attr("block_keys", len(block_keys))
        trace(logger, "derived %d block keys", len(block_keys))
        return tokens, block_keys

    def get_pod_scores(
        self,
        prompt: str,
        model_name: str,
        pod_identifiers: Optional[Sequence[str]] = None,
        render_req: Optional[ApplyChatTemplateRequest] = None,
        pod_loads: Optional[Dict[str, float]] = None,
    ) -> Dict[str, float]:
        """Score candidate pods for a prompt.

        ``pod_identifiers`` filters the result; None/empty scores every pod
        the index knows about.  Filtered pods unknown to the index get
        explicit 0.0 entries.  ``pod_loads`` (optional per-pod queue
        depths) blends load into the result when the ``LOAD_BLEND``
        coefficient is set; omitted, scores are bit-identical to the
        load-blind path.
        """
        if self._fast_lane:
            scores = self._get_pod_scores_fast(
                prompt, model_name, pod_identifiers, render_req
            )
        else:
            scores = self._get_pod_scores_straight(
                prompt, model_name, pod_identifiers, render_req
            )
        return self._blend_loads(scores, pod_loads)

    def _get_pod_scores_straight(
        self,
        prompt: str,
        model_name: str,
        pod_identifiers: Optional[Sequence[str]] = None,
        render_req: Optional[ApplyChatTemplateRequest] = None,
    ) -> Dict[str, float]:
        """The pre-fast-lane path: hash every block, one lookup, one
        scoring pass (the same ``begin``/``advance`` drive ``score()``
        wraps, unrolled here so the chain's attribution state is
        readable).  Kept as the parity oracle (READ_PATH_FAST_LANE=0)
        and the fallback when the fast lane is configured off."""
        tokens, block_keys = self._tokens_and_block_keys(
            prompt, model_name, render_req
        )
        if not block_keys:
            if self.capture is not None:
                self._capture_score(model_name, tokens, pod_identifiers, {})
            return {}

        ledger = self.cache_stats
        sampled = ledger is not None and ledger.should_sample()
        track_tiers = sampled and ledger.tier_detail_due()
        traced = current_trace() is not None
        pod_set = set(pod_identifiers) if pod_identifiers else None
        with obs_span("index_lookup") as s:
            key_to_pods = self.kv_block_index.lookup(block_keys, pod_set)
            s.set_attr("keys_hit", len(key_to_pods))
        with obs_span("score") as s:
            chain = self.scorer.begin(
                track_tiers=track_tiers, track_deaths=traced
            )
            # lookup() already applied the pod filter; feeding every
            # key keeps break indices aligned with explain's.
            self.scorer.advance(
                chain, [key_to_pods.get(key, ()) for key in block_keys]
            )
            scores = self._fill_filtered_zero(
                chain.scores, pod_identifiers
            )
            s.set_attr("pods", len(scores))
            if traced:
                s.set_attr("provenance", _provenance_attr(chain))
        if sampled:
            family = ledger.family_key(block_keys, len(block_keys))
            _ledger_record(
                ledger,
                family,
                model_name,
                len(block_keys),
                chain.matched_blocks,
                chain.tier_counts,
            )
            if self.policy_engine is not None:
                self.policy_engine.observe_scored(block_keys, family)
        if self.capture is not None:
            self._capture_score(model_name, tokens, pod_identifiers, scores)
        logger.debug(
            "scored %d pods over %d block keys", len(scores), len(block_keys)
        )
        return scores

    def _get_pod_scores_fast(
        self,
        prompt: str,
        model_name: str,
        pod_identifiers: Optional[Sequence[str]] = None,
        render_req: Optional[ApplyChatTemplateRequest] = None,
    ) -> Dict[str, float]:
        """The fast lane: memoized prefix keys + chunked early-exit
        hashing/lookup/scoring, fronted by the request score memo.
        Identical scores to the straight path
        (tests/test_read_path_fastlane.py pins it)."""
        memo = self._score_memo
        memo_key = None
        if memo is not None and render_req is None:
            memo_key = (
                prompt,
                model_name,
                tuple(pod_identifiers) if pod_identifiers else None,
            )
        active_trace = current_trace()
        ledger = self.cache_stats
        sampled = ledger is not None and ledger.should_sample()
        track_tiers = sampled and ledger.tier_detail_due()
        with obs_span("tokenize") as s:
            result = self.tokenization_pool.tokenize_with_keys(
                prompt, model_name, render_req, self._key_space
            )
            s.set_attr("tokens", len(result.tokens))
        # Anchor for the traced stage layout below: everything from
        # here to the emit point belongs to some walk stage, so the
        # stage spans are laid out to cover this whole interval (the
        # slo smoke pins stage-sum ≈ end-to-end ±5%).
        walk_start = time.perf_counter()

        tokens = result.tokens
        block_size = self.token_processor.block_size
        total_blocks = len(tokens) // block_size
        if total_blocks == 0:
            if self.capture is not None:
                self._capture_score(model_name, tokens, pod_identifiers, {})
            return {}

        memo_keys = result.memo_keys
        memo_blocks = min(len(memo_keys), total_blocks)
        pod_set = set(pod_identifiers) if pod_identifiers else None

        index = self.kv_block_index
        # Chain-speculation depth signal (docs/replication.md): blocks
        # the last walk of this exact prompt matched, harvested from a
        # stale memo entry below — a multi-turn family whose prefix
        # stayed deep predicts a likely-alive chain worth dispatching
        # ahead of the current chunk's replies.
        predicted_hit_blocks = 0
        if memo_key is not None and active_trace is None:
            # Exact-prompt score memo, validated optimistically: the
            # memoized result is served only when (1) tokenization
            # served the exact token stream the walk that computed it
            # saw (count alone is not enough — an overlapping prompt's
            # add_tokenization can re-split a shared prefix-store chunk
            # to different token values with the same count, and
            # different tokens mean different block keys) and (2) the
            # index's per-shard version vector is unchanged since that
            # walk began (no score-relevant mutation landed).  Traced
            # requests always walk, so sampled traces carry real stage
            # spans.
            hit = memo.get(memo_key)
            if (
                hit is not None
                and len(hit.tokens) == len(tokens)
                and hit.version == index.version_vector()
                and list(hit.tokens) == tokens
            ):
                index.touch_chain(hit.touch_keys)
                if self._record_chain_lookup is not None:
                    self._record_chain_lookup(0.0, hit.max_pod_hits)
                if sampled:
                    # Replay the elided walk's attribution so the
                    # ledger's view is hit-path-independent (pinned by
                    # the memo≡walk ledger test).
                    _ledger_record(
                        ledger,
                        hit.family,
                        model_name,
                        total_blocks,
                        hit.matched_blocks,
                        hit.tier_counts,
                    )
                    if self.policy_engine is not None:
                        # The elided walk's chain keys are the touched
                        # resident ones; the rhythm update rides them.
                        self.policy_engine.observe_scored(
                            hit.touch_keys, hit.family
                        )
                if self.capture is not None:
                    # The memo's tokens ARE the served stream (the
                    # validator just proved it) — no copy needed.
                    self._capture_score(
                        model_name, hit.tokens, pod_identifiers,
                        hit.scores,
                    )
                logger.debug(
                    "score-memo hit: %d pods over %d chain keys",
                    len(hit.scores),
                    len(hit.touch_keys),
                )
                return dict(hit.scores)
            if hit is not None:
                predicted_hit_blocks = hit.matched_blocks
        processor = self.token_processor
        scorer = self.scorer
        chain = scorer.begin(
            track_tiers=track_tiers, track_deaths=active_trace is not None
        )
        chunk_size = self._lookup_chunk
        perf = time.perf_counter

        hash_s = 0.0
        lookup_s = 0.0
        score_s = 0.0
        keys_hit = 0
        record_lookup = self._record_chain_lookup
        hits_per_pod: Dict[str, int] = {}
        parent_key = (
            memo_keys[memo_blocks - 1] if memo_blocks else EMPTY_BLOCK_HASH
        )
        keys_done: List[int] = []
        touched_keys: List[int] = []
        # Captured BEFORE the first lookup: a mutation landing anywhere
        # during the walk bumps past this vector, so the memoized result
        # can never validate against post-mutation state.
        memo_version = (
            index.version_vector() if memo_key is not None else None
        )
        position = 0  # blocks consumed (scored)
        next_pos = 0  # blocks hashed + dispatched (>= position)
        alive = True

        def next_chunk() -> Sequence[int]:
            """Hash (or slice from the prefix memo) the next
            un-dispatched chunk, advancing the dispatch cursor.  Both
            drives below share it, so chunk boundaries — hence scorer
            advance granularity and scores — are identical."""
            nonlocal hash_s, next_pos, parent_key, chunk_size
            t_0 = perf()
            if next_pos < memo_blocks:
                # The memoized prefix needs no hashing, so early exit
                # saves nothing there: drive it as ONE chunk (one
                # grouped lock pass over the whole prefix).
                chunk: Sequence[int] = (
                    memo_keys[:memo_blocks]
                    if next_pos == 0 and memo_blocks == len(memo_keys)
                    else memo_keys[next_pos:memo_blocks]
                )
            else:
                n_blocks = min(chunk_size, total_blocks - next_pos)
                suffix = tokens[
                    next_pos * block_size : (next_pos + n_blocks) * block_size
                ]
                chunk = processor.extend_block_keys(
                    parent_key, suffix, model_name
                )
                parent_key = chunk[-1] if chunk else parent_key
                # Hash chunks double up to the cap: early exit stays
                # fine-grained near the front of a cold chain (where
                # breaks live) while a long live suffix amortizes the
                # per-chunk overhead.
                if chunk_size < 512:
                    chunk_size *= 2
            hash_s += perf() - t_0
            next_pos += len(chunk)
            return chunk

        # Pipelined chunk drive (docs/replication.md): against a
        # backend whose lookup_chain_async runs the owner fan-out off
        # the calling thread (the cluster RemoteIndex), hash and
        # dispatch chunk N+1 while chunk N's replies are on the wire.
        # One chunk ahead is unconditional; deeper dispatch is chain
        # speculation, gated on a likely-alive-deep prediction (the
        # prefix-memo depth, a stale memo entry's matched depth, or
        # the ledger's per-family average).  Results are consumed
        # strictly in chain order on this thread, so scores stay
        # bit-identical to the sequential drive — early exit just
        # drops the speculative in-flight results on the floor.
        depth = (
            self._pipeline_depth
            if callable(getattr(index, "lookup_chain_async", None))
            else 0
        )
        in_flight: deque = deque()
        speculated = 0
        predicted_blocks = max(memo_blocks, predicted_hit_blocks)
        ledger_predicted = ledger is None
        while position < total_blocks and alive:
            if depth > 0:
                while len(in_flight) < depth and next_pos < total_blocks:
                    if len(in_flight) >= 2 and not (
                        self._speculate and next_pos < predicted_blocks
                    ):
                        break
                    if in_flight:
                        speculated += 1
                    chunk = next_chunk()
                    # Dispatch counts as lookup time: an unarmed (or
                    # closed) router resolves the chunk inline right
                    # here, and that wall time must land in the
                    # index_lookup stage, not in an untracked gap
                    # (the slo smoke pins stage-sum ≈ end-to-end).
                    t_d = perf()
                    handle = index.lookup_chain_async(chunk)
                    lookup_s += perf() - t_d
                    in_flight.append((chunk, handle))
                key_chunk, handle = in_flight.popleft()
                t_1 = perf()
                pods_per_key = handle.result()
            else:
                key_chunk = next_chunk()
                t_1 = perf()
                pods_per_key = index.lookup_chain(key_chunk)
            t_2 = perf()
            lookup_s += t_2 - t_1
            keys_done.extend(key_chunk)
            keys_hit += len(pods_per_key)
            if memo_key is not None and pods_per_key:
                touched_keys.extend(key_chunk[: len(pods_per_key)])
            if record_lookup is not None:
                # Tally over the FILTERED view (what the straight
                # path's instrumented lookup counts): a non-candidate
                # pod's residency must not move the hit metrics.  One
                # knowing divergence: the tally covers only the chain
                # actually driven, so residency past the point where
                # the chain died for every candidate (which early exit
                # never looks up, and which cannot move any score) is
                # not counted, while the straight path's full lookup
                # would count it (docs/performance.md).
                for pods in pods_per_key:
                    for entry in pods:
                        pod_id = entry.pod_identifier
                        if pod_set is not None and pod_id not in pod_set:
                            continue
                        hits_per_pod[pod_id] = (
                            hits_per_pod.get(pod_id, 0) + 1
                        )
            alive = (
                scorer.advance(chain, pods_per_key, pod_set)
                and len(pods_per_key) == len(key_chunk)
            )
            score_s += perf() - t_2
            position += len(key_chunk)
            if (
                not ledger_predicted
                and depth > 1
                and self._speculate
                and len(keys_done)
                >= min(ledger.config.family_blocks, total_blocks)
            ):
                # One mid-walk refinement: once enough of the chain is
                # hashed to derive the family id, the ledger's average
                # matched depth for it extends the speculation horizon
                # (multi-turn families that historically match deep).
                ledger_predicted = True
                prediction = ledger.predicted_matched_blocks(
                    ledger.family_key(keys_done, total_blocks)
                )
                if prediction is not None:
                    predicted_blocks = max(
                        predicted_blocks, int(prediction)
                    )
        if speculated or in_flight:
            # Wasted = dispatched but never consumed (early exit after
            # the chain died); the executor finishes them harmlessly in
            # the background and their keys never reach keys_done, the
            # prefix store, or the family id.
            record_speculation = getattr(index, "record_speculation", None)
            if callable(record_speculation):
                record_speculation(speculated, len(in_flight))

        if (
            self._key_space is not None
            and len(keys_done) > memo_blocks
            and result.text
        ):
            # New keys were hashed: memoize them on the prompt's chunk
            # chain so the next request over this prefix resumes
            # instead of re-hashing (advisory; evictions only cost a
            # re-hash).  min_blocks skips re-writing the records the
            # memo was resumed from — only the new suffix's chunks pay.
            self.prefix_store.attach_block_keys(
                result.text,
                model_name,
                self._key_space,
                keys_done,
                tokens,
                min_blocks=memo_blocks,
            )

        max_pod_hits = max(hits_per_pod.values()) if hits_per_pod else 0
        if record_lookup is not None:
            record_lookup(lookup_s, max_pod_hits)

        if chain.deaths is not None and chain.active:
            # The chain died by lookup truncation (the next key had no
            # resident pods) rather than by scorer intersection; the
            # surviving pods' break index is the first un-looked-up
            # block — exactly where explain's full walk would break
            # them (pinned by the provenance≡explain test).
            if not alive:
                for pod in chain.active:
                    chain.deaths.setdefault(pod, chain.position)

        # Filter fix-up BEFORE the memo store: memo keys include the
        # pod-filter tuple, so memoized entries carry the filled dict a
        # re-walk under the same filter would produce.
        self._fill_filtered_zero(chain.scores, pod_identifiers)

        family = None
        if ledger is not None and (sampled or memo_key is not None):
            # The family id must be lane- and memo-state-independent
            # (one prompt, one family): an early exit can leave
            # keys_done short of family_blocks (e.g. a dead 2-block
            # memoized prefix), so hash the few missing prefix blocks
            # before deriving it — bounded by family_blocks, and only
            # on walks that died inside the family prefix.
            need = min(ledger.config.family_blocks, total_blocks)
            if len(keys_done) < need:
                keys_done.extend(
                    processor.extend_block_keys(
                        keys_done[-1],
                        tokens[
                            len(keys_done) * block_size: need * block_size
                        ],
                        model_name,
                    )
                )
            family = ledger.family_key(keys_done, total_blocks)
        if memo_key is not None:
            memo.put(
                memo_key,
                _ScoreMemoEntry(
                    dict(chain.scores),
                    memo_version,
                    tuple(tokens),
                    tuple(touched_keys),
                    max_pod_hits,
                    family=family,
                    matched_blocks=chain.matched_blocks,
                    tier_counts=(
                        dict(chain.tier_counts)
                        if chain.tier_counts is not None
                        else None
                    ),
                ),
            )
        if sampled:
            _ledger_record(
                ledger,
                family,
                model_name,
                total_blocks,
                chain.matched_blocks,
                chain.tier_counts,
            )
            if self.policy_engine is not None:
                self.policy_engine.observe_scored(keys_done, family)

        tracer = active_trace
        if tracer is not None:
            # One span per pipeline stage (the stage vocabulary the
            # metrics histogram and the debug surface share), durations
            # accumulated across chunks and emitted as contiguous
            # intervals covering [walk_start, now].  lookup/score keep
            # their measured durations; hash_blocks absorbs the walk's
            # fixed bookkeeping (memo check + version capture up front,
            # memo store / ledger / prefix attach at the tail) so the
            # stage sum tracks the request's end-to-end latency.
            end = perf()
            span = tracer.add_completed(
                "hash_blocks", walk_start,
                end - lookup_s - score_s,
            )
            span.set_attr("block_keys", len(keys_done))
            span.set_attr("memo_blocks", memo_blocks)
            span = tracer.add_completed(
                "index_lookup", end - lookup_s - score_s, end - score_s
            )
            span.set_attr("keys_hit", keys_hit)
            span = tracer.add_completed("score", end - score_s, end)
            span.set_attr("pods", len(chain.scores))
            span.set_attr("provenance", _provenance_attr(chain))
        if self.capture is not None:
            self._capture_score(
                model_name, tokens, pod_identifiers, chain.scores
            )
        logger.debug(
            "fast-lane scored %d pods over %d/%d block keys "
            "(%d memoized)",
            len(chain.scores),
            len(keys_done),
            total_blocks,
            memo_blocks,
        )
        return chain.scores

    def get_pod_scores_planned(
        self,
        prompt: str,
        model_name: str,
        pod_identifiers: Optional[Sequence[str]] = None,
        pod_loads: Optional[Dict[str, float]] = None,
        render_req: Optional[ApplyChatTemplateRequest] = None,
    ) -> Tuple[Dict[str, float], Optional[Dict]]:
        """The opt-in planned scoring variant: ``get_pod_scores`` plus
        a transfer directive when an attached TransferEngine decides
        the best holder is overloaded and moving its blocks beats
        recompute (docs/transfer.md).  Returns ``(scores,
        directive_or_None)``; rides the explained walk because the
        planner needs the per-pod provenance, so it shares explain's
        cost profile — for schedulers that opted in, not the hot path.
        """
        scores, explanation = self.get_pod_scores_explained(
            prompt,
            model_name,
            pod_identifiers,
            render_req,
            pod_loads=pod_loads,
        )
        return scores, explanation.get("transfer")

    def get_pod_scores_explained(
        self,
        prompt: str,
        model_name: str,
        pod_identifiers: Optional[Sequence[str]] = None,
        render_req: Optional[ApplyChatTemplateRequest] = None,
        pod_loads: Optional[Dict[str, float]] = None,
    ) -> Tuple[Dict[str, float], Dict]:
        """``get_pod_scores`` plus a per-pod score explanation.

        Returns ``(scores, explanation)``; scores are identical to
        ``get_pod_scores``.  The explanation carries token/block-key
        counts and, per pod, blocks matched, the block index where the
        consecutive-prefix chain broke, and per-tier hit counts (see
        ``LongestPrefixScorer.explain``); with ``pod_loads`` and an
        attached TransferEngine it also carries the load blend and the
        transfer planner's decision.  The debug surface — slower
        than the hot path by the explain bookkeeping (and it always
        walks the full chain: break indices need the straight-line
        path, never the early-exit fast lane); not for every request.
        """
        tokens, block_keys = self._tokens_and_block_keys(
            prompt, model_name, render_req
        )
        explanation: Dict = {
            "tokens": len(tokens),
            "block_keys": len(block_keys),
            "pods": {},
        }
        if not block_keys:
            if self.capture is not None:
                self._capture_score(model_name, tokens, pod_identifiers, {})
            return {}, explanation

        pod_set = set(pod_identifiers) if pod_identifiers else None
        with obs_span("index_lookup") as s:
            key_to_pods = self.kv_block_index.lookup(block_keys, pod_set)
            s.set_attr("keys_hit", len(key_to_pods))
        with obs_span("score") as s:
            per_pod = self.scorer.explain(block_keys, key_to_pods)
            s.set_attr("pods", len(per_pod))
            s.set_attr(
                "provenance",
                {
                    pod: {
                        "blocks_matched": detail["blocks_matched"],
                        "break_index": detail["break_index"],
                    }
                    for pod, detail in per_pod.items()
                },
            )
        if pod_identifiers:
            # Unknown-pod filter fix-up, explain flavor: explicit
            # zero-provenance entries so the planner, the ledger, and
            # this surface agree on the candidate set.
            for pod in pod_identifiers:
                per_pod.setdefault(
                    pod,
                    {
                        "score": 0.0,
                        "blocks_matched": 0,
                        "break_index": 0,
                        "tiers": {},
                    },
                )
        explanation["pods"] = per_pod
        scores = {pod: detail["score"] for pod, detail in per_pod.items()}
        if self.capture is not None:
            # Explain requests are scoring requests too: the replay
            # harness re-drives them through the plain scoring path
            # (scores are identical by the explain≡score property).
            self._capture_score(model_name, tokens, pod_identifiers, scores)
        ledger = self.cache_stats
        if ledger is not None and ledger.should_sample():
            # Explain requests are scoring requests too.  Attribution
            # comes from the same ScoreChain drive the hot path uses
            # (per-block best-resident-tier split, tier-sample gate
            # included) — recording the best pod's OWN tiers here
            # would feed the ledger a different split than the walk
            # records for the identical request.
            chain = self.scorer.begin(
                track_tiers=ledger.tier_detail_due()
            )
            self.scorer.advance(
                chain, [key_to_pods.get(key, ()) for key in block_keys]
            )
            family = ledger.family_key(block_keys, len(block_keys))
            _ledger_record(
                ledger,
                family,
                model_name,
                len(block_keys),
                chain.matched_blocks,
                chain.tier_counts,
            )
            if self.policy_engine is not None:
                self.policy_engine.observe_scored(block_keys, family)
        engine = self.policy_engine
        if engine is not None and per_pod:
            # Compute-or-load advice for the best pod's resident prefix
            # (docs/tiering.md): would loading its offloaded KV beat
            # recomputing it, or should the two overlap?  Advisory —
            # failures never fail an explain request.
            try:
                best_pod, best = max(
                    per_pod.items(), key=lambda item: item[1]["score"]
                )
                tiers = best.get("tiers") or {}
                tier = (
                    max(tiers.items(), key=lambda item: item[1])[0]
                    if tiers
                    else None
                )
                advice = engine.advisor.advise(
                    best["blocks_matched"], tier=tier
                )
                explanation["tiering"] = dict(
                    advice.to_dict(), pod=best_pod
                )
            except Exception:  # noqa: BLE001 — advice is advisory
                logger.exception("tiering advice failed")
        transfer = self.transfer_engine
        if transfer is not None and per_pod:
            # Transfer planning rides the RAW provenance (holders are
            # holders regardless of their queue); plan_for_chain never
            # raises into scoring (transfer/engine.py contract).
            directive = transfer.plan_for_chain(
                per_pod,
                pod_loads,
                block_keys,
                token_ids=tokens,
                block_size=getattr(
                    self.token_processor, "block_size", 16
                ),
            )
            if directive is not None:
                explanation["transfer"] = directive
        if pod_loads and self._load_blend > 0.0:
            blended = self._blend_loads(scores, pod_loads)
            explanation["load_blend"] = {
                "coefficient": self._load_blend,
                "pods": {
                    pod: {
                        "raw": scores[pod],
                        "queue_depth": float(
                            pod_loads.get(pod, 0.0)
                        ),
                        "blended": blended[pod],
                    }
                    for pod in sorted(scores)
                },
            }
            scores = blended
        return scores, explanation
