"""Replay-to-divergence harness for capture artifacts.

Re-drives a capture (``obs/capture.py`` wire format) through a FRESH
in-process stack — the real ``kvevents.Pool`` write path and the real
``Indexer`` read path, over either a single in-memory index or a
3-replica :class:`~..cluster.harness.LocalCluster` — and reports the
first divergence between replayed and recorded outputs:

* **scores** — every recorded scoring request is re-issued in the
  recorded global order (the capture's single ingress seq) and must
  reproduce the recorded score map bit-identically;
* **seq classifications** — the recorded per-(pod, topic) sequence
  stream is re-fed through the real ``TopicSeqTracker`` and each
  message's gap classification must match what the live subscriber
  recorded (a mutated or torn capture shows up here first);
* **final index state** — when the artifact carries a state section
  and no capture ring was truncated, the replayed index's
  canonicalized ``dump_entries`` must equal the recorded one.

Determinism ground rules the harness enforces on itself:

* The replayed token streams ARE the recorded ones: prompts are
  re-rendered from the recorded token chains through a word-per-token
  tokenizer, and the replay stack pins
  ``min_prefix_overlap_ratio > 1`` so the prefix-store fast path can
  never re-truncate a stream the live store already truncated.
* Event records replay strictly before any later score record: the
  pool is drained at every event→score boundary, so replayed reads
  see exactly the writes the recorded order said they saw.
* A message the live pool admitted and LATER displaced (two records:
  admitted, then shed) is cancelled up front — it never contributed
  to live state, so it must not contribute to replayed state.
* The capture header's config fingerprint must match this process
  (same knobs → same hash chains); mismatches raise
  :class:`CaptureMismatchError` naming the differing knobs instead of
  diverging mysteriously (``allow_mismatch=True`` overrides for
  forensic runs).

Turning an anomaly into a fixture (docs/observability.md "Incident
response runbook"): fetch the bundle's ``capture.cbor``, then

    from llm_d_kv_cache_manager_tpu_torch.obs.replay import (
        load_capture, replay_capture,
    )
    report = replay_capture(load_capture(path))
    assert report.ok, report.divergence

``hack/replay_smoke.py`` is the CI-gated end-to-end version.

Copied from the JAX reference's ``obs/replay.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from llm_d_kv_cache_manager_tpu_torch.obs.capture import (
    canonical_state,
    capture_enabled_env,  # noqa: F401  (re-export: wiring convenience)
    decode_f64,
    diff_knobs,
    load_artifact,
)
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("obs.replay")

DEFAULT_CLUSTER_REPLICAS = 3


class CaptureMismatchError(ValueError):
    """The capture was recorded under different config knobs than this
    process resolves — replaying would diverge for config reasons, not
    behavior reasons.  ``differences`` names each mismatched knob."""

    def __init__(
        self,
        fingerprint: str,
        differences: List[str],
        source: Optional[str] = None,
    ) -> None:
        self.fingerprint = fingerprint
        self.differences = differences
        self.source = source
        detail = "; ".join(differences) or "package version differs"
        # Forensics over a directory of bundles needs the offending
        # artifact named IN the message (the short fingerprint is what
        # `kvtpu_build_info` and manifests print).
        artifact = f"{source} " if source else ""
        super().__init__(
            f"capture {artifact}(fingerprint {fingerprint[:8]}, full "
            f"{fingerprint}) does not match this process ({detail}); "
            "set the knobs to the recorded values or pass "
            "allow_mismatch=True"
        )


def load_capture(
    source, allow_mismatch: bool = False
) -> dict:
    """Load + validate a capture artifact from a path or raw bytes.

    Refuses (``CaptureMismatchError``) when the recorded config
    fingerprint differs from this process's unless ``allow_mismatch``.
    """
    if isinstance(source, (bytes, bytearray, memoryview)):
        data = bytes(source)
        source_name = None
    else:
        source_name = str(source)
        with open(source, "rb") as handle:
            data = handle.read()
    capture = load_artifact(data)
    from llm_d_kv_cache_manager_tpu_torch.obs.capture import config_fingerprint

    if capture["fingerprint"] != config_fingerprint():
        differences = diff_knobs(capture["knobs"])
        if not allow_mismatch:
            raise CaptureMismatchError(
                capture["fingerprint"], differences, source_name
            )
        logger.warning(
            "replaying a mismatched capture %s (%s): %s",
            source_name or "<bytes>",
            capture["fingerprint"],
            "; ".join(differences) or "version drift",
        )
    return capture


@dataclass
class ReplayReport:
    """Outcome of one replay; ``ok`` means zero divergence."""

    mode: str
    records: int = 0
    events_applied: int = 0
    events_shed: int = 0
    events_cancelled: int = 0
    scores_compared: int = 0
    classifications_checked: int = 0
    state_compared: bool = False
    truncated_sources: List[str] = field(default_factory=list)
    divergence: Optional[dict] = None

    @property
    def ok(self) -> bool:
        return self.divergence is None

    def to_dict(self) -> dict:
        return {
            "mode": self.mode,
            "ok": self.ok,
            "records": self.records,
            "events_applied": self.events_applied,
            "events_shed": self.events_shed,
            "events_cancelled": self.events_cancelled,
            "scores_compared": self.scores_compared,
            "classifications_checked": self.classifications_checked,
            "state_compared": self.state_compared,
            "truncated_sources": self.truncated_sources,
            "divergence": self.divergence,
        }


class _ReplayTokenizer:
    """Word-per-token tokenizer over prompts rendered by
    :func:`render_prompt` — the inverse pair that feeds recorded token
    chains back through the REAL tokenize→hash→lookup→score path."""

    def type(self) -> str:
        return "capture-replay"

    def encode(self, prompt: str, model_name: str, add_special_tokens):
        from llm_d_kv_cache_manager_tpu_torch.tokenization.tokenizers import (
            Encoding,
        )

        tokens: List[int] = []
        offsets: List[Tuple[int, int]] = []
        pos = 0
        for word in prompt.split(" "):
            if word.startswith("t"):
                tokens.append(int(word[1:]))
                offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return Encoding(tokens=tokens, offsets=offsets)


def render_prompt(tokens) -> str:
    """The prompt text whose :class:`_ReplayTokenizer` encoding is
    exactly ``tokens``."""
    return " ".join(f"t{int(token)}" for token in tokens)


def _cancel_displaced(records: List[list]) -> Tuple[Dict[int, bool], int]:
    """Map record seq -> cancelled for kvevents records: an admitted
    message later re-recorded as shed (cross-batch displacement) never
    reached the live index, so its admitted record must not replay."""
    cancelled: Dict[int, bool] = {}
    open_admits: Dict[tuple, List[int]] = {}
    n_cancelled = 0
    for record in records:
        if record[0] != 0:
            continue
        seq = record[1]
        key = (record[3], record[4], record[6])  # pod, topic, msg seq
        if record[9] == "admitted":
            open_admits.setdefault(key, []).append(seq)
        elif record[8] is None:
            # A shed record without a payload is the displacement
            # notice for a previously admitted message (shed-at-admit
            # records carry their payload).
            pending = open_admits.get(key)
            if pending:
                cancelled[pending.pop(0)] = True
                n_cancelled += 1
    return cancelled, n_cancelled


def replay_capture(
    capture: dict,
    mode: str = "single",
    replicas: int = DEFAULT_CLUSTER_REPLICAS,
    pool_concurrency: int = 2,
) -> ReplayReport:
    """Re-drive a loaded capture through a fresh stack; see module
    docstring.  ``mode`` is ``"single"`` (in-memory index) or
    ``"cluster"`` (``LocalCluster`` with ``replicas`` real replicas
    behind the ``RemoteIndex``)."""
    if mode not in ("single", "cluster"):
        raise ValueError(f"unknown replay mode: {mode!r}")
    from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import (
        Indexer,
        IndexerConfig,
    )
    from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
        TokenProcessorConfig,
    )
    from llm_d_kv_cache_manager_tpu_torch.kvevents.pool import (
        Message,
        Pool,
        PoolConfig,
    )
    from llm_d_kv_cache_manager_tpu_torch.kvevents.zmq_subscriber import (
        TopicSeqTracker,
    )
    from llm_d_kv_cache_manager_tpu_torch.tokenization.pool import (
        TokenizationPoolConfig,
    )

    meta = capture.get("meta") or {}
    block_size = int(meta.get("block_size", 16) or 16)
    hash_seed = str(meta.get("hash_seed", ""))
    report = ReplayReport(
        mode=mode,
        records=len(capture["records"]),
        truncated_sources=list(capture.get("truncated") or []),
    )

    cluster = None
    kv_block_index = None
    if mode == "cluster":
        from llm_d_kv_cache_manager_tpu_torch.cluster import LocalCluster

        cluster = LocalCluster(
            [f"replay-{i}" for i in range(max(1, replicas))]
        )
        kv_block_index = cluster.remote_index
    indexer = Indexer(
        IndexerConfig(
            token_processor_config=TokenProcessorConfig(
                block_size=block_size, hash_seed=hash_seed
            ),
            tokenizers_pool_config=TokenizationPoolConfig(
                # The live capture already holds the SERVED token
                # streams (prefix-store truncation included); the
                # replay store must never re-truncate them, so the
                # fast path is pinned unreachable.
                min_prefix_overlap_ratio=1.1,
            ),
            cache_stats=False,
        ),
        tokenizer=_ReplayTokenizer(),
        kv_block_index=kv_block_index,
    )
    indexer.run()
    pool = Pool(
        indexer.kv_block_index,
        indexer.token_processor,
        # The replay pool must NEVER shed: flow control dropping a
        # faithfully-recorded admitted message would read as a false
        # divergence.  Depth is effectively unbounded (the capture is
        # already fully in memory) and the periodic drain below keeps
        # the standing backlog small anyway.
        PoolConfig(
            concurrency=max(1, pool_concurrency),
            max_queue_depth=1 << 30,
        ),
    )
    pool.start()
    trackers: Dict[str, TopicSeqTracker] = {}
    cancelled, report.events_cancelled = _cancel_displaced(
        capture["records"]
    )
    try:
        pending_drain = False
        for record in capture["records"]:
            if report.divergence is not None:
                break
            if record[0] == 0:
                (
                    _kind,
                    seq,
                    _ts,
                    pod,
                    topic,
                    model,
                    msg_seq,
                    seq_gap,
                    payload,
                    disposition,
                ) = record
                if disposition != "admitted" and payload is None:
                    # Displacement notice — already reconciled.
                    continue
                tracker = trackers.get(pod)
                if tracker is None:
                    tracker = trackers[pod] = TopicSeqTracker()
                observed = tracker.observe(str(topic), int(msg_seq))
                report.classifications_checked += 1
                if int(observed.gap) != int(seq_gap):
                    report.divergence = {
                        "at_seq": seq,
                        "source": "kvevents",
                        "kind": "seq_classification",
                        "detail": (
                            f"pod {pod} topic {topic} seq {msg_seq}: "
                            f"recorded gap {seq_gap}, replay computed "
                            f"{observed.gap}"
                        ),
                    }
                    break
                if disposition != "admitted":
                    report.events_shed += 1
                    continue
                if cancelled.pop(seq, False):
                    continue
                pool.add_task(
                    Message(
                        topic=str(topic),
                        payload=bytes(payload),
                        pod_identifier=str(pod),
                        model_name=str(model),
                        seq=int(msg_seq),
                    )
                )
                report.events_applied += 1
                pending_drain = True
                if report.events_applied % 4096 == 0:
                    # Long event-only stretches: keep the replayed
                    # backlog bounded without waiting for the next
                    # score record.
                    pool.drain()
                    pending_drain = False
            else:
                _kind, seq, _ts, model, tokens, pods, raw_scores = record
                if pending_drain:
                    pool.drain()
                    pending_drain = False
                want = {
                    str(pod): decode_f64(value)
                    for pod, value in raw_scores
                }
                got = indexer.get_pod_scores(
                    render_prompt(tokens),
                    str(model),
                    [str(p) for p in pods] if pods is not None else None,
                )
                report.scores_compared += 1
                if got != want:
                    report.divergence = {
                        "at_seq": seq,
                        "source": "scores",
                        "kind": "score",
                        "detail": _score_diff_detail(want, got),
                    }
                    break
        if report.divergence is None:
            pool.drain()
            recorded_state = capture.get("state")
            if recorded_state is not None and not report.truncated_sources:
                replayed = canonical_state(indexer.kv_block_index)
                report.state_compared = True
                if replayed != recorded_state:
                    report.divergence = {
                        "at_seq": None,
                        "source": "state",
                        "kind": "state",
                        "detail": _state_diff_detail(
                            recorded_state, replayed
                        ),
                    }
    finally:
        pool.shutdown()
        indexer.shutdown()
        if cluster is not None:
            cluster.close()
    return report


def _score_diff_detail(want: dict, got: dict) -> str:
    for pod in sorted(set(want) | set(got)):
        recorded = want.get(pod)
        replayed = got.get(pod)
        if recorded != replayed:
            return (
                f"pod {pod}: recorded {recorded!r}, replayed "
                f"{replayed!r} ({len(want)} recorded / {len(got)} "
                "replayed pods)"
            )
    return "score maps differ"


def _state_diff_detail(recorded: list, replayed: list) -> str:
    rec_blocks = {key: pods for key, pods in recorded[0]}
    rep_blocks = {key: pods for key, pods in replayed[0]}
    for key in sorted(set(rec_blocks) | set(rep_blocks)):
        if rec_blocks.get(key) != rep_blocks.get(key):
            return (
                f"request key {key:#x}: recorded "
                f"{rec_blocks.get(key)!r}, replayed "
                f"{rep_blocks.get(key)!r}"
            )
    rec_map = {ek: rk for ek, rk in recorded[1]}
    rep_map = {ek: rk for ek, rk in replayed[1]}
    for key in sorted(set(rec_map) | set(rep_map)):
        if rec_map.get(key) != rep_map.get(key):
            return (
                f"engine key {key:#x}: recorded mapping "
                f"{rec_map.get(key)!r}, replayed {rep_map.get(key)!r}"
            )
    return "index states differ"
