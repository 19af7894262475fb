"""Replay-driven what-if engine: the fleet's wind tunnel.

The replay harness (``obs/replay.py``) answers "did behavior change?"
by re-driving a capture to a bit-identical check.  This module turns
the same artifacts into DECISIONS (ROADMAP item 4):

* **Time-compressed replay** (:func:`run_whatif`) — drive a recorded
  capture at a speed multiplier on a *virtual clock* against a fresh
  candidate stack (single index or a 3-replica ``LocalCluster``),
  measuring real hit rate, score-latency distribution, shed counts,
  and SLO-envelope verdicts under the compressed load.  Determinism is
  structural, not hopeful: the candidate ``Pool`` is never started —
  flow-control decisions happen at enqueue time as pure data-structure
  ops, and the virtual clock owns the only drain
  (``Pool.process_inline``), so the same capture + speed + arm always
  yields the same event interleaving, counters, and digest.  Wall
  clock is used ONLY for reported latencies/throughput and never
  participates in the deterministic pins.  A finite ``drain_rate``
  (events per virtual second) models the candidate's fixed apply
  capacity: raising ``speed`` then raises arrival rate against that
  capacity, reproducing offload-pressure regimes ("Understanding
  Bottlenecks … KV Offloading", PAPERS.md) from real traffic.
* **A/B replay** (:func:`run_ab`) — the same capture through two
  :class:`StackConfig` arms (shards, replicas, backend, eviction
  budget, flow-control knobs), reporting a structured delta: hit
  rate, TTFT-proxy latency percentiles, per-SLI envelope states, and
  the first checkpoint at which the two arms' SLO envelopes diverge.
  "Would this config have held last Tuesday's storm?" gets a measured
  answer from the incident bundle itself.
* **Synthetic composition** (:func:`splice`, :func:`interleave`,
  :func:`scale_pods`, :func:`stretch`, :func:`repeat`) — splice,
  fan-out-multiply, interleave, and time-stretch recorded streams
  into millions-of-users shapes the live bench cannot reach, emitted
  as valid v1 capture artifacts (``obs/capture.encode_capture``) the
  existing replay/divergence machinery accepts.

Surfaces: the CLI (``python -m llm_d_kv_cache_manager_tpu_torch.obs.whatif
run|ab|compose``), ``GET /debug/whatif`` (the bounded results
registry), ``POST /admin/whatif`` (run against a retained incident
bundle), ``kvtpu_whatif_*`` metrics, and the ``hack/perf_trend.py``
gate over the pinned reference capture
(``tests/testdata/whatif_reference.cbor``).  See
docs/observability.md "What-if engine".

Copied from the JAX reference's ``obs/whatif.py``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field, fields, replace
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS, safe_label
from llm_d_kv_cache_manager_tpu_torch.obs.capture import (
    canonical_state,
    decode_f64,
    encode_capture,
)
from llm_d_kv_cache_manager_tpu_torch.obs.replay import (
    load_capture,
    render_prompt,
    _ReplayTokenizer,
)
from llm_d_kv_cache_manager_tpu_torch.obs.slo import (
    SloEngine,
    SloSpec,
    envelope_states,
    envelope_violations,
)
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("obs.whatif")

DEFAULT_SPEED = 4.0
DEFAULT_CHECKPOINT_S = 1.0
DEFAULT_WINDOW_FAST_S = 5.0
DEFAULT_WINDOW_SLOW_S = 30.0
DEFAULT_LATENCY_BUDGET_MS = 50.0
DEFAULT_RESULTS_KEEP = 8

# At most this many SLO checkpoints per run: a week-long stretched
# capture must not allocate a million timeline rows, so the effective
# checkpoint interval grows with the virtual span past this.
MAX_CHECKPOINTS = 1024

# The pinned reference capture (hack/make_reference_capture.py) —
# what perf-trend's capacity gate and the smoke replay.
REFERENCE_CAPTURE_RELPATH = os.path.join(
    "tests", "testdata", "whatif_reference.cbor"
)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def reference_capture_path() -> str:
    """Absolute path of the checked-in reference capture (exists only
    in a full checkout; callers handle absence)."""
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(root, REFERENCE_CAPTURE_RELPATH)


def resolve_capture_source(path: str) -> str:
    """Accept a capture artifact OR an incident bundle directory (the
    satellite ergonomic: point the CLI at the bundle, not at its
    internals)."""
    if os.path.isdir(path):
        candidate = os.path.join(path, "capture.cbor")
        if not os.path.isfile(candidate):
            raise FileNotFoundError(
                f"{path} is a directory without a capture.cbor "
                "(not an incident bundle?)"
            )
        return candidate
    return path


# ------------------------------ stack config ------------------------------


@dataclass
class StackConfig:
    """One candidate stack (an A/B arm).

    ``parse`` accepts the CLI/admin spec form — comma-separated
    ``key=value`` pairs, e.g. ``"shards=8,mode=cluster,replicas=3"``
    or ``"backend=cost_aware,max_cost_mb=4"``.
    """

    name: str = "a"
    # "single" (one in-memory index) or "cluster" (LocalCluster behind
    # the RemoteIndex).
    mode: str = "single"
    replicas: int = 3
    # "memory" (InMemoryIndex) or "cost_aware" (byte-budgeted LRU with
    # optional predictive eviction — the eviction-policy A/B knob).
    backend: str = "memory"
    shards: int = 0  # 0 -> backend default
    index_size: int = 0  # block-key capacity; 0 -> backend default
    pod_cache: int = 0  # per-key pod entries; 0 -> backend default
    max_cost_mb: float = 64.0  # cost_aware byte budget
    # Event-plane flow control: pool shards, per-shard queue depth
    # (0 -> effectively unbounded), per-pod budget.
    concurrency: int = 1
    depth: int = 0
    pod_budget: Optional[int] = None
    # Load-blended scoring coefficient (None -> LOAD_BLEND env).
    load_blend: Optional[float] = None
    # Apply capacity in events per VIRTUAL second; 0 = unbounded (the
    # stack keeps up perfectly and every score sees every prior
    # admitted write, the replay-parity semantics).
    drain_rate: float = 0.0

    _INT_KEYS = (
        "replicas",
        "shards",
        "index_size",
        "pod_cache",
        "concurrency",
        "depth",
    )
    _FLOAT_KEYS = ("max_cost_mb", "drain_rate")

    @classmethod
    def parse(cls, spec: str, name: str = "a") -> "StackConfig":
        cfg = cls(name=name)
        valid = {f.name for f in fields(cls)}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"arm spec needs key=value pairs, got {part!r}"
                )
            key, value = part.split("=", 1)
            key = key.strip()
            value = value.strip()
            if key == "name" or key.startswith("_") or key not in valid:
                raise ValueError(f"unknown arm knob {key!r}")
            if key in cls._INT_KEYS:
                setattr(cfg, key, int(value))
            elif key in cls._FLOAT_KEYS:
                setattr(cfg, key, float(value))
            elif key in ("pod_budget", "load_blend"):
                setattr(
                    cfg,
                    key,
                    None
                    if value.lower() in ("", "none")
                    else (int(value) if key == "pod_budget" else float(value)),
                )
            else:  # mode / backend
                setattr(cfg, key, value)
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.mode not in ("single", "cluster"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.backend not in ("memory", "cost_aware"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.mode == "cluster" and self.backend != "memory":
            raise ValueError(
                "cluster arms use the in-memory backend per replica"
            )
        if self.mode == "cluster" and self.replicas <= 0:
            raise ValueError("cluster arms need replicas >= 1")
        if self.concurrency <= 0:
            raise ValueError("concurrency must be positive")
        if self.drain_rate < 0:
            raise ValueError("drain_rate must be >= 0")

    def describe(self) -> dict:
        out = {
            "name": self.name,
            "mode": self.mode,
            "backend": self.backend,
        }
        if self.mode == "cluster":
            out["replicas"] = self.replicas
        for key in (
            "shards",
            "index_size",
            "pod_cache",
            "concurrency",
            "depth",
        ):
            value = getattr(self, key)
            if value:
                out[key] = value
        if self.backend == "cost_aware":
            out["max_cost_mb"] = self.max_cost_mb
        if self.pod_budget is not None:
            out["pod_budget"] = self.pod_budget
        if self.load_blend is not None:
            out["load_blend"] = self.load_blend
        if self.drain_rate:
            out["drain_rate"] = self.drain_rate
        return out


@dataclass
class WhatIfConfig:
    """Run-shape knobs shared by both arms (docs/configuration.md:
    ``WHATIF_SPEED``, ``WHATIF_CHECKPOINT_S``,
    ``WHATIF_LATENCY_BUDGET_MS``, ``WHATIF_RESULTS_KEEP``)."""

    speed: float = DEFAULT_SPEED
    checkpoint_s: float = DEFAULT_CHECKPOINT_S
    window_fast_s: float = DEFAULT_WINDOW_FAST_S
    window_slow_s: float = DEFAULT_WINDOW_SLOW_S
    latency_budget_ms: float = DEFAULT_LATENCY_BUDGET_MS

    @classmethod
    def from_env(cls) -> "WhatIfConfig":
        return cls(
            speed=_env_float("WHATIF_SPEED", DEFAULT_SPEED),
            checkpoint_s=_env_float(
                "WHATIF_CHECKPOINT_S", DEFAULT_CHECKPOINT_S
            ),
            latency_budget_ms=_env_float(
                "WHATIF_LATENCY_BUDGET_MS", DEFAULT_LATENCY_BUDGET_MS
            ),
        )

    def validate(self) -> None:
        if self.speed <= 0:
            raise ValueError("speed must be positive")
        if self.checkpoint_s <= 0:
            raise ValueError("checkpoint_s must be positive")


# --------------------------- disposition tap ---------------------------


class _DispositionTap:
    """Duck-typed capture recorder attached to the candidate pool: it
    records each offered message's flow-control disposition in offer
    order (the deterministic interleaving the digest folds) instead of
    retaining payloads."""

    def __init__(self) -> None:
        self.events: List[Tuple[str, str, int, str]] = []
        self.admitted = 0
        self.shed = 0
        self.shed_reasons: Dict[str, int] = {}

    def record_admitted_messages(self, messages) -> None:
        for message in messages:
            self.events.append(
                (
                    message.pod_identifier,
                    message.topic,
                    int(message.seq),
                    "admitted",
                )
            )
            self.admitted += 1

    def record_kvevents_batch(self, items) -> None:
        for pod, topic, _model, seq, _gap, _payload, disposition in items:
            self.events.append(
                (str(pod), str(topic), int(seq), str(disposition))
            )
            if disposition == "admitted":
                self.admitted += 1
            else:
                self.shed += 1
                self.shed_reasons[disposition] = (
                    self.shed_reasons.get(disposition, 0) + 1
                )


# ------------------------------ the stack ------------------------------


class _CandidateStack:
    """A fresh index + indexer + (un-started) pool built to one
    :class:`StackConfig` — everything a virtual-clock drive needs."""

    def __init__(self, arm: StackConfig, meta: Dict[str, str]) -> None:
        from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import (
            Indexer,
            IndexerConfig,
        )
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import (
            CostAwareIndexConfig,
            IndexConfig,
            InMemoryIndexConfig,
        )
        from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
            TokenProcessorConfig,
        )
        from llm_d_kv_cache_manager_tpu_torch.kvevents.pool import (
            Pool,
            PoolConfig,
        )
        from llm_d_kv_cache_manager_tpu_torch.tokenization.pool import (
            TokenizationPoolConfig,
        )

        arm.validate()
        block_size = int(meta.get("block_size", 16) or 16)
        hash_seed = str(meta.get("hash_seed", ""))

        in_memory = InMemoryIndexConfig()
        if arm.shards:
            in_memory.shards = arm.shards
        if arm.index_size:
            in_memory.size = arm.index_size
        if arm.pod_cache:
            in_memory.pod_cache_size = arm.pod_cache

        self.cluster = None
        kv_block_index = None
        index_config = IndexConfig(in_memory_config=in_memory)
        if arm.mode == "cluster":
            from llm_d_kv_cache_manager_tpu_torch.cluster import LocalCluster

            self.cluster = LocalCluster(
                [f"whatif-{i}" for i in range(max(1, arm.replicas))],
                index_config=in_memory,
            )
            kv_block_index = self.cluster.remote_index
        elif arm.backend == "cost_aware":
            index_config = IndexConfig(
                in_memory_config=None,
                cost_aware_config=CostAwareIndexConfig(
                    max_cost_bytes=int(
                        max(1.0, arm.max_cost_mb) * 1024 * 1024
                    ),
                    pod_cache_size=arm.pod_cache or 10,
                ),
            )

        self.indexer = Indexer(
            IndexerConfig(
                token_processor_config=TokenProcessorConfig(
                    block_size=block_size, hash_seed=hash_seed
                ),
                kvblock_index_config=index_config,
                tokenizers_pool_config=TokenizationPoolConfig(
                    # Recorded token streams are the SERVED streams;
                    # the candidate's prefix store must never
                    # re-truncate them (same pin as obs/replay.py).
                    min_prefix_overlap_ratio=1.1,
                ),
                cache_stats=False,
                load_blend=arm.load_blend,
            ),
            tokenizer=_ReplayTokenizer(),
            kv_block_index=kv_block_index,
        )
        self.indexer.run()
        self.tap = _DispositionTap()
        # NEVER started: the virtual clock owns the only drain
        # (Pool.process_inline), so enqueue/shed/apply interleaving is
        # a pure function of the schedule.
        self.pool = Pool(
            self.indexer.kv_block_index,
            self.indexer.token_processor,
            PoolConfig(
                concurrency=max(1, arm.concurrency),
                max_queue_depth=arm.depth if arm.depth > 0 else 1 << 30,
                pod_budget=arm.pod_budget,
            ),
            capture=self.tap,
        )

    def close(self) -> None:
        self.pool.shutdown()
        self.indexer.shutdown()
        if self.cluster is not None:
            self.cluster.close()


def _register_slos(
    engine: SloEngine,
    counters: Dict[str, int],
    tap: _DispositionTap,
    pool,
) -> None:
    """The replayed-stream SLIs evaluated on the VIRTUAL clock.  Shed
    fraction, hit rate, and backlog are deterministic; score latency
    is wall-measured (a real TTFT proxy) and intentionally excluded
    from the determinism pins."""
    engine.register(
        SloSpec(
            "whatif.event_shed",
            kind="ratio",
            objective=0.99,
            degraded_bound=0.90,
            description="offered kvevents neither rejected nor "
            "displaced by the candidate stack's flow control",
        ),
        lambda: (
            (max(0, counters["offered"] - tap.shed), counters["offered"])
            if counters["offered"]
            else None
        ),
    )
    engine.register(
        SloSpec(
            "whatif.hit_rate",
            kind="ratio",
            objective=0.25,
            degraded_bound=0.05,
            description="scored requests with a non-zero best score "
            "under the replayed load",
        ),
        lambda: (
            (counters["hits"], counters["scores"])
            if counters["scores"]
            else None
        ),
    )
    engine.register(
        SloSpec(
            "whatif.score_latency",
            kind="ratio",
            objective=0.95,
            degraded_bound=0.80,
            description="scores answered within WHATIF_LATENCY_BUDGET_MS "
            "(wall-measured TTFT proxy; not part of the deterministic "
            "pins)",
        ),
        lambda: (
            (counters["lat_good"], counters["scores"])
            if counters["scores"]
            else None
        ),
    )
    engine.register(
        SloSpec(
            "whatif.backlog",
            kind="gauge",
            objective=512.0,
            degraded_bound=65536.0,
            gauge_agg="max",
            description="candidate pool backlog (queued, not yet "
            "applied) at the checkpoint",
        ),
        lambda: float(pool.backlog()),
    )


def _percentile(sorted_values: List[float], q: float) -> float:
    if not sorted_values:
        return 0.0
    pos = min(
        len(sorted_values) - 1, int(q * (len(sorted_values) - 1) + 0.5)
    )
    return sorted_values[pos]


# ------------------------------ the drive ------------------------------


def run_whatif(
    capture: dict,
    arm: Optional[StackConfig] = None,
    config: Optional[WhatIfConfig] = None,
    register: bool = True,
) -> dict:
    """Time-compressed replay of one loaded capture through one
    candidate arm; returns the machine-readable result (and records it
    in the ``/debug/whatif`` registry unless ``register=False``).

    Deterministic fields for a given (capture, speed, arm):
    ``events``, ``scores.total/hits/hit_rate/recorded_parity``,
    ``digest``, ``seq_classification_mismatches``.  Wall-clock fields
    (``latency_ms``, ``wall_s``, throughput) vary run to run.
    """
    from llm_d_kv_cache_manager_tpu_torch.kvevents.pool import Message
    from llm_d_kv_cache_manager_tpu_torch.kvevents.zmq_subscriber import (
        TopicSeqTracker,
    )

    arm = arm or StackConfig()
    config = config or WhatIfConfig.from_env()
    config.validate()
    records = capture["records"]
    if not records:
        raise ValueError("capture holds no records")
    meta = capture.get("meta") or {}

    ts_values = [int(r[2]) for r in records]
    t0 = min(ts_values)
    span_virtual = max(0.0, (max(ts_values) - t0) / 1e6 / config.speed)
    checkpoint_s = max(
        config.checkpoint_s, span_virtual / MAX_CHECKPOINTS
    )

    counters: Dict[str, int] = {
        "offered": 0,
        "shed": 0,
        "applied": 0,
        "scores": 0,
        "hits": 0,
        "lat_good": 0,
        "parity": 0,
    }
    stack = _CandidateStack(arm, meta)
    engine = SloEngine(
        window_fast_s=config.window_fast_s,
        window_slow_s=max(config.window_slow_s, config.window_fast_s),
    )
    _register_slos(engine, counters, stack.tap, stack.pool)

    digest = hashlib.blake2b(digest_size=16)
    timeline: List[Tuple[float, Dict[str, str]]] = []
    latencies: List[float] = []
    trackers: Dict[str, TopicSeqTracker] = {}
    mismatches = 0
    drain_rate = float(arm.drain_rate)
    credit = 0.0
    # Token-bucket burst bound: one virtual second of capacity (at
    # least one apply batch) — idle stretches must not bank unlimited
    # catch-up credit or the backlog model goes soft.
    burst = max(drain_rate, 32.0)
    last_v = 0.0
    next_cp = checkpoint_s
    tap = stack.tap
    tap_cursor = 0
    peak_backlog = 0
    wall_t0 = time.perf_counter()

    def checkpoint(now_v: float) -> None:
        engine.sample(now=now_v)
        payload = engine.evaluate(now=now_v)
        timeline.append((round(now_v, 6), envelope_states(payload)))

    try:
        for record in records:
            v = max(0.0, (int(record[2]) - t0) / 1e6 / config.speed)
            if drain_rate > 0.0 and v > last_v:
                credit = min(credit + (v - last_v) * drain_rate, burst)
                budget = int(credit)
                if budget > 0:
                    counters["applied"] += stack.pool.process_inline(
                        budget
                    )
                    credit -= budget
            last_v = max(last_v, v)
            while v >= next_cp:
                checkpoint(next_cp)
                next_cp += checkpoint_s
            if record[0] == 0:
                (
                    _kind,
                    _seq,
                    _ts,
                    pod,
                    topic,
                    model,
                    msg_seq,
                    seq_gap,
                    payload,
                    _disposition,
                ) = record
                if payload is None:
                    # Displacement notice / payload-free shed: the
                    # admit-time record (which carries the payload)
                    # is the offer; what-if re-decides its fate.
                    continue
                tracker = trackers.get(str(pod))
                if tracker is None:
                    tracker = trackers[str(pod)] = TopicSeqTracker()
                observed = tracker.observe(str(topic), int(msg_seq))
                if int(observed.gap) != int(seq_gap):
                    mismatches += 1
                counters["offered"] += 1
                stack.pool.add_task(
                    Message(
                        topic=str(topic),
                        payload=bytes(payload),
                        pod_identifier=str(pod),
                        model_name=str(model),
                        seq=int(msg_seq),
                        seq_gap=int(observed.gap),
                    )
                )
                backlog = stack.pool.backlog()
                if backlog > peak_backlog:
                    peak_backlog = backlog
                if (
                    drain_rate == 0.0
                    and counters["offered"] % 4096 == 0
                ):
                    counters["applied"] += stack.pool.process_inline()
            else:
                _kind, seq, _ts, model, tokens, pods, raw_scores = record
                if drain_rate == 0.0:
                    # Unbounded capacity: replay-parity semantics —
                    # every admitted write is visible to this read.
                    counters["applied"] += stack.pool.process_inline()
                score_t0 = time.perf_counter()
                got = stack.indexer.get_pod_scores(
                    render_prompt(tokens),
                    str(model),
                    [str(p) for p in pods] if pods is not None else None,
                )
                elapsed_ms = (time.perf_counter() - score_t0) * 1e3
                latencies.append(elapsed_ms)
                counters["scores"] += 1
                if any(value > 0.0 for value in got.values()):
                    counters["hits"] += 1
                if elapsed_ms <= config.latency_budget_ms:
                    counters["lat_good"] += 1
                recorded = {
                    str(p): decode_f64(value) for p, value in raw_scores
                }
                if got == recorded:
                    counters["parity"] += 1
                digest.update(
                    f"s|{seq}|{sorted(got.items())!r}\n".encode()
                )
            # Fold newly-decided dispositions in interleaved order.
            events = tap.events
            while tap_cursor < len(events):
                pod_id, topic_id, mseq, dispo = events[tap_cursor]
                digest.update(
                    f"e|{pod_id}|{topic_id}|{mseq}|{dispo}\n".encode()
                )
                tap_cursor += 1

        final_backlog = stack.pool.backlog()
        counters["applied"] += stack.pool.process_inline()
        end_v = max(span_virtual, next_cp - checkpoint_s) + checkpoint_s
        checkpoint(end_v)
        final_payload = engine.evaluate(now=end_v)
        state = canonical_state(stack.indexer.kv_block_index)
        digest.update(repr(state).encode())
        digest.update(
            f"c|{counters['offered']}|{tap.admitted}|{tap.shed}|"
            f"{counters['scores']}|{counters['hits']}|"
            f"{final_backlog}\n".encode()
        )
    finally:
        stack.close()

    wall_s = max(1e-9, time.perf_counter() - wall_t0)
    latencies_sorted = sorted(latencies)
    scores_total = counters["scores"]
    result = {
        "kind": "run",
        "arm": arm.name,
        "config": arm.describe(),
        "speed": config.speed,
        "drain_rate": drain_rate,
        "virtual_span_s": round(span_virtual, 6),
        "checkpoint_s": checkpoint_s,
        "wall_s": wall_s,
        "events": {
            "offered": counters["offered"],
            "admitted": tap.admitted,
            "shed": tap.shed,
            "shed_reasons": dict(sorted(tap.shed_reasons.items())),
            "applied": counters["applied"],
            "final_backlog": final_backlog,
            "peak_backlog": peak_backlog,
            "per_sec_wall": counters["offered"] / wall_s,
        },
        "scores": {
            "total": scores_total,
            "hits": counters["hits"],
            "hit_rate": (
                counters["hits"] / scores_total if scores_total else 0.0
            ),
            "recorded_parity": (
                counters["parity"] / scores_total if scores_total else 0.0
            ),
            "latency_ms": {
                "p50": _percentile(latencies_sorted, 0.50),
                "p90": _percentile(latencies_sorted, 0.90),
                "p99": _percentile(latencies_sorted, 0.99),
            },
            "per_sec_wall": scores_total / wall_s,
        },
        "seq_classification_mismatches": mismatches,
        "slo": {
            "final": envelope_states(final_payload),
            "violations": envelope_violations(final_payload),
            "checkpoints": len(timeline),
            "timeline": [
                [v, states] for v, states in timeline
            ],
        },
        "digest": digest.hexdigest(),
    }
    _account_run(result, outcome="ok")
    if register:
        REGISTRY.add(result)
    return result


def _account_run(result: dict, outcome: str) -> None:
    try:
        METRICS.whatif_runs.labels(
            kind=result.get("kind", "run"), outcome=outcome
        ).inc()
        events = result.get("events") or {}
        for disposition, count in (
            ("admitted", events.get("admitted", 0)),
            ("shed", events.get("shed", 0)),
        ):
            if count:
                METRICS.whatif_events.labels(
                    disposition=disposition
                ).inc(count)
        scores = result.get("scores") or {}
        METRICS.whatif_hit_rate.labels(
            arm=safe_label(str(result.get("arm", "a")))
        ).set(float(scores.get("hit_rate", 0.0)))
    except Exception:  # noqa: BLE001 — metrics must never fail a run
        logger.exception("whatif metrics accounting failed")


# ------------------------------- A/B replay -------------------------------


def first_slo_divergence(
    timeline_a: Sequence[Sequence],
    timeline_b: Sequence[Sequence],
) -> Optional[dict]:
    """The first checkpoint at which the two arms' envelope states
    differ (per-SLI), or ``None`` when they never do."""
    for (v_a, states_a), (v_b, states_b) in zip(timeline_a, timeline_b):
        if states_a != states_b:
            differing = sorted(
                name
                for name in set(states_a) | set(states_b)
                if states_a.get(name) != states_b.get(name)
            )
            return {
                "virtual_s": v_a,
                "slis": differing,
                "a": {name: states_a.get(name) for name in differing},
                "b": {name: states_b.get(name) for name in differing},
            }
    return None


def _pair(a_value, b_value) -> dict:
    out = {"a": a_value, "b": b_value}
    if isinstance(a_value, (int, float)) and isinstance(
        b_value, (int, float)
    ):
        out["delta"] = b_value - a_value
    return out


def run_ab(
    capture: dict,
    arm_a: StackConfig,
    arm_b: StackConfig,
    config: Optional[WhatIfConfig] = None,
    register: bool = True,
) -> dict:
    """Same capture, two arms, one structured delta (the
    machine-readable A/B verdict).  Arms run sequentially against
    fresh stacks; both see the identical virtual schedule."""
    config = config or WhatIfConfig.from_env()
    if arm_a.name == arm_b.name:
        arm_b = replace(arm_b, name=arm_b.name + "-b")
    a = run_whatif(capture, arm_a, config, register=False)
    b = run_whatif(capture, arm_b, config, register=False)
    hit_a = a["scores"]["hit_rate"]
    hit_b = b["scores"]["hit_rate"]
    if hit_a == hit_b:
        hit_parity = 1.0
    else:
        low, high = sorted((hit_a, hit_b))
        hit_parity = (low / high) if high > 0 else 0.0
    delta = {
        "hit_rate": _pair(hit_a, hit_b),
        "hit_parity": hit_parity,
        "recorded_parity": _pair(
            a["scores"]["recorded_parity"], b["scores"]["recorded_parity"]
        ),
        "shed": _pair(a["events"]["shed"], b["events"]["shed"]),
        "applied": _pair(a["events"]["applied"], b["events"]["applied"]),
        "final_backlog": _pair(
            a["events"]["final_backlog"], b["events"]["final_backlog"]
        ),
        "latency_p50_ms": _pair(
            a["scores"]["latency_ms"]["p50"],
            b["scores"]["latency_ms"]["p50"],
        ),
        "latency_p99_ms": _pair(
            a["scores"]["latency_ms"]["p99"],
            b["scores"]["latency_ms"]["p99"],
        ),
        "wall_scores_per_sec": _pair(
            a["scores"]["per_sec_wall"], b["scores"]["per_sec_wall"]
        ),
        "digest_equal": a["digest"] == b["digest"],
        "slo": {
            "a_final": a["slo"]["final"],
            "b_final": b["slo"]["final"],
            "first_divergence": first_slo_divergence(
                a["slo"]["timeline"], b["slo"]["timeline"]
            ),
        },
    }
    result = {
        "kind": "ab",
        "speed": config.speed,
        "a": a,
        "b": b,
        "delta": delta,
    }
    _account_run(
        {"kind": "ab", "arm": "ab", "events": {}, "scores": {}},
        outcome="ok",
    )
    if register:
        REGISTRY.add(result)
    return result


def gate_headlines(ab: dict) -> Dict[str, float]:
    """The deterministic higher-is-better headlines perf-trend gates
    on the pinned reference capture (hack/perf_trend.py):

    * ``whatif.hit_rate`` — arm A's measured hit rate (a hashing /
      chunking / index regression zeroes or dents it);
    * ``whatif.recorded_parity`` — fraction of replayed scores equal
      to the recorded maps (ANY behavioral drift shows here first);
    * ``whatif.ab_hit_parity`` — hit-rate parity between the two index
      configs (a shard-count-dependent scoring bug breaks it).
    """
    delta = ab["delta"]
    return {
        "whatif.hit_rate": float(delta["hit_rate"]["a"]),
        "whatif.recorded_parity": float(delta["recorded_parity"]["a"]),
        "whatif.ab_hit_parity": float(delta["hit_parity"]),
    }


def reference_ab(
    capture_path: Optional[str] = None,
    config: Optional[WhatIfConfig] = None,
) -> dict:
    """The pinned capacity check: A/B of ``shards=1`` vs ``shards=8``
    over the reference capture — deterministic headline values on any
    machine (hit rate, recorded parity, A/B parity)."""
    path = capture_path or reference_capture_path()
    # The fingerprint hashes the package version; the checked-in
    # artifact intentionally survives version bumps, and what-if
    # measures rather than bit-compares, so mismatch is allowed.
    capture = load_capture(
        resolve_capture_source(path), allow_mismatch=True
    )
    return run_ab(
        capture,
        StackConfig.parse("shards=1", name="shards1"),
        StackConfig.parse("shards=8", name="shards8"),
        config or WhatIfConfig(speed=DEFAULT_SPEED),
        register=False,
    )


# ---------------------------- results registry ----------------------------

# kvlint: lock-order: WhatIfRegistry._lock ascending
lockorder.declare_ascending("WhatIfRegistry._lock")


def _drop_none(payload: dict) -> dict:
    return {k: v for k, v in payload.items() if v is not None}


def _summarize(result: dict) -> dict:
    """One-line view for /debug/whatif listings."""
    if result.get("kind") == "ab":
        delta = result.get("delta") or {}
        return _drop_none(
            {
                "kind": "ab",
                "speed": result.get("speed"),
                "hit_rate": delta.get("hit_rate"),
                "shed": delta.get("shed"),
                "digest_equal": delta.get("digest_equal"),
                "first_divergence": (delta.get("slo") or {}).get(
                    "first_divergence"
                ),
                "completed_unix": result.get("completed_unix"),
            }
        )
    events = result.get("events") or {}
    scores = result.get("scores") or {}
    return _drop_none(
        {
            "kind": result.get("kind", "run"),
            "arm": result.get("arm"),
            "speed": result.get("speed"),
            "offered": events.get("offered"),
            "shed": events.get("shed"),
            "hit_rate": scores.get("hit_rate"),
            "slo_final": (result.get("slo") or {})
            .get("final", {})
            .get("overall"),
            "digest": result.get("digest"),
            "completed_unix": result.get("completed_unix"),
        }
    )


class WhatIfRegistry:
    """Bounded ring of completed run/A-B results — the
    ``GET /debug/whatif`` surface (``WHATIF_RESULTS_KEEP``)."""

    def __init__(self, keep: int = DEFAULT_RESULTS_KEEP) -> None:
        self.keep = max(1, keep)
        self._lock = lockorder.tracked(
            threading.Lock(), "WhatIfRegistry._lock"
        )
        self._results: Deque[dict] = deque(
            maxlen=self.keep
        )  # guarded-by: _lock

    def add(self, result: dict) -> None:
        result = dict(result)
        result.setdefault("completed_unix", time.time())
        with self._lock:
            self._results.append(result)

    def list(self, full: bool = False) -> List[dict]:
        with self._lock:
            results = list(self._results)
        results.reverse()  # newest first
        if full:
            return results
        return [_summarize(result) for result in results]

    def last(self) -> Optional[dict]:
        with self._lock:
            return self._results[-1] if self._results else None

    def status(self) -> dict:
        with self._lock:
            count = len(self._results)
            last = self._results[-1] if self._results else None
        return {
            "results": count,
            "keep": self.keep,
            "last": _summarize(last) if last else None,
        }


REGISTRY = WhatIfRegistry(
    keep=_env_int("WHATIF_RESULTS_KEEP", DEFAULT_RESULTS_KEEP)
)


# ----------------------------- composition -----------------------------


def _require_compatible(captures: Sequence[dict]) -> None:
    if not captures:
        raise ValueError("composition needs at least one capture")
    base = captures[0].get("meta") or {}
    for capture in captures[1:]:
        meta = capture.get("meta") or {}
        for key in ("block_size", "hash_seed"):
            if str(meta.get(key, "")) != str(base.get(key, "")):
                raise ValueError(
                    f"incompatible captures: meta {key} differs "
                    f"({base.get(key)!r} vs {meta.get(key)!r})"
                )


def _renumber(records: List[list]) -> List[list]:
    for seq, record in enumerate(records, start=1):
        record[1] = seq
    return records


def _compose_result(
    base: dict,
    records: List[list],
    ops_note: str,
    state: Optional[list],
) -> dict:
    meta = dict(base.get("meta") or {})
    prior = meta.get("compose_ops", "")
    meta["composed"] = "1"
    meta["compose_ops"] = f"{prior}+{ops_note}" if prior else ops_note
    return {
        "fingerprint": base["fingerprint"],
        "knobs": list(base["knobs"]),
        "created_us": int(base.get("created_us", 0)),
        "window_s": int(base.get("window_s", 0)),
        "max_bytes": int(base.get("max_bytes", 0)),
        "truncated": sorted(
            {
                source
                for capture in (base,)
                for source in (capture.get("truncated") or [])
            }
        ),
        "meta": meta,
        "records": _renumber(records),
        "state": state,
    }


def capture_to_bytes(capture: dict) -> bytes:
    """Serialize a loaded/composed capture dict back to a valid v1
    artifact (``load_capture``-compatible round trip)."""
    return encode_capture(
        capture["records"],
        fingerprint=capture["fingerprint"],
        knobs=capture["knobs"],
        created_us=capture.get("created_us", 0),
        window_s=capture.get("window_s", 0),
        max_bytes=capture.get("max_bytes", 0),
        truncated=capture.get("truncated") or [],
        meta=capture.get("meta") or {},
        state=capture.get("state"),
    )


def splice(captures: Sequence[dict], gap_us: int = 1_000_000) -> dict:
    """Play captures back-to-back on one timeline: capture *k+1*
    starts ``gap_us`` after capture *k* ends, and each (pod, topic)
    publisher seq stream is offset to CONTINUE the prior segment's
    stream — every recorded gap classification replays identically
    (the boundary record's offset preserves its recorded gap).  State
    and recorded scores describe the SOURCE segments, so the spliced
    artifact drops its state section (what-if measures; bit-exact
    replay of a splice is only meaningful segment by segment)."""
    _require_compatible(captures)
    out: List[list] = []
    last_ts = 0
    # (pod, topic) -> last msg seq emitted on the spliced timeline
    # (the replayed TopicSeqTracker watermark).
    watermark: Dict[Tuple[str, str], int] = {}
    for idx, capture in enumerate(captures):
        records = capture["records"]
        if not records:
            continue
        first_ts = min(int(r[2]) for r in records)
        shift = 0 if idx == 0 else (last_ts + gap_us - first_ts)
        # Per-stream seq offset for THIS segment, fixed at the
        # stream's first record so internal deltas are preserved.
        offsets: Dict[Tuple[str, str], int] = {}
        for record in records:
            row = [
                value if not isinstance(value, list) else list(value)
                for value in record
            ]
            row[2] = int(row[2]) + shift
            if row[0] == 0:
                key = (str(row[3]), str(row[4]))
                if key not in offsets:
                    prior = watermark.get(key)
                    if prior is None:
                        offsets[key] = 0
                    else:
                        # Continue the stream: the first record keeps
                        # its recorded gap (new_seq - prior - 1 ==
                        # recorded gap).
                        offsets[key] = (
                            prior + 1 + int(row[7]) - int(row[6])
                        )
                row[6] = int(row[6]) + offsets[key]
                watermark[key] = row[6]
            out.append(row)
        last_ts = max(int(r[2]) + shift for r in records)
    return _compose_result(
        captures[0], out, f"splice:{len(captures)}", state=None
    )


def repeat(capture: dict, times: int, gap_us: int = 1_000_000) -> dict:
    """Splice a capture with itself ``times`` times — the sustained
    re-arrival storm shape."""
    if times < 1:
        raise ValueError("repeat needs times >= 1")
    return splice([capture] * times, gap_us=gap_us)


def _rename_pod_topic(topic: str, pod: str, clone: str, tag: str) -> str:
    if pod and pod in topic:
        return topic.replace(pod, clone, 1)
    return f"{topic}{tag}"


def scale_pods(capture: dict, factor: int) -> dict:
    """Pod-fanout multiply: every kvevents stream is cloned under
    ``factor - 1`` derived pod identities (identical payload bytes,
    identical seq stream), and every recorded score map / pod filter /
    state entry is expanded to the clones — the clones hold exactly
    the original pods' blocks, so within the index's per-key pod-cache
    capacity the scaled artifact still replays bit-exactly through
    ``obs/replay.replay_capture``.  When the expansion would overflow
    the default pod cache the state section is dropped (scores remain
    recorded truth per construction)."""
    if factor < 1:
        raise ValueError("scale factor must be >= 1")
    records = capture["records"]
    out: List[list] = []
    max_pods_per_key = 0
    for record in records:
        if record[0] == 0:
            base_row = [
                value if not isinstance(value, list) else list(value)
                for value in record
            ]
            out.append(base_row)
            pod = str(record[3])
            for k in range(1, factor):
                clone = f"{pod}x{k}"
                row = list(base_row)
                row[3] = clone
                row[4] = _rename_pod_topic(
                    str(record[4]), pod, clone, f"x{k}"
                )
                out.append(row)
        else:
            kind, seq, ts, model, tokens, pods, raw_scores = record
            new_pods = None
            if pods is not None:
                new_pods = []
                for pod in pods:
                    new_pods.append(pod)
                    new_pods.extend(
                        f"{pod}x{k}" for k in range(1, factor)
                    )
            new_scores = []
            for pod, value in raw_scores:
                new_scores.append([pod, value])
                new_scores.extend(
                    [f"{pod}x{k}", value] for k in range(1, factor)
                )
            new_scores.sort(key=lambda item: str(item[0]))
            out.append(
                [
                    kind,
                    seq,
                    ts,
                    model,
                    list(tokens),
                    new_pods,
                    new_scores,
                ]
            )
    state = capture.get("state")
    new_state = None
    if state is not None and factor >= 1:
        block_rows = []
        for key, entries in state[0]:
            expanded = []
            for pod, tier in entries:
                expanded.append([pod, tier])
                expanded.extend(
                    [f"{pod}x{k}", tier] for k in range(1, factor)
                )
            expanded.sort(key=lambda item: (str(item[0]), str(item[1])))
            max_pods_per_key = max(max_pods_per_key, len(expanded))
            block_rows.append([key, expanded])
        # InMemoryIndexConfig.pod_cache_size default — past it the
        # replayed index evicts pod entries the recorded state keeps.
        if max_pods_per_key <= 10:
            new_state = [block_rows, [list(row) for row in state[1]]]
    return _compose_result(
        capture, out, f"scale:{factor}", state=new_state
    )


def interleave(captures: Sequence[dict]) -> dict:
    """Overlay captures on ONE timeline (offset to a common origin),
    renaming every stream of capture *k>0* (``~s<k>`` pod suffix) so
    publisher seq streams never collide — the concurrent-fleets storm
    shape.  Scores keep their per-stream pod filters (renamed); the
    state section is dropped (streams sharing token chains would
    cross-pollinate score maps, which is exactly the load shape this
    operator exists to create, measured by what-if rather than
    bit-compared)."""
    _require_compatible(captures)
    rows: List[Tuple[int, int, int, list]] = []
    for idx, capture in enumerate(captures):
        records = capture["records"]
        if not records:
            continue
        first_ts = min(int(r[2]) for r in records)
        suffix = f"~s{idx}"
        for record in records:
            row = [
                value if not isinstance(value, list) else list(value)
                for value in record
            ]
            row[2] = int(row[2]) - first_ts
            if idx > 0:
                if row[0] == 0:
                    pod = str(row[3])
                    clone = pod + suffix
                    row[3] = clone
                    row[4] = _rename_pod_topic(
                        str(row[4]), pod, clone, suffix
                    )
                else:
                    if row[5] is not None:
                        row[5] = [str(p) + suffix for p in row[5]]
                    row[6] = [
                        [str(p) + suffix, value] for p, value in row[6]
                    ]
            rows.append((row[2], idx, int(record[1]), row))
    rows.sort(key=lambda item: (item[0], item[1], item[2]))
    base_t0 = int(captures[0].get("created_us", 0))
    out = []
    for offset, _idx, _seq, row in rows:
        row[2] = base_t0 + offset
        out.append(row)
    return _compose_result(
        captures[0], out, f"interleave:{len(captures)}", state=None
    )


def stretch(capture: dict, factor: float) -> dict:
    """Time-stretch (factor > 1) or compress (factor < 1) the recorded
    timeline around its first timestamp.  Replay semantics are
    timestamp-free, so a stretched capture still replays bit-exactly;
    what-if's virtual clock sees the new arrival density."""
    if factor <= 0:
        raise ValueError("stretch factor must be positive")
    records = capture["records"]
    if not records:
        raise ValueError("capture holds no records")
    t0 = min(int(r[2]) for r in records)
    out = []
    for record in records:
        row = [
            value if not isinstance(value, list) else list(value)
            for value in record
        ]
        row[2] = t0 + int(round((int(row[2]) - t0) * factor))
        out.append(row)
    return _compose_result(
        capture,
        out,
        f"stretch:{factor:g}",
        state=capture.get("state"),
    )


# --------------------------------- CLI ---------------------------------


def _load(path: str, allow_mismatch: bool) -> dict:
    return load_capture(
        resolve_capture_source(path), allow_mismatch=allow_mismatch
    )


def _apply_ops(captures: List[dict], ops: List[str]) -> dict:
    """Apply composition ops left to right.  ``splice`` /
    ``interleave`` consume the current capture LIST; ``scale:<n>`` /
    ``stretch:<f>`` / ``repeat:<n>`` transform the current (single)
    capture."""
    current: Optional[dict] = captures[0] if len(captures) == 1 else None
    for op in ops:
        name, _, arg = op.partition(":")
        name = name.strip().lower()
        if name in ("splice", "interleave"):
            pool = captures if current is None else [current]
            current = (
                splice(pool) if name == "splice" else interleave(pool)
            )
        elif name == "scale":
            if current is None:
                current = splice(captures)
            current = scale_pods(current, int(arg or "2"))
        elif name == "stretch":
            if current is None:
                current = splice(captures)
            current = stretch(current, float(arg or "1"))
        elif name == "repeat":
            if current is None:
                current = splice(captures)
            current = repeat(current, int(arg or "2"))
        else:
            raise ValueError(f"unknown compose op {op!r}")
    if current is None:
        current = splice(captures)
    return current


def _emit(result: dict, json_path: Optional[str]) -> None:
    if json_path:
        with open(json_path, "w") as handle:
            json.dump(result, handle, indent=2, default=str)
        print(f"whatif: full result written to {json_path}")
    print(json.dumps(_summarize(result), indent=2, default=str))


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m llm_d_kv_cache_manager_tpu_torch.obs.whatif",
        description="Replay-driven what-if engine: time-compressed "
        "replay, A/B config canarying, synthetic capture composition "
        "(docs/observability.md)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    def add_common(p) -> None:
        p.add_argument(
            "capture",
            help="capture artifact path OR incident bundle directory",
        )
        p.add_argument(
            "--speed",
            type=float,
            default=None,
            help="time-compression multiplier (default WHATIF_SPEED)",
        )
        p.add_argument(
            "--strict-fingerprint",
            action="store_true",
            help="refuse mismatched captures (default: measure anyway)",
        )
        p.add_argument(
            "--json", default=None, help="write the full result here"
        )

    p_run = sub.add_parser(
        "run", help="time-compressed replay through one candidate arm"
    )
    add_common(p_run)
    p_run.add_argument(
        "--arm",
        default="",
        help="arm spec, e.g. shards=8,mode=cluster,drain_rate=500",
    )

    p_ab = sub.add_parser(
        "ab", help="same capture through two arms; structured delta"
    )
    add_common(p_ab)
    p_ab.add_argument("--a", default="shards=1", help="arm A spec")
    p_ab.add_argument("--b", default="shards=8", help="arm B spec")

    p_comp = sub.add_parser(
        "compose",
        help="splice/scale/interleave/stretch captures into a new "
        "artifact",
    )
    p_comp.add_argument("output", help="output artifact path")
    p_comp.add_argument(
        "inputs", nargs="+", help="input captures / bundle dirs"
    )
    p_comp.add_argument(
        "--op",
        action="append",
        default=[],
        help="operator, repeatable: splice | interleave | scale:<n> | "
        "stretch:<f> | repeat:<n> (applied left to right)",
    )
    p_comp.add_argument(
        "--strict-fingerprint",
        action="store_true",
        help="refuse mismatched captures",
    )

    args = parser.parse_args(argv)
    config = WhatIfConfig.from_env()
    if getattr(args, "speed", None):
        config.speed = args.speed

    if args.command == "run":
        capture = _load(args.capture, not args.strict_fingerprint)
        arm = StackConfig.parse(args.arm, name="a")
        result = run_whatif(capture, arm, config)
        _emit(result, args.json)
        return 0
    if args.command == "ab":
        capture = _load(args.capture, not args.strict_fingerprint)
        result = run_ab(
            capture,
            StackConfig.parse(args.a, name="a"),
            StackConfig.parse(args.b, name="b"),
            config,
        )
        _emit(result, args.json)
        return 0
    # compose
    captures = [
        _load(path, not args.strict_fingerprint) for path in args.inputs
    ]
    composed = _apply_ops(captures, args.op or ["splice"])
    payload = capture_to_bytes(composed)
    with open(args.output, "wb") as handle:
        handle.write(payload)
    print(
        json.dumps(
            {
                "output": args.output,
                "bytes": len(payload),
                "records": len(composed["records"]),
                "meta": composed["meta"],
            },
            indent=2,
        )
    )
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI entry
    sys.exit(main())
