"""Prometheus metrics for the indexer stack.

Capability parity with pkg/kvcache/metrics/collector.go: index
admissions/evictions/lookup counters, lookup-latency histogram, per-lookup
max-pod-hit counter, tokenization latency/token counters labeled by backend,
and a periodic "metrics beat" logger.  Exposed through a dedicated registry
so embedding applications can mount ``/metrics`` wherever they like.

Copied from the JAX reference's ``metrics/collector.py`` (every series of
``KVCacheMetrics`` under the same name, labels and buckets), but without
``prometheus_client``: the port keeps its own small registry below
(``Counter``, ``Gauge``, ``Histogram``, ``CollectorRegistry`` and
``generate_latest`` in the Prometheus text format, version 0.0.4).  For the
same observations its exposition parses to the same samples as the
reference's, ``_created`` samples aside (the port emits none).
"""

from __future__ import annotations

import gc
import math
import os
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("metrics")

_NAMESPACE = "kvtpu"

_INF = float("inf")


def _go_float(value: float) -> str:
    """A float as Prometheus (and Go) print it: ``+Inf``, ``-Inf``,
    ``NaN``, else Python's repr, switching to an exponent past six
    integer digits (so bucket ``le`` labels read as the reference's)."""
    value = float(value)
    if value == _INF:
        return "+Inf"
    if value == -_INF:
        return "-Inf"
    if math.isnan(value):
        return "NaN"
    text = repr(value)
    dot = text.find(".")
    if value > 0 and dot > 6:
        mantissa = f"{text[0]}.{text[1:dot]}{text[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return text


def _escape_label(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')
    )


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


class Sample(NamedTuple):
    name: str
    labels: Dict[str, str]
    value: float


class MetricFamily(NamedTuple):
    name: str
    documentation: str
    type: str
    samples: List[Sample]


class CollectorRegistry:
    """The metrics of one exposition, in registration order."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: List["_Metric"] = []
        self._names: set = set()

    def register(self, metric: "_Metric") -> None:
        with self._lock:
            if metric.name in self._names:
                raise ValueError(f"duplicated metric name: {metric.name}")
            self._names.add(metric.name)
            self._metrics.append(metric)

    def collect(self) -> List[MetricFamily]:
        with self._lock:
            metrics = list(self._metrics)
        return [family for metric in metrics for family in metric.collect()]


def generate_latest(registry: CollectorRegistry) -> bytes:
    """The registry in the Prometheus text format (version 0.0.4)."""
    lines: List[str] = []
    for family in registry.collect():
        lines.append(
            f"# HELP {family.name} {_escape_help(family.documentation)}"
        )
        lines.append(f"# TYPE {family.name} {family.type}")
        for sample in family.samples:
            labels = ""
            if sample.labels:
                labels = "{" + ",".join(
                    f'{key}="{_escape_label(value)}"'
                    for key, value in sample.labels.items()
                ) + "}"
            lines.append(f"{sample.name}{labels} {_go_float(sample.value)}")
    return ("\n".join(lines) + "\n").encode("utf-8") if lines else b""


class _Value:
    """One series' state: a float under a lock."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0


class _Metric:
    """A metric with zero or more label names.  Unlabeled, it is its own
    single series; labeled, ``labels(...)`` returns (and creates on first
    use) the child series of one label set, and only children that exist
    are exposed."""

    _type = ""

    def __init__(
        self,
        name: str,
        documentation: str,
        labelnames: Sequence[str] = (),
        registry: Optional[CollectorRegistry] = None,
        _labelvalues: Optional[Tuple[str, ...]] = None,
    ) -> None:
        self.name = name
        self.documentation = documentation
        self._labelnames = tuple(labelnames)
        self._labelvalues = _labelvalues
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}
        self._children_lock = threading.Lock()
        if self._labelvalues is not None or not self._labelnames:
            self._init_series()
        if registry is not None:
            registry.register(self)

    def _init_series(self) -> None:
        raise NotImplementedError

    def _child_args(self) -> dict:
        return {}

    def labels(self, *values: str, **kwvalues: str) -> "_Metric":
        if not self._labelnames:
            raise ValueError(f"{self.name} has no labels")
        if values and kwvalues:
            raise ValueError("labels take positional or keyword values, not both")
        if kwvalues:
            if set(kwvalues) != set(self._labelnames):
                raise ValueError(f"{self.name} takes labels {self._labelnames}")
            values = tuple(kwvalues[name] for name in self._labelnames)
        if len(values) != len(self._labelnames):
            raise ValueError(f"{self.name} takes labels {self._labelnames}")
        key = tuple(str(value) for value in values)
        child = self._children.get(key)
        if child is None:
            with self._children_lock:
                child = self._children.get(key)
                if child is None:
                    child = type(self)(
                        self.name,
                        self.documentation,
                        self._labelnames,
                        _labelvalues=key,
                        **self._child_args(),
                    )
                    self._children[key] = child
        return child

    def remove(self, *values: str) -> None:
        """Drop one label set's series (a no-op when it does not exist),
        as ``prometheus_client``'s ``remove``."""
        if not self._labelnames:
            raise ValueError(f"{self.name} has no labels")
        if len(values) != len(self._labelnames):
            raise ValueError(f"{self.name} takes labels {self._labelnames}")
        with self._children_lock:
            self._children.pop(tuple(str(value) for value in values), None)

    def _series(self) -> List["_Metric"]:
        if not self._labelnames:
            return [self]
        with self._children_lock:
            return list(self._children.values())

    def _label_dict(self) -> Dict[str, str]:
        return dict(zip(self._labelnames, self._labelvalues or ()))

    def _samples(self) -> Iterable[Sample]:
        raise NotImplementedError

    def collect(self) -> List[MetricFamily]:
        samples = [s for series in self._series() for s in series._samples()]
        return [
            MetricFamily(self._family_name(), self.documentation, self._type, samples)
        ]

    def _family_name(self) -> str:
        return self.name


class Counter(_Metric):
    """A monotonic counter; exposed as ``<name>_total`` (a trailing
    ``_total`` in the given name is not doubled)."""

    _type = "counter"

    def __init__(self, name: str, *args, **kwargs) -> None:
        if name.endswith("_total"):
            name = name[: -len("_total")]
        super().__init__(name, *args, **kwargs)

    def _init_series(self) -> None:
        self._value = _Value()

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError("counters can only be incremented by non-negative amounts")
        value = self._value
        with value._lock:
            value.value += amount

    def _samples(self) -> Iterable[Sample]:
        yield Sample(f"{self.name}_total", self._label_dict(), self._value.value)

    def _family_name(self) -> str:
        # Headed by the sample name, as prometheus_client writes the text
        # format, so both expositions parse to the same families.
        return f"{self.name}_total"


class Gauge(_Metric):
    """A value that goes up and down."""

    _type = "gauge"

    def _init_series(self) -> None:
        self._value = _Value()

    def inc(self, amount: float = 1) -> None:
        value = self._value
        with value._lock:
            value.value += amount

    def dec(self, amount: float = 1) -> None:
        self.inc(-amount)

    def set(self, amount: float) -> None:
        value = self._value
        with value._lock:
            value.value = float(amount)

    def _samples(self) -> Iterable[Sample]:
        yield Sample(self.name, self._label_dict(), self._value.value)


class Histogram(_Metric):
    """Observations counted into cumulative ``le`` buckets (``+Inf``
    appended when missing), with their count and sum."""

    _type = "histogram"

    def __init__(
        self,
        name: str,
        documentation: str,
        labelnames: Sequence[str] = (),
        registry: Optional[CollectorRegistry] = None,
        *,
        buckets: Sequence[float],
        _labelvalues: Optional[Tuple[str, ...]] = None,
    ) -> None:
        bounds = [float(b) for b in buckets]
        if bounds != sorted(bounds):
            raise ValueError("buckets not in sorted order")
        if not bounds or bounds[-1] != _INF:
            bounds.append(_INF)
        self._bounds = tuple(bounds)
        super().__init__(name, documentation, labelnames, registry, _labelvalues=_labelvalues)

    def _child_args(self) -> dict:
        return {"buckets": self._bounds}

    def _init_series(self) -> None:
        self._lock = threading.Lock()
        with self._lock:
            self._counts = [0.0] * len(self._bounds)
            self._sum = 0.0

    def observe(self, amount: float) -> None:
        bounds = self._bounds
        with self._lock:
            self._sum += amount
            for i, bound in enumerate(bounds):
                if amount <= bound:
                    self._counts[i] += 1
                    break

    def _samples(self) -> Iterable[Sample]:
        labels = self._label_dict()
        with self._lock:
            counts = list(self._counts)
            total = self._sum
        cumulative = 0.0
        for bound, count in zip(self._bounds, counts):
            cumulative += count
            yield Sample(
                f"{self.name}_bucket", dict(labels, le=_go_float(bound)), cumulative
            )
        yield Sample(f"{self.name}_count", labels, cumulative)
        yield Sample(f"{self.name}_sum", labels, total)



class KVCacheMetrics:
    def __init__(self, registry: Optional[CollectorRegistry] = None) -> None:
        self.registry = registry or CollectorRegistry()
        self.index_admissions = Counter(
            f"{_NAMESPACE}_kvcache_index_admissions_total",
            "Number of KV-block keys admitted into the index.",
            registry=self.registry,
        )
        self.index_evictions = Counter(
            f"{_NAMESPACE}_kvcache_index_evictions_total",
            "Number of KV-block eviction operations applied to the index.",
            registry=self.registry,
        )
        self.index_lookup_requests = Counter(
            f"{_NAMESPACE}_kvcache_index_lookup_requests_total",
            "Number of index lookups served.",
            registry=self.registry,
        )
        self.index_lookup_hits = Counter(
            f"{_NAMESPACE}_kvcache_index_lookup_hits_total",
            "Number of index lookups that returned at least one pod.",
            registry=self.registry,
        )
        self.index_max_pod_hits = Counter(
            f"{_NAMESPACE}_kvcache_index_max_pod_hit_count_total",
            "Sum over lookups of the max per-pod hit count.",
            registry=self.registry,
        )
        self.index_lookup_latency = Histogram(
            f"{_NAMESPACE}_kvcache_index_lookup_latency_seconds",
            "Latency of index lookups.",
            registry=self.registry,
            buckets=(
                0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
            ),
        )
        self.tokenization_latency = Histogram(
            f"{_NAMESPACE}_tokenization_latency_seconds",
            "Latency of tokenization calls by backend.",
            ("tokenizer",),
            registry=self.registry,
            # Sub-millisecond resolution: the prefix-store fast path and
            # local fast tokenizers finish far below the Prometheus
            # default 5ms first bucket (same style as
            # index_lookup_latency above).
            buckets=(
                0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
            ),
        )
        self.tokenization_tokens = Counter(
            f"{_NAMESPACE}_tokenization_tokens_total",
            "Tokens produced by tokenization calls by backend.",
            ("tokenizer",),
            registry=self.registry,
        )
        self.tokenization_prefix_fast_path = Counter(
            f"{_NAMESPACE}_tokenization_prefix_fast_path_total",
            "Tokenizations served from the prefix store (coverage >= "
            "min_prefix_overlap_ratio) instead of a full tokenizer run.",
            registry=self.registry,
        )
        self.kvevents_dropped = Counter(
            f"{_NAMESPACE}_kvevents_dropped_total",
            "KV-event messages dropped by the ingestion pool by reason.",
            ("reason",),
            registry=self.registry,
        )
        self.kvevents_batch_size = Histogram(
            f"{_NAMESPACE}_kvevents_batch_size",
            "Messages drained per kvevents worker wake-up (the batched "
            "apply path; 1 = no batching headroom, the queue never "
            "backed up).",
            registry=self.registry,
            buckets=(1, 2, 4, 8, 16, 32, 64, 128),
        )
        self.kvevents_seq_gaps = Counter(
            f"{_NAMESPACE}_kvevents_seq_gaps_total",
            "Events lost to publisher sequence-number gaps, by pod.",
            ("pod",),
            registry=self.registry,
        )
        self.kvevents_publisher_restarts = Counter(
            f"{_NAMESPACE}_kvevents_publisher_restarts_total",
            "Publisher restarts detected as per-topic sequence-number "
            "regressions (counter reset); distinguished from gaps so an "
            "engine restart does not inflate the loss signal.",
            ("pod",),
            registry=self.registry,
        )
        self.kvevents_pod_shed = Counter(
            f"{_NAMESPACE}_kvevents_pod_shed_total",
            "Event messages shed by per-pod flow control, by the pod "
            "whose message was dropped (docs/event-plane.md).",
            ("pod",),
            registry=self.registry,
        )
        self.kvevents_pod_backlog = Gauge(
            f"{_NAMESPACE}_kvevents_pod_backlog",
            "Queued (not yet applied) event messages per pod in the "
            "ingestion pool's shard lanes.",
            ("pod",),
            registry=self.registry,
        )
        self.kvevents_poller_sockets = Gauge(
            f"{_NAMESPACE}_kvevents_poller_sockets",
            "SUB sockets currently multiplexed by each consolidated "
            "event-plane poller thread.",
            ("poller",),
            registry=self.registry,
        )
        self.kvevents_suspect_pods = Gauge(
            f"{_NAMESPACE}_kvevents_suspect_pods",
            "Pods whose index entries are suspect (sequence gap "
            "detected, resync not yet completed).",
            registry=self.registry,
        )
        self.kvevents_resyncs = Counter(
            f"{_NAMESPACE}_kvevents_resyncs_total",
            "Anti-entropy pod resyncs by outcome.",
            ("outcome",),
            registry=self.registry,
        )
        self.kvevents_resync_staleness = Histogram(
            f"{_NAMESPACE}_kvevents_resync_staleness_seconds",
            "Index-staleness window per resynced pod: first detected "
            "gap to repair (purge + inventory re-apply) completed.",
            registry=self.registry,
            buckets=(
                0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                10.0, 30.0, 60.0,
            ),
        )
        self.persistence_journal_records = Counter(
            f"{_NAMESPACE}_persistence_journal_records_total",
            "Index operations appended to the persistence journal by op.",
            ("op",),
            registry=self.registry,
        )
        self.persistence_journal_lag = Gauge(
            f"{_NAMESPACE}_persistence_journal_records_since_snapshot",
            "Journal records appended since the last published snapshot "
            "(replay cost of a crash right now).",
            registry=self.registry,
        )
        self.persistence_snapshot_timestamp = Gauge(
            f"{_NAMESPACE}_persistence_snapshot_created_timestamp_seconds",
            "Unix time of the last published index snapshot.",
            registry=self.registry,
        )
        self.persistence_snapshot_bytes = Gauge(
            f"{_NAMESPACE}_persistence_snapshot_bytes",
            "Size of the last published index snapshot.",
            registry=self.registry,
        )
        self.persistence_replayed_records = Counter(
            f"{_NAMESPACE}_persistence_replayed_records_total",
            "Journal records replayed into the index during recovery.",
            registry=self.registry,
        )
        self.persistence_recoveries = Counter(
            f"{_NAMESPACE}_persistence_recoveries_total",
            "Startup recoveries by outcome (warm: state restored; cold: "
            "nothing on disk).",
            ("outcome",),
            registry=self.registry,
        )
        self.offload_bytes = Counter(
            f"{_NAMESPACE}_offload_bytes_total",
            "Bytes moved by the offload engine by direction.",
            ("direction",),
            registry=self.registry,
        )
        self.offload_jobs = Counter(
            f"{_NAMESPACE}_offload_jobs_total",
            "Offload jobs completed by direction and status.",
            ("direction", "status"),
            registry=self.registry,
        )
        self.offload_staging_lane_waits = Counter(
            f"{_NAMESPACE}_offload_staging_lane_waits_total",
            "Staged transfers that had to wait for a free per-chip "
            "staging lane (lane-saturation backpressure; climbing "
            "value = raise OFFLOAD_STAGING_LANES or the engine is "
            "wedged).",
            registry=self.registry,
        )
        # Cache-efficiency analytics (analytics/ledger.py): per-request
        # hit attribution on the scoring read path.  At
        # CACHESTATS_SAMPLE_RATE < 1 these are an unbiased sample of
        # the request mix, not a total count (same caveat as
        # stage_latency below).
        self.cachestats_requests = Counter(
            f"{_NAMESPACE}_cachestats_requests_total",
            "Scored requests recorded by the hit-attribution ledger, by "
            "outcome (hit: best pod covered >= hit_ratio of the prompt's "
            "block chain; partial: anything matched; miss: nothing).",
            ("outcome",),
            registry=self.registry,
        )
        self.cachestats_tier_hits = Counter(
            f"{_NAMESPACE}_cachestats_tier_hits_total",
            "Scored blocks attributed to each memory tier (the best "
            "resident tier per consecutive matched block).",
            ("tier",),
            registry=self.registry,
        )
        self.cachestats_reuse_distance = Histogram(
            f"{_NAMESPACE}_cachestats_reuse_distance",
            "Distinct scored requests between re-encounters of a prefix "
            "family (working-set reuse distance).",
            registry=self.registry,
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096,
                     16384),
        )
        self.cachestats_families = Gauge(
            f"{_NAMESPACE}_cachestats_families",
            "Prefix families currently tracked, summed across ledger "
            "instances (each LRU-bounded by CACHESTATS_MAX_FAMILIES); "
            "maintained by deltas so several ledgers aggregate.",
            registry=self.registry,
        )
        # Index-truth audit plane (analytics/auditor.py).
        self.index_divergence_ratio = Gauge(
            f"{_NAMESPACE}_index_divergence_ratio",
            "Per-pod index-vs-inventory divergence from the last audit: "
            "(phantom + missing + wrong-tier blocks) / union size.",
            ("pod",),
            registry=self.registry,
        )
        self.index_audits = Counter(
            f"{_NAMESPACE}_index_audits_total",
            "Pod audits by outcome (clean / divergent / failed).",
            ("outcome",),
            registry=self.registry,
        )
        self.index_audit_blocks = Counter(
            f"{_NAMESPACE}_index_audit_blocks_total",
            "Divergent blocks found by audits, by kind (phantom / "
            "missing / wrong_tier).",
            ("kind",),
            registry=self.registry,
        )
        # Predictive tiering (tiering/; docs/tiering.md).
        self.tiering_demotions = Counter(
            f"{_NAMESPACE}_tiering_demotions_total",
            "Proactive block-group demotions by transition "
            "(hbm_to_host / host_to_storage).",
            ("transition",),
            registry=self.registry,
        )
        self.tiering_demotion_bytes = Counter(
            f"{_NAMESPACE}_tiering_demotion_bytes_total",
            "Bytes moved down the memory ladder by proactive demotion, "
            "by transition.",
            ("transition",),
            registry=self.registry,
        )
        self.tiering_advice = Counter(
            f"{_NAMESPACE}_tiering_advice_total",
            "Compute-or-load advisor decisions by action "
            "(load / recompute / hybrid).",
            ("action",),
            registry=self.registry,
        )
        self.tiering_evictions = Counter(
            f"{_NAMESPACE}_tiering_policy_evictions_total",
            "Eviction victims chosen by the predictive policy, by "
            "backend and mode (predicted: a reuse prediction ranked the "
            "sample; fallback_lru: no prediction known, LRU-proxy order).",
            ("backend", "mode"),
            registry=self.registry,
        )
        self.tiering_readback_rtt = Gauge(
            f"{_NAMESPACE}_tiering_readback_rtt_seconds",
            "EWMA of observed offload load-job latency (submit to "
            "harvest) feeding the compute-or-load advisor.",
            registry=self.registry,
        )
        self.tiering_writeback_rtt = Gauge(
            f"{_NAMESPACE}_tiering_writeback_rtt_seconds",
            "EWMA of observed offload store-job latency (submit to "
            "harvest) feeding the advisor's write-side cost model.",
            registry=self.registry,
        )
        self.tiering_snapshot_age = Gauge(
            f"{_NAMESPACE}_tiering_snapshot_age_seconds",
            "Age of the policy feed's current prediction snapshot.",
            registry=self.registry,
        )
        # KV-transfer planning plane (transfer/; docs/transfer.md).
        self.transfer_plans = Counter(
            f"{_NAMESPACE}_transfer_plans_total",
            "Transfer-planner decisions by outcome (planned / warmup / "
            "holder-not-overloaded / no-holder / no-target / "
            "too-few-blocks / no-block-bytes / no-rtt-observations / "
            "recompute-cheaper / pod-invalidated / expired).",
            ("outcome",),
            registry=self.registry,
        )
        self.transfer_executions = Counter(
            f"{_NAMESPACE}_transfer_executions_total",
            "Executed transfer plans by outcome (copied / moved / "
            "partial-copied / partial-moved / invalidated / stale).",
            ("outcome",),
            registry=self.registry,
        )
        self.transfer_bytes = Counter(
            f"{_NAMESPACE}_transfer_bytes_total",
            "Bytes moved pod-to-pod by executed transfer plans.",
            registry=self.registry,
        )
        self.transfer_warmup_moves = Counter(
            f"{_NAMESPACE}_transfer_warmup_moves_total",
            "Hot-family pre-placements executed by the warm-up worker.",
            registry=self.registry,
        )
        self.transfer_cold_pods = Gauge(
            f"{_NAMESPACE}_transfer_cold_pods",
            "Pods registered cold with warm-up transfers still pending.",
            registry=self.registry,
        )
        # Replicated index service (cluster/; docs/replication.md).
        self.cluster_ring_version = Gauge(
            f"{_NAMESPACE}_cluster_ring_version",
            "Version of the router's consistent-hash ring (bumps on "
            "every membership change).",
            registry=self.registry,
        )
        self.cluster_replicas_alive = Gauge(
            f"{_NAMESPACE}_cluster_replicas_alive",
            "Replicas currently considered alive by the router's "
            "membership (heartbeat-healthy).",
            registry=self.registry,
        )
        self.cluster_failovers = Counter(
            f"{_NAMESPACE}_cluster_failovers_total",
            "Replicas removed from the ring (heartbeat timeout or "
            "observed transport failure); each removal re-routes the "
            "replica's slice to its rendezvous runner-up.",
            registry=self.registry,
        )
        self.cluster_rpc_latency = Histogram(
            f"{_NAMESPACE}_cluster_rpc_latency_seconds",
            "Latency of router->replica RPCs by replica method (the "
            "fan-out attribution view; per-replica panels live in "
            "/debug/cluster).",
            ("method",),
            registry=self.registry,
            buckets=(
                0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
            ),
        )
        self.cluster_rpc_errors = Counter(
            f"{_NAMESPACE}_cluster_rpc_errors_total",
            "Router->replica RPC transport failures by replica and "
            "failure kind (timeout / refused / wire_decode / "
            "http_status / killed / io); each marks the replica dead "
            "and retries on the failover owner.",
            ("replica", "kind"),
            registry=self.registry,
        )
        self.cluster_replica_lag = Gauge(
            f"{_NAMESPACE}_cluster_replica_lag_records",
            "Journal records a replication follower was behind its "
            "primary when its last sync poll began, by followed peer.",
            ("peer",),
            registry=self.registry,
        )
        self.cluster_replication_applied = Counter(
            f"{_NAMESPACE}_cluster_replication_applied_total",
            "Journal records applied by replication followers, by "
            "followed peer.",
            ("peer",),
            registry=self.registry,
        )
        # Read-path SLO feed: end-to-end scored-request latency at the
        # service boundary (api/http_service.py), unsampled — unlike
        # stage_latency below this sees EVERY request, so the SLO
        # engine's latency SLI (obs/slo.py) windows an unbiased stream.
        self.score_latency = Histogram(
            f"{_NAMESPACE}_score_latency_seconds",
            "End-to-end latency of scored requests at the HTTP service "
            "boundary (every request — errors included, not just "
            "sampled traces).",
            registry=self.registry,
            buckets=(
                0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5,
            ),
        )
        self.score_requests = Counter(
            f"{_NAMESPACE}_score_requests_total",
            "Scored requests at the HTTP service boundary by outcome "
            "(ok / error) — the availability SLI's feed: a fully "
            "failing service must read as violated, not as a no-data "
            "latency SLI.",
            ("outcome",),
            registry=self.registry,
        )
        # Score memo visibility (kvcache/indexer.py): 1 when the
        # exact-prompt memo was requested but self-disabled because the
        # backend lacks version_vector/touch_chain.  The in-memory
        # backend AND the cluster RemoteIndex (version-vectored since
        # the pipelined read path; docs/replication.md) both support
        # the memo, so a 1 here means a custom backend without the
        # optimistic-validation surface.
        self.score_memo_disabled = Gauge(
            f"{_NAMESPACE}_score_memo_disabled",
            "1 when the request score memo is configured but disabled "
            "by an index backend lacking version_vector/touch_chain, "
            "else 0 (the in-memory backend and the cluster RemoteIndex "
            "both support it).",
            registry=self.registry,
        )
        # SLO engine (obs/slo.py; docs/observability.md).
        self.slo_state = Gauge(
            f"{_NAMESPACE}_slo_state",
            "Degradation-envelope state per SLI (0 healthy / 1 "
            "degraded / 2 violated); sli=\"overall\" is the worst.",
            ("sli",),
            registry=self.registry,
        )
        self.slo_burn_rate = Gauge(
            f"{_NAMESPACE}_slo_burn_rate",
            "Error-budget burn rate per SLI and evaluation window "
            "(1.0 = burning exactly the objective's budget).",
            ("sli", "window"),
            registry=self.registry,
        )
        # Lock-contention telemetry (utils/lockorder.py timing mode;
        # docs/observability.md "Lock contention").  Only contended
        # sampled acquires land here — with LOCK_CONTENTION_SAMPLE
        # unset/0 both families stay empty.
        self.lock_wait = Histogram(
            f"{_NAMESPACE}_lock_wait_seconds",
            "Wait time of contended sampled acquires per tracked lock "
            "name (LOCK_CONTENTION_SAMPLE gates the probe rate).",
            ("lock",),
            registry=self.registry,
            buckets=(
                0.000005, 0.00001, 0.000025, 0.00005, 0.0001, 0.00025,
                0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 1.0,
            ),
        )
        self.lock_contention = Counter(
            f"{_NAMESPACE}_lock_contention_total",
            "Contended sampled acquires per tracked lock name (the "
            "non-blocking probe failed; the acquire had to wait).",
            ("lock",),
            registry=self.registry,
        )
        # Process runtime gauges (refreshed by update_process_metrics:
        # the metrics beat and the gauge timeline both call it).
        self.process_rss = Gauge(
            f"{_NAMESPACE}_process_rss_bytes",
            "Resident set size of this process (/proc/self/statm).",
            registry=self.registry,
        )
        self.process_open_fds = Gauge(
            f"{_NAMESPACE}_process_open_fds",
            "Open file descriptors of this process (/proc/self/fd).",
            registry=self.registry,
        )
        self.process_threads = Gauge(
            f"{_NAMESPACE}_process_threads",
            "Live Python threads (threading.active_count()).",
            registry=self.registry,
        )
        self.gc_collections = Counter(
            f"{_NAMESPACE}_gc_collections_total",
            "Garbage-collection passes by generation (gc callbacks; "
            "install_gc_metrics()).",
            ("gen",),
            registry=self.registry,
        )
        self.gc_pause = Histogram(
            f"{_NAMESPACE}_gc_pause_seconds",
            "Wall time of each garbage-collection pass (the collecting "
            "thread is stalled for the duration; every other thread "
            "contends for the GIL against it).",
            registry=self.registry,
            buckets=(
                0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 1.0,
            ),
        )
        # The port's device work built in this process; the reference has
        # no such family, so docs/observability.md's inventory leaves it
        # out and obs/DEVICE_TRACE.md documents both.
        self.kernel_builds = Counter(  # kvlint: disable=KV007
            f"{_NAMESPACE}_kernel_builds_total",
            "Device work built in this process, by what: library (a "
            "CUDA kernel's load, after its nvcc build where no built "
            "file is found), plan (a bf16 attention "
            "work list built and uploaded on a cache miss), graph (a "
            "decode step's eager run and CUDA graph capture).",
            ("what",),
            registry=self.registry,
        )
        self.kernel_build_seconds = Histogram(  # kvlint: disable=KV007
            f"{_NAMESPACE}_kernel_build_seconds",
            "Host wall time of each build counted in "
            "kvtpu_kernel_builds_total, by what.",
            ("what",),
            registry=self.registry,
            buckets=(
                0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 1.0, 10.0, 100.0,
            ),
        )
        # Incident capture plane (obs/capture.py; docs/observability.md
        # "Incident capture & replay").
        self.build_info = Gauge(
            f"{_NAMESPACE}_build_info",
            "Always 1; labels carry the package version and the "
            "config fingerprint (hash of the resolved score-relevant "
            "env knobs) stamped into every capture header and "
            "incident bundle — replays refuse mismatched artifacts.",
            ("version", "fingerprint"),
            registry=self.registry,
        )
        self.capture_ring_bytes = Gauge(
            f"{_NAMESPACE}_capture_ring_bytes",
            "Estimated bytes retained by the input flight recorder "
            "per ingress source (kvevents / scores); bounded by "
            "CAPTURE_MAX_BYTES.",
            ("source",),
            registry=self.registry,
        )
        self.capture_records = Counter(
            f"{_NAMESPACE}_capture_records_total",
            "Ingress records appended to the input flight recorder "
            "per source (refreshed in batches off the hot path).",
            ("source",),
            registry=self.registry,
        )
        self.incident_bundles = Counter(
            f"{_NAMESPACE}_incident_bundles_total",
            "Incident bundles written by outcome (ok / failed); "
            "SLO-triggered and /admin/incident both count.",
            ("outcome",),
            registry=self.registry,
        )
        # What-if engine (obs/whatif.py; docs/observability.md
        # "What-if engine").
        self.whatif_runs = Counter(
            f"{_NAMESPACE}_whatif_runs_total",
            "What-if replays completed, by kind (run / ab) and "
            "outcome; CLI, /admin/whatif, and perf-trend gate runs "
            "all count.",
            ("kind", "outcome"),
            registry=self.registry,
        )
        self.whatif_events = Counter(
            f"{_NAMESPACE}_whatif_events_total",
            "Recorded kvevents offered to what-if candidate stacks, "
            "by the candidate's flow-control disposition (admitted / "
            "shed).",
            ("disposition",),
            registry=self.registry,
        )
        self.whatif_hit_rate = Gauge(
            f"{_NAMESPACE}_whatif_hit_rate",
            "Hit rate measured by the most recent what-if replay, per "
            "arm name (fraction of replayed scores with a non-zero "
            "best score).",
            ("arm",),
            registry=self.registry,
        )
        # Per-stage latencies fed by the tracing subsystem (obs/trace.py):
        # every span of a sampled trace lands here under its span name, so
        # the aggregate view and the per-request flight-recorder view
        # share one stage vocabulary ("tokenize", "index_lookup",
        # "kvevents.apply", "offload.io", ...).  Only sampled requests
        # contribute — at low TRACE_SAMPLE_RATE this is an unbiased
        # sample of the stage mix, not a total count.
        self.stage_latency = Histogram(
            f"{_NAMESPACE}_stage_latency_seconds",
            "Per-stage latency of traced requests, by pipeline stage.",
            ("stage",),
            registry=self.registry,
            buckets=(
                0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
            ),
        )

    def exposition(self) -> bytes:
        return generate_latest(self.registry)


# Process-wide default instance; modules import this rather than plumbing a
# registry through every constructor.
METRICS = KVCacheMetrics()

# Label values longer than this are truncated (with a marker) before
# reaching the registry: label values are unbounded wire input in the
# pod-labeled families, and a single hostile topic string must not blow
# up every scrape.
MAX_LABEL_LEN = 120


def safe_label(value: str) -> str:
    """Bound and sanitize a wire-sourced label value.

    The exposition format itself escapes ``\\``, ``\"`` and newlines
    (prometheus_client does this on output; pinned by
    tests/test_metrics_endpoint.py) — this helper handles what escaping
    cannot: unbounded length and non-printable control characters in
    values that arrive from the network (pod identifiers parsed out of
    ZMQ topics).  Printable text passes through unchanged, so normal
    pod names keep their exact label identity.
    """
    text = str(value)
    if any(ch < " " or ch == "\x7f" for ch in text):
        text = "".join(
            ch if ch >= " " and ch != "\x7f" else "�" for ch in text
        )
    if len(text) > MAX_LABEL_LEN:
        text = text[: MAX_LABEL_LEN - 1] + "…"
    return text


def counter_total(counter: Counter) -> float:
    """Sum of a counter's ``_total`` samples across all label sets.

    ``collect()[0].samples[0]`` only works for unlabeled counters — a
    labeled counter's first sample is whichever label set was created
    first (and with no children yet there are NO samples at all).
    Summing by the ``_total`` suffix handles unlabeled, labeled, and
    empty counters alike and skips ``_created`` gauge samples.
    """
    total = 0.0
    for metric in counter.collect():
        for sample in metric.samples:
            if sample.name.endswith("_total"):
                total += sample.value
    return total


def gauge_value(gauge: Gauge) -> float:
    """Current value of an unlabeled gauge (0.0 when never set)."""
    for metric in gauge.collect():
        for sample in metric.samples:
            return sample.value
    return 0.0


def gauge_total(gauge: Gauge) -> float:
    """Sum of a labeled gauge's samples across all label sets (e.g.
    total event backlog over the per-pod ``kvevents_pod_backlog``
    series); 0.0 with no children yet."""
    total = 0.0
    for metric in gauge.collect():
        for sample in metric.samples:
            total += sample.value
    return total


def count_build(what: str, seconds: float) -> None:
    """One build of device work (``library``, ``plan`` or ``graph``)
    that took ``seconds`` of host wall time."""
    METRICS.kernel_builds.labels(what=what).inc()
    METRICS.kernel_build_seconds.labels(what=what).observe(seconds)


# ------------------------ process runtime metrics ------------------------

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def update_process_metrics() -> dict:
    """Refresh the process runtime gauges and return their values.

    Called by the metrics beat and by the gauge timeline's sampler
    (obs/timeline.py) — cheap by construction: two /proc reads and a
    thread count, no allocation-heavy walks.  Platforms without /proc
    (macOS dev boxes) report what they can and leave the rest at 0.
    """
    out = {"rss_bytes": 0.0, "open_fds": 0.0, "threads": 0.0}
    try:
        with open("/proc/self/statm", "rb") as statm:
            out["rss_bytes"] = float(
                int(statm.read().split()[1]) * _PAGE_SIZE
            )
    except (OSError, ValueError, IndexError):
        pass  # kvlint: disable=KV005 — no /proc: gauge stays 0
    try:
        out["open_fds"] = float(len(os.listdir("/proc/self/fd")))
    except OSError:
        pass  # kvlint: disable=KV005 — no /proc: gauge stays 0
    out["threads"] = float(threading.active_count())
    METRICS.process_rss.set(out["rss_bytes"])
    METRICS.process_open_fds.set(out["open_fds"])
    METRICS.process_threads.set(out["threads"])
    return out


# gc callbacks run on whichever thread triggered the collection, and
# CPython serializes collections — a per-generation start stamp keyed
# by generation is race-free without a lock.
_gc_starts: dict = {}
_gc_installed = False
_gc_children: dict = {}
# A pass's ``kvtpu.gc`` range on a recording torch profiler's timeline,
# open from "start" to "stop" on the collecting thread;
# ``obs.trace.profiler_range``, bound by install_gc_metrics (obs.trace
# imports this module).
_gc_ranges: dict = {}
_gc_range = None


def _gc_callback(phase: str, info: dict) -> None:
    gen = info.get("generation", 0)
    if phase == "start":
        opened = _gc_range("gc")
        opened.__enter__()
        _gc_ranges[gen] = opened
        _gc_starts[gen] = time.perf_counter()
        return
    opened = _gc_ranges.pop(gen, None)
    if opened is not None:
        opened.__exit__(None, None, None)
    start = _gc_starts.pop(gen, None)
    child = _gc_children.get(gen)
    if child is None:
        child = METRICS.gc_collections.labels(gen=str(gen))
        _gc_children[gen] = child
    child.inc()
    if start is not None:
        METRICS.gc_pause.observe(time.perf_counter() - start)


def install_gc_metrics() -> bool:
    """Hook ``gc.callbacks`` so every collection pass lands in
    ``kvtpu_gc_collections_total{gen}`` / ``kvtpu_gc_pause_seconds``,
    and on a recording torch profiler's timeline as a ``kvtpu.gc``
    range.  Idempotent; returns True when (already) installed."""
    global _gc_installed, _gc_range
    if _gc_installed:
        return True
    from llm_d_kv_cache_manager_tpu_torch.obs.trace import profiler_range

    _gc_range = profiler_range
    gc.callbacks.append(_gc_callback)
    _gc_installed = True
    return True


def uninstall_gc_metrics() -> None:
    """Remove the gc hook (test isolation)."""
    global _gc_installed
    if _gc_installed:
        try:
            gc.callbacks.remove(_gc_callback)
        except ValueError:
            logger.warning("gc metrics callback already removed")
        _gc_installed = False


def start_metrics_logging(interval_seconds: float = 60.0) -> threading.Event:
    """Log a periodic one-line metrics beat; returns a stop event."""
    stop = threading.Event()

    def beat() -> None:
        while not stop.wait(interval_seconds):
            # dropped_events and journal_lag earn their place on the
            # line during incidents: a climbing drop count means event
            # shards are shedding (stale index), a climbing lag means a
            # crash right now replays that many journal records.  The
            # process block (rss/fds/threads/gc) is the leak telltale:
            # those climb for minutes before anything else degrades.
            proc = update_process_metrics()
            # capture_kb / incidents join the line for the same reason
            # dropped_events did: during an incident the flight
            # recorder's occupancy says whether the replay window is
            # still intact, and a climbing incident count says the SLO
            # engine is actively bundling (docs/observability.md).
            logger.info(
                "metrics beat: admissions=%d evictions=%d lookups=%d "
                "hits=%d dropped_events=%d journal_lag=%d rss_mb=%.1f "
                "fds=%d threads=%d gc=%d capture_kb=%.0f incidents=%d",
                counter_total(METRICS.index_admissions),
                counter_total(METRICS.index_evictions),
                counter_total(METRICS.index_lookup_requests),
                counter_total(METRICS.index_lookup_hits),
                counter_total(METRICS.kvevents_dropped),
                gauge_value(METRICS.persistence_journal_lag),
                proc["rss_bytes"] / 1e6,
                proc["open_fds"],
                proc["threads"],
                counter_total(METRICS.gc_collections),
                gauge_total(METRICS.capture_ring_bytes) / 1e3,
                counter_total(METRICS.incident_bundles),
            )

    thread = threading.Thread(target=beat, name="kvtpu-metrics-beat", daemon=True)
    thread.start()
    return stop
