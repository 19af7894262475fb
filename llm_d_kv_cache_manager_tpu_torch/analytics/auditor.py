"""Index-truth auditor: measured staleness instead of inferred.

The index is advisory — continuously rebuilt from engine events — so
its claims drift from pod reality whenever events are lost, reordered,
or late.  Gap-driven resync repairs *detected* gaps; this
auditor closes the remaining blind spot: divergence with **no gap on
the wire** (a pod that silently restarted, an inventory surface that
disagrees, an eviction burst the budget shed).  It periodically pulls a
pod's block inventory through the same pluggable
:class:`~llm_d_kv_cache_manager_tpu_torch.kvevents.resync.InventorySource`
the resync path uses and diffs it against the index's view of that
pod, emitting per-pod divergence as a first-class, alertable quantity:

* **phantom** — the index claims a block the pod no longer holds
  (stale hits mis-route traffic toward it);
* **missing** — the pod holds a block the index never learned
  (lost hit rate: traffic routes away from a warm pod);
* **wrong_tier** — both agree the block exists but disagree on the
  memory tier (scores shift by the tier-weight delta).

``divergence_ratio = (phantom + missing + wrong_tier) / |union|`` per
pod lands in ``kvtpu_index_divergence_ratio{pod=...}``; audit outcomes
count in ``kvtpu_index_audits_total{outcome=...}`` and divergent
blocks in ``kvtpu_index_audit_blocks_total{kind=...}``.  Every audit
also appends to a bounded in-memory **audit log** (the flight
recorder's retention style: a ring of recent audits plus a reservoir
of the divergent ones), surfaced via ``GET /debug/cachestats``.

Inventory blocks carry *engine* hashes + token ids, exactly like
``BlockStored`` events; the auditor recomputes request keys with the
indexer's own token processor (parents resolved inside the inventory
first, then through the dumped engine map), so per-engine hash schemes
cannot fake divergence.  The index view comes from ``dump_entries()``
— O(index size), same class of administrative operation as
``purge_pod``; the audit interval (env ``AUDIT_INTERVAL_S``) bounds
the amortized cost.  Durable backends whose ``dump_entries`` is a
documented no-op (Redis) surface no pods to audit, so cycles there are
empty rather than fake-clean.

Copied from the JAX reference's ``analytics/auditor.py``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Set, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    EMPTY_BLOCK_HASH,
    engine_hash_to_uint64,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.resync import (
    InventorySource,
    PodInventory,
)
from llm_d_kv_cache_manager_tpu_torch.metrics.collector import (
    METRICS,
    safe_label,
)
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("analytics.auditor")

DEFAULT_AUDIT_INTERVAL_S = 0.0  # disabled until explicitly enabled
DEFAULT_LOG_KEEP = 64
DEFAULT_DIVERGENT_KEEP = 32
DEFAULT_TIER = "hbm"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("invalid %s=%r; using %s", name, raw, default)
        return default


@dataclass
class AuditorConfig:
    # Seconds between audit cycles; <= 0 means the background worker
    # never runs (audits only via explicit run_cycle()/audit_pod()).
    interval_s: float = DEFAULT_AUDIT_INTERVAL_S
    # Pods audited per cycle (round-robin across cycles); 0 = all.
    pods_per_cycle: int = 0
    # Default tier when inventory blocks omit medium (must match the
    # event pool's default_device_tier or tier diffs are noise).
    default_tier: str = DEFAULT_TIER
    # Audit-log retention (ring of recent + reservoir of divergent).
    log_keep: int = DEFAULT_LOG_KEEP
    divergent_keep: int = DEFAULT_DIVERGENT_KEEP

    @classmethod
    def from_env(cls) -> "AuditorConfig":
        return cls(
            interval_s=_env_float(
                "AUDIT_INTERVAL_S", DEFAULT_AUDIT_INTERVAL_S
            )
        )


@dataclass
class AuditReport:
    """One pod audit: the diff and its provenance."""

    pod: str
    outcome: str  # clean | divergent | failed | unsupported
    ts_unix: float = 0.0
    duration_s: float = 0.0
    index_claims: int = 0
    inventory_blocks: int = 0
    phantom: int = 0
    missing: int = 0
    wrong_tier: int = 0
    unresolvable: int = 0
    divergence_ratio: float = 0.0
    detail: str = ""
    # Small samples of divergent request keys, for operator drill-down.
    phantom_sample: List[str] = field(default_factory=list)
    missing_sample: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "pod": self.pod,
            "outcome": self.outcome,
            "ts_unix": self.ts_unix,
            "duration_ms": round(self.duration_s * 1e3, 2),
            "index_claims": self.index_claims,
            "inventory_blocks": self.inventory_blocks,
            "phantom": self.phantom,
            "missing": self.missing,
            "wrong_tier": self.wrong_tier,
            "unresolvable": self.unresolvable,
            "divergence_ratio": round(self.divergence_ratio, 4),
            "detail": self.detail,
            "phantom_sample": self.phantom_sample,
            "missing_sample": self.missing_sample,
        }


_SAMPLE_KEYS = 8


class IndexAuditor:
    """Background index-truth sampler over one index + inventory source."""

    def __init__(
        self,
        index: Index,
        token_processor,
        source: InventorySource,
        config: Optional[AuditorConfig] = None,
    ) -> None:
        self._index = index
        self._token_processor = token_processor
        self._source = source
        self.config = config or AuditorConfig.from_env()
        # Leaf lock + wake channel (the ResyncManager shape).  Nothing
        # else is acquired under it: audits run with it released.
        self._lock = lockorder.tracked(
            threading.Condition(), "IndexAuditor._lock"
        )
        self._log: Deque[AuditReport] = deque(
            maxlen=max(1, self.config.log_keep)
        )  # guarded-by: _lock
        self._divergent: Deque[AuditReport] = deque(
            maxlen=max(1, self.config.divergent_keep)
        )  # guarded-by: _lock
        self._cycles = 0  # guarded-by: _lock
        self._audits = 0  # guarded-by: _lock
        self._last_cycle_unix: Optional[float] = None  # guarded-by: _lock
        self._ratio_by_pod: Dict[str, float] = {}  # guarded-by: _lock
        self._rr_cursor = 0  # guarded-by: _lock
        self._stopping = False  # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        """Start the periodic worker (no-op when interval_s <= 0)."""
        if self._thread is not None or self.config.interval_s <= 0:
            return
        with self._lock:
            self._stopping = False
        # gil-atomic: lifecycle ref; start/close are control-plane
        self._thread = threading.Thread(
            target=self._run, name="kvtpu-index-auditor", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        with self._lock:
            self._stopping = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            # gil-atomic: lifecycle ref; start/close are control-plane
            self._thread = None

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._stopping:
                    return
                self._lock.wait(self.config.interval_s)
                if self._stopping:
                    return
            try:
                self.run_cycle()
            except Exception:  # noqa: BLE001 — worker must survive
                logger.exception("audit cycle failed")

    # -- the audit -------------------------------------------------------

    def _index_view(
        self,
    ) -> Tuple[Dict[str, Dict[int, Set[str]]], Dict[int, int]]:
        """Per-pod index claims and the engine->request map, from one
        dump: ``claims[pod][request_key] = {tiers}``."""
        block_entries, engine_map = self._index.dump_entries()
        claims: Dict[str, Dict[int, Set[str]]] = {}
        for request_key, pods in block_entries:
            for entry in pods:
                per_key = claims.setdefault(entry.pod_identifier, {})
                per_key.setdefault(request_key, set()).add(
                    entry.device_tier
                )
        return claims, dict(engine_map)

    def _inventory_view(
        self,
        inventory: PodInventory,
        engine_map: Dict[int, int],
    ) -> Tuple[Dict[int, Set[str]], int]:
        """Recompute the inventory's request keys with the indexer's
        own hash chain: ``{request_key: {tiers}}`` plus the count of
        blocks whose parent chain could not be resolved.  Tier SETS,
        mirroring the index side: a pod can hold one block on several
        tiers, and a single-string view would make the diff depend on
        inventory block ordering."""
        expected: Dict[int, Set[str]] = {}
        local_map: Dict[int, int] = {}
        unresolvable = 0
        for block in inventory.blocks:
            engine_keys = []
            try:
                for raw in block.block_hashes:
                    engine_keys.append(engine_hash_to_uint64(raw))
            except (TypeError, ValueError):
                unresolvable += len(block.block_hashes)
                continue
            parent_request = EMPTY_BLOCK_HASH
            if block.parent_block_hash is not None:
                try:
                    parent_engine = engine_hash_to_uint64(
                        block.parent_block_hash
                    )
                except (TypeError, ValueError):
                    unresolvable += len(engine_keys)
                    continue
                parent_request = local_map.get(parent_engine)
                if parent_request is None:
                    parent_request = engine_map.get(parent_engine)
                if parent_request is None:
                    try:
                        parent_request = self._index.get_request_key(
                            parent_engine
                        )
                    except KeyError:
                        unresolvable += len(engine_keys)
                        continue
            model = block.lora_name or inventory.model_name
            request_keys = self._token_processor.tokens_to_kv_block_keys(
                parent_request, block.token_ids, model
            )
            overlap = min(len(request_keys), len(engine_keys))
            if overlap < len(engine_keys):
                unresolvable += len(engine_keys) - overlap
            tier = (
                block.medium.lower()
                if block.medium
                else self.config.default_tier
            )
            for engine_key, request_key in zip(
                engine_keys[:overlap], request_keys[:overlap]
            ):
                local_map[engine_key] = request_key
                expected.setdefault(request_key, set()).add(tier)
        return expected, unresolvable

    def audit_pod(
        self,
        pod: str,
        claims: Optional[Dict[int, Set[str]]] = None,
        engine_map: Optional[Dict[int, int]] = None,
    ) -> AuditReport:
        """Audit one pod now; pass ``claims``/``engine_map`` from a
        shared dump when auditing many pods in one cycle."""
        started = time.perf_counter()
        if claims is None or engine_map is None:
            all_claims, engine_map = self._index_view()
            claims = all_claims.get(pod, {})
        report = AuditReport(pod=pod, outcome="clean", ts_unix=time.time())
        report.index_claims = len(claims)
        try:
            inventory = self._source.fetch_inventory(pod)
        except Exception as exc:  # noqa: BLE001 — source may do I/O
            inventory = None
            report.detail = f"inventory fetch raised: {exc!r}"
        if inventory is None:
            report.outcome = "failed"
            report.detail = report.detail or "inventory unavailable"
            report.duration_s = time.perf_counter() - started
            self._finish(report)
            return report

        expected, unresolvable = self._inventory_view(inventory, engine_map)
        report.inventory_blocks = len(expected)
        report.unresolvable = unresolvable

        phantom = [key for key in claims if key not in expected]
        missing = [key for key in expected if key not in claims]
        # Wrong tier only when NO tier agrees: a pod holding a block
        # on more tiers than the index knows is an under-claim, not a
        # mis-claim, and must not flip with inventory ordering.
        wrong_tier = [
            key
            for key, tiers in expected.items()
            if key in claims and tiers.isdisjoint(claims[key])
        ]
        union = len(claims.keys() | expected.keys())
        report.phantom = len(phantom)
        report.missing = len(missing)
        report.wrong_tier = len(wrong_tier)
        report.divergence_ratio = (
            (report.phantom + report.missing + report.wrong_tier) / union
            if union
            else 0.0
        )
        report.phantom_sample = [
            f"{key:016x}" for key in sorted(phantom)[:_SAMPLE_KEYS]
        ]
        report.missing_sample = [
            f"{key:016x}" for key in sorted(missing)[:_SAMPLE_KEYS]
        ]
        if report.divergence_ratio > 0.0:
            report.outcome = "divergent"
        report.duration_s = time.perf_counter() - started
        self._finish(report)
        return report

    def _finish(self, report: AuditReport) -> None:
        pod_label = safe_label(report.pod)
        with self._lock:
            self._audits += 1
            self._log.append(report)
            if report.outcome == "divergent":
                self._divergent.append(report)
            if report.outcome in ("clean", "divergent"):
                self._ratio_by_pod[report.pod] = report.divergence_ratio
        METRICS.index_audits.labels(outcome=report.outcome).inc()
        if report.outcome in ("clean", "divergent"):
            METRICS.index_divergence_ratio.labels(pod=pod_label).set(
                report.divergence_ratio
            )
            if report.phantom:
                METRICS.index_audit_blocks.labels(kind="phantom").inc(
                    report.phantom
                )
            if report.missing:
                METRICS.index_audit_blocks.labels(kind="missing").inc(
                    report.missing
                )
            if report.wrong_tier:
                METRICS.index_audit_blocks.labels(kind="wrong_tier").inc(
                    report.wrong_tier
                )
        if report.outcome == "divergent":
            logger.warning(
                "index divergence on pod %s: ratio %.4f "
                "(phantom=%d missing=%d wrong_tier=%d over %d claims / "
                "%d inventory blocks)",
                report.pod,
                report.divergence_ratio,
                report.phantom,
                report.missing,
                report.wrong_tier,
                report.index_claims,
                report.inventory_blocks,
            )

    def run_cycle(self) -> List[AuditReport]:
        """One audit cycle: dump the index once, audit the selected
        pods (round-robin slice when ``pods_per_cycle`` bounds it)."""
        claims_by_pod, engine_map = self._index_view()
        pods = sorted(claims_by_pod)
        if not pods:
            with self._lock:
                departed = list(self._ratio_by_pod)
                self._ratio_by_pod.clear()
                self._cycles += 1
                self._last_cycle_unix = time.time()
            for pod in departed:
                try:
                    METRICS.index_divergence_ratio.remove(safe_label(pod))
                except KeyError:
                    pass
            return []
        per_cycle = self.config.pods_per_cycle
        if per_cycle and per_cycle < len(pods):
            with self._lock:
                start = self._rr_cursor % len(pods)
                self._rr_cursor = start + per_cycle
            selected = [
                pods[(start + i) % len(pods)] for i in range(per_cycle)
            ]
        else:
            selected = pods
        reports = [
            self.audit_pod(
                pod, claims=claims_by_pod.get(pod, {}), engine_map=engine_map
            )
            for pod in selected
        ]
        # Pods that left the index (decommissioned, purged) must not
        # keep a stale divergence reading alive forever — in a churning
        # fleet the per-pod map and the gauge's label series would
        # otherwise grow monotonically and /healthz would alert on
        # pods that no longer exist.
        current = set(pods)
        with self._lock:
            departed = [
                pod for pod in self._ratio_by_pod if pod not in current
            ]
            for pod in departed:
                # The earlier read is in the mutually-exclusive
                # empty-index early-return branch; this block derives
                # `departed` under its own acquisition.
                del self._ratio_by_pod[pod]  # kvlint: atomic-ok
            self._cycles += 1
            self._last_cycle_unix = time.time()
        for pod in departed:
            try:
                METRICS.index_divergence_ratio.remove(safe_label(pod))
            except KeyError:
                pass  # label series never created (audit never scored it)
        return reports

    # -- read surface ----------------------------------------------------

    def status(self) -> dict:
        """The /healthz analytics block's audit half."""
        with self._lock:
            divergent = {
                pod: round(ratio, 4)
                for pod, ratio in sorted(self._ratio_by_pod.items())
                if ratio > 0.0
            }
            return {
                "interval_s": self.config.interval_s,
                "running": self._thread is not None,
                "cycles": self._cycles,
                "audits": self._audits,
                "last_cycle_unix": self._last_cycle_unix,
                "pods_tracked": len(self._ratio_by_pod),
                "divergent_pods": divergent,
            }

    def recent(self, limit: int = 50) -> List[dict]:
        """Newest-first audit log (the flight-recorder-style ring)."""
        with self._lock:
            return [r.to_dict() for r in list(self._log)[::-1][:limit]]

    def divergent(self, limit: int = 50) -> List[dict]:
        """Newest-first reservoir of divergent audits."""
        with self._lock:
            return [r.to_dict() for r in list(self._divergent)[::-1][:limit]]
