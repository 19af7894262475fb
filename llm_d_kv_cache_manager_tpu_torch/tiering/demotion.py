"""Proactive demotion: HBM -> host -> shared_storage ahead of pressure.

Reactive offload (store when the engine evicts) loses the race under
churn: by the time pressure forces an eviction the block is gone and
the next request pays a full prefill.  The demotion worker moves
**cold-but-reusable** block groups down the ladder *before* pressure —
cold: idle past the tier's threshold (or HBM utilization above the
watermark); reusable: the PolicyFeed still predicts a next use — and
publishes ``medium``-tagged KVEvents for every transition so the fleet
index (and therefore ``LongestPrefixScorer.tier_weights``) scores real
tier residency, not guesses.

State machine (docs/tiering.md), per block group::

      hbm --(idle >= demote_host_idle_s, or pressure)--> host
      host --(idle >= demote_storage_idle_s)--> shared_storage

Each ``hbm -> host`` transition emits ``BlockStored(medium="host")``
then ``BlockRemoved(medium=device_medium)``; ``host -> shared_storage`` emits
``BlockStored(medium="shared_storage")`` then
``BlockRemoved(medium="host")``.  Store-before-remove means the index
never sees a window where the pod holds nothing (a scorer racing the
transition sees two tiers, max-weight wins — conservative).

``device_medium`` is the name under which the pod's engine publishes
its device tier: ``hbm`` on a TPU pod, ``gpu`` on a vLLM pod on a GPU.
The index removes an entry only under the tier it was stored with, so
the first rung's ``BlockRemoved`` must carry the engine's name.

The worker is target-agnostic: it decides *what* and *when*; a
:class:`DemotionTarget` does the move and owns event publication.
:class:`PodTierState` is the residency-only target — it models a
pod's group residency, optionally pages bytes into a
``HostTierCache``, and publishes through any sink callable
(:func:`pool_event_sink` adapts the kvevents ingestion pool; a real pod
would hand it its ZMQ publisher).  :class:`~.staged_target.
StagedDemotionTarget` is the one whose rungs move a pool's bytes.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from llm_d_kv_cache_manager_tpu_torch.kvevents.events import (
    BlockRemoved,
    BlockStored,
    EventBatch,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.pool import Message
from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("tiering.demotion")

HBM = "hbm"
HOST = "host"
SHARED_STORAGE = "shared_storage"

_NEXT_TIER = {HBM: HOST, HOST: SHARED_STORAGE}
_TRANSITION = {HBM: "hbm_to_host", HOST: "host_to_storage"}

# PodTierState._lock is a leaf: event publication happens outside it.
# kvlint: lock-order: PodTierState._lock ascending
lockorder.declare_ascending("PodTierState._lock")
# kvlint: lock-order: DemotionWorker._lock ascending
lockorder.declare_ascending("DemotionWorker._lock")


@dataclass
class DemotionCandidate:
    """One block group as seen by the worker's scan."""

    group_key: int
    tier: str
    nbytes: int
    idle_s: float
    # Ledger family the group's blocks belong to (None = unknown).
    family: Optional[int] = None


@dataclass
class DemotionConfig:
    interval_s: float = 5.0
    # Idle thresholds per rung (seconds since last use).
    demote_host_idle_s: float = 30.0
    demote_storage_idle_s: float = 120.0
    # HBM utilization above which hbm->host demotion ignores the idle
    # threshold (demote the coldest reusable groups NOW).
    pressure_watermark: float = 0.85
    # Transition budget per cycle (keeps a cold start from issuing an
    # I/O storm).
    max_moves_per_cycle: int = 8
    # Only demote groups the feed still predicts a next use for unless
    # pressure forces the move ("cold-but-reusable"); groups with no
    # prediction are left for ordinary eviction to reap.
    require_prediction: bool = True


class DemotionTarget:
    """What a demotion target must provide (duck-typed protocol)."""

    def scan(self) -> List[DemotionCandidate]:  # pragma: no cover
        raise NotImplementedError

    def pressure(self) -> float:  # pragma: no cover
        raise NotImplementedError

    def demote(
        self, group_key: int, to_tier: str
    ) -> bool:  # pragma: no cover
        raise NotImplementedError


def pool_event_sink(pool, pod_identifier: str, model_name: str) -> Callable:
    """Adapt a kvevents ingestion pool into a demotion event sink.

    Returns ``sink(events)`` that wraps the tier-transition events in
    an ``EventBatch`` message exactly as the pod's publisher would put
    them on the wire, so the index applies them through the same
    decode/apply path as live traffic: the payload is the port's own
    msgpack encoding (``EventBatch.encode``).
    """

    def sink(events: Sequence[object]) -> None:
        if not events:
            return
        batch = EventBatch(ts=time.time(), events=list(events))
        pool.add_task(
            Message(
                topic=f"kv@{pod_identifier}@{model_name}",
                payload=batch.encode(),
                pod_identifier=pod_identifier,
                model_name=model_name,
            )
        )

    return sink


@dataclass
class _Group:
    engine_hashes: List[int]
    token_ids: List[int]
    parent_hash: Optional[int]
    block_size: int
    nbytes: int
    tier: str
    last_use: float
    family: Optional[int] = None
    group: Optional[object] = None  # host-tier payload (np.ndarray)


class PodTierState(DemotionTarget):
    """Reference demotion target: one pod's block-group residency.

    Tracks each group's tier, bytes, and last use; ``demote`` performs
    the transition (optionally paging bytes into a ``HostTierCache``
    on hbm->host) and publishes the medium-tagged events through the
    sink OUTSIDE its lock.  ``capacity_bytes`` bounds the hbm tier for
    the pressure signal.
    """

    def __init__(
        self,
        capacity_bytes: int,
        event_sink: Optional[Callable] = None,
        host_cache=None,
        feed=None,
        device_medium: str = HBM,
    ) -> None:
        if capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be positive")
        self.capacity_bytes = capacity_bytes
        self.device_medium = device_medium
        self._event_sink = event_sink
        self._host_cache = host_cache
        self._feed = feed
        self._lock = lockorder.tracked(
            threading.Lock(), "PodTierState._lock"
        )
        self._groups: Dict[int, _Group] = {}  # guarded-by: _lock
        self._hbm_bytes = 0  # guarded-by: _lock

    def register_group(
        self,
        group_key: int,
        engine_hashes: Sequence[int],
        token_ids: Sequence[int],
        nbytes: int,
        parent_hash: Optional[int] = None,
        block_size: int = 16,
        tier: str = HBM,
        family: Optional[int] = None,
        group=None,
        now: Optional[float] = None,
    ) -> None:
        """Admit (or refresh) a resident block group."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            old = self._groups.get(group_key)
            if old is not None and old.tier == HBM:
                self._hbm_bytes -= old.nbytes
            self._groups[group_key] = _Group(
                engine_hashes=list(engine_hashes),
                token_ids=list(token_ids),
                parent_hash=parent_hash,
                block_size=block_size,
                nbytes=nbytes,
                tier=tier,
                last_use=now,
                family=family,
                group=group,
            )
            if tier == HBM:
                self._hbm_bytes += nbytes

    def touch(self, group_key: int, now: Optional[float] = None) -> None:
        if now is None:
            now = time.monotonic()
        with self._lock:
            group = self._groups.get(group_key)
            if group is not None:
                group.last_use = now

    def scan(self) -> List[DemotionCandidate]:
        now = time.monotonic()
        with self._lock:
            return [
                DemotionCandidate(
                    group_key=key,
                    tier=group.tier,
                    nbytes=group.nbytes,
                    idle_s=now - group.last_use,
                    family=group.family,
                )
                for key, group in self._groups.items()
                if group.tier in _NEXT_TIER
            ]

    def pressure(self) -> float:
        with self._lock:
            return self._hbm_bytes / self.capacity_bytes

    def demote(self, group_key: int, to_tier: str) -> bool:
        """Move one group down a rung; publishes events on success."""
        events: List[object] = []
        with self._lock:
            group = self._groups.get(group_key)
            if group is None or _NEXT_TIER.get(group.tier) != to_tier:
                return False
            if to_tier == HOST and self._host_cache is not None:
                if group.group is None or not self._host_cache.put(
                    group_key, group.group
                ):
                    # Not admitted into host DRAM: the group stays put
                    # (advertising an unadmitted tier would poison the
                    # index; kvlint KV008 has nothing to close here).
                    return False
            from_tier = group.tier
            group.tier = to_tier
            if from_tier == HBM:
                self._hbm_bytes -= group.nbytes
            events.append(
                BlockStored(
                    block_hashes=list(group.engine_hashes),
                    parent_block_hash=group.parent_hash,
                    token_ids=list(group.token_ids),
                    block_size=group.block_size,
                    medium=to_tier,
                )
            )
            events.append(
                BlockRemoved(
                    block_hashes=list(group.engine_hashes),
                    medium=(
                        self.device_medium if from_tier == HBM else from_tier
                    ),
                )
            )
            nbytes = group.nbytes
            family = group.family
        # Sink + feed registration OUTSIDE the lock (leaf discipline).
        if self._event_sink is not None:
            self._event_sink(events)
        if self._feed is not None and family is not None:
            self._feed.observe_keys([group_key], family)
        METRICS.tiering_demotions.labels(
            transition=_TRANSITION[from_tier]
        ).inc()
        METRICS.tiering_demotion_bytes.labels(
            transition=_TRANSITION[from_tier]
        ).inc(nbytes)
        return True

    def tiers(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for group in self._groups.values():
                out[group.tier] = out.get(group.tier, 0) + 1
            return out


@dataclass
class _DemotionRecord:
    at: float
    group_key: int
    transition: str
    nbytes: int
    idle_s: float
    predicted_next_use_s: Optional[float]
    forced_by_pressure: bool

    def to_dict(self) -> dict:
        return {
            "age_s": round(time.monotonic() - self.at, 1),
            "group": f"{self.group_key:016x}",
            "transition": self.transition,
            "nbytes": self.nbytes,
            "idle_s": round(self.idle_s, 3),
            "predicted_next_use_s": (
                None
                if self.predicted_next_use_s is None
                else round(self.predicted_next_use_s, 3)
            ),
            "forced_by_pressure": self.forced_by_pressure,
        }


class DemotionWorker:
    """Background policy loop over one :class:`DemotionTarget`.

    ``run_cycle()`` is the testable unit (scan -> rank -> demote);
    ``start()`` runs it every ``interval_s`` on a daemon thread until
    ``close()``.
    """

    def __init__(
        self,
        target: DemotionTarget,
        feed,
        config: Optional[DemotionConfig] = None,
    ) -> None:
        self.target = target
        self.feed = feed
        self.config = config or DemotionConfig()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = lockorder.tracked(
            threading.Lock(), "DemotionWorker._lock"
        )
        self._recent: deque = deque(maxlen=32)  # guarded-by: _lock
        self._cycles = 0  # guarded-by: _lock
        self._moves = 0  # guarded-by: _lock
        self._last_pressure = 0.0  # guarded-by: _lock

    def start(self) -> None:
        if self._thread is not None:
            return
        # gil-atomic: lifecycle ref; start/close are control-plane
        self._thread = threading.Thread(
            target=self._run, name="kvtpu-tiering-demotion", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5)
            # gil-atomic: lifecycle ref; start/close are control-plane
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.run_cycle()
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("demotion cycle failed")

    def run_cycle(self, now: Optional[float] = None) -> int:
        """One scan -> rank -> demote pass; returns moves performed."""
        if now is None:
            now = time.monotonic()
        config = self.config
        snapshot = self.feed.refresh(now) if self.feed is not None else None
        pressure = self.target.pressure()
        candidates = self.target.scan()
        # Coldest first: expected next use descending (idle as the
        # tiebreak for unpredicted groups under pressure).
        ranked = []
        for candidate in candidates:
            expected = None
            if snapshot is not None and candidate.family is not None:
                prediction = snapshot.predictions.get(candidate.family)
                if prediction is not None:
                    expected = max(0.0, prediction.expected_next_use_s(now))
            ranked.append((candidate, expected))
        ranked.sort(
            key=lambda pair: (
                -(pair[1] if pair[1] is not None else -1.0),
                -pair[0].idle_s,
            )
        )
        moves = 0
        under_pressure = pressure >= config.pressure_watermark
        for candidate, expected in ranked:
            if moves >= config.max_moves_per_cycle:
                break
            if candidate.tier == HBM:
                due = candidate.idle_s >= config.demote_host_idle_s
                forced = under_pressure
                if not (due or forced):
                    continue
                if (
                    config.require_prediction
                    and expected is None
                    and not forced
                ):
                    # Cold but NOT reusable: leave it to plain eviction.
                    continue
                to_tier = HOST
            else:
                if candidate.idle_s < config.demote_storage_idle_s:
                    continue
                if config.require_prediction and expected is None:
                    continue
                to_tier = SHARED_STORAGE
                forced = False
            if self.target.demote(candidate.group_key, to_tier):
                moves += 1
                with self._lock:
                    self._moves += 1
                    self._recent.append(
                        _DemotionRecord(
                            at=now,
                            group_key=candidate.group_key,
                            transition=_TRANSITION[candidate.tier],
                            nbytes=candidate.nbytes,
                            idle_s=candidate.idle_s,
                            predicted_next_use_s=expected,
                            forced_by_pressure=forced,
                        )
                    )
        with self._lock:
            self._cycles += 1
            self._last_pressure = pressure
        return moves

    def stats(self) -> dict:
        with self._lock:
            return {
                "running": self._thread is not None,
                "cycles": self._cycles,
                "moves": self._moves,
                "last_pressure": round(self._last_pressure, 4),
                "config": {
                    "interval_s": self.config.interval_s,
                    "demote_host_idle_s": self.config.demote_host_idle_s,
                    "demote_storage_idle_s": (
                        self.config.demote_storage_idle_s
                    ),
                    "pressure_watermark": self.config.pressure_watermark,
                    "max_moves_per_cycle": self.config.max_moves_per_cycle,
                },
                "recent": [record.to_dict() for record in self._recent],
            }
