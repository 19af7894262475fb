"""Gap-driven anti-entropy resync: suspect pods, inventory pulls, repair.

The wire-level sequence numbers the subscriber parses finally close
their loop here.  A detected gap means events were lost: the index's
claims about that pod are now *suspect* — it may advertise blocks the
pod evicted (stale hits mis-route traffic) or miss blocks the pod
stored (lost hit rate).  Instead of silently serving stale scores until
LRU churn clears them, the gap listener marks the pod suspect and this
manager repairs it:

1. **mark** — ``mark_suspect(pod, model)`` (wired as the
   ``SubscriberManager`` gap listener) records the pod with a
   timestamp and bumps ``kvtpu_kvevents_suspect_pods``; marking is
   idempotent while a pod is already suspect.
2. **fetch** — the worker thread pulls a block-inventory snapshot
   through the pluggable :class:`InventorySource` (span
   ``kvevents.resync.fetch``), with bounded retries and backoff.
3. **repair** — the inventory is handed to the ingestion pool as a
   :class:`~.pool.ResyncJob` riding the pod's normal shard lane, so the
   purge + re-apply is ordered against the pod's live events and runs
   through the same batched-apply surface (span
   ``kvevents.resync.apply`` on the worker side).
4. **report** — on success the pod leaves the suspect set and the
   mark→repair **staleness window** lands in
   ``kvtpu_kvevents_resync_staleness_seconds``; outcomes count in
   ``kvtpu_kvevents_resyncs_total{outcome=ok|failed}``.  A failed
   resync leaves the pod suspect (visible on the gauge) until the next
   gap or an explicit ``request_resync``.

Inventory sources are deliberately pluggable: production fleets expose
per-pod block inventories in different ways (a vLLM debug endpoint, a
shared-storage manifest, a scheduler-side mirror).
:class:`CallableInventorySource` adapts any ``fn(pod) ->
PodInventory | None``; :class:`EmptyInventorySource` is the degraded
mode for fleets with no inventory surface at all — the "snapshot" is
empty, so a gap simply *purges* the pod's suspect entries (stale
claims stop attracting traffic; the live stream re-stores reality).

Copied from the JAX reference's ``kvevents/resync.py``.
"""

from __future__ import annotations

import threading
import time
from abc import ABC, abstractmethod
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

from llm_d_kv_cache_manager_tpu_torch.kvevents.events import BlockStored
from llm_d_kv_cache_manager_tpu_torch.kvevents.pool import Pool, ResyncJob
from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.obs.trace import TRACER, span as obs_span
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("kvevents.resync")


@dataclass
class InventoryBlock:
    """One stored-block record of a pod's inventory snapshot, shaped
    like the ``BlockStored`` wire event it replays as.  Records must be
    listed in parent-chain order (parents before children), exactly as
    the engine originally published them."""

    block_hashes: List[object]
    token_ids: List[int]
    block_size: int
    parent_block_hash: Optional[object] = None
    medium: Optional[str] = None
    lora_name: Optional[str] = None


@dataclass
class PodInventory:
    """A pod's current block inventory, as pulled from an
    :class:`InventorySource`."""

    pod_identifier: str
    model_name: str
    blocks: List[InventoryBlock] = field(default_factory=list)


class InventorySource(ABC):
    """Where pod block-inventory snapshots come from (pluggable)."""

    @abstractmethod
    def fetch_inventory(self, pod_identifier: str) -> Optional[PodInventory]:
        """Return the pod's inventory, or None when unavailable (the
        resync retries, then fails leaving the pod suspect).  Called
        from the resync worker thread; may block on I/O."""


class CallableInventorySource(InventorySource):
    """Adapts a plain ``fn(pod_identifier) -> PodInventory | None``
    (tests, benches, scheduler-side mirrors)."""

    def __init__(
        self, fn: Callable[[str], Optional[PodInventory]]
    ) -> None:
        self._fn = fn

    def fetch_inventory(self, pod_identifier: str) -> Optional[PodInventory]:
        return self._fn(pod_identifier)


class EmptyInventorySource(InventorySource):
    """Degraded mode for fleets with no inventory surface: every fetch
    returns an empty snapshot, so a resync purges the pod's suspect
    index entries and lets the live event stream re-store reality.
    Strictly better than serving stale claims, at the cost of a
    temporary hit-rate dip for that pod."""

    def fetch_inventory(self, pod_identifier: str) -> Optional[PodInventory]:
        return PodInventory(pod_identifier=pod_identifier, model_name="")


@dataclass
class ResyncConfig:
    # Inventory-fetch attempts per resync before giving up (the pod
    # stays suspect).
    max_attempts: int = 3
    retry_backoff_s: float = 1.0
    # Bound on how long the manager waits for the pool worker to apply
    # a queued ResyncJob before counting the resync failed.
    apply_timeout_s: float = 30.0


class ResyncManager:
    """Suspect-pod registry + one repair worker thread.

    ``mark_suspect`` is safe to call from poller threads (it only flips
    registry state and notifies); all I/O happens on the worker.
    """

    def __init__(
        self,
        pool: Pool,
        source: InventorySource,
        config: Optional[ResyncConfig] = None,
    ) -> None:
        self._pool = pool
        self._source = source
        self.config = config or ResyncConfig()
        # Leaf lock + wake channel in one Condition (the StagingBudget
        # shape — tracking the inner lock would trip the watchdog on
        # Condition's ownership probe).  Nothing else is acquired under
        # it: the worker fetches and enqueues with it released.
        self._lock = lockorder.tracked(
            threading.Condition(), "ResyncManager._lock"
        )
        # pod -> perf_counter() of the FIRST gap since it was last
        # clean; preserved across repeat gaps so the staleness window
        # measures mark -> repaired, not last-gap -> repaired.
        self._suspect: Dict[str, float] = {}  # guarded-by: _lock
        self._model_by_pod: Dict[str, str] = {}  # guarded-by: _lock
        self._queue: Deque[str] = deque()  # guarded-by: _lock
        self._queued: set = set()  # guarded-by: _lock
        self._stopping = False  # guarded-by: _lock
        self._resyncs_ok = 0  # guarded-by: _lock
        self._resyncs_failed = 0  # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None

    # -- marking (poller-thread safe) -----------------------------------

    def gap_listener(self, pod_identifier: str, topic: str, gap: int) -> None:
        """``SubscriberManager(on_gap=...)`` adapter: a wire-level seq
        gap marks the pod suspect and schedules a resync."""
        self.mark_suspect(pod_identifier)

    def mark_suspect(
        self, pod_identifier: str, model_name: str = ""
    ) -> bool:
        """Record a pod as suspect and queue a resync; returns True if
        the pod was newly marked (False: already suspect/queued)."""
        with self._lock:
            if self._stopping:
                return False
            newly = pod_identifier not in self._suspect
            if newly:
                self._suspect[pod_identifier] = time.perf_counter()
            if model_name:
                self._model_by_pod[pod_identifier] = model_name
            if pod_identifier not in self._queued:
                self._queued.add(pod_identifier)
                self._queue.append(pod_identifier)
                self._lock.notify_all()
            suspects = len(self._suspect)
        METRICS.kvevents_suspect_pods.set(suspects)
        if newly:
            logger.warning(
                "pod %s marked suspect (sequence gap); resync scheduled",
                pod_identifier,
            )
        return newly

    # An explicit trigger, for callers outside the gap path.
    def request_resync(
        self, pod_identifier: str, model_name: str = ""
    ) -> bool:
        return self.mark_suspect(pod_identifier, model_name)

    def suspect_pods(self) -> List[str]:
        with self._lock:
            return sorted(self._suspect)

    def is_suspect(self, pod_identifier: str) -> bool:
        with self._lock:
            return pod_identifier in self._suspect

    def stats(self) -> dict:
        with self._lock:
            return {
                "suspect": sorted(self._suspect),
                "queued": len(self._queue),
                "resyncs_ok": self._resyncs_ok,
                "resyncs_failed": self._resyncs_failed,
            }

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        with self._lock:
            self._stopping = False
        # gil-atomic: lifecycle ref; start/close are control-plane
        self._thread = threading.Thread(
            target=self._run, name="kvtpu-evplane-resync", daemon=True
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

    # -- worker ----------------------------------------------------------

    def _next_pod(self) -> Optional[str]:
        with self._lock:
            while not self._queue and not self._stopping:
                self._lock.wait()
            if self._stopping:
                return None
            pod = self._queue.popleft()
            self._queued.discard(pod)
            return pod

    def _run(self) -> None:
        while True:
            pod = self._next_pod()
            if pod is None:
                return
            try:
                self._resync_pod(pod)
            except Exception:  # noqa: BLE001 — worker must survive
                logger.exception("resync worker failed for pod %s", pod)
                self._record_outcome(pod, ok=False)

    def _fetch(self, pod: str) -> Optional[PodInventory]:
        for attempt in range(1, self.config.max_attempts + 1):
            with self._lock:
                if self._stopping:
                    return None
            try:
                inventory = self._source.fetch_inventory(pod)
            except Exception as exc:  # noqa: BLE001 — source may do I/O
                inventory = None
                logger.warning(
                    "inventory fetch for pod %s failed (attempt %d/%d): %s",
                    pod,
                    attempt,
                    self.config.max_attempts,
                    exc,
                )
            if inventory is not None:
                return inventory
            if attempt < self.config.max_attempts:
                time.sleep(self.config.retry_backoff_s * attempt)
        return None

    def _resync_pod(self, pod: str) -> None:
        with self._lock:
            suspect_since = self._suspect.get(pod, time.perf_counter())
            model_name = self._model_by_pod.get(pod, "")
        tr = TRACER.start_trace("kvevents.resync")
        if tr is not None:
            tr.set_attr("pod", pod)
        with obs_span("kvevents.resync.fetch") if tr is None else tr.span(
            "kvevents.resync.fetch"
        ):
            inventory = self._fetch(pod)
        if inventory is None:
            logger.warning(
                "resync for pod %s failed: no inventory after %d attempts; "
                "pod stays suspect",
                pod,
                self.config.max_attempts,
            )
            if tr is not None:
                tr.set_error("inventory unavailable")
                tr.finish("error")
            self._record_outcome(pod, ok=False)
            return

        # The job's completion is reported by the pool worker that
        # applies it (ordered within the pod's shard lane); bounded
        # wait here.
        done = threading.Event()
        outcome = {}

        def on_done(job: ResyncJob, ok: bool, purged: int, detail: str):
            outcome["ok"] = ok
            outcome["purged"] = purged
            outcome["detail"] = detail
            done.set()

        job = ResyncJob(
            pod_identifier=pod,
            model_name=inventory.model_name or model_name,
            events=[
                BlockStored(
                    block_hashes=list(block.block_hashes),
                    parent_block_hash=block.parent_block_hash,
                    token_ids=list(block.token_ids),
                    block_size=block.block_size,
                    medium=block.medium,
                    lora_name=block.lora_name,
                )
                for block in inventory.blocks
            ],
            suspect_since=suspect_since,
            on_done=on_done,
        )
        self._pool.enqueue_resync(job, trace_=tr)
        if not done.wait(self.config.apply_timeout_s):
            logger.warning(
                "resync apply for pod %s timed out after %.0fs; pod stays "
                "suspect",
                pod,
                self.config.apply_timeout_s,
            )
            self._record_outcome(pod, ok=False)
            return
        if not outcome.get("ok"):
            self._record_outcome(pod, ok=False)
            return
        staleness = time.perf_counter() - suspect_since
        METRICS.kvevents_resync_staleness.observe(staleness)
        logger.info(
            "pod %s resynced: purged %d entries, re-applied %d inventory "
            "blocks, staleness window %.3fs",
            pod,
            outcome.get("purged", 0),
            len(inventory.blocks),
            staleness,
        )
        self._record_outcome(pod, ok=True)

    def _record_outcome(self, pod: str, ok: bool) -> None:
        with self._lock:
            if ok:
                self._resyncs_ok += 1
                self._suspect.pop(pod, None)
            else:
                self._resyncs_failed += 1
            suspects = len(self._suspect)
        METRICS.kvevents_resyncs.labels(
            outcome="ok" if ok else "failed"
        ).inc()
        METRICS.kvevents_suspect_pods.set(suspects)
