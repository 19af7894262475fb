"""Instant-warm scale-out: pre-place hot families on cold pods.

Today a scale-out event costs cache-warmup minutes: the new pod joins
with an empty KV cache, scores zero on every prefix, and only warms by
taking misses.  The warm-up plane turns that into seconds: when a pod
registers cold, the planner bulk-plans its share of the fleet's hot
prefix families — ranked by the cachestats ledger's
``reuse_predictions()`` (shortest reuse interval first, i.e. hottest)
— and a budgeted worker drains the plan queue a few transfers per
cycle, publishing real KVEvents so the new pod's scores rise through
the ordinary index path.

The :class:`HotFamilyCatalog` is the bridge: the transfer engine notes
every scored chain's holder + block keys as traffic flows (the ledger
knows *which* families are hot, the catalog knows *where* their bytes
live and what the chain is), so ``register_cold_pod`` can turn a
ranked family list into executable plans without re-scoring anything.

State machine, per cold pod (docs/transfer.md)::

    cold --register_cold_pod: rank + bulk-plan--> warming
    warming --run_cycle x N: queue drains--> warm

``kvtpu_transfer_cold_pods`` gauges pods still warming;
``kvtpu_transfer_warmup_moves_total`` counts executed pre-placements.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("transfer.warmup")

DEFAULT_CATALOG_SIZE = 1024

# kvlint: lock-order: HotFamilyCatalog._lock ascending
lockorder.declare_ascending("HotFamilyCatalog._lock")
# kvlint: lock-order: WarmupWorker._lock ascending
lockorder.declare_ascending("WarmupWorker._lock")


@dataclass
class HotFamilyRecord:
    """Where one prefix family's bytes live and what the chain is."""

    family: int
    holder_pod: str
    block_keys: List[int]
    engine_hashes: List[int]
    token_ids: List[int]
    block_size: int
    tier: str = "hbm"
    last_seen: float = 0.0


class HotFamilyCatalog:
    """Bounded family -> holder/chain registry, fed from scored
    traffic by the transfer engine (and directly by embedding code)."""

    def __init__(self, max_families: int = DEFAULT_CATALOG_SIZE) -> None:
        self.max_families = max_families
        self._lock = lockorder.tracked(
            threading.Lock(), "HotFamilyCatalog._lock"
        )
        # guarded-by: _lock — insertion-ordered for bounded eviction.
        self._records: "OrderedDict[int, HotFamilyRecord]" = OrderedDict()

    def note(
        self,
        family: int,
        holder_pod: str,
        block_keys: Sequence[int],
        engine_hashes: Optional[Sequence[int]] = None,
        token_ids: Optional[Sequence[int]] = None,
        block_size: int = 16,
        tier: str = "hbm",
        now: Optional[float] = None,
    ) -> None:
        """Record (or refresh) a family's holder.  A longer observed
        chain replaces a shorter one; a newer holder replaces an older
        one at equal length (residency drifts with traffic)."""
        if not block_keys:
            return
        if now is None:
            now = time.monotonic()
        record = HotFamilyRecord(
            family=family,
            holder_pod=holder_pod,
            block_keys=list(block_keys),
            engine_hashes=(
                list(engine_hashes)
                if engine_hashes is not None
                else list(block_keys)
            ),
            token_ids=list(token_ids or []),
            block_size=block_size,
            tier=tier,
            last_seen=now,
        )
        with self._lock:
            old = self._records.pop(family, None)
            if old is not None and len(old.block_keys) > len(
                record.block_keys
            ):
                old.last_seen = now
                record = old
            self._records[family] = record
            while len(self._records) > self.max_families:
                self._records.popitem(last=False)

    def get(self, family: int) -> Optional[HotFamilyRecord]:
        with self._lock:
            return self._records.get(family)

    def families(self) -> List[int]:
        with self._lock:
            return list(self._records)

    def stats(self) -> dict:
        with self._lock:
            return {
                "families": len(self._records),
                "max_families": self.max_families,
            }


class WarmupWorker:
    """Budgeted drain of per-pod warm-up plan queues.

    Run either as a daemon thread (``start()``) or by pumping
    :meth:`run_cycle` directly (a caller's own clock, tests).
    """

    def __init__(
        self,
        catalog: HotFamilyCatalog,
        planner,
        executor,
        ledger=None,
        warmup_families: int = 8,
        interval_s: float = 1.0,
        moves_per_cycle: int = 4,
    ) -> None:
        self.catalog = catalog
        self.planner = planner
        self.executor = executor
        self.ledger = ledger
        self.warmup_families = warmup_families
        self.interval_s = interval_s
        self.moves_per_cycle = moves_per_cycle
        self._lock = lockorder.tracked(
            threading.Lock(), "WarmupWorker._lock"
        )
        # guarded-by: _lock — (pod, plan) FIFO across all cold pods.
        self._queue: Deque[Tuple[str, object]] = deque()
        self._pending: Dict[str, int] = {}  # guarded-by: _lock
        self._warmed: Dict[str, int] = {}  # guarded-by: _lock
        self._cycles = 0
        self._moves = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- planning --------------------------------------------------------

    def _ranked_families(self) -> List[int]:
        """Hottest-first family ranking: shortest predicted reuse
        interval wins, family id breaks ties (determinism)."""
        if self.ledger is None:
            with_catalog = self.catalog.families()
            return sorted(with_catalog)[: self.warmup_families]
        predictions = self.ledger.reuse_predictions()
        ranked = sorted(predictions, key=lambda p: (p[1], p[0]))
        out: List[int] = []
        for family, _ewma, _last_seen, _requests in ranked:
            if self.catalog.get(family) is not None:
                out.append(family)
            if len(out) >= self.warmup_families:
                break
        return out

    def register_cold_pod(self, pod_identifier: str) -> int:
        """A new pod joined cold: bulk-plan its share of hot families.
        Returns the number of transfers queued."""
        queued = 0
        plans: List[Tuple[str, object]] = []
        for family in self._ranked_families():
            record = self.catalog.get(family)
            if record is None or record.holder_pod == pod_identifier:
                continue
            plan = self.planner.plan_warmup(
                source_pod=record.holder_pod,
                target_pod=pod_identifier,
                block_keys=record.block_keys,
                engine_hashes=record.engine_hashes,
                token_ids=record.token_ids,
                block_size=record.block_size,
                tier=record.tier,
            )
            plans.append((pod_identifier, plan))
            queued += 1
        with self._lock:
            self._queue.extend(plans)
            self._pending[pod_identifier] = (
                self._pending.get(pod_identifier, 0) + queued
            )
            cold = sum(1 for n in self._pending.values() if n > 0)
        METRICS.transfer_cold_pods.set(cold)
        logger.info(
            "cold pod %s: %d warm-up transfers planned",
            pod_identifier,
            queued,
        )
        return queued

    def queued_plans(self) -> List[object]:
        """Snapshot of the not-yet-executed warm-up plans, in drain
        order — a caller that moves the bytes itself reads what the
        next cycles will execute."""
        with self._lock:
            return [plan for _pod, plan in self._queue]

    # -- draining --------------------------------------------------------

    def run_cycle(self) -> int:
        """Execute up to ``moves_per_cycle`` queued transfers; the
        testable unit the thread loops over."""
        moved = 0
        for _ in range(self.moves_per_cycle):
            with self._lock:
                if not self._queue:
                    break
                pod, plan = self._queue.popleft()
            ok = False
            try:
                ok = self.executor.execute(plan, mode="copy")
            except Exception:  # noqa: BLE001 — a bad plan must not
                # wedge the drain loop; the plan is already terminal.
                logger.exception("warm-up transfer failed")
            with self._lock:
                self._pending[pod] = max(
                    0, self._pending.get(pod, 1) - 1
                )
                if ok:
                    self._warmed[pod] = self._warmed.get(pod, 0) + 1
                cold = sum(
                    1 for n in self._pending.values() if n > 0
                )
            if ok:
                moved += 1
                METRICS.transfer_warmup_moves.inc()
            METRICS.transfer_cold_pods.set(cold)
        # gil-atomic: stats counter bumped by the one warm-up thread
        self._cycles += 1
        return moved

    # -- thread lifecycle ------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        # gil-atomic: lifecycle ref; start/close are control-plane
        self._thread = threading.Thread(
            target=self._run,
            name="kvtpu-transfer-warmup",
            daemon=True,
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.run_cycle()
            except Exception:  # noqa: BLE001
                logger.exception("warm-up cycle failed")

    def close(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
            # gil-atomic: lifecycle ref; start/close are control-plane
            self._thread = None

    def status(self) -> dict:
        with self._lock:
            pending = {
                pod: n for pod, n in self._pending.items() if n > 0
            }
            warmed = dict(self._warmed)
            queued = len(self._queue)
        return {
            "running": self._thread is not None
            and self._thread.is_alive(),
            "interval_s": self.interval_s,
            "moves_per_cycle": self.moves_per_cycle,
            "warmup_families": self.warmup_families,
            "queued": queued,
            "cold_pods": pending,
            "warmed_moves": warmed,
            "cycles": self._cycles,
        }
