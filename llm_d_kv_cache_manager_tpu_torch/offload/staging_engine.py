"""Per-GPU host-offload staging engine: pinned lanes + slot pipeline.

The one-shot handlers (offload/worker.py) move a whole transfer as one
device gather + one copy + one engine job.  That is simple and correct,
but it serializes the two halves of every job: the copy engine idles
while the I/O pool writes files, and the I/O pool idles while the GPU
gathers.  This module is the reference's ``StorageOffloadEngine``
equivalent (SURVEY §2.2): each GPU owns a fixed set of **lanes**, each
lane a ring of reusable **staging slots** sized to one block-major file
group, and a transfer pipelines through them —

    slot N:   device gather+transpose -> side-stream copy to pinned host
    slot N-1: file read/write on the native I/O pool

— so the copy for slot N overlaps the file I/O for slot N-1, the way
the reference overlaps ``cudaMemcpyAsync`` with its NUMA-pinned I/O
threads (storage_offload.cpp:145-239).  On a CUDA pool the copy lands
file-layout bytes straight in pinned pages
(``KVCachePool.stage_gather_pinned``; the transpose happens on the
device), and the slot waits on the copy's CUDA event before it hands
the bytes to the engine.  On a CPU pool the pinned path does not exist:
the engine picks the plain path (``gather_block_major``) up front, and
asking for the pinned path there raises.  A pinned copy that fails on a
CUDA pool raises too; nothing drops quietly to the plain path.

Contract with the shared :class:`~llm_d_kv_cache_manager_tpu_torch.native.
engine.OffloadEngine`: the staging engine submits one engine **sub-job
per file group** from a reserved id range (``SUB_ID_BASE``), so
incremental submission never collides with connector-assigned job ids.
The connector's harvest loop offers every engine completion to
:meth:`claim` first; when a parent's last sub-job lands, the parent
surfaces through :meth:`pop_ready` (or :meth:`wait`) and the owning
handler finishes it exactly like a one-shot job — event emission and
RTT stamping stay in offload/worker.py, byte movement lives here.  Each
staged job is harvested through EITHER the polling path or
:meth:`wait`, never both (the engine's own contract).

Atomicity: file writes ride the engine's tmp+rename path unchanged, and
the reference layout is untouched — GPU pods, TPU pods, one-shot pods
and staged pods all share one filesystem tree.

Backpressure (watchdog-armed): slot reuse waits for that slot's
previous sub-job via ``engine.wait`` (self-draining — no external
harvest needed, so a submitter blocked here always makes progress),
and lane acquisition times out with :class:`StagingSaturated` instead
of wedging a serving thread when every lane is stuck.  The
:class:`~llm_d_kv_cache_manager_tpu_torch.offload.staging.StagingBudget`
composes safely on top: budget bytes are acquired before a lane, and
lanes free at end of submission without needing a harvest, so there is
no budget<->lane cycle.

Threads and CUDA: staged loads scatter from the lane-owner thread (slot
retirement) or the harvesting thread; ``scatter_lock`` serializes
them.  No harvest may run while another thread captures a CUDA graph
over the same pool (``llama.make_decode_step``): a CUDA call from
another thread during capture is an error.

A transfer that finds every lane busy counts once in
``offload_staging_lane_waits_total``; each staged group's gather and
copy is an ``offload.stage.dma`` span under the handler's
``offload.stage`` span, as in the JAX package.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.models.kv_cache_pool import KVCachePool
from llm_d_kv_cache_manager_tpu_torch.native.engine import (
    JobStatus,
    OffloadEngine,
)
from llm_d_kv_cache_manager_tpu_torch.obs.trace import span as obs_span
from llm_d_kv_cache_manager_tpu_torch.offload.file_mapper import FileMapper
from llm_d_kv_cache_manager_tpu_torch.utils.device import to_numpy

logger = logging.getLogger(__name__)

# Engine sub-job ids live above every connector-assigned job id — far
# outside any realistic caller range (vLLM job ids are small ints).
SUB_ID_BASE = 1 << 48

DEFAULT_LANES_PER_CHIP = 2
DEFAULT_SLOTS_PER_LANE = 2
DEFAULT_LANE_WAIT_S = 60.0


class StagingSaturated(RuntimeError):
    """Every lane stayed busy past the watchdog window — the engine is
    wedged or oversubscribed; raised instead of deadlocking a serving
    thread."""


@dataclass
class StagingConfig:
    """Lane/slot geometry for one GPU's staging engine.

    ``lanes_per_chip`` bounds concurrent pipelines per GPU (one lane
    per in-flight transfer); ``slots_per_lane`` is the pipeline depth
    (2 = classic double buffering: one slot in the device copy while the
    other is in file I/O).  ``use_pinned=None`` follows the pool:
    pinned side-stream copies on a CUDA pool, plain numpy slots on the
    CPU.  ``False`` forces the plain slots on a CUDA pool too (the same
    file bytes); ``True`` on a CPU pool raises, where the reference
    drops to the plain path without a word."""

    lanes_per_chip: int = DEFAULT_LANES_PER_CHIP
    slots_per_lane: int = DEFAULT_SLOTS_PER_LANE
    lane_wait_s: float = DEFAULT_LANE_WAIT_S
    use_pinned: Optional[bool] = None

    def __post_init__(self) -> None:
        if self.lanes_per_chip <= 0:
            raise ValueError("lanes_per_chip must be positive")
        if self.slots_per_lane <= 0:
            raise ValueError("slots_per_lane must be positive")


class _Slot:
    """One reusable staging slot: holds the host buffer (and, on the
    pinned path, the pinned tensor whose pages the buffer views) of at
    most one in-flight engine sub-job."""

    __slots__ = ("buffer", "sub_id", "pinned_ref")

    def __init__(self) -> None:
        self.buffer: Optional[np.ndarray] = None  # lazily allocated
        self.sub_id: Optional[int] = None  # outstanding occupant
        self.pinned_ref: Optional[object] = None


class _Lane:
    __slots__ = ("index", "slots", "cursor", "busy")

    def __init__(self, index: int, n_slots: int) -> None:
        self.index = index
        self.slots = [_Slot() for _ in range(n_slots)]
        self.cursor = 0
        self.busy = False  # guarded-by: StagingEngine._cond


@dataclass
class _Sub:
    """One engine sub-job (= one file group) of a staged parent."""

    parent_id: int
    status: Optional[JobStatus] = None
    waiter: bool = False  # a thread is inside engine.wait for this sub
    # Load-side scatter payload (None for stores / after scatter).
    block_ids: Optional[List[int]] = None
    buffer: Optional[np.ndarray] = None


@dataclass
class _Parent:
    direction: str  # "store" | "load"
    pending: set = field(default_factory=set)  # sub ids not yet complete
    submitted: bool = False
    failed: bool = False
    ready: bool = False
    files: int = 0
    file_nbytes: int = 0
    device_s: float = 0.0
    io_start: Optional[float] = None
    io_s: float = 0.0


# (file_hash, device_block_ids) — same shape as offload.worker's
# FileBlockGroup (redeclared: worker imports this module).
FileGroup = Tuple[int, Sequence[int]]


class StagingEngine:
    """Per-GPU pinned staging lanes over the shared native I/O pool."""

    def __init__(
        self,
        pool: KVCachePool,
        engine: OffloadEngine,
        file_mapper: FileMapper,
        blocks_per_file: int,
        config: Optional[StagingConfig] = None,
    ) -> None:
        if blocks_per_file <= 0:
            raise ValueError("blocks_per_file must be positive")
        self.pool = pool
        self.engine = engine
        self.file_mapper = file_mapper
        self.blocks_per_file = blocks_per_file
        self.config = config or StagingConfig()
        if self.config.use_pinned and not pool.pinned_host:
            raise ValueError(
                "use_pinned=True needs a CUDA pool: a CPU pool has no pinned path"
            )
        self._use_pinned = (
            pool.pinned_host if self.config.use_pinned is None else self.config.use_pinned
        )
        self._lanes = [
            _Lane(i, self.config.slots_per_lane)
            for i in range(self.config.lanes_per_chip)
        ]
        # Released around every engine call (store/load/wait) and
        # around pool scatters; only scatter_lock is a strict leaf.
        self._cond = threading.Condition()
        self._parents: Dict[int, _Parent] = {}  # guarded-by: _cond
        self._subs: Dict[int, _Sub] = {}  # guarded-by: _cond
        self._ready: List[Tuple[int, JobStatus]] = []  # guarded-by: _cond
        self._sub_ids = itertools.count(SUB_ID_BASE)
        # Serializes pool scatters: they may run from the lane-owner
        # thread (slot retirement) and the connector's harvest thread
        # concurrently.  The load handler takes it for its one-shot
        # scatters too.
        self.scatter_lock = threading.Lock()

    @property
    def uses_pinned(self) -> bool:
        """Whether the pinned side-stream copy path is active (False =
        the plain path with reusable numpy slots, CPU pools)."""
        return self._use_pinned

    def scatter_block_major(self, block_ids, group) -> None:
        """Pool scatter serialized with this engine's harvest-time
        scatters (see scatter_lock).  Handlers route their
        host-tier-hit scatters through here."""
        with self.scatter_lock:
            self.pool.scatter_block_major(block_ids, group)

    # -- geometry ---------------------------------------------------------

    def _group_shape(self, n_blocks: int) -> Tuple[int, ...]:
        c = self.pool.config
        return (
            n_blocks,
            c.num_layers,
            2,
            c.block_size,
            c.num_kv_heads,
            c.head_dim,
        )

    def _slot_buffer(self, slot: _Slot) -> np.ndarray:
        """The slot's full-group reusable buffer (lazily allocated —
        lanes sized but never used cost nothing)."""
        if slot.buffer is None:
            from llm_d_kv_cache_manager_tpu_torch.offload.worker import host_dtype

            slot.buffer = np.empty(
                self._group_shape(self.blocks_per_file),
                dtype=host_dtype(self.pool.config.dtype),
            )
        return slot.buffer

    # -- lane lifecycle ---------------------------------------------------

    def _acquire_lane(self) -> _Lane:
        deadline = time.monotonic() + self.config.lane_wait_s
        waited = False
        with self._cond:
            while True:
                for lane in self._lanes:
                    if not lane.busy:
                        lane.busy = True
                        return lane
                if not waited:
                    waited = True
                    METRICS.offload_staging_lane_waits.inc()
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise StagingSaturated(
                        f"no staging lane freed within "
                        f"{self.config.lane_wait_s:.1f}s "
                        f"({len(self._lanes)} lanes, all busy)"
                    )
                self._cond.wait(min(remaining, 1.0))

    def _release_lane(self, lane: _Lane) -> None:
        with self._cond:
            lane.busy = False
            self._cond.notify_all()

    def _acquire_lane_for(self, parent_id: int, parent: _Parent) -> _Lane:
        """Lane acquisition for a registered parent: a watchdog raise
        must not strand the parent record — the job completes as
        FAILED (harvestable by poll or wait, releasing the caller's
        budget/pending state) before the exception surfaces."""
        try:
            return self._acquire_lane()
        except BaseException:
            with self._cond:
                parent.failed = True
                parent.submitted = True
                self._check_parent_locked(parent_id, parent)
            raise

    # -- sub-job completion machinery ------------------------------------

    def claim(self, job_id: int, status: JobStatus) -> bool:
        """Offer an engine completion; True iff it was a staged sub-job
        (the connector must then NOT route the raw id to a handler)."""
        with self._cond:
            if job_id not in self._subs:
                return False
        self._finish_sub(job_id, status)
        return True

    def pop_ready(self) -> List[Tuple[int, JobStatus]]:
        """Parents whose last sub-job has landed since the last call."""
        with self._cond:
            ready, self._ready = self._ready, []
            return ready

    def wait(self, parent_id: int) -> JobStatus:
        """Block until ``parent_id`` completes; single-harvester
        contract (don't mix with the polling path for the same job)."""
        while True:
            with self._cond:
                parent = self._parents.get(parent_id)
                if parent is None:
                    return JobStatus.UNKNOWN
                for i, (pid, status) in enumerate(self._ready):
                    if pid == parent_id:
                        del self._ready[i]
                        return status
                pending = next(iter(parent.pending), None)
                if pending is None:
                    # Submission still running (or completion racing
                    # into _ready): wait for a state change.
                    self._cond.wait(0.05)
                    continue
            self._await_sub(pending)

    def _await_sub(self, sub_id: int) -> None:
        """Drive (or wait out) one sub-job's completion."""
        with self._cond:
            while True:
                sub = self._subs.get(sub_id)
                if sub is None or sub.status is not None:
                    return
                if not sub.waiter:
                    sub.waiter = True
                    break
                self._cond.wait(0.05)
        status = self.engine.wait(sub_id)
        if status == JobStatus.UNKNOWN:
            # An external harvest (connector poll) raced us and owns
            # this completion; wait for its claim() to land.
            with self._cond:
                while True:
                    sub = self._subs.get(sub_id)
                    if sub is None or sub.status is not None:
                        return
                    self._cond.wait(0.05)
        self._finish_sub(sub_id, status)

    def _finish_sub(self, sub_id: int, status: JobStatus) -> None:
        """Record one sub completion; scatters load groups (outside
        ``_cond``) and completes the parent on the last sub."""
        with self._cond:
            sub = self._subs.get(sub_id)
            if sub is None or sub.status is not None:
                return  # already finished (idempotence guard)
            scatter = None
            if (
                status == JobStatus.SUCCEEDED
                and sub.block_ids is not None
                and sub.buffer is not None
            ):
                scatter = (sub.block_ids, sub.buffer)
        if scatter is not None:
            try:
                with self.scatter_lock:
                    self.pool.scatter_block_major(*scatter)
            except Exception:
                logger.exception(
                    "staged scatter failed for sub %d", sub_id
                )
                status = JobStatus.FAILED
        with self._cond:
            # Double-check shape: the scatter must run OUTSIDE _cond,
            # and this second acquisition re-validates via pop() — a
            # racing finisher gets None and bails.
            sub = self._subs.pop(sub_id, None)  # kvlint: atomic-ok
            if sub is None:
                return
            sub.status = status
            parent = self._parents.get(sub.parent_id)
            if parent is not None:
                parent.pending.discard(sub_id)
                if status != JobStatus.SUCCEEDED:
                    parent.failed = True
                self._check_parent_locked(sub.parent_id, parent)
            self._cond.notify_all()

    def _check_parent_locked(self, parent_id: int, parent: _Parent) -> None:
        if parent.ready or not parent.submitted or parent.pending:
            return
        parent.ready = True
        if parent.io_start is not None:
            parent.io_s = time.perf_counter() - parent.io_start
        self._ready.append(
            (
                parent_id,
                JobStatus.FAILED if parent.failed else JobStatus.SUCCEEDED,
            )
        )
        self._cond.notify_all()

    def _retire_slot(self, slot: _Slot) -> None:
        """Wait out the slot's previous occupant before reuse (the
        pipeline's self-draining backpressure)."""
        if slot.sub_id is None:
            return
        self._await_sub(slot.sub_id)
        slot.sub_id = None
        slot.pinned_ref = None

    def _register_parent(self, parent_id: int, direction: str) -> _Parent:
        with self._cond:
            if parent_id in self._parents:
                raise ValueError(
                    f"staged job id {parent_id} is still in flight; ids "
                    "must be unique until harvested"
                )
            parent = _Parent(direction)
            self._parents[parent_id] = parent
            return parent

    def job_stats(self, parent_id: int, pop: bool = True) -> Optional[dict]:
        """Measured splits of a completed parent: ``device_s`` (gather +
        copy wall time), ``io_s`` (first file submit -> last file
        completion), ``file_nbytes``, ``files``.  ``pop`` retires the
        record (call once, at finish)."""
        with self._cond:
            parent = self._parents.get(parent_id)
            if parent is None:
                return None
            stats = {
                "direction": parent.direction,
                "files": parent.files,
                "file_nbytes": parent.file_nbytes,
                "device_s": parent.device_s,
                "io_s": parent.io_s,
            }
            if pop:
                if not parent.ready:
                    # An unharvested parent must survive until its
                    # completion surfaces; popping early would strand
                    # sub completions against a missing record.
                    stats["incomplete"] = True
                    return stats
                del self._parents[parent_id]
            return stats

    # -- store pipeline ---------------------------------------------------

    def store(
        self,
        parent_id: int,
        groups: Sequence[FileGroup],
        on_group: Optional[Callable[[int, np.ndarray], None]] = None,
    ) -> None:
        """Pipelined device -> pinned-slot -> file store of block groups.

        Submits one engine file job per group through the acquired
        lane's slot ring and returns once every group is submitted
        (file I/O may still be in flight).  ``on_group(file_hash,
        buffer)`` fires after each group's bytes land in host memory —
        the host-tier admission hook; the buffer is only valid during
        the callback (slots are reused), copy to retain.
        """
        parent = self._register_parent(parent_id, "store")
        if not groups:
            with self._cond:
                parent.submitted = True
                self._check_parent_locked(parent_id, parent)
            return
        lane = self._acquire_lane_for(parent_id, parent)
        device_s = 0.0
        try:
            for file_hash, ids in groups:
                slot = lane.slots[lane.cursor]
                lane.cursor = (lane.cursor + 1) % len(lane.slots)
                self._retire_slot(slot)
                t0 = time.perf_counter()
                # Child of the handler's offload.stage span (flat span
                # model: dotted children attribute time inside a stage).
                with obs_span(
                    "offload.stage.dma", parent="offload.stage"
                ) as span:
                    host = self._stage_store_group(slot, list(ids))
                    span.set_attr("blocks", len(ids))
                device_s += time.perf_counter() - t0
                if on_group is not None:
                    on_group(file_hash, host)
                sub_id = next(self._sub_ids)
                path = self.file_mapper.get_file_name(file_hash)
                with self._cond:
                    parent.pending.add(sub_id)
                    parent.files += 1
                    parent.file_nbytes += host.nbytes
                    if parent.io_start is None:
                        parent.io_start = time.perf_counter()
                    self._subs[sub_id] = _Sub(parent_id=parent_id)
                slot.sub_id = sub_id
                # While the I/O pool writes this file, the next loop
                # iteration's gather+copy proceeds — the overlap.
                self.engine.store(sub_id, [path], [host], skip_existing=True)
        except BaseException:
            with self._cond:
                parent.failed = True
            raise
        finally:
            with self._cond:
                parent.device_s = device_s
                parent.submitted = True
                self._check_parent_locked(parent_id, parent)
            self._release_lane(lane)

    def _stage_store_group(
        self, slot: _Slot, ids: List[int]
    ) -> np.ndarray:
        """Stage one group's bytes for its file write.  The store side
        produces a FRESH host array per group either way; the slot only
        tracks its lifetime — slot retirement still bounds in-flight
        group buffers per lane to ``slots_per_lane``, without a
        redundant copy into a reusable buffer (the preallocated slot
        buffer serves the load side)."""
        if self._use_pinned:
            pinned, event = self.pool.stage_gather_pinned(ids)
            # The copy runs on a side stream: its bytes are in the
            # pinned pages only once the event has fired.  Handing the
            # engine the view any earlier would write zeros or stale
            # bytes to the file.
            event.synchronize()
            # The numpy view aliases the pinned pages: keep the tensor
            # alive until the file write is harvested (slot retirement).
            slot.pinned_ref = pinned
            return to_numpy(pinned)
        host = self.pool.gather_block_major(ids)
        slot.pinned_ref = host
        return host

    # -- load pipeline ----------------------------------------------------

    def load(self, parent_id: int, groups: Sequence[FileGroup]) -> None:
        """Pipelined file -> slot -> device load; each group scatters
        into the pool as soon as its file read lands (slot retirement
        or harvest), so the upload for group N overlaps the read for
        group N+1.  Zero-group jobs still surface through
        ``pop_ready``/``wait`` (parity with ``engine.load``)."""
        parent = self._register_parent(parent_id, "load")
        if not groups:
            with self._cond:
                parent.submitted = True
                self._check_parent_locked(parent_id, parent)
            return
        lane = self._acquire_lane_for(parent_id, parent)
        try:
            for file_hash, ids in groups:
                slot = lane.slots[lane.cursor]
                lane.cursor = (lane.cursor + 1) % len(lane.slots)
                self._retire_slot(slot)
                view = self._slot_buffer(slot)[: len(ids)]
                sub_id = next(self._sub_ids)
                path = self.file_mapper.get_file_name(file_hash)
                with self._cond:
                    parent.pending.add(sub_id)
                    parent.files += 1
                    parent.file_nbytes += view.nbytes
                    if parent.io_start is None:
                        parent.io_start = time.perf_counter()
                    self._subs[sub_id] = _Sub(
                        parent_id=parent_id,
                        block_ids=list(ids),
                        buffer=view,
                    )
                slot.sub_id = sub_id
                self.engine.load(sub_id, [path], [view])
        except BaseException:
            with self._cond:
                parent.failed = True
            raise
        finally:
            with self._cond:
                parent.submitted = True
                self._check_parent_locked(parent_id, parent)
            self._release_lane(lane)

    # -- status -----------------------------------------------------------

    def stats(self) -> dict:
        with self._cond:
            return {
                "lanes": len(self._lanes),
                "slots_per_lane": self.config.slots_per_lane,
                "use_pinned": self._use_pinned,
                "busy_lanes": sum(1 for lane in self._lanes if lane.busy),
                "in_flight_parents": len(self._parents),
                "in_flight_subs": len(self._subs),
            }
