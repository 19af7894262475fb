"""Worker-side offload handlers: GPU HBM <-> shared storage.

The store path is *one device gather + one copy to the host + async file
fanout*: the handler gathers every requested block (all layers at once)
into a single host array, slices per-file views, and hands them to the
native I/O engine — in place of the reference's per-block-per-layer
``cudaMemcpyAsync`` loop + CUDA-event fencing (storage_offload.cpp:145-239,
tensor_copier.cu:50-97).

The load path is the mirror: async file reads into host buffers, then on
completion one upload + indexed write into the cache pool.  Because the
scatter must wait for the file bytes, loads finish at harvest time
(``get_finished``/``wait``), keeping the serving step free of blocking I/O.
The scatter writes ``pool.kv`` in place, so every holder of that tensor
(the serving path, a captured decode graph) sees the loaded bytes.

File grouping: an offloaded block = ``blocks_per_file`` device blocks; the
*last* file of a transfer may carry fewer (a partial tail group).  The
reference puts the partial group first (worker.py:100-117); this package
and the JAX one deviate deliberately — prefix chains grow at the tail, and
a tail-partial split is the only one coherent with head-of-file bytes (see
layout below).

File byte layout is **block-major**: ``[k, num_layers, 2, block_size,
heads, dim]`` — each block's all-layer data contiguous, matching the
reference's staging layout (tensor_copier.cu:50-97).  This is what makes
partial groups coherent: the head ``k * block_nbytes`` bytes of a file
ARE its first k blocks, so a partial store writes a valid prefix and a
partial load reads one.  The pool's device layout is layer-major (one
gather for all layers), so the host path transposes at the boundary.
bf16 blocks travel as their ``uint16`` bit patterns (numpy has no
bfloat16), which are the same bytes the JAX package writes.

Each job counts in ``offload_jobs_total`` at harvest and, on success, in
``offload_bytes_total``; a sampled job is one ``offload.store`` or
``offload.load`` trace with an ``offload.stage`` span (submit side) and
an ``offload.io`` span (submit to harvest), as in the JAX package.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.models.kv_cache_pool import KVCachePool
from llm_d_kv_cache_manager_tpu_torch.native.engine import (
    JobStatus,
    OffloadEngine,
)
from llm_d_kv_cache_manager_tpu_torch.obs.trace import (
    TRACER,
    span as obs_span,
    use_trace,
)
from llm_d_kv_cache_manager_tpu_torch.offload.file_mapper import FileMapper

logger = logging.getLogger(__name__)


def host_dtype(name: str) -> np.dtype:
    """Numpy dtype of host staging buffers: bf16 as its ``uint16`` bit
    patterns (the pool's gathers return those, see ``utils/device.py``)."""
    if name == "bfloat16":
        return np.dtype(np.uint16)
    return np.dtype(name)


# (file_hash, device_block_ids) — one file per offloaded block group.
FileBlockGroup = Tuple[int, Sequence[int]]

# Called with (file_hashes, medium) when a store job lands, so the pod can
# advertise the new tier in its KVEvents stream.
StoreEventSink = Callable[[List[int], str], None]

# Write-side cost feed: (file_nbytes, io_seconds, device_seconds) per
# successful store job — the advisor's observe_store signature.
StoreRttObserver = Callable[[int, float, Optional[float]], None]

SHARED_STORAGE_MEDIUM = "shared_storage"
HOST_MEDIUM = "host"


def group_blocks_per_file(
    file_hashes: Sequence[int],
    block_ids: Sequence[int],
    blocks_per_file: int,
) -> List[FileBlockGroup]:
    """Group device block ids under their file hashes.

    The LAST group may be partial; earlier groups are full.  This is the
    prefix-caching shape — block chains grow at the tail, so a transfer
    covers whole groups from its start and at most one incomplete tail
    group — and it is what keeps partial files coherent with the
    head-of-file byte layout (module docstring): a partial group's k
    blocks are the first k of its group, stored at/loaded from the head
    of that group's file.  A tail-only store (resuming mid-group) cannot
    be expressed; re-store the whole group — size-aware dedupe makes the
    full rewrite upgrade the partial file.
    """
    if not file_hashes:
        return []
    remainder = len(block_ids) - (len(file_hashes) - 1) * blocks_per_file
    if remainder <= 0 or remainder > blocks_per_file:
        raise ValueError(
            f"{len(block_ids)} blocks cannot split into {len(file_hashes)} "
            f"files of up to {blocks_per_file}"
        )
    groups: List[FileBlockGroup] = []
    cursor = 0
    last = len(file_hashes) - 1
    for i, file_hash in enumerate(file_hashes):
        take = remainder if i == last else blocks_per_file
        groups.append((file_hash, list(block_ids[cursor : cursor + take])))
        cursor += take
    return groups


class _HandlerBase:
    """Shared-engine handler.

    Both handlers submit jobs to one engine, so raw ``engine.get_finished``
    interleaves their completions; each handler claims only its own job ids
    via ``owns``/``on_finished``, and the connector routes the harvest.
    Job ids must be unique across the connector.
    """

    def __init__(
        self,
        pool: KVCachePool,
        engine: OffloadEngine,
        file_mapper: FileMapper,
        staging_budget=None,
        staging=None,
    ) -> None:
        self.pool = pool
        self.engine = engine
        self.file_mapper = file_mapper
        # Optional in-flight host-byte gate (offload/staging.py); job
        # bytes are acquired before buffers exist and released at
        # completion, success or not.
        self._budget = staging_budget
        self._budget_bytes: Dict[int, int] = {}
        # Optional per-chip staging engine (offload/staging_engine.py):
        # when present, transfers pipeline through pinned lane slots
        # instead of the one-shot gather, and jobs in _staged complete
        # through the staging engine rather than raw engine ids.
        self._staging = staging
        self._staged: set = set()
        # Sampled per-job traces: job_id -> (trace, io-start stamp).
        # Submit-to-harvest, same single-submitter discipline as the
        # other per-job dicts here.
        self._job_traces: Dict[int, Tuple[object, float]] = {}
        # io-start stamps of every job, traced or not: the RTT observers
        # need real submit->harvest latencies.
        self._io_started: Dict[int, float] = {}

    def _trace_submit(self, name: str, job_id: int, n_blocks: int):
        """Sampled trace for one offload job; None when unsampled."""
        job_trace = TRACER.start_trace(name)
        if job_trace is not None:
            job_trace.set_attr("job_id", job_id)
            job_trace.set_attr("blocks", n_blocks)
        return job_trace

    def _trace_io_start(self, job_id: int, job_trace) -> None:
        now = time.perf_counter()
        self._io_started[job_id] = now
        if job_trace is not None:
            self._job_traces[job_id] = (job_trace, now)

    def _io_elapsed(self, job_id: int) -> Optional[float]:
        """Submit->harvest seconds for a completing job (None for
        unknown jobs); call exactly once per completion."""
        started = self._io_started.pop(job_id, None)
        if started is None:
            return None
        return time.perf_counter() - started

    def _trace_finish(self, job_id: int, status: JobStatus) -> None:
        """Close the job's io span at harvest.  The io span covers
        engine submit -> completion harvest: actual file/copy time plus
        any idle-until-harvest slack, which is exactly the latency the
        serving step experiences."""
        entry = self._job_traces.pop(job_id, None)
        if entry is None:
            return
        job_trace, io_start = entry
        job_trace.add_completed("offload.io", io_start)
        job_trace.set_attr("status", status.name.lower())
        job_trace.finish(
            "ok" if status == JobStatus.SUCCEEDED else "error"
        )

    def _budget_acquire(self, job_id: int, nbytes: int) -> None:
        if self._budget is not None and nbytes > 0:
            self._budget.acquire(nbytes)
            self._budget_bytes[job_id] = nbytes

    def _budget_release(self, job_id: int) -> None:
        if self._budget is not None:
            nbytes = self._budget_bytes.pop(job_id, 0)
            if nbytes:
                self._budget.release(nbytes)

    def owns(self, job_id: int) -> bool:
        raise NotImplementedError

    def on_finished(self, job_id: int, status: JobStatus) -> JobStatus:
        """Completion hook; returns the (possibly updated) status."""
        raise NotImplementedError

    def _staging_stats(self, job_id: int) -> Optional[dict]:
        """Measured splits of a completing staged job (pops the staging
        record); None for one-shot jobs."""
        if self._staging is None or job_id not in self._staged:
            return None
        self._staged.discard(job_id)
        return self._staging.job_stats(job_id)

    def wait(self, job_id: int) -> JobStatus:
        if self._staging is not None and job_id in self._staged:
            return self.on_finished(job_id, self._staging.wait(job_id))
        return self.on_finished(job_id, self.engine.wait(job_id))


class DeviceToStorageHandler(_HandlerBase):
    """Asynchronously persist device blocks to shared storage.

    With a ``host_cache``, gathered groups also stay resident in host
    DRAM (the middle tier) and a ``host``-medium event fires
    immediately — the durable ``shared_storage`` event follows when the
    file write lands."""

    def __init__(
        self,
        *args,
        event_sink: Optional[StoreEventSink] = None,
        host_cache=None,
        staging_budget=None,
        staging=None,
        rtt_observer: Optional[StoreRttObserver] = None,
    ):
        super().__init__(*args, staging_budget=staging_budget,
                         staging=staging)
        self._event_sink = event_sink
        self._host_cache = host_cache
        # Write-side cost feed: called with (file bytes, io seconds,
        # device seconds) on every successful store.
        self._rtt_observer = rtt_observer
        # job_id -> (file hashes, payload bytes, device-transfer
        # seconds) until completion.
        self._job_hashes: Dict[
            int, Tuple[List[int], int, Optional[float]]
        ] = {}

    def transfer_async(
        self, job_id: int, groups: Sequence[FileBlockGroup]
    ) -> None:
        all_ids: List[int] = []
        for _, ids in groups:
            all_ids.extend(ids)
        job_trace = self._trace_submit("offload.store", job_id, len(all_ids))
        # Gate on the staging budget before the gather allocates.
        self._budget_acquire(
            job_id, len(all_ids) * self.pool.block_nbytes
        )
        if self._staging is not None:
            self._transfer_async_staged(job_id, groups, job_trace)
            return
        device_t0 = time.perf_counter()
        with use_trace(job_trace), obs_span("offload.stage") as stage:
            # One gather + one copy to the host for the whole job.
            host = self.pool.gather_to_host(all_ids)  # [L, n, 2, bs, h, d]

            paths: List[str] = []
            buffers: List[np.ndarray] = []
            cursor = 0
            for file_hash, ids in groups:
                paths.append(self.file_mapper.get_file_name(file_hash))
                chunk = host[:, cursor : cursor + len(ids)]
                # Layer-major gather -> block-major file bytes (see
                # module docstring: head-of-file == first blocks).
                buffers.append(
                    np.ascontiguousarray(np.moveaxis(chunk, 1, 0))
                )
                cursor += len(ids)
            device_s = time.perf_counter() - device_t0
            if self._host_cache is not None:
                admitted = [
                    file_hash
                    for (file_hash, _), buffer in zip(groups, buffers)
                    if self._host_cache.put(file_hash, buffer)
                ]
                # Advertise only what the budget actually admitted.
                if admitted and self._event_sink is not None:
                    self._event_sink(admitted, HOST_MEDIUM)
            stage.set_attr("files", len(paths))
        self._job_hashes[job_id] = (
            [h for h, _ in groups],
            sum(buffer.nbytes for buffer in buffers),
            device_s,
        )
        self._trace_io_start(job_id, job_trace)
        self.engine.store(job_id, paths, buffers, skip_existing=True)

    def _transfer_async_staged(
        self, job_id: int, groups: Sequence[FileBlockGroup], job_trace
    ) -> None:
        """Staging-engine path: per-group pinned-slot pipeline; the
        host-tier admission hook copies (slots are reused)."""
        admitted: List[int] = []

        def on_group(file_hash: int, buffer: np.ndarray) -> None:
            if self._host_cache is not None and self._host_cache.put(
                file_hash, buffer.copy()
            ):
                admitted.append(file_hash)

        # Pending entry BEFORE submission so a parent that completes
        # mid-pipeline (every sub waited out) still routes here.
        self._job_hashes[job_id] = (
            [h for h, _ in groups],
            sum(len(ids) for _, ids in groups) * self.pool.block_nbytes,
            None,  # device split measured by the staging engine
        )
        self._staged.add(job_id)
        self._trace_io_start(job_id, job_trace)
        with use_trace(job_trace), obs_span("offload.stage") as stage:
            stage.set_attr("files", len(groups))
            stage.set_attr("staged", True)
            self._staging.store(job_id, groups, on_group=on_group)
        if admitted and self._event_sink is not None:
            self._event_sink(admitted, HOST_MEDIUM)

    def owns(self, job_id: int) -> bool:
        return job_id in self._job_hashes

    def on_finished(self, job_id: int, status: JobStatus) -> JobStatus:
        self._budget_release(job_id)
        self._trace_finish(job_id, status)
        io_seconds = self._io_elapsed(job_id)
        staged = self._staging_stats(job_id)
        hashes, nbytes, device_s = self._job_hashes.pop(
            job_id, (None, 0, None)
        )
        if hashes is None:
            # A completion this handler never submitted (or one already
            # harvested) points at connector routing bugs — the store
            # event for those blocks will never fire.  Never silent.
            logger.warning(
                "store completion for unknown job %d (status %s); "
                "no event will be published",
                job_id,
                status.name,
            )
        METRICS.offload_jobs.labels("store", status.name.lower()).inc()
        if status != JobStatus.SUCCEEDED:
            return status
        if staged is not None:
            # The staging engine measured the real splits: the file
            # window (first submit -> last completion) and the summed
            # gather+copy time — tighter than submit->harvest, which
            # also counts idle-until-poll slack.
            io_seconds = staged["io_s"] or io_seconds
            device_s = staged["device_s"]
        if (
            self._rtt_observer is not None
            and io_seconds is not None
            and nbytes > 0
        ):
            try:
                self._rtt_observer(nbytes, io_seconds, device_s)
            except Exception:  # noqa: BLE001 — advisory feed only
                logger.exception("store rtt observer failed")
        # Counted on success only, symmetric with the load path (bytes
        # deduped by skip_existing still transit the gather and copy).
        METRICS.offload_bytes.labels("store").inc(nbytes)
        if hashes and self._event_sink is not None:
            self._event_sink(hashes, SHARED_STORAGE_MEDIUM)
        return status


class StorageToDeviceHandler(_HandlerBase):
    """Asynchronously page blocks from shared storage into the pool.

    With a ``host_cache``, resident groups are served from host DRAM
    (memcpy, no file I/O); only the cache misses go to the engine."""

    def __init__(
        self, *args, host_cache=None, staging_budget=None,
        rtt_observer=None, staging=None,
    ):
        super().__init__(*args, staging_budget=staging_budget,
                         staging=staging)
        self._host_cache = host_cache
        # One lock over every pool scatter of this handler: the one-shot
        # scatter runs on whichever thread harvests (get_finished/wait),
        # the staged ones also on lane-owner threads.  With a staging
        # engine it is that engine's lock, so all of them serialize.
        self._scatter_lock = (
            staging.scatter_lock if staging is not None else threading.Lock()
        )
        # Compute-or-load feed: called with (payload bytes,
        # submit->harvest seconds) on every successful load that read
        # files.
        self._rtt_observer = rtt_observer
        # job_id -> (device_block_ids, host buffers awaiting scatter,
        # bytes the engine reads from files — excludes host-tier hits)
        self._pending: Dict[
            int, Tuple[List[int], List[np.ndarray], int]
        ] = {}

    def transfer_async(
        self, job_id: int, groups: Sequence[FileBlockGroup]
    ) -> None:
        c = self.pool.config
        n_blocks = sum(len(ids) for _, ids in groups)
        job_trace = self._trace_submit("offload.load", job_id, n_blocks)
        self._budget_acquire(job_id, n_blocks * self.pool.block_nbytes)
        if self._staging is not None:
            self._transfer_async_staged(job_id, groups, job_trace)
            return
        with use_trace(job_trace), obs_span("offload.stage") as stage:
            paths: List[str] = []
            buffers: List[np.ndarray] = []
            file_buffers: List[np.ndarray] = []
            all_ids: List[int] = []
            for file_hash, ids in groups:
                cached = (
                    self._host_cache.get(file_hash)
                    if self._host_cache is not None
                    else None
                )
                if cached is not None and cached.shape[0] >= len(ids):
                    # Host-tier hit: a partial request reads the group's
                    # head blocks (block-major layout invariant).
                    buffers.append(cached[: len(ids)])
                else:
                    buffer = np.empty(
                        (
                            len(ids),
                            c.num_layers,
                            2,
                            c.block_size,
                            c.num_kv_heads,
                            c.head_dim,
                        ),
                        dtype=host_dtype(c.dtype),
                    )
                    buffers.append(buffer)
                    file_buffers.append(buffer)
                    paths.append(self.file_mapper.get_file_name(file_hash))
                all_ids.extend(ids)
            stage.set_attr("files", len(paths))
            stage.set_attr("host_tier_hits", len(buffers) - len(file_buffers))
        # file_nbytes = what the engine actually reads from storage;
        # the RTT observer must see ONLY these bytes (a host-tier-hit-
        # heavy job pairs a near-zero io time with its full payload,
        # which would collapse a per-byte cost estimate).
        file_nbytes = sum(buffer.nbytes for buffer in file_buffers)
        self._pending[job_id] = (all_ids, buffers, file_nbytes)
        self._trace_io_start(job_id, job_trace)
        # Zero-file jobs still register so get_finished reports them.
        self.engine.load(job_id, paths, file_buffers)

    def _transfer_async_staged(
        self, job_id: int, groups: Sequence[FileBlockGroup], job_trace
    ) -> None:
        """Staging-engine path: host-tier hits scatter immediately,
        file-backed groups pipeline through the lane slots (the
        staging engine scatters each as its read lands)."""
        file_groups: List[FileBlockGroup] = []
        host_hits = 0
        with use_trace(job_trace), obs_span("offload.stage") as stage:
            for file_hash, ids in groups:
                cached = (
                    self._host_cache.get(file_hash)
                    if self._host_cache is not None
                    else None
                )
                if cached is not None and cached.shape[0] >= len(ids):
                    # Host-tier hit: head blocks of the cached group
                    # (block-major layout invariant), device-bound now
                    # — serialized with the staging engine's
                    # harvest-time scatters.
                    self._staging.scatter_block_major(
                        list(ids), cached[: len(ids)]
                    )
                    host_hits += 1
                else:
                    file_groups.append((file_hash, ids))
            stage.set_attr("files", len(file_groups))
            stage.set_attr("host_tier_hits", host_hits)
            stage.set_attr("staged", True)
        file_nbytes = (
            sum(len(ids) for _, ids in file_groups)
            * self.pool.block_nbytes
        )
        # Buffers live in the staging engine's slots; the pending entry
        # carries an empty buffer list so on_finished skips the
        # one-shot concatenate+scatter (already done per group).
        self._pending[job_id] = (
            [i for _, ids in groups for i in ids],
            [],
            file_nbytes,
        )
        self._staged.add(job_id)
        self._trace_io_start(job_id, job_trace)
        self._staging.load(job_id, file_groups)

    def owns(self, job_id: int) -> bool:
        return job_id in self._pending

    def on_finished(self, job_id: int, status: JobStatus) -> JobStatus:
        self._budget_release(job_id)
        self._trace_finish(job_id, status)
        io_seconds = self._io_elapsed(job_id)
        staged = self._staging_stats(job_id)
        pending = self._pending.pop(job_id, None)
        METRICS.offload_jobs.labels("load", status.name.lower()).inc()
        if pending is None:
            # An unknown load completion means the scatter for those
            # blocks never runs — the pool is silently missing data the
            # caller believes was paged in.  Never silent.
            logger.warning(
                "load completion for unknown job %d (status %s); "
                "scatter skipped",
                job_id,
                status.name,
            )
            return status
        if status != JobStatus.SUCCEEDED:
            return status
        block_ids, buffers, file_nbytes = pending
        METRICS.offload_bytes.labels("load").inc(
            len(block_ids) * self.pool.block_nbytes
            if staged is not None
            else sum(buffer.nbytes for buffer in buffers)
        )
        if staged is not None:
            # The staging engine measured the file window directly —
            # tighter than submit->harvest (no idle-until-poll slack).
            io_seconds = staged["io_s"] or io_seconds
        if (
            self._rtt_observer is not None
            and io_seconds is not None
            and file_nbytes > 0
        ):
            # Only real file I/O informs the readback cost model: a
            # host-tier-served job's near-zero io time says nothing
            # about storage bandwidth.
            try:
                self._rtt_observer(file_nbytes, io_seconds)
            except Exception:  # noqa: BLE001 — advisory feed only
                logger.exception("rtt observer failed")
        if staged is None and buffers:
            host = np.concatenate(
                [np.moveaxis(b, 0, 1) for b in buffers], axis=1
            )
            with self._scatter_lock:
                self.pool.scatter_from_host(block_ids, host)
        # Staged groups were scattered as each file read landed.
        return status
