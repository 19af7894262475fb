"""Connector assembly: config -> manager + handlers + file mapper.

Parity with the reference's ``SharedStorageOffloadingSpec`` (kv_connectors/
llmd_fs_backend/llmd_fs_backend/spec.py:36-117): reads the connector
config, validates the offloaded-block geometry (offloaded block size must
be a whole multiple of the device block size), builds the FileMapper keyed
by model/geometry/mesh-axes/rank/dtype, and hands the scheduler a manager
(rank 0 only) and the workers their transfer handlers.

The names ``TPUOffloadSpec``/``TPUOffloadConnector`` are the JAX
package's, kept so a reader finds the counterpart; here the pool is a
``KVCachePool`` on one GPU (or the CPU, for tests).  On a CUDA pool the
connector always runs the native I/O engine and, with staging lanes, the
pinned side-stream copies.  ``policy_engine`` (a
``tiering.PolicyEngine``) wires predictive tiering in as the JAX
package's connector does: the host tier evicts by its predictive policy,
and every load and store completion feeds its compute-or-load advisor.
Without an engine, the same three feeds are plain constructor
arguments: ``rtt_observer`` (loads), ``store_rtt_observer`` (stores) and
``eviction_policy`` (host tier).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from llm_d_kv_cache_manager_tpu_torch.models.kv_cache_pool import KVCachePool
from llm_d_kv_cache_manager_tpu_torch.native.engine import OffloadEngine
from llm_d_kv_cache_manager_tpu_torch.offload.file_mapper import FileMapper
from llm_d_kv_cache_manager_tpu_torch.offload.host_tier import HostTierCache
from llm_d_kv_cache_manager_tpu_torch.offload.manager import (
    SharedStorageOffloadManager,
)
from llm_d_kv_cache_manager_tpu_torch.offload.staging import StagingBudget
from llm_d_kv_cache_manager_tpu_torch.offload.staging_engine import (
    DEFAULT_LANE_WAIT_S,
    DEFAULT_SLOTS_PER_LANE,
    StagingConfig,
    StagingEngine,
)
from llm_d_kv_cache_manager_tpu_torch.offload.worker import (
    DeviceToStorageHandler,
    StorageToDeviceHandler,
    StoreEventSink,
    StoreRttObserver,
)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


@dataclass
class TPUOffloadSpec:
    """Connector configuration (the ``--kv-transfer-config`` analogue)."""

    shared_storage_path: str
    model_name: str
    # Tokens per device KV block.
    device_block_size: int = 16
    # Tokens per offloaded block (one file); must be a whole multiple of
    # device_block_size.
    offloaded_block_size: int = 64
    threads_per_chip: int = 4
    numa_node: int = -1
    # Host-DRAM tier budget; 0 disables the middle tier and offload
    # goes straight to shared storage.
    host_cache_bytes: int = 0
    # Cap on in-flight host staging bytes across both transfer
    # directions (reference clamps I/O threads against the same budget,
    # llmd_fs_backend/worker.py:191-216); submissions block until
    # completions free room.
    max_staging_memory_gb: float = 150.0
    # Per-GPU staging-lane pipeline (offload/staging_engine.py).  0
    # disables (the one-shot gather path, the parity oracle); -1
    # resolves from OFFLOAD_STAGING_LANES (default 0).  slots: pipeline
    # depth per lane (-1 = OFFLOAD_STAGING_SLOTS, default 2 = double
    # buffering); lane_wait_s: saturation watchdog
    # (-1 = OFFLOAD_STAGING_WATCHDOG_S, default 60).  Explicit values
    # win over the environment.
    staging_lanes: int = -1
    staging_slots: int = -1
    staging_lane_wait_s: float = -1.0
    dtype: str = "bfloat16"
    tp_size: int = 1
    pp_size: int = 1
    pcp_size: int = 1
    rank: int = 0

    def __post_init__(self) -> None:
        if self.offloaded_block_size % self.device_block_size != 0:
            raise ValueError(
                "offloaded_block_size must be a multiple of "
                f"device_block_size ({self.offloaded_block_size} % "
                f"{self.device_block_size} != 0)"
            )
        if self.staging_lanes < 0:
            self.staging_lanes = _env_int("OFFLOAD_STAGING_LANES", 0)
        if self.staging_slots < 0:
            self.staging_slots = _env_int(
                "OFFLOAD_STAGING_SLOTS", DEFAULT_SLOTS_PER_LANE
            )
        if self.staging_lane_wait_s < 0:
            self.staging_lane_wait_s = _env_float(
                "OFFLOAD_STAGING_WATCHDOG_S", DEFAULT_LANE_WAIT_S
            )
        if self.staging_lanes < 0:
            raise ValueError(
                f"staging_lanes must be 0 (off) or positive, got "
                f"{self.staging_lanes}"
            )
        if self.staging_slots <= 0 or self.staging_lane_wait_s <= 0:
            raise ValueError(
                "staging_slots and staging_lane_wait_s must be positive, "
                f"got {self.staging_slots} and {self.staging_lane_wait_s}"
            )

    @property
    def blocks_per_file(self) -> int:
        return self.offloaded_block_size // self.device_block_size


class TPUOffloadConnector:
    """One per worker process; scheduler rank additionally gets a manager."""

    def __init__(
        self,
        spec: TPUOffloadSpec,
        pool: KVCachePool,
        event_sink: Optional[StoreEventSink] = None,
        rtt_observer: Optional[Callable[[int, float], None]] = None,
        store_rtt_observer: Optional[StoreRttObserver] = None,
        eviction_policy=None,
        policy_engine=None,
    ) -> None:
        if pool.config.block_size != spec.device_block_size:
            raise ValueError(
                f"pool block_size {pool.config.block_size} != spec "
                f"device_block_size {spec.device_block_size}; the storage "
                "layout would advertise a geometry the files don't have"
            )
        if pool.config.dtype != spec.dtype:
            raise ValueError(
                f"pool dtype {pool.config.dtype!r} != spec dtype "
                f"{spec.dtype!r}"
            )
        if type(pool.kv) is not torch.Tensor:
            # Like the reference (one engine per rank over that rank's
            # GPU tensors), each mesh rank runs its own connector over a
            # single-device pool holding its KV shard, writing under its
            # own rank_<r> path.  A tensor subclass (a DTensor spread
            # over a mesh) here would make every rank gather and persist
            # the full global array — rank-layout corruption.
            raise ValueError(
                f"pool.kv is a {type(pool.kv).__name__}, not one plain "
                "tensor on one device; run one connector per mesh rank "
                "over that rank's local pool and set spec.rank accordingly"
            )
        self.spec = spec
        self.pool = pool
        self.file_mapper = FileMapper(
            root_dir=spec.shared_storage_path,
            model_name=spec.model_name,
            device_block_size=spec.device_block_size,
            blocks_per_file=spec.blocks_per_file,
            tp_size=spec.tp_size,
            pp_size=spec.pp_size,
            pcp_size=spec.pcp_size,
            rank=spec.rank,
            dtype=spec.dtype,
        )
        self.engine = OffloadEngine(
            n_threads=spec.threads_per_chip, numa_node=spec.numa_node
        )
        # Predictive tiering (tiering/engine.py): when attached, the
        # host tier evicts by predicted-next-use x byte-cost and every
        # load and store completion feeds the compute-or-load advisor.
        self.policy_engine = policy_engine
        if policy_engine is not None:
            if (rtt_observer, store_rtt_observer, eviction_policy) != (
                None, None, None
            ):
                raise ValueError(
                    "pass policy_engine or the plain feeds (rtt_observer, "
                    "store_rtt_observer, eviction_policy), not both"
                )
            eviction_policy = policy_engine.eviction_policy(
                backend="host_tier"
            )
            advisor = policy_engine.advisor
            rtt_observer = advisor.observe_load
            store_rtt_observer = advisor.observe_store
            if advisor.config.bytes_per_block <= 0:
                advisor.config.bytes_per_block = pool.block_nbytes
        self.staging_budget = StagingBudget(
            int(spec.max_staging_memory_gb * (1 << 30))
        )
        # Per-GPU staging lanes: pinned-slot pipeline overlapping the
        # device copy with file I/O.  Off by default — the one-shot
        # path is the parity oracle.
        self.staging: Optional[StagingEngine] = None
        if spec.staging_lanes > 0:
            self.staging = StagingEngine(
                pool,
                self.engine,
                self.file_mapper,
                spec.blocks_per_file,
                StagingConfig(
                    lanes_per_chip=spec.staging_lanes,
                    slots_per_lane=spec.staging_slots,
                    lane_wait_s=spec.staging_lane_wait_s,
                ),
            )
        self.host_cache: Optional[HostTierCache] = None
        if spec.host_cache_bytes > 0:
            self.host_cache = HostTierCache(
                spec.host_cache_bytes, eviction_policy=eviction_policy
            )
        self.store_handler = DeviceToStorageHandler(
            pool,
            self.engine,
            self.file_mapper,
            event_sink=event_sink,
            host_cache=self.host_cache,
            staging_budget=self.staging_budget,
            staging=self.staging,
            rtt_observer=store_rtt_observer,
        )
        self.load_handler = StorageToDeviceHandler(
            pool,
            self.engine,
            self.file_mapper,
            host_cache=self.host_cache,
            staging_budget=self.staging_budget,
            rtt_observer=rtt_observer,
            staging=self.staging,
        )

    def get_manager(self) -> SharedStorageOffloadManager:
        """Scheduler-side manager; call on mesh-rank 0 only."""
        return SharedStorageOffloadManager(
            self.file_mapper,
            full_file_nbytes=self.pool.block_nbytes
            * self.spec.blocks_per_file,
        )

    def get_finished(self):
        """Poll the shared engine once and route each completion to the
        handler that owns the job (store-event emission / load scatter
        happen here).  With staging enabled, engine completions are
        offered to the staging engine first — its sub-jobs never
        surface raw; the PARENT job id surfaces once its last file
        lands."""
        completions = []
        for job_id, status in self.engine.get_finished():
            if self.staging is not None and self.staging.claim(
                job_id, status
            ):
                continue  # a staged sub-job; parent surfaces below
            completions.append((job_id, status))
        if self.staging is not None:
            completions.extend(self.staging.pop_ready())
        routed = []
        for job_id, status in completions:
            for handler in (self.store_handler, self.load_handler):
                if handler.owns(job_id):
                    status = handler.on_finished(job_id, status)
                    break
            routed.append((job_id, status))
        return routed

    def close(self) -> None:
        self.engine.close()
