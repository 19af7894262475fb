"""Staging-backed demotion target: demotion cycles move REAL bytes.

:class:`~llm_d_kv_cache_manager_tpu_torch.tiering.demotion.PodTierState`
models residency — its demotions flip a tier tag and publish events.
This target makes the demotion state machine a data plane:

* ``hbm -> host``: the group's blocks are gathered from the GPU pool
  (``KVCachePool.gather_block_major``: a device gather and transpose
  into the file's block-major layout, then one copy to the host) and
  admitted into the
  :class:`~llm_d_kv_cache_manager_tpu_torch.offload.host_tier.HostTierCache`
  **before** the ``host``-medium event publishes;
* ``host -> shared_storage``: the cached group is written to its
  block-hash file synchronously on the demotion thread (the engine's
  atomic tmp+rename primitive, :func:`~llm_d_kv_cache_manager_tpu_torch.
  native.engine.store_file`) and the write **completes** before the
  ``shared_storage`` event publishes — the index never advertises a
  tier that does not hold the bytes yet.  The write deliberately does
  NOT ride the shared async engine: its completion stream is drained
  by the connector's ``get_finished`` poll, which would race the
  demotion thread's harvest.

Keying contract: ``group_key`` IS the group's offload **file hash**, so
the bytes this target pages into the host cache are served by the load
handlers' host-tier probe, and the files it writes are found by
``SharedStorageOffloadManager.lookup`` — one keyspace across the
demotion plane and the offload connector.  The bytes are those the
offload connector writes: bf16 blocks as their ``uint16`` bit patterns.

Measured write costs feed the advisor's write-side estimator
(``observe_store``) so demotion is priced from real transfers.  A failed
gather or write is logged and the transition returns False (the tier
does not advance); callers that must not go on decide from that.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from llm_d_kv_cache_manager_tpu_torch.native.engine import store_file
from llm_d_kv_cache_manager_tpu_torch.tiering.demotion import (
    HBM,
    HOST,
    SHARED_STORAGE,
    PodTierState,
)
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("tiering.staged_target")


class StagedDemotionTarget(PodTierState):
    """A :class:`PodTierState` whose transitions move group bytes.

    One per (pool, connector) pair; reuses the connector's file mapper
    and host cache so demoted bytes land exactly where the
    serving-path load handlers look for them.
    """

    def __init__(
        self,
        capacity_bytes: int,
        pool,
        file_mapper,
        host_cache,
        event_sink=None,
        feed=None,
        store_rtt_observer=None,
        device_medium: str = HBM,
    ) -> None:
        if host_cache is None:
            raise ValueError(
                "StagedDemotionTarget needs a HostTierCache: without "
                "one the hbm->host rung has nowhere to put the bytes "
                "(use plain PodTierState for residency-only modeling)"
            )
        super().__init__(
            capacity_bytes,
            event_sink=event_sink,
            host_cache=host_cache,
            feed=feed,
            device_medium=device_medium,
        )
        self.pool = pool
        self.file_mapper = file_mapper
        self._store_rtt_observer = store_rtt_observer
        # group_key (= file hash) -> device block ids at registration.
        # Written only by register_pool_group before the group is
        # eligible, read by demote; per-key writes are atomic (GIL).
        self._block_ids: Dict[int, List[int]] = {}

    # -- registration -----------------------------------------------------

    def register_pool_group(
        self,
        group_key: int,
        block_ids: Sequence[int],
        engine_hashes: Sequence[int],
        token_ids: Sequence[int],
        parent_hash: Optional[int] = None,
        block_size: int = 16,
        family: Optional[int] = None,
        now: Optional[float] = None,
    ) -> None:
        """Admit a pool-resident group; bytes are derived from the
        pool's block geometry (``group_key`` must be the group's file
        hash — see module docstring)."""
        self._block_ids[group_key] = list(block_ids)
        self.register_group(
            group_key,
            engine_hashes=engine_hashes,
            token_ids=token_ids,
            nbytes=len(block_ids) * self.pool.block_nbytes,
            parent_hash=parent_hash,
            block_size=block_size,
            tier=HBM,
            family=family,
            now=now,
        )

    # -- the byte-moving transitions --------------------------------------

    def demote(self, group_key: int, to_tier: str) -> bool:
        if to_tier == HOST:
            return self._demote_to_host(group_key)
        if to_tier == SHARED_STORAGE:
            return self._demote_to_storage(group_key)
        return False

    def _demote_to_host(self, group_key: int) -> bool:
        block_ids = self._block_ids.get(group_key)
        if block_ids is None:
            return False
        try:
            # Device gather + transpose, then one copy to the host:
            # file-layout bytes in host DRAM.
            payload = self.pool.gather_block_major(block_ids)
        except Exception:
            logger.exception(
                "hbm->host gather failed for group %016x", group_key
            )
            return False
        with self._lock:
            group = self._groups.get(group_key)
            if group is None or group.tier != HBM:
                return False
            group.group = payload
        # Parent demote pages the payload into the host cache and
        # publishes store-before-remove events outside its lock.
        return super().demote(group_key, HOST)

    def _demote_to_storage(self, group_key: int) -> bool:
        with self._lock:
            group = self._groups.get(group_key)
            if group is None or group.tier != HOST:
                return False
        payload = (
            self._host_cache.get(group_key)
            if self._host_cache is not None
            else None
        )
        if payload is None:
            # Host copy already evicted: page from the pool if the
            # blocks are still registered.
            block_ids = self._block_ids.get(group_key)
            if block_ids is None:
                return False
            try:
                payload = self.pool.gather_block_major(block_ids)
            except Exception:
                logger.exception(
                    "host->storage gather failed for group %016x",
                    group_key,
                )
                return False
        t0 = time.perf_counter()
        # Synchronous atomic write on THIS thread — the shared async
        # engine's completion stream belongs to the connector's
        # get_finished poll (module docstring: harvest race).
        ok = store_file(
            self.file_mapper.get_file_name(group_key),
            np.ascontiguousarray(payload),
            skip_existing=True,
        )
        nbytes = payload.nbytes
        if not ok:
            logger.warning(
                "host->storage write failed for group %016x; "
                "tier NOT advanced",
                group_key,
            )
            return False
        if self._store_rtt_observer is not None:
            try:
                self._store_rtt_observer(
                    nbytes, time.perf_counter() - t0, None
                )
            except Exception:  # noqa: BLE001 — advisory feed only
                logger.exception("demotion store rtt observer failed")
        ok = super().demote(group_key, SHARED_STORAGE)
        if ok:
            # The group left host DRAM: free the cache entry and the
            # registration payload (the file is now the source).
            if self._host_cache is not None:
                self._host_cache.evict(group_key)
            with self._lock:
                group = self._groups.get(group_key)
                if group is not None:
                    group.group = None
        return ok
