"""vLLM ``OffloadingSpec`` adapter: plug the shared-storage connector
into a stock vLLM pod.

This is the product boundary the reference ships as ``llmd_fs_backend``
(kv_connectors/llmd_fs_backend/llmd_fs_backend/spec.py:36-117): a spec
class vLLM loads via ``--kv-transfer-config``::

    --kv-transfer-config '{
      "kv_connector": "OffloadingConnector",
      "kv_role": "kv_both",
      "kv_connector_extra_config": {
        "spec_name": "TPUSharedStorageOffloadingSpec",
        "spec_module_path": "llm_d_kv_cache_manager_tpu_torch.offload.vllm_spec",
        "shared_storage_path": "/mnt/files-storage/kv-cache/",
        "block_size": 256,
        "threads_per_chip": 8,
        "max_staging_memory_gb": 16
      }
    }'

vLLM is soft-imported: without it this module still imports, the layout
probe and handlers are unit-testable against duck-typed stand-ins, and
only constructing the spec inside a real vLLM process requires the real
dependency.

Worker-side KV layout discovery mirrors the reference's synthetic-shape
probe (kv_connectors/llmd_fs_backend/llmd_fs_backend/worker.py:270-346):
ask each layer's attention backend for a reference shape with sentinel
dimensions, then classify the live tensor as cross-layer
(``[L, num_blocks, ...]``), standard (``[num_blocks, ...]``), or
split-KV (``[2, num_blocks, ...]``), honoring the backend's stride
order.  File grouping follows vLLM's convention: the FIRST group of a
transfer may be partial (worker.py:100-117) — unlike the in-repo
connector, whose tail-partial deviation documents why
(offload/worker.py); here vLLM's scheduler defines the contract.

Copied from the JAX reference's ``offload/vllm_spec.py`` over the port's
own native engine, file mapper, manager and staging budget.  The public
names keep their ``TPU`` prefix, so a deployment's
``kv-transfer-config`` changes only its ``spec_module_path``, to
``llm_d_kv_cache_manager_tpu_torch.offload.vllm_spec``.  The design is
the reference's, unchanged: each store reads every view of every file
as one gather and one pageable device-to-host copy, and each load
writes one view at a time with a pageable host-to-device copy; file
bytes equal the reference's, bf16 travelling as uint16 bit patterns.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from llm_d_kv_cache_manager_tpu_torch.native.engine import (
    JobStatus,
    OffloadEngine,
)
from llm_d_kv_cache_manager_tpu_torch.offload.file_mapper import FileMapper
from llm_d_kv_cache_manager_tpu_torch.offload.manager import (
    SharedStorageOffloadManager,
)
from llm_d_kv_cache_manager_tpu_torch.offload.staging import StagingBudget
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

# drain()/wait_for() hold the router lock across engine.get_finished(),
# whose fallback/buffer locks nest inside — the one cross-component
# nesting in the offload path, declared for both KV006 halves.
# kvlint: lock-order: CompletionRouter._lock < _PythonEngine._lock
lockorder.declare_order("CompletionRouter._lock", "_PythonEngine._lock")
# kvlint: lock-order: CompletionRouter._lock < OffloadEngine._buffers_lock
lockorder.declare_order(
    "CompletionRouter._lock", "OffloadEngine._buffers_lock"
)

logger = get_logger("offload.vllm_spec")

DEFAULT_MAX_THREADS_PER_CHIP = 64
DEFAULT_MAX_STAGING_MEMORY_GB = 150

# --- soft vLLM import ------------------------------------------------------

try:  # pragma: no cover - exercised only inside a real vLLM process
    from vllm.v1.kv_offload.abstract import (
        LoadStoreSpec as _LoadStoreSpec,
    )
    from vllm.v1.kv_offload.abstract import (
        OffloadingManager as _OffloadingManager,
    )
    from vllm.v1.kv_offload.abstract import (
        PrepareStoreOutput as _PrepareStoreOutput,
    )
    from vllm.v1.kv_offload.mediums import GPULoadStoreSpec
    from vllm.v1.kv_offload.spec import OffloadingSpec as _OffloadingSpec
    from vllm.v1.kv_offload.worker.worker import (
        OffloadingHandler as _OffloadingHandler,
    )

    HAVE_VLLM = True
except ImportError:  # duck-typed stand-ins keep the module importable
    HAVE_VLLM = False

    class _LoadStoreSpec:  # type: ignore[no-redef]
        pass

    class _OffloadingManager:  # type: ignore[no-redef]
        pass

    class _OffloadingSpec:  # type: ignore[no-redef]
        def __init__(self, vllm_config, kv_cache_config) -> None:
            self.vllm_config = vllm_config
            self.kv_cache_config = kv_cache_config

    class _OffloadingHandler:  # type: ignore[no-redef]
        pass

    class GPULoadStoreSpec(_LoadStoreSpec):  # type: ignore[no-redef]
        """Stand-in carrying device block ids (vLLM's GPU medium)."""

        def __init__(self, block_ids: Iterable[int]) -> None:
            self.block_ids = list(block_ids)

        @staticmethod
        def medium() -> str:
            return "GPU"

    class _PrepareStoreOutput:  # type: ignore[no-redef]
        def __init__(
            self,
            block_hashes_to_store,
            store_spec,
            block_hashes_evicted=(),
        ) -> None:
            self.block_hashes_to_store = list(block_hashes_to_store)
            self.store_spec = store_spec
            self.block_hashes_evicted = list(block_hashes_evicted)


class TPUSharedStorageLoadStoreSpec(_LoadStoreSpec):
    """Load/store target: block-hash-named files on shared storage."""

    def __init__(self, block_hashes: Iterable[int]) -> None:
        self.block_hashes = list(block_hashes)

    def __repr__(self) -> str:  # matches reference mediums.py
        return repr(self.block_hashes)

    @staticmethod
    def medium() -> str:
        return "SHARED_STORAGE"


# --- KV tensor layout probe ------------------------------------------------

_PROBE_BLOCKS = 1234
_PROBE_BLOCK_SIZE = 16
_PROBE_HEADS = 8
_PROBE_HEAD_SIZE = 256


class KVTensorView:
    """One ``[num_blocks, ...]``-leading tensor (a layer, or one of K/V).

    ``read``/``write`` move whole kernel blocks between the device tensor
    and numpy host memory, byte-preserving (bf16 travels as uint16 bit
    patterns through torch, which cannot view bf16 as numpy directly).
    """

    def __init__(self, tensor, name: str) -> None:
        self.tensor = tensor
        self.name = name

    @property
    def block_nbytes(self) -> int:
        t = self.tensor
        if hasattr(t, "element_size"):  # torch
            return t.stride(0) * t.element_size()
        item = t.dtype.itemsize if hasattr(t.dtype, "itemsize") else 2
        return int(np.prod(t.shape[1:])) * item

    def read(self, block_ids: Sequence[int]) -> np.ndarray:
        t = self.tensor
        if hasattr(t, "detach"):  # torch tensor
            import torch

            chunk = t[list(block_ids)].detach().cpu().contiguous()
            if chunk.dtype == torch.bfloat16:
                chunk = chunk.view(torch.uint16)
            return chunk.numpy()
        if isinstance(t, np.ndarray):
            return t[list(block_ids)]
        raise TypeError(
            f"unsupported KV tensor type {type(t)!r} for layer "
            f"{self.name!r}; a KVCachePool is served by the in-repo "
            "connector (offload/spec.py), which scatters through the "
            "pool"
        )

    def write(self, block_ids: Sequence[int], data: np.ndarray) -> None:
        t = self.tensor
        if hasattr(t, "detach"):
            import torch

            host = torch.from_numpy(np.ascontiguousarray(data))
            if t.dtype == torch.bfloat16:
                host = host.view(torch.bfloat16)
            t[list(block_ids)] = host.to(t.device)
            return
        if isinstance(t, np.ndarray):
            t[list(block_ids)] = data
            return
        raise TypeError(
            f"unsupported KV tensor type {type(t)!r} for layer "
            f"{self.name!r}"
        )


def infer_kv_tensor_views(
    kv_caches: Dict[str, object],
    attn_backends: Dict[str, type],
) -> Tuple[List[KVTensorView], int]:
    """Classify each layer's KV-cache layout; return (views, kernel_bs).

    Covers the reference's three cases (worker.py:270-346): cross-layer
    tensors (extra leading layer dim), standard ``[num_blocks, ...]``,
    and split-KV ``[2, num_blocks, ...]`` (K and V become separate
    views).  A backend-provided stride order permutes the probe shape
    before the block-size dimension is located.
    """
    views: List[KVTensorView] = []
    kernel_block_size: Optional[int] = None

    for layer_name, tensor in kv_caches.items():
        shape = tuple(tensor.shape)
        backend = attn_backends[layer_name]
        test_shape = tuple(
            backend.get_kv_cache_shape(
                num_blocks=_PROBE_BLOCKS,
                block_size=_PROBE_BLOCK_SIZE,
                num_kv_heads=_PROBE_HEADS,
                head_size=_PROBE_HEAD_SIZE,
            )
        )

        split_k_and_v = False
        has_layers_dim = False
        if len(shape) != len(test_shape):
            if len(shape) != len(test_shape) + 1:
                raise ValueError(
                    f"layer {layer_name!r}: tensor rank {len(shape)} "
                    f"does not match backend shape rank {len(test_shape)}"
                    " (+1 for cross-layer)"
                )
            has_layers_dim = True
            test_shape = (80,) + test_shape  # dummy layer count
        elif test_shape[0] == _PROBE_BLOCKS:
            pass  # standard [num_blocks, ...]
        else:
            if test_shape[0] != 2 or test_shape[1] != _PROBE_BLOCKS:
                raise ValueError(
                    f"layer {layer_name!r}: unrecognized KV layout "
                    f"{test_shape} for tensor shape {shape}"
                )
            if shape[0] != 2:
                raise ValueError(
                    f"layer {layer_name!r}: backend advertises split-KV "
                    f"but tensor leading dim is {shape[0]}, not 2"
                )
            split_k_and_v = True

        if split_k_and_v:
            views.append(KVTensorView(tensor[0], f"{layer_name}.k"))
            views.append(KVTensorView(tensor[1], f"{layer_name}.v"))
        else:
            views.append(KVTensorView(tensor, layer_name))

        try:
            stride_order = tuple(
                backend.get_kv_cache_stride_order(
                    include_num_layers_dimension=has_layers_dim
                )
            )
            if len(stride_order) != len(shape):
                raise ValueError(
                    f"layer {layer_name!r}: stride order length "
                    f"{len(stride_order)} != tensor rank {len(shape)}"
                )
        except (AttributeError, NotImplementedError, TypeError):
            stride_order = tuple(range(len(shape)))
        permuted = tuple(test_shape[i] for i in stride_order)

        block_size_idx = permuted.index(_PROBE_BLOCK_SIZE)
        layer_kernel_bs = shape[block_size_idx]
        if kernel_block_size is None:
            kernel_block_size = layer_kernel_bs
        elif kernel_block_size != layer_kernel_bs:
            raise ValueError(
                f"layer {layer_name!r}: kernel block size "
                f"{layer_kernel_bs} != {kernel_block_size} of earlier "
                "layers"
            )

    if not views or kernel_block_size is None:
        raise ValueError("no KV-cache tensors to offload")
    block_strides = {view.block_nbytes for view in views}
    if len(block_strides) != 1:
        raise ValueError(
            f"KV-cache tensors disagree on per-block bytes: {block_strides}"
        )
    return views, kernel_block_size


# --- worker-side handlers --------------------------------------------------


def build_file_block_mapping(
    file_mapper: FileMapper,
    block_hashes: Sequence[int],
    block_ids: Sequence[int],
    blocks_per_file: int,
) -> Tuple[List[str], List[List[int]]]:
    """vLLM grouping convention: the FIRST group may be partial
    (reference worker.py:100-117)."""
    files: List[str] = []
    per_file: List[List[int]] = []
    first = len(block_ids) % blocks_per_file or blocks_per_file
    start, size = 0, first
    for block_hash in block_hashes:
        end = min(start + size, len(block_ids))
        files.append(file_mapper.get_file_name(block_hash))
        per_file.append(list(block_ids[start:end]))
        start += size
        size = blocks_per_file
    return files, per_file


class CompletionRouter:
    """Routes a shared engine's completions to the owning handler.

    vLLM's ``OffloadingWorker`` polls ``get_finished`` on *every*
    handler, but the engine is shared by both directions — an unfiltered
    drain would let the store handler consume a load job's completion,
    so the load's harvest-time scatter never runs (silent KV corruption)
    and its staging bytes leak.  The in-repo connector routes
    via ``owns()``/``on_finished`` (offload/spec.py) for the same
    reason; this router is the vLLM-adapter equivalent: completions not
    owned by the draining handler are buffered until their owner drains.
    """

    def __init__(self, engine: OffloadEngine) -> None:
        self.engine = engine
        self._unclaimed: Dict[int, JobStatus] = {}  # guarded-by: _lock
        self._lock = lockorder.tracked(
            threading.Lock(), "CompletionRouter._lock"
        )

    def drain(self, owned_ids) -> List[Tuple[int, JobStatus]]:
        """Harvest engine completions; return only those in ``owned_ids``."""
        with self._lock:
            for job_id, status in self.engine.get_finished():
                self._unclaimed[job_id] = status
            mine = [j for j in list(self._unclaimed) if j in owned_ids]
            return [(j, self._unclaimed.pop(j)) for j in mine]

    def wait_for(self, job_id: int) -> JobStatus:
        """Block until ``job_id`` completes, wherever it was harvested.

        Held under the router lock so a completion can never sit
        popped-from-the-engine but not-yet-buffered while a waiter looks
        for it.  vLLM drives both handlers from one worker thread, so
        the lock is uncontended in practice.
        """
        with self._lock:
            if job_id in self._unclaimed:
                return self._unclaimed.pop(job_id)
            return self.engine.wait(job_id)


class _VllmHandlerBase(_OffloadingHandler):
    """Gathers/scatters whole device blocks through the native engine.

    One engine and one staging budget are shared by both directions; the
    :class:`CompletionRouter` keys completions to the handler whose
    ``_job_bytes`` holds the job id, so each direction's ``_finish``
    (budget release, and the load path's scatter) always runs.
    """

    def __init__(
        self,
        views: List[KVTensorView],
        kernel_blocks_per_block: int,
        blocks_per_file: int,
        file_mapper: FileMapper,
        engine: OffloadEngine,
        budget: StagingBudget,
        router: CompletionRouter,
    ) -> None:
        self.views = views
        self.kernel_blocks_per_block = kernel_blocks_per_block
        self.blocks_per_file = blocks_per_file
        self.file_mapper = file_mapper
        self.engine = engine
        self.budget = budget
        # Required, never defaulted: two handlers on one engine with
        # separate routers would strand each other's completions.
        self.router = router
        self._job_bytes: Dict[int, int] = {}
        # Probe once: host dtype and per-kernel-block element count.
        probe = views[0].read([0])
        self.host_dtype = probe.dtype
        self.kernel_block_elems = int(np.prod(probe.shape[1:]))

    def _kernel_ids(self, block_ids: Sequence[int]) -> List[int]:
        k = self.kernel_blocks_per_block
        return [b * k + j for b in block_ids for j in range(k)]

    def _file_buffer_shape(self, n_blocks: int) -> Tuple[int, ...]:
        """Block-major: per device block, every view's kernel blocks
        contiguous (flattened — views may differ in trailing shape but
        agree on bytes) — head-of-file bytes are the first blocks, so
        partial files are coherent prefixes."""
        return (
            n_blocks,
            len(self.views),
            self.kernel_blocks_per_block,
            self.kernel_block_elems,
        )

    def _job_nbytes(self, per_file: Sequence[Sequence[int]]) -> int:
        """Host bytes a job's file buffers will occupy (shape-derived, so
        it can be charged to the budget BEFORE any allocation)."""
        total = sum(
            int(np.prod(self._file_buffer_shape(len(ids))))
            for ids in per_file
        )
        return total * self.host_dtype.itemsize

    def get_finished(self) -> List[Tuple[int, bool]]:
        out = []
        for job_id, status in self.router.drain(self._job_bytes):
            out.append((job_id, self._finish(job_id, status)))
        return out

    def wait(self, job_ids) -> None:
        for job_id in set(job_ids):
            self._finish(job_id, self.router.wait_for(job_id))

    def _finish(self, job_id: int, status: JobStatus) -> bool:
        nbytes = self._job_bytes.pop(job_id, 0)
        if nbytes:
            self.budget.release(nbytes)
        return status == JobStatus.SUCCEEDED


class TPUToStorageHandler(_VllmHandlerBase):
    """Device -> shared-storage (PUT)."""

    def transfer_async(self, job_id: int, spec) -> bool:
        src, dst = spec
        files, per_file = build_file_block_mapping(
            self.file_mapper,
            dst.block_hashes,
            list(src.block_ids),
            self.blocks_per_file,
        )
        nbytes = self._job_nbytes(per_file)
        # Non-blocking: releases happen when this same vLLM worker thread
        # later polls get_finished, so blocking here would deadlock the
        # serving loop.  False tells vLLM to retry the transfer later.
        if not self.budget.try_acquire(nbytes):
            return False
        buffers = []
        for ids in per_file:
            stacked = np.stack(
                [
                    view.read(self._kernel_ids(ids)).reshape(
                        len(ids),
                        self.kernel_blocks_per_block,
                        self.kernel_block_elems,
                    )
                    for view in self.views
                ],
                axis=1,
            )
            buffers.append(np.ascontiguousarray(stacked))
        self._job_bytes[job_id] = nbytes
        self.engine.store(job_id, files, buffers, skip_existing=True)
        return True


class StorageToTPUHandler(_VllmHandlerBase):
    """Shared-storage -> device (GET).

    The scatter into the live KV tensors must wait for the file bytes, so
    it happens at harvest time (``get_finished``/``wait``), keeping the
    serving step free of blocking I/O.
    """

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        # job_id -> (per-file block ids, host buffers to scatter)
        self._pending: Dict[int, Tuple[List[List[int]], List[np.ndarray]]] = {}

    def transfer_async(self, job_id: int, spec) -> bool:
        src, dst = spec
        files, per_file = build_file_block_mapping(
            self.file_mapper,
            src.block_hashes,
            list(dst.block_ids),
            self.blocks_per_file,
        )
        # Acquire BEFORE allocating (mirrors the store path): a submitter
        # blocked-out by the budget must not already hold its job's host
        # memory, or the gate no longer bounds resident bytes.  And
        # non-blocking, for the same serving-loop-deadlock reason as the
        # store path.
        nbytes = self._job_nbytes(per_file)
        if not self.budget.try_acquire(nbytes):
            return False
        buffers = [
            np.empty(self._file_buffer_shape(len(ids)), dtype=self.host_dtype)
            for ids in per_file
        ]
        self._job_bytes[job_id] = nbytes
        self._pending[job_id] = (per_file, buffers)
        self.engine.load(job_id, files, buffers)
        return True

    def _finish(self, job_id: int, status: JobStatus) -> bool:
        ok = super()._finish(job_id, status)
        pending = self._pending.pop(job_id, None)
        if pending is None or not ok:
            return ok
        per_file, buffers = pending
        for ids, buffer in zip(per_file, buffers):
            kernel_ids = self._kernel_ids(ids)
            for view_idx, view in enumerate(self.views):
                data = buffer[:, view_idx].reshape(
                    len(kernel_ids), *view.tensor.shape[1:]
                )
                view.write(kernel_ids, data)
        return ok


# --- scheduler-side manager adapter ---------------------------------------


class TPUSharedStorageOffloadingManager(_OffloadingManager):
    """vLLM ``OffloadingManager`` facade over the shared-FS manager."""

    def __init__(self, file_mapper: FileMapper) -> None:
        self._inner = SharedStorageOffloadManager(file_mapper)

    def lookup(self, block_hashes: Iterable[int]) -> int:
        return self._inner.lookup(block_hashes)

    def prepare_load(self, block_hashes: Iterable[int]):
        return TPUSharedStorageLoadStoreSpec(block_hashes)

    def touch(self, block_hashes: Iterable[int]) -> None:
        self._inner.touch(block_hashes)

    def complete_load(self, block_hashes: Iterable[int]) -> None:
        pass

    def prepare_store(self, block_hashes: Iterable[int]):
        hashes = list(block_hashes)
        return _PrepareStoreOutput(
            block_hashes_to_store=hashes,
            store_spec=TPUSharedStorageLoadStoreSpec(hashes),
            block_hashes_evicted=[],
        )

    def complete_store(
        self, block_hashes: Iterable[int], success: bool = True
    ) -> None:
        pass


# --- the spec itself -------------------------------------------------------


class TPUSharedStorageOffloadingSpec(_OffloadingSpec):
    """Drop-in ``OffloadingSpec`` for vLLM pods.

    Reference parity: kv_connectors/llmd_fs_backend/llmd_fs_backend/
    spec.py:36-117, with the CUDA staging engine replaced by the
    connector's native host-I/O engine and an in-flight staging-byte
    budget replacing the pinned-buffer thread clamp.
    """

    def __init__(self, vllm_config, kv_cache_config) -> None:
        super().__init__(vllm_config, kv_cache_config)
        self.vllm_config = vllm_config
        self.kv_cache_config = kv_cache_config

        extra = self._extra_config(vllm_config)
        self.threads_per_chip = int(
            extra.get(
                "threads_per_chip",
                extra.get("threads_per_gpu", DEFAULT_MAX_THREADS_PER_CHIP),
            )
        )
        self.shared_storage_path = extra.get(
            "shared_storage_path", "/tmp/shared-kv"
        )
        self.max_staging_memory_gb = float(
            extra.get("max_staging_memory_gb", DEFAULT_MAX_STAGING_MEMORY_GB)
        )

        self.device_block_size = int(vllm_config.cache_config.block_size)
        self.offloaded_block_size = int(
            extra.get("block_size", self.device_block_size)
        )
        if self.offloaded_block_size % self.device_block_size != 0:
            raise ValueError(
                "offloaded block_size must be a multiple of the device "
                f"block size ({self.offloaded_block_size} % "
                f"{self.device_block_size} != 0)"
            )
        self.blocks_per_file = (
            self.offloaded_block_size // self.device_block_size
        )

        parallel = vllm_config.parallel_config
        tp_size = int(getattr(parallel, "tensor_parallel_size", 1))
        pp_size = int(getattr(parallel, "pipeline_parallel_size", 1))
        pcp_size = int(
            getattr(parallel, "prefill_context_parallel_size", 1)
        )
        world = int(getattr(parallel, "world_size", tp_size * pp_size))
        if world != tp_size * pp_size * pcp_size:
            raise ValueError(
                f"world_size {world} != tp {tp_size} * pp {pp_size} * "
                f"pcp {pcp_size}"
            )

        dtype = str(vllm_config.cache_config.cache_dtype)
        if dtype in ("auto", "None"):
            dtype = str(getattr(vllm_config.model_config, "dtype", "auto"))
        dtype = dtype.replace("torch.", "")

        self.file_mapper = FileMapper(
            root_dir=self.shared_storage_path,
            model_name=vllm_config.model_config.model,
            device_block_size=self.device_block_size,
            blocks_per_file=self.blocks_per_file,
            tp_size=tp_size,
            pp_size=pp_size,
            pcp_size=pcp_size,
            rank=int(getattr(parallel, "rank", 0)),
            dtype=dtype,
        )
        self._manager: Optional[TPUSharedStorageOffloadingManager] = None
        self._handlers: Optional[
            Tuple[TPUToStorageHandler, StorageToTPUHandler]
        ] = None
        # Exact host bytes of one full file buffer, set by the handler
        # build (the staging clamp's unit; docs/configuration.md §8).
        self.file_buffer_nbytes: Optional[int] = None

    @staticmethod
    def _extra_config(vllm_config) -> dict:
        transfer = getattr(vllm_config, "kv_transfer_config", None)
        return dict(
            getattr(transfer, "kv_connector_extra_config", None) or {}
        )

    def get_manager(self) -> TPUSharedStorageOffloadingManager:
        rank = int(getattr(self.vllm_config.parallel_config, "rank", 0))
        if rank != 0:
            raise RuntimeError("scheduler-side manager runs on rank 0 only")
        if self._manager is None:
            self._manager = TPUSharedStorageOffloadingManager(
                self.file_mapper
            )
        return self._manager

    def get_handlers(self, kv_caches, attn_backends):
        """Yield (src medium, dst medium, handler) for both directions."""
        if self._handlers is None:
            self._handlers = self._build_handlers(kv_caches, attn_backends)
        store, load = self._handlers
        yield GPULoadStoreSpec, TPUSharedStorageLoadStoreSpec, store
        yield TPUSharedStorageLoadStoreSpec, GPULoadStoreSpec, load

    def _build_handlers(self, kv_caches, attn_backends):
        views, kernel_block_size = infer_kv_tensor_views(
            kv_caches, attn_backends
        )
        if self.device_block_size % kernel_block_size != 0:
            raise ValueError(
                f"device block size {self.device_block_size} is not a "
                f"multiple of kernel block size {kernel_block_size}"
            )
        kernel_per_block = self.device_block_size // kernel_block_size

        # Staging-budget sizing semantics (docs/configuration.md §8):
        # the thread clamp and the runtime budget both count the EXACT
        # host bytes of one full block-major file buffer —
        # blocks_per_file x kernel_blocks_per_block x the sum of every
        # view's per-kernel-block bytes — the same number
        # ``_job_nbytes`` charges per file at submit time (a nominal
        # per-file figure would miss K/V and the dtype's width).  Each
        # I/O thread stages at most one file buffer, so threads clamp
        # to max(1, budget // file_buffer_nbytes).
        file_bytes = (
            sum(view.block_nbytes for view in views)
            * kernel_per_block
            * self.blocks_per_file
        )
        self.file_buffer_nbytes = file_bytes
        budget_bytes = int(self.max_staging_memory_gb * (1 << 30))
        threads = min(
            self.threads_per_chip,
            os.cpu_count() or 1,
            DEFAULT_MAX_THREADS_PER_CHIP,
        )
        if file_bytes * threads > budget_bytes:
            threads = max(1, budget_bytes // file_bytes)
            logger.warning(
                "clamped I/O threads to %d: file buffer %d bytes x "
                "threads exceeds max_staging_memory_gb=%.1f",
                threads,
                file_bytes,
                self.max_staging_memory_gb,
            )
        engine = OffloadEngine(n_threads=int(threads))
        budget = StagingBudget(budget_bytes)
        router = CompletionRouter(engine)  # shared: one drain point
        common = (
            views,
            kernel_per_block,
            self.blocks_per_file,
            self.file_mapper,
            engine,
            budget,
            router,
        )
        logger.info(
            "vLLM offload handlers: %d views, kernel_bs=%d, "
            "blocks_per_file=%d, threads=%d, staging=%.1fGB",
            len(views),
            kernel_block_size,
            self.blocks_per_file,
            threads,
            self.max_staging_memory_gb,
        )
        return TPUToStorageHandler(*common), StorageToTPUHandler(*common)
