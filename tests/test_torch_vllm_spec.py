"""The port's vLLM ``OffloadingSpec`` adapter (``offload/vllm_spec.py``)
beside the JAX package's, on the CPU.

Every case of the reference's ``tests/test_vllm_spec.py`` runs on both
packages (``m`` is either one's names), through the same duck-typed
stand-ins for vLLM's config objects and attention backends: layout
inference (standard, split-KV, cross-layer, stride order), spec
construction, round trips, completion routing on the shared engine and
the staging budget's backpressure.  Then the packages against each
other: from the same numpy and torch-CPU tensors (float32 and bf16) both
write byte-identical files, each loads the other's, and a split-KV
layout writes the same bytes as the standard layout of the same K and V
(per block, layer by layer, K then V).
"""

import os
import threading
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.offload import staging as ref_staging
from llm_d_kv_cache_manager_tpu.offload import vllm_spec as ref_vllm_spec
from tests.helpers.torch_port import port

SIDES = ("ref", "port")


def side(name):
    if name == "ref":
        spec_mod, staging = ref_vllm_spec, ref_staging
    else:
        spec_mod, staging = port("offload.vllm_spec"), port("offload.staging")
    return SimpleNamespace(
        side=name, vllm_spec=spec_mod, StagingBudget=staging.StagingBudget,
        GPULoadStoreSpec=spec_mod.GPULoadStoreSpec,
        TPUSharedStorageLoadStoreSpec=spec_mod.TPUSharedStorageLoadStoreSpec,
        TPUSharedStorageOffloadingSpec=spec_mod.TPUSharedStorageOffloadingSpec,
        infer_kv_tensor_views=spec_mod.infer_kv_tensor_views)


@pytest.fixture(params=SIDES)
def m(request):
    return side(request.param)


# --- vLLM config stand-ins -------------------------------------------------


@dataclass
class CacheConfig:
    block_size: int = 16
    cache_dtype: str = "auto"


@dataclass
class ModelConfig:
    model: str = "test/model"
    dtype: str = "float32"


@dataclass
class ParallelConfig:
    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    prefill_context_parallel_size: int = 1
    rank: int = 0

    @property
    def world_size(self) -> int:
        return (
            self.tensor_parallel_size
            * self.pipeline_parallel_size
            * self.prefill_context_parallel_size
        )


@dataclass
class KVTransferConfig:
    kv_connector_extra_config: dict = field(default_factory=dict)


@dataclass
class VllmConfig:
    cache_config: CacheConfig = field(default_factory=CacheConfig)
    model_config: ModelConfig = field(default_factory=ModelConfig)
    parallel_config: ParallelConfig = field(default_factory=ParallelConfig)
    kv_transfer_config: KVTransferConfig = field(
        default_factory=KVTransferConfig
    )


# --- attention-backend stand-ins ------------------------------------------


class StandardBackend:
    """vLLM FlashAttention-style: (num_blocks, block_size, heads, head)."""

    @staticmethod
    def get_kv_cache_shape(num_blocks, block_size, num_kv_heads, head_size):
        return (num_blocks, block_size, num_kv_heads, head_size)


class SplitKVBackend:
    """(2, num_blocks, heads, block_size, head_size) — K/V split."""

    @staticmethod
    def get_kv_cache_shape(num_blocks, block_size, num_kv_heads, head_size):
        return (2, num_blocks, num_kv_heads, block_size, head_size)


class CrossLayerBackend(StandardBackend):
    """Per-layer shape; the live tensor carries an extra layer dimension
    and its stride order puts num_blocks ahead of the layer stack
    (physical layout ``(num_blocks, L, block_size, heads, head)``)."""

    @staticmethod
    def get_kv_cache_stride_order(include_num_layers_dimension=False):
        if include_num_layers_dimension:
            return (1, 0, 2, 3, 4)
        return (0, 1, 2, 3)


class StrideOrderBackend:
    """Backend whose canonical order permutes block_size elsewhere."""

    @staticmethod
    def get_kv_cache_shape(num_blocks, block_size, num_kv_heads, head_size):
        return (num_blocks, num_kv_heads, block_size, head_size)

    @staticmethod
    def get_kv_cache_stride_order(include_num_layers_dimension=False):
        assert not include_num_layers_dimension
        return (0, 2, 1, 3)  # heads and block_size swapped in memory


def spec_for(m, tmp_path, extra=None, block_size=16):
    config = VllmConfig(
        cache_config=CacheConfig(block_size=block_size),
        kv_transfer_config=KVTransferConfig(
            {
                "shared_storage_path": str(tmp_path / "kv"),
                **(extra or {}),
            }
        ),
    )
    kv_cache_config = object()
    return m.TPUSharedStorageOffloadingSpec(config, kv_cache_config)


# --- layout inference ------------------------------------------------------


class TestLayoutInference:
    def test_standard_layout(self, m):
        caches = {
            "l0": np.zeros((8, 16, 2, 4), np.float32),
            "l1": np.zeros((8, 16, 2, 4), np.float32),
        }
        backends = {"l0": StandardBackend, "l1": StandardBackend}
        views, kernel_bs = m.infer_kv_tensor_views(caches, backends)
        assert len(views) == 2 and kernel_bs == 16

    def test_split_kv_layout_doubles_views(self, m):
        caches = {"l0": np.zeros((2, 8, 2, 16, 4), np.float32)}
        views, kernel_bs = m.infer_kv_tensor_views(
            caches, {"l0": SplitKVBackend}
        )
        assert len(views) == 2 and kernel_bs == 16
        assert views[0].name == "l0.k" and views[1].name == "l0.v"
        # Views alias the parent K/V halves.
        views[0].tensor[0, 0, 0, 0] = 7.0
        assert caches["l0"][0, 0, 0, 0, 0] == 7.0

    def test_cross_layer_layout(self, m):
        # Physical (num_blocks=8, L=4, bs=16, H=2, D=4): blocks lead, so
        # one view covers all layers of a block (reference "Case 1").
        caches = {"all": np.zeros((8, 4, 16, 2, 4), np.float32)}
        views, kernel_bs = m.infer_kv_tensor_views(
            caches, {"all": CrossLayerBackend}
        )
        assert len(views) == 1 and kernel_bs == 16

    def test_stride_order_locates_block_size(self, m):
        # Canonical (nb, heads, bs, hs); stride order (0,2,1,3) says the
        # physical layout is (nb, bs, heads, hs).
        caches = {"l0": np.zeros((8, 16, 2, 4), np.float32)}
        views, kernel_bs = m.infer_kv_tensor_views(
            caches, {"l0": StrideOrderBackend}
        )
        assert kernel_bs == 16

    def test_mismatched_kernel_block_size_rejected(self, m):
        caches = {
            "l0": np.zeros((8, 16, 2, 4), np.float32),
            "l1": np.zeros((8, 8, 2, 4), np.float32),
        }
        with pytest.raises(ValueError, match="kernel block size"):
            m.infer_kv_tensor_views(
                caches, {"l0": StandardBackend, "l1": StandardBackend}
            )

    def test_unrecognized_rank_rejected(self, m):
        caches = {"l0": np.zeros((8, 16, 2, 4, 1, 1), np.float32)}
        with pytest.raises(ValueError, match="rank"):
            m.infer_kv_tensor_views(caches, {"l0": StandardBackend})


# --- spec construction -----------------------------------------------------


class TestSpecConstruction:
    def test_importable_without_vllm(self, m):
        assert m.vllm_spec.HAVE_VLLM is False  # this image has no vLLM

    def test_reads_extra_config(self, m, tmp_path):
        spec = spec_for(m, tmp_path,
            extra={"block_size": 64, "threads_per_chip": 2,
                   "max_staging_memory_gb": 1},
        )
        assert spec.blocks_per_file == 4
        assert spec.threads_per_chip == 2
        assert spec.max_staging_memory_gb == 1
        assert "test/model" in spec.file_mapper.get_file_name(0xABC)

    def test_rejects_misaligned_block_size(self, m, tmp_path):
        with pytest.raises(ValueError, match="multiple"):
            spec_for(m, tmp_path, extra={"block_size": 24})

    def test_rejects_world_size_mismatch(self, m, tmp_path):
        config = VllmConfig(
            parallel_config=ParallelConfig(tensor_parallel_size=2)
        )
        config.parallel_config.__class__ = type(
            "P", (), {"world_size": 3, **{
                k: getattr(config.parallel_config, k)
                for k in ("tensor_parallel_size", "pipeline_parallel_size",
                          "prefill_context_parallel_size", "rank")
            }}
        )
        with pytest.raises(ValueError, match="world_size"):
            m.TPUSharedStorageOffloadingSpec(config, object())

    def test_manager_rank0_only(self, m, tmp_path):
        spec = spec_for(m, tmp_path)
        spec.vllm_config.parallel_config.rank = 1
        with pytest.raises(RuntimeError, match="rank 0"):
            spec.get_manager()


# --- end-to-end roundtrip --------------------------------------------------


def run_roundtrip(m, tmp_path, caches, backends, n_blocks, extra=None):
    spec = spec_for(m, tmp_path, extra=extra)
    handlers = list(spec.get_handlers(caches, backends))
    (_, _, store), (_, _, load) = handlers
    assert handlers[0][0] is m.GPULoadStoreSpec
    assert handlers[0][1] is m.TPUSharedStorageLoadStoreSpec

    block_ids = list(range(n_blocks))
    bpf = spec.blocks_per_file
    n_files = -(-n_blocks // bpf)
    hashes = [0x1000 + i for i in range(n_files)]

    originals = {k: np.array(v, copy=True) for k, v in caches.items()}
    assert store.transfer_async(
        1, (m.GPULoadStoreSpec(block_ids), m.TPUSharedStorageLoadStoreSpec(hashes))
    )
    store.wait({1})

    manager = spec.get_manager()
    assert manager.lookup(hashes) == len(hashes)

    for cache in caches.values():
        cache[...] = 0
    assert load.transfer_async(
        2, (m.TPUSharedStorageLoadStoreSpec(hashes), m.GPULoadStoreSpec(block_ids))
    )
    load.wait({2})
    for name, cache in caches.items():
        np.testing.assert_array_equal(cache, originals[name], err_msg=name)
    return spec


class TestRoundtrip:
    def test_standard_two_layers(self, m, tmp_path):
        rng = np.random.default_rng(0)
        caches = {
            f"l{i}": rng.standard_normal((12, 16, 2, 4)).astype(np.float32)
            for i in range(2)
        }
        backends = {f"l{i}": StandardBackend for i in range(2)}
        run_roundtrip(m, tmp_path, caches, backends, n_blocks=12,
                      extra={"block_size": 64})

    def test_split_kv_partial_first_group(self, m, tmp_path):
        rng = np.random.default_rng(1)
        caches = {
            "l0": rng.standard_normal((2, 10, 2, 16, 4)).astype(np.float32)
        }
        # 10 blocks over bpf=4 -> first file partial (2 blocks), 2 full.
        run_roundtrip(m, tmp_path, caches, {"l0": SplitKVBackend}, n_blocks=10,
                      extra={"block_size": 64})

    def test_kernel_blocks_smaller_than_device_blocks(self, m, tmp_path):
        rng = np.random.default_rng(2)
        # kernel block 8, device block 16 -> 2 kernel blocks per block.
        caches = {
            "l0": rng.standard_normal((24, 8, 2, 4)).astype(np.float32)
        }
        run_roundtrip(m, tmp_path, caches, {"l0": StandardBackend}, n_blocks=12,
                      extra={"block_size": 32})

    def test_cross_layer_roundtrip(self, m, tmp_path):
        rng = np.random.default_rng(5)
        caches = {
            "all": rng.standard_normal((12, 4, 16, 2, 4)).astype(np.float32)
        }
        run_roundtrip(m, tmp_path, caches, {"all": CrossLayerBackend},
                      n_blocks=12, extra={"block_size": 64})

    def test_torch_bfloat16_bit_exact(self, m, tmp_path):
        torch = pytest.importorskip("torch")
        caches_t = {
            "l0": torch.randn(8, 16, 2, 4, dtype=torch.float32).to(
                torch.bfloat16
            )
        }
        spec = spec_for(m, tmp_path, extra={"block_size": 64})
        (_, _, store), (_, _, load) = spec.get_handlers(
            caches_t, {"l0": StandardBackend}
        )
        original = caches_t["l0"].clone()
        ids = list(range(8))
        store.transfer_async(
            1, (m.GPULoadStoreSpec(ids), m.TPUSharedStorageLoadStoreSpec([1, 2]))
        )
        store.wait({1})
        caches_t["l0"].zero_()
        load.transfer_async(
            2, (m.TPUSharedStorageLoadStoreSpec([1, 2]), m.GPULoadStoreSpec(ids))
        )
        load.wait({2})
        assert torch.equal(caches_t["l0"], original)

    def test_get_finished_reports_and_scatters(self, m, tmp_path):
        rng = np.random.default_rng(3)
        caches = {
            "l0": rng.standard_normal((8, 16, 2, 4)).astype(np.float32)
        }
        spec = spec_for(m, tmp_path, extra={"block_size": 64})
        (_, _, store), (_, _, load) = spec.get_handlers(
            caches, {"l0": StandardBackend}
        )
        original = caches["l0"].copy()
        ids = list(range(8))
        store.transfer_async(
            7, (m.GPULoadStoreSpec(ids), m.TPUSharedStorageLoadStoreSpec([5, 6]))
        )
        done = []
        while not done:
            done = store.get_finished()
        assert done == [(7, True)]
        caches["l0"][...] = 0
        load.transfer_async(
            8, (m.TPUSharedStorageLoadStoreSpec([5, 6]), m.GPULoadStoreSpec(ids))
        )
        done = []
        while not done:
            done = load.get_finished()
        assert done == [(8, True)]
        np.testing.assert_array_equal(caches["l0"], original)

    def test_missing_file_load_fails(self, m, tmp_path):
        caches = {"l0": np.zeros((8, 16, 2, 4), np.float32)}
        spec = spec_for(m, tmp_path, extra={"block_size": 64})
        (_, _, _store), (_, _, load) = spec.get_handlers(
            caches, {"l0": StandardBackend}
        )
        load.transfer_async(
            9,
            (
                m.TPUSharedStorageLoadStoreSpec([0xDEAD]),
                m.GPULoadStoreSpec(list(range(4))),
            ),
        )
        done = []
        while not done:
            done = load.get_finished()
        assert done == [(9, False)]


# --- completion routing ----------------------------------------------------


class TestCompletionRouting:
    """vLLM polls get_finished on EVERY handler against one shared
    engine; completions must route to the owning handler (an unfiltered
    drain would let the store handler consume a load job, skipping the
    scatter and leaking budget bytes)."""

    def _handlers(self, m, tmp_path):
        rng = np.random.default_rng(11)
        caches = {
            "l0": rng.standard_normal((8, 16, 2, 4)).astype(np.float32)
        }
        spec = spec_for(m, tmp_path, extra={"block_size": 64})
        (_, _, store), (_, _, load) = spec.get_handlers(
            caches, {"l0": StandardBackend}
        )
        return caches, store, load

    def test_handlers_share_one_router(self, m, tmp_path):
        _, store, load = self._handlers(m, tmp_path)
        assert store.router is load.router
        assert store.engine is load.engine

    def test_store_poll_does_not_consume_load_completion(self, m, tmp_path):
        caches, store, load = self._handlers(m, tmp_path)
        original = caches["l0"].copy()
        ids = list(range(8))
        assert store.transfer_async(
            1, (m.GPULoadStoreSpec(ids), m.TPUSharedStorageLoadStoreSpec([1, 2]))
        )
        store.wait({1})
        caches["l0"][...] = 0
        assert load.transfer_async(
            2, (m.TPUSharedStorageLoadStoreSpec([1, 2]), m.GPULoadStoreSpec(ids))
        )
        # Poll the WRONG handler until the engine has surely finished:
        # it must never report the load job (and must not scatter).
        deadline = time.monotonic() + 10
        while load.router._unclaimed.get(2) is None:
            assert store.get_finished() == []
            if time.monotonic() > deadline:
                pytest.fail("load job never reached the router")
            time.sleep(0.001)
        # The owning handler harvests it and the scatter lands.
        done = load.get_finished()
        assert done == [(2, True)]
        np.testing.assert_array_equal(caches["l0"], original)
        assert load.budget.in_flight_bytes == 0

    def test_wait_recovers_cross_drained_completion(self, m, tmp_path):
        caches, store, load = self._handlers(m, tmp_path)
        ids = list(range(8))
        assert store.transfer_async(
            3, (m.GPULoadStoreSpec(ids), m.TPUSharedStorageLoadStoreSpec([7]))
        )
        # The load handler's poll harvests the store job into the shared
        # router buffer; store.wait must still find it.
        deadline = time.monotonic() + 10
        while 3 not in store.router._unclaimed:
            assert load.get_finished() == []
            if time.monotonic() > deadline:
                pytest.fail("store job never reached the router")
            time.sleep(0.001)
        store.wait({3})
        assert store.budget.in_flight_bytes == 0


# --- staging budget --------------------------------------------------------


class TestBudgetBackpressure:
    """transfer_async must never block: releases
    only happen on the same thread's later get_finished/wait calls, so
    a blocking acquire wedges the serving loop.  And the load path must
    acquire before allocating, or blocked submitters already hold their
    job's memory."""

    def _loaded_handlers(self, m, tmp_path, budget_bytes):
        rng = np.random.default_rng(12)
        caches = {
            "l0": rng.standard_normal((8, 16, 2, 4)).astype(np.float32)
        }
        spec = spec_for(m, tmp_path,
            extra={
                "block_size": 64,
                "max_staging_memory_gb": budget_bytes / (1 << 30),
            },
        )
        (_, _, store), (_, _, load) = spec.get_handlers(
            caches, {"l0": StandardBackend}
        )
        return caches, store, load

    def test_store_returns_false_when_budget_full(self, m, tmp_path):
        _, store, _ = self._loaded_handlers(m, tmp_path, budget_bytes=4096)
        store.budget.acquire(4096)  # saturate
        t0 = time.monotonic()
        accepted = store.transfer_async(
            1,
            (
                m.GPULoadStoreSpec(list(range(8))),
                m.TPUSharedStorageLoadStoreSpec([1, 2]),
            ),
        )
        assert accepted is False
        assert time.monotonic() - t0 < 1.0  # did not block
        assert 1 not in store._job_bytes  # no leaked accounting
        store.budget.release(4096)

    def test_load_returns_false_without_allocating(self, m, tmp_path):
        _, _, load = self._loaded_handlers(m, tmp_path, budget_bytes=4096)
        load.budget.acquire(4096)
        accepted = load.transfer_async(
            2,
            (
                m.TPUSharedStorageLoadStoreSpec([1, 2]),
                m.GPULoadStoreSpec(list(range(8))),
            ),
        )
        assert accepted is False
        assert 2 not in load._job_bytes
        assert 2 not in load._pending  # buffers were never allocated
        # in-flight is exactly the saturation we injected — the refused
        # job added nothing.
        assert load.budget.in_flight_bytes == 4096
        load.budget.release(4096)

    def test_rejected_transfer_succeeds_after_release(self, m, tmp_path):
        caches, store, load = self._loaded_handlers(
            m, tmp_path, budget_bytes=4096
        )
        original = caches["l0"].copy()
        ids = list(range(8))
        store.budget.acquire(4096)
        spec_pair = (
            m.GPULoadStoreSpec(ids),
            m.TPUSharedStorageLoadStoreSpec([1, 2]),
        )
        assert store.transfer_async(1, spec_pair) is False
        store.budget.release(4096)
        assert store.transfer_async(1, spec_pair) is True  # vLLM's retry
        store.wait({1})
        caches["l0"][...] = 0
        assert load.transfer_async(
            2, (m.TPUSharedStorageLoadStoreSpec([1, 2]), m.GPULoadStoreSpec(ids))
        )
        load.wait({2})
        np.testing.assert_array_equal(caches["l0"], original)


class TestStagingBudget:
    def test_acquire_release(self, m):
        budget = m.StagingBudget(100)
        assert budget.acquire(60)
        assert not budget.acquire(60, timeout=0.05)
        budget.release(60)
        assert budget.acquire(60)

    def test_try_acquire_never_blocks(self, m):
        budget = m.StagingBudget(100)
        assert budget.try_acquire(100)
        t0 = time.monotonic()
        assert not budget.try_acquire(1)
        assert time.monotonic() - t0 < 0.5
        budget.release(100)
        assert budget.try_acquire(1)

    def test_oversized_request_admitted_alone(self, m):
        budget = m.StagingBudget(10)
        assert budget.acquire(50)  # would deadlock if refused forever
        assert not budget.acquire(1, timeout=0.05)
        budget.release(50)
        assert budget.acquire(1)

    def test_burst_never_exceeds_budget(self, m, tmp_path):
        """A burst of stores from many threads must keep in-flight host
        bytes within max_staging_memory_gb at every sampled instant."""
        rng = np.random.default_rng(4)
        caches = {
            "l0": rng.standard_normal((64, 16, 2, 4)).astype(np.float32)
        }
        spec = spec_for(m, tmp_path,
            # Tiny budget: one file buffer is 2KB and each 4-file job
            # stages 8KB, so the 32KB budget holds ~4 jobs in flight.
            extra={"block_size": 64, "max_staging_memory_gb": 32 / (1 << 20)},
        )
        (_, _, store), _ = spec.get_handlers(caches, {"l0": StandardBackend})
        budget = store.budget
        assert budget.max_bytes == 32 * 1024

        violations = []
        stop = threading.Event()

        def sampler():
            while not stop.is_set():
                seen = budget.in_flight_bytes
                if seen > budget.max_bytes:
                    violations.append(seen)

        sampler_thread = threading.Thread(target=sampler)
        sampler_thread.start()

        def submit(job_id):
            ids = list(range(16))
            hashes = [job_id * 100 + i for i in range(4)]
            # transfer_async is non-blocking: False = budget full, retry
            # later (exactly what vLLM's worker does).
            while not store.transfer_async(
                job_id,
                (
                    m.GPULoadStoreSpec(ids),
                    m.TPUSharedStorageLoadStoreSpec(hashes),
                ),
            ):
                time.sleep(0.001)

        threads = [
            threading.Thread(target=submit, args=(j,)) for j in range(1, 9)
        ]
        for t in threads:
            t.start()
        deadline_jobs = set(range(1, 9))
        finished = set()
        while finished != deadline_jobs:
            for job_id, ok in store.get_finished():
                assert ok
                finished.add(job_id)
        for t in threads:
            t.join(timeout=10)
        stop.set()
        sampler_thread.join(timeout=5)
        assert not violations
        assert budget.in_flight_bytes == 0

    def test_thread_clamp_under_budget(self, m, tmp_path):
        """Staging-budget sizing semantics: the clamp unit is the
        EXACT block-major file buffer —
        blocks_per_file x kernel_blocks x Σ per-kernel-block view
        bytes — not a nominal per-file figure.  Here that is
        4 blocks x (16 x 2 x 4 floats) = 2048 bytes, and a budget of
        exactly one such buffer must clamp to a single I/O thread
        regardless of threads_per_chip or host core count
        (docs/configuration.md §8)."""
        caches = {
            "l0": np.zeros((64, 16, 2, 4), np.float32)
        }
        file_buffer_nbytes = 4 * (16 * 2 * 4) * 4
        spec = spec_for(m, tmp_path,
            extra={
                "block_size": 64,
                "threads_per_chip": 32,
                "max_staging_memory_gb": file_buffer_nbytes / (1 << 30),
            },
        )
        (_, _, store), _ = spec.get_handlers(caches, {"l0": StandardBackend})
        assert spec.file_buffer_nbytes == file_buffer_nbytes
        # The clamp unit and the runtime budget unit must agree: what
        # the budget charges per file at submit time is exactly one
        # clamp unit.
        assert store._job_nbytes([[0, 1, 2, 3]]) == file_buffer_nbytes
        assert store.engine.n_threads == 1


# --- the two packages together ----------------------------------------------


class PoolLayerBackend:
    """A KVCachePool layer as vLLM would see it, ``pool.kv[l]``:
    (num_blocks, 2, block_size, heads, head) — standard, K and V inside
    each block."""

    @staticmethod
    def get_kv_cache_shape(num_blocks, block_size, num_kv_heads, head_size):
        return (num_blocks, 2, block_size, num_kv_heads, head_size)


class FlashSplitBackend:
    """vLLM FlashAttention's (2, num_blocks, block_size, heads, head)."""

    @staticmethod
    def get_kv_cache_shape(num_blocks, block_size, num_kv_heads, head_size):
        return (2, num_blocks, block_size, num_kv_heads, head_size)


def read_tree(root):
    out = {}
    for folder, _, files in os.walk(root):
        for name in files:
            path = os.path.join(folder, name)
            with open(path, "rb") as handle:
                out[os.path.relpath(path, root)] = handle.read()
    return out


def store_files(m, root, caches, backends, n_blocks, hashes, extra):
    """Store blocks 0..n_blocks-1 of ``caches`` through ``m``'s spec
    under ``root``; returns the spec."""
    config = VllmConfig(kv_transfer_config=KVTransferConfig(
        {"shared_storage_path": str(root), **extra}))
    spec = m.TPUSharedStorageOffloadingSpec(config, object())
    (_, _, store), _ = spec.get_handlers(caches, backends)
    assert store.transfer_async(1, (m.GPULoadStoreSpec(list(range(n_blocks))),
                                    m.TPUSharedStorageLoadStoreSpec(hashes)))
    store.wait({1})
    return spec


def load_files(m, root, caches, backends, n_blocks, hashes, extra):
    config = VllmConfig(kv_transfer_config=KVTransferConfig(
        {"shared_storage_path": str(root), **extra}))
    spec = m.TPUSharedStorageOffloadingSpec(config, object())
    _, (_, _, load) = spec.get_handlers(caches, backends)
    assert load.transfer_async(2, (m.TPUSharedStorageLoadStoreSpec(hashes),
                                   m.GPULoadStoreSpec(list(range(n_blocks)))))
    load.wait({2})


def _numpy_standard(rng):
    return {f"l{i}": rng.standard_normal((12, 16, 2, 4)).astype(np.float32)
            for i in range(2)}, {f"l{i}": StandardBackend for i in range(2)}, 12


def _numpy_split(rng):
    return {"l0": rng.standard_normal((2, 10, 2, 16, 4)).astype(np.float32)}, {
        "l0": SplitKVBackend}, 10


def _numpy_cross_layer(rng):
    return {"all": rng.standard_normal((12, 4, 16, 2, 4)).astype(np.float32)}, {
        "all": CrossLayerBackend}, 12


def _torch_bf16_pool_layers(rng):
    return {f"l{i}": torch.from_numpy(rng.standard_normal((12, 2, 16, 2, 4)).astype(
        np.float32)).to(torch.bfloat16) for i in range(3)}, {
        f"l{i}": PoolLayerBackend for i in range(3)}, 12


def _torch_f32_flash_split(rng):
    return {f"l{i}": torch.from_numpy(rng.standard_normal((2, 10, 16, 2, 4)).astype(
        np.float32)) for i in range(2)}, {f"l{i}": FlashSplitBackend for i in range(2)}, 10


LAYOUTS = {"numpy_standard": _numpy_standard, "numpy_split_partial_first": _numpy_split,
           "numpy_cross_layer": _numpy_cross_layer,
           "torch_bf16_pool_layers": _torch_bf16_pool_layers,
           "torch_f32_flash_split_partial_first": _torch_f32_flash_split}


def _copy(caches):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v.copy() for k, v in caches.items()}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_both_packages_write_identical_files_and_read_each_others(tmp_path, layout):
    caches, backends, n_blocks = LAYOUTS[layout](np.random.default_rng(21))
    extra = {"block_size": 64}
    hashes = [0xA000 + i for i in range(-(-n_blocks // 4))]
    trees = {}
    for name in SIDES:
        store_files(side(name), tmp_path / name, _copy(caches), backends, n_blocks, hashes, extra)
        trees[name] = read_tree(tmp_path / name)
    assert len(trees["port"]) == len(hashes)
    assert trees["port"] == trees["ref"]
    # Each package loads the files the other wrote.
    for reader, writer in (("port", "ref"), ("ref", "port")):
        target = {k: v.zero_() if isinstance(v, torch.Tensor) else np.zeros_like(v)
                  for k, v in _copy(caches).items()}
        load_files(side(reader), tmp_path / writer, target, backends, n_blocks, hashes, extra)
        for key, want in caches.items():
            got = target[key]
            if isinstance(want, torch.Tensor):
                assert torch.equal(got, want), (reader, key)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{reader} {key}")


def test_split_kv_files_equal_the_pool_layouts(tmp_path):
    """The same K and V as 3 pool layers ``[N, 2, bs, H, D]`` (3 views)
    and as FlashAttention's ``[2, N, bs, H, D]`` (6 views): per block,
    layer by layer, K then V, so the files hold the same bytes."""
    rng = np.random.default_rng(5)
    pool_layers, pool_backends, n_blocks = _torch_bf16_pool_layers(rng)
    split = {k: torch.stack([v[:, 0], v[:, 1]]).contiguous() for k, v in pool_layers.items()}
    m = side("port")
    views, _ = m.infer_kv_tensor_views(split, {k: FlashSplitBackend for k in split})
    assert [v.name for v in views][:2] == ["l0.k", "l0.v"] and len(views) == 6
    assert {v.block_nbytes for v in views} == {16 * 2 * 4 * 2}
    pool_views, _ = m.infer_kv_tensor_views(pool_layers, pool_backends)
    assert {v.block_nbytes for v in pool_views} == {2 * 16 * 2 * 4 * 2}
    hashes = [0xB000 + i for i in range(3)]
    store_files(m, tmp_path / "pool", pool_layers, pool_backends, n_blocks, hashes,
                {"block_size": 64})
    store_files(m, tmp_path / "split", split, {k: FlashSplitBackend for k in split}, n_blocks,
                hashes, {"block_size": 64})
    assert read_tree(tmp_path / "pool") == read_tree(tmp_path / "split")
    assert len(read_tree(tmp_path / "pool")) == 3


def test_torch_block_stride_of_split_views():
    """``block_nbytes`` is ``stride(0) * element_size()`` for torch: the
    split views ``tensor[0]`` and ``tensor[1]`` of a ``[2, N, ...]``
    tensor keep the per-block stride of one half."""
    tensor = torch.zeros(2, 7, 16, 8, 128, dtype=torch.bfloat16)
    view_cls = side("port").vllm_spec.KVTensorView
    for half in (tensor[0], tensor[1]):
        assert view_cls(half, "h").block_nbytes == 16 * 8 * 128 * 2
    assert view_cls(tensor, "t").block_nbytes == 7 * 16 * 8 * 128 * 2
