"""The port's staging engine on the CPU: the staged path held against
the port's own one-shot path and against the JAX package's files, the
plain path chosen up front on a CPU pool, lane backpressure
(watchdog-armed), budget composition, write-side RTT stamping,
atomic files and the ``use_pinned`` key.  Ports of ``TestStagedParity``,
``TestBackpressure``, ``TestAtomicity``, ``TestStoreRtt`` and
``TestCpuFallback`` of ``tests/test_staging_engine.py``.
"""

import os
import threading
import time

import numpy as np
import pytest

from llm_d_kv_cache_manager_tpu.native.engine import JobStatus as JaxJobStatus
from llm_d_kv_cache_manager_tpu.offload import staging_engine as jax_staging_mod
from tests.helpers.torch_port import port
from tests.test_torch_offload import (
    BLOCKS_PER_FILE,
    bits,
    jax_connector,
    jax_pool,
    poll,
    port_connector,
    port_pool,
    random_blocks,
    read_tree,
)

engine_mod = port("native.engine")
staging_mod = port("offload.staging_engine")
budget_mod = port("offload.staging")
worker = port("offload.worker")
host_tier = port("offload.host_tier")
JobStatus = engine_mod.JobStatus
group_blocks_per_file = worker.group_blocks_per_file


def staging_engine(conn, pool, **config):
    return staging_mod.StagingEngine(
        pool, conn.engine, conn.file_mapper, BLOCKS_PER_FILE,
        staging_mod.StagingConfig(**config))


class TestStagedParity:
    """Staged path = one-shot path = the JAX package's files."""

    @pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
    def test_disk_bytes_bit_identical(self, tmp_path, dtype):
        block_ids = [3, 4, 7, 9, 11]  # partial tail group included
        hashes = [0xA, 0xB, 0xC]
        blocks = random_blocks(dtype, len(block_ids), seed=5)
        pool, reference = port_pool(dtype), jax_pool(dtype)
        pool.scatter_from_host(block_ids, blocks)
        reference.scatter_from_host(block_ids, blocks)
        groups = group_blocks_per_file(hashes, block_ids, BLOCKS_PER_FILE)
        oneshot = port_connector(tmp_path / "one", pool, 0)
        staged = port_connector(tmp_path / "two", pool, 2)
        jax_staged = jax_connector(tmp_path / "jax", reference, 2)
        assert staged.staging is not None and not staged.staging.uses_pinned
        for conn, status in ((oneshot, JobStatus), (staged, JobStatus), (jax_staged, JaxJobStatus)):
            conn.store_handler.transfer_async(1, groups)
            assert conn.store_handler.wait(1) == status.SUCCEEDED
            conn.close()
        one, two, jax = (read_tree(str(tmp_path / d)) for d in ("one", "two", "jax"))
        assert one.keys() == two.keys() == jax.keys() and len(one) == 3
        for rel in one:
            assert one[rel] == two[rel] == jax[rel], f"byte drift in {rel}"

    def test_scatter_bit_identical(self, tmp_path):
        block_ids = [1, 2, 5, 6, 8]
        hashes = [0x1, 0x2, 0x3]
        blocks = random_blocks("bfloat16", len(block_ids), seed=6)
        source = jax_pool()
        source.scatter_from_host(block_ids, blocks)
        writer = jax_connector(tmp_path, source)  # the JAX package's files
        writer.store_handler.transfer_async(1, group_blocks_per_file(hashes, block_ids, 2))
        assert writer.store_handler.wait(1) == JaxJobStatus.SUCCEEDED
        writer.close()
        target_ids = [20, 21, 22, 23, 24]
        loaded = {}
        for lanes in (0, 2):
            pool = port_pool()
            reader = port_connector(tmp_path, pool, lanes)
            reader.load_handler.transfer_async(2, group_blocks_per_file(hashes, target_ids, 2))
            assert reader.load_handler.wait(2) == JobStatus.SUCCEEDED
            loaded[lanes] = pool.gather_to_host(target_ids)
            reader.close()
        np.testing.assert_array_equal(loaded[0], loaded[2])
        np.testing.assert_array_equal(loaded[2], bits(blocks))

    def test_polling_path_routes_staged_parent(self, tmp_path):
        events = []
        pool = port_pool()
        pool.scatter_from_host([0, 1], random_blocks("bfloat16", 2))
        conn = port_connector(tmp_path, pool, 2,
                              event_sink=lambda h, m: events.append((tuple(h), m)))
        conn.store_handler.transfer_async(10, group_blocks_per_file([0xC], [0, 1], 2))
        # The raw engine sub-job id never surfaces — only the parent.
        assert poll(conn) == [(10, JobStatus.SUCCEEDED)]
        assert events == [((0xC,), "shared_storage")]
        conn.load_handler.transfer_async(11, group_blocks_per_file([0xC], [5, 6], 2))
        assert poll(conn) == [(11, JobStatus.SUCCEEDED)]
        np.testing.assert_array_equal(pool.gather_to_host([5, 6]), pool.gather_to_host([0, 1]))
        conn.close()

    def test_staged_load_missing_file_fails(self, tmp_path):
        conn = port_connector(tmp_path, port_pool(), 2)
        conn.load_handler.transfer_async(20, group_blocks_per_file([0xDEAD], [1, 2], 2))
        assert conn.load_handler.wait(20) == JobStatus.FAILED
        conn.close()

    def test_zero_group_staged_load_completes(self, tmp_path):
        conn = port_connector(tmp_path, port_pool(), 1)
        conn.load_handler.transfer_async(30, [])
        assert conn.load_handler.wait(30) == JobStatus.SUCCEEDED
        conn.close()

    def test_staged_host_tier_hit_skips_file(self, tmp_path):
        """A host-cached group scatters at once; only misses read files,
        and the RTT observer sees only the file bytes."""
        pool = port_pool()
        block_ids = [1, 2, 3, 4]
        pool.scatter_from_host(block_ids, random_blocks("bfloat16", 4, seed=7))
        conn = port_connector(tmp_path, pool, 0)
        conn.store_handler.transfer_async(1, group_blocks_per_file([0xA, 0xB], block_ids, 2))
        assert conn.store_handler.wait(1) == JobStatus.SUCCEEDED
        cache = host_tier.HostTierCache(1 << 20)
        assert cache.put(0xA, pool.gather_block_major([1, 2]))
        observed = []
        loader = worker.StorageToDeviceHandler(
            pool, conn.engine, conn.file_mapper, host_cache=cache,
            rtt_observer=lambda nbytes, s: observed.append((nbytes, s)),
            staging=staging_engine(conn, pool, lanes_per_chip=1))
        loader.transfer_async(5, group_blocks_per_file([0xA, 0xB], [20, 21, 22, 23], 2))
        assert loader.wait(5) == JobStatus.SUCCEEDED
        np.testing.assert_array_equal(pool.gather_to_host([20, 21, 22, 23]),
                                      pool.gather_to_host(block_ids))
        assert [n for n, _ in observed] == [2 * pool.block_nbytes] and observed[0][1] > 0
        conn.close()


class TestPathChoice:
    def test_cpu_pool_chooses_the_plain_path_up_front(self, tmp_path):
        pool = port_pool()
        conn = port_connector(tmp_path, pool, 1)
        assert not pool.pinned_host and not conn.staging.uses_pinned
        assert conn.staging.stats()["use_pinned"] is False
        conn.close()

    def test_pinned_path_on_a_cpu_pool_raises(self, tmp_path, monkeypatch):
        """A CPU pool has no pinned staging, and a staging engine that
        takes the pinned path over one raises instead of falling back."""
        pool = port_pool()
        with pytest.raises(RuntimeError, match="CPU pool"):
            pool.stage_gather_pinned([0])
        monkeypatch.setattr(type(pool), "pinned_host", property(lambda self: True))
        conn = port_connector(tmp_path, pool, 1)
        assert conn.staging.uses_pinned
        # The pinned allocation fails here; the store raises it.
        with pytest.raises(RuntimeError, match="pin"):
            conn.staging.store(1, group_blocks_per_file([0xA], [0], 2))
        assert not any(tmp_path.rglob("*.bin"))
        conn.close()

    def test_plain_slots_keep_files_byte_correct(self, tmp_path):
        """Slot reuse across groups must not corrupt a file written
        before the slot was reused."""
        pool = port_pool()
        pool.scatter_from_host([0, 1, 2], random_blocks("bfloat16", 3, seed=8))
        conn = port_connector(tmp_path, pool)
        staging = staging_engine(conn, pool, lanes_per_chip=1, slots_per_lane=1)
        staging.store(1, group_blocks_per_file([0xA, 0xB], [0, 1, 2], 2))
        assert staging.wait(1) == JobStatus.SUCCEEDED
        stats = staging.job_stats(1)
        assert stats["files"] == 2 and stats["file_nbytes"] == 3 * pool.block_nbytes
        for file_hash, ids in ((0xA, [0, 1]), (0xB, [2])):
            with open(conn.file_mapper.get_file_name(file_hash), "rb") as handle:
                assert handle.read() == pool.gather_block_major(ids).tobytes()
        conn.close()

    def test_sub_job_ids_come_from_the_reserved_range(self, tmp_path):
        pool = port_pool()
        conn = port_connector(tmp_path, pool, 1)
        seen = []
        real_store = conn.engine.store
        conn.engine.store = lambda job_id, *a, **kw: (seen.append(job_id),
                                                       real_store(job_id, *a, **kw))
        conn.store_handler.transfer_async(3, group_blocks_per_file([0x1, 0x2], [0, 1, 2], 2))
        assert conn.store_handler.wait(3) == JobStatus.SUCCEEDED
        assert len(seen) == 2 and all(s >= staging_mod.SUB_ID_BASE for s in seen)
        conn.close()


class TestBackpressure:
    def test_lane_saturation_raises_not_deadlocks(self, tmp_path):
        pool = port_pool()
        conn = port_connector(tmp_path, pool)
        staging = staging_engine(conn, pool, lanes_per_chip=1, lane_wait_s=0.2)
        lane = staging._acquire_lane()
        t0 = time.monotonic()
        with pytest.raises(staging_mod.StagingSaturated):
            staging._acquire_lane()
        assert time.monotonic() - t0 < 5
        staging._release_lane(lane)
        staging._release_lane(staging._acquire_lane())
        conn.close()

    def test_saturation_raise_completes_job_as_failed(self, tmp_path):
        """A StagingSaturated raise must not strand the job: it completes
        FAILED, the harvest releases the budget, and the id is reusable."""
        pool = port_pool()
        conn = port_connector(tmp_path, pool)
        staging = staging_engine(conn, pool, lanes_per_chip=1, lane_wait_s=0.2)
        budget = budget_mod.StagingBudget(1 << 30)
        handler = worker.DeviceToStorageHandler(
            pool, conn.engine, conn.file_mapper, staging_budget=budget, staging=staging)
        lane = staging._acquire_lane()  # wedge the only lane
        with pytest.raises(staging_mod.StagingSaturated):
            handler.transfer_async(7, group_blocks_per_file([0xE], [0, 1], 2))
        assert handler.wait(7) == JobStatus.FAILED
        assert budget.in_flight_bytes == 0
        staging._release_lane(lane)
        handler.transfer_async(7, group_blocks_per_file([0xE], [0, 1], 2))
        assert handler.wait(7) == JobStatus.SUCCEEDED
        conn.close()

    def test_concurrent_jobs_with_budget_no_deadlock(self, tmp_path):
        """Lane saturation and a tight StagingBudget together: every
        submitter completes (the test fails by timeout, not by hanging)."""
        pool = port_pool()
        conn = port_connector(tmp_path, pool)
        staging = staging_engine(conn, pool, lanes_per_chip=1, slots_per_lane=1,
                                 lane_wait_s=30.0)
        budget = budget_mod.StagingBudget(4 * pool.block_nbytes)  # ~2 jobs
        handler = worker.DeviceToStorageHandler(
            pool, conn.engine, conn.file_mapper, staging_budget=budget, staging=staging)
        pool.scatter_from_host(list(range(8)), random_blocks("bfloat16", 8, seed=9))
        errors, done = [], []

        def submit(worker_idx):
            try:
                for j in range(3):
                    job_id = worker_idx * 100 + j
                    first = (worker_idx * 3 + j) * 2 % 8
                    handler.transfer_async(job_id, group_blocks_per_file(
                        [0x500 + job_id], [first, first + 1], 2))
                    assert handler.wait(job_id) == JobStatus.SUCCEEDED
                done.append(worker_idx)
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=submit, args=(i,), name=f"submit-{i}")
                   for i in range(3)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
        assert not errors, errors
        assert not any(t.is_alive() for t in threads), "deadlocked"
        assert sorted(done) == [0, 1, 2]
        assert budget.in_flight_bytes == 0
        conn.close()

    def test_budget_admits_an_oversized_request_alone(self):
        budget = budget_mod.StagingBudget(100)
        assert budget.try_acquire(60)
        assert not budget.try_acquire(50)
        assert not budget.acquire(500, timeout=0.05)  # oversized waits for empty
        budget.release(60)
        assert budget.try_acquire(500) and budget.in_flight_bytes == 500
        budget.release(500)
        with pytest.raises(ValueError):
            budget_mod.StagingBudget(0)


class TestStoreRtt:
    @pytest.mark.parametrize("staged", [False, True], ids=["one_shot", "staged"])
    def test_store_stamps_observer(self, tmp_path, staged):
        pool = port_pool()
        conn = port_connector(tmp_path, pool)
        observed = []
        handler = worker.DeviceToStorageHandler(
            pool, conn.engine, conn.file_mapper,
            staging=staging_engine(conn, pool, lanes_per_chip=1) if staged else None,
            rtt_observer=lambda n, io_s, dev_s: observed.append((n, io_s, dev_s)))
        handler.transfer_async(1, group_blocks_per_file([0xA, 0xB], [0, 1, 2, 3], 2))
        assert handler.wait(1) == JobStatus.SUCCEEDED
        assert len(observed) == 1
        nbytes, io_s, dev_s = observed[0]
        assert nbytes == 4 * pool.block_nbytes and io_s > 0
        assert dev_s is not None and dev_s > 0
        conn.close()


class TestAtomicity:
    """A store killed between tmp-write and rename leaves no visible
    file, and lookup never trusts .tmp leftovers or torn files."""

    def test_kill_between_tmp_and_rename_leaves_no_visible_file(self, tmp_path, monkeypatch):
        engine = engine_mod._PythonEngine(n_threads=1)

        def dying_replace(src, dst):
            raise OSError("simulated kill between tmp write and rename")

        monkeypatch.setattr(os, "replace", dying_replace)
        path = str(tmp_path / "aa" / "bb" / "deadbeef.bin")
        engine.store(1, [path], [np.arange(64, dtype=np.uint8)], skip_existing=True)
        assert engine.wait(1) == JobStatus.FAILED
        assert not os.path.exists(path), "torn store became visible"
        assert [n for n in os.listdir(tmp_path / "aa" / "bb") if ".tmp." in n]
        engine.close()

    def test_lookup_rejects_tmp_leftovers(self, tmp_path):
        pool = port_pool()
        conn = port_connector(tmp_path, pool)
        manager = conn.get_manager()
        conn.store_handler.transfer_async(1, group_blocks_per_file([0x9], [0, 1], 2))
        assert conn.store_handler.wait(1) == JobStatus.SUCCEEDED
        assert manager.lookup([0x9]) == 1
        real = conn.file_mapper.get_file_name(0x9)
        with open(real, "rb") as handle:
            payload = handle.read()
        orphan = conn.file_mapper.get_file_name(0xBEEF) + ".tmp.12345.67890"
        os.makedirs(os.path.dirname(orphan), exist_ok=True)
        with open(orphan, "wb") as handle:
            handle.write(payload)
        assert manager.lookup([0xBEEF]) == 0
        assert manager.lookup([0x9, 0xBEEF]) == 1
        torn = conn.file_mapper.get_file_name(0x77)
        os.makedirs(os.path.dirname(torn), exist_ok=True)
        with open(torn, "wb") as handle:
            handle.write(payload[: len(payload) // 2])
        assert manager.lookup([0x77]) == 0
        conn.close()

    def test_native_engine_leaves_no_tmp_after_a_store(self, tmp_path):
        pool = port_pool()
        conn = port_connector(tmp_path, pool, 2)
        conn.store_handler.transfer_async(1, group_blocks_per_file([0x1, 0x2], [0, 1, 2], 2))
        assert conn.store_handler.wait(1) == JobStatus.SUCCEEDED
        names = [n for _, _, files in os.walk(tmp_path) for n in files]
        assert sorted(names) == ["0000000000000001.bin", "0000000000000002.bin"]
        conn.close()


class TestCpuFallback:
    """``StagingConfig(use_pinned=...)``, the reference's key
    (tests/test_staging_engine.py::TestCpuFallback): None follows the
    pool, False forces the plain slots with the same file bytes, True
    on a CPU pool raises where the reference drops to the plain path."""

    def test_fallback_when_pinned_unsupported(self, tmp_path):
        pool, reference = port_pool(), jax_pool()
        blocks = random_blocks("bfloat16", 3, seed=9)
        pool.scatter_from_host([0, 1, 2], blocks)
        reference.scatter_from_host([0, 1, 2], blocks)
        conn = port_connector(tmp_path / "port", pool)
        staging = staging_engine(conn, pool, lanes_per_chip=1, use_pinned=False)
        assert not staging.uses_pinned and staging.stats()["use_pinned"] is False
        staging.store(1, group_blocks_per_file([0xA, 0xB], [0, 1, 2], 2))
        assert staging.wait(1) == JobStatus.SUCCEEDED
        ref_conn = jax_connector(tmp_path / "jax", reference)
        ref_staging = jax_staging_mod.StagingEngine(
            reference, ref_conn.engine, ref_conn.file_mapper, 2,
            jax_staging_mod.StagingConfig(lanes_per_chip=1, use_pinned=False))
        ref_staging.store(1, group_blocks_per_file([0xA, 0xB], [0, 1, 2], 2))
        assert ref_staging.wait(1) == JaxJobStatus.SUCCEEDED
        conn.close()
        ref_conn.close()
        got, want = read_tree(str(tmp_path / "port")), read_tree(str(tmp_path / "jax"))
        assert got == want and len(got) == 2

    def test_auto_probe_matches_pool(self, tmp_path):
        pool = port_pool()
        conn = port_connector(tmp_path, pool)
        assert staging_engine(conn, pool).uses_pinned == pool.pinned_host is False
        conn.close()

    def test_forcing_pinned_on_a_cpu_pool_raises(self, tmp_path):
        pool = port_pool()
        conn = port_connector(tmp_path, pool)
        with pytest.raises(ValueError, match="use_pinned=True needs a CUDA pool"):
            staging_engine(conn, pool, use_pinned=True)
        conn.close()

    def test_false_forces_plain_slots_on_a_pinned_pool(self, tmp_path, monkeypatch):
        """A pool that offers the pinned path (as a CUDA pool does) with
        use_pinned=False: the engine takes the plain slots, never the
        pinned copy, and the files hold the pool's bytes."""
        pool = port_pool()
        pool.scatter_from_host([0, 1, 2], random_blocks("bfloat16", 3, seed=10))
        monkeypatch.setattr(type(pool), "pinned_host", property(lambda self: True))
        monkeypatch.setattr(type(pool), "stage_gather_pinned", lambda self, ids: pytest.fail(
            "use_pinned=False took the pinned path"))
        conn = port_connector(tmp_path, pool)
        assert staging_engine(conn, pool, use_pinned=None).uses_pinned
        staging = staging_engine(conn, pool, lanes_per_chip=1, use_pinned=False)
        assert not staging.uses_pinned
        staging.store(1, group_blocks_per_file([0xA, 0xB], [0, 1, 2], 2))
        assert staging.wait(1) == JobStatus.SUCCEEDED
        for file_hash, ids in ((0xA, [0, 1]), (0xB, [2])):
            with open(conn.file_mapper.get_file_name(file_hash), "rb") as handle:
                assert handle.read() == pool.gather_block_major(ids).tobytes()
        conn.close()
