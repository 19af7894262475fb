"""The port's offload connector against the JAX package's, on the CPU.

The same pool contents (made from a numpy seed) go through both
connectors: file paths, block grouping, manager probes and the bytes of
every file must be identical, one-shot and staged, a partial tail group
included, and each package must load the other's files back bit for
bit.  bf16 is compared through its ``uint16`` bit patterns.  The host
tier, job routing and the in-place load are the ports of the JAX
package's own tests (``tests/test_offload.py``, ``tests/test_host_tier.py``).
"""

import os
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.metrics.collector import METRICS as JAX_METRICS
from llm_d_kv_cache_manager_tpu.models.kv_cache_pool import (
    KVCachePool as JaxPool,
    KVCachePoolConfig as JaxPoolConfig,
)
from llm_d_kv_cache_manager_tpu.offload.file_mapper import FileMapper as JaxFileMapper
from llm_d_kv_cache_manager_tpu.offload.spec import (
    TPUOffloadConnector as JaxConnector,
    TPUOffloadSpec as JaxSpec,
)
from llm_d_kv_cache_manager_tpu.offload.worker import (
    group_blocks_per_file as jax_group_blocks_per_file,
)
from llm_d_kv_cache_manager_tpu.obs.trace import TRACER as JAX_TRACER
from tests.helpers.torch_port import port

pool_mod = port("models.kv_cache_pool")
spec_mod = port("offload.spec")
worker = port("offload.worker")
mapper_mod = port("offload.file_mapper")
host_tier = port("offload.host_tier")
JobStatus = port("native.engine").JobStatus
group_blocks_per_file = worker.group_blocks_per_file

# Two small pool geometries: (layers, blocks, block_size, kv heads, head_dim).
GEOMETRY = {
    "bfloat16": (3, 32, 8, 2, 16),
    "float32": (2, 32, 4, 2, 32),
}
BLOCKS_PER_FILE = 2


def numpy_dtype(dtype):
    return np.dtype(ml_dtypes.bfloat16) if dtype == "bfloat16" else np.dtype(dtype)


def bits(array):
    """An array's bytes as comparable unsigned bit patterns."""
    array = np.asarray(array)
    return array.view(np.uint16 if array.dtype.itemsize == 2 else np.uint32)


def port_pool(dtype="bfloat16"):
    return pool_mod.KVCachePool(
        pool_mod.KVCachePoolConfig(*GEOMETRY[dtype], dtype=dtype), device="cpu"
    )


def jax_pool(dtype="bfloat16"):
    return JaxPool(JaxPoolConfig(*GEOMETRY[dtype], dtype=dtype))


def random_blocks(dtype, n, seed=0):
    """``[L, n, 2, bs, h, d]`` blocks from a numpy seed, in the host dtype
    the JAX package takes (ml_dtypes bf16, which the port reads bit for bit)."""
    layers, _, bs, heads, dim = GEOMETRY[dtype]
    rng = np.random.default_rng(seed)
    return rng.standard_normal((layers, n, 2, bs, heads, dim)).astype(numpy_dtype(dtype))


def spec_kwargs(root, dtype, **extra):
    return dict(
        shared_storage_path=str(root),
        model_name="meta-llama/Llama-3.1-8B",
        device_block_size=GEOMETRY[dtype][2],
        offloaded_block_size=GEOMETRY[dtype][2] * BLOCKS_PER_FILE,
        threads_per_chip=2,
        dtype=dtype,
        **extra,
    )


def port_connector(root, pool, staging_lanes=0, **extra):
    spec = spec_mod.TPUOffloadSpec(
        **spec_kwargs(root, pool.config.dtype, staging_lanes=staging_lanes),
    )
    return spec_mod.TPUOffloadConnector(spec, pool, **extra)


def jax_connector(root, pool, staging_lanes=0):
    spec = JaxSpec(**spec_kwargs(root, pool.config.dtype, staging_lanes=staging_lanes))
    return JaxConnector(spec, pool)


def read_tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as handle:
                out[os.path.relpath(path, root)] = handle.read()
    return out


def poll(connector, deadline_s=10.0):
    deadline = time.monotonic() + deadline_s
    finished = []
    while time.monotonic() < deadline and not finished:
        finished = connector.get_finished()
        time.sleep(0.005)
    return finished


# ------------------------------------------------------------ file mapper

GEOMETRIES = [
    dict(model_name="org/model", device_block_size=16, blocks_per_file=4,
         tp_size=2, pp_size=2, pcp_size=1, rank=3, dtype="bfloat16"),
    dict(model_name="meta-llama/Llama-3.1-8B", device_block_size=16, blocks_per_file=4),
    dict(model_name="m", device_block_size=8, blocks_per_file=1, dtype="float32"),
    dict(model_name="qwen/Qwen3-32B", device_block_size=32, blocks_per_file=8,
         tp_size=8, rank=7),
    dict(model_name="m", device_block_size=16, blocks_per_file=2, pp_size=4, pcp_size=2,
         rank=5, dtype="float16"),
]
HASHES = [0, 1, 0xABCDEF0123456789, 0xFFFFFFFFFFFFFFFF, (1 << 64) + 5, -1, -(1 << 63),
          (0x1122).to_bytes(8, "little"), bytes(range(8)), bytearray(b"\x01\x02")]


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: g["model_name"])
def test_file_mapper_paths_identical(geometry):
    """Paths match the JAX package's letter for letter (GPU and TPU pods
    share one tree), for int, bytes and negative hashes."""
    ours = mapper_mod.FileMapper("/shared", **geometry)
    theirs = JaxFileMapper("/shared", **geometry)
    assert ours.base_path == theirs.base_path
    for block_hash in HASHES:
        assert ours.get_file_name(block_hash) == theirs.get_file_name(block_hash)


def test_file_mapper_layout():
    mapper = mapper_mod.FileMapper("/shared", **GEOMETRIES[0])
    assert mapper.get_file_name(0xABCDEF0123456789) == (
        "/shared/org/model/block_size_16_blocks_per_file_4/"
        "tp_2_pp_size_2_pcp_size_1/rank_3/bfloat16/"
        "abc/de/abcdef0123456789.bin"
    )
    assert "ffffffffffffffff" in mapper.get_file_name(-1)


# ---------------------------------------------------------------- grouping

GROUPINGS = [
    ([1, 2], [10, 11, 12, 13], 2),
    ([1, 2], [11, 12, 13], 2),  # partial tail group
    ([7], [5], 4),
    ([1, 2, 3], list(range(9)), 4),
    ([], [], 4),
    ([1, 2], [1, 2, 3, 4, 5], 2),  # too many blocks
    ([1, 2, 3], [1, 2], 2),  # too few
    ([1], [], 2),
]


@pytest.mark.parametrize("hashes,ids,per_file", GROUPINGS)
def test_group_blocks_per_file_identical(hashes, ids, per_file):
    try:
        want = jax_group_blocks_per_file(hashes, ids, per_file)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            group_blocks_per_file(hashes, ids, per_file)
        assert str(got.value) == str(exc)
        return
    assert group_blocks_per_file(hashes, ids, per_file) == want


# ------------------------------------------------------------ spec checks


def test_spec_validation_matches_the_reference(tmp_path, monkeypatch):
    for cls in (spec_mod.TPUOffloadSpec, JaxSpec):
        with pytest.raises(ValueError, match="multiple of"):
            cls(shared_storage_path=str(tmp_path), model_name="m",
                device_block_size=16, offloaded_block_size=24)
    assert spec_mod.TPUOffloadSpec(str(tmp_path), "m", 16, 64).blocks_per_file == 4
    names = ("OFFLOAD_STAGING_LANES", "OFFLOAD_STAGING_SLOTS", "OFFLOAD_STAGING_WATCHDOG_S")
    for name in names:
        monkeypatch.delenv(name, raising=False)
    ours = spec_mod.TPUOffloadSpec(str(tmp_path), "m")
    theirs = JaxSpec(str(tmp_path), "m")
    assert (ours.staging_lanes, ours.staging_slots, ours.staging_lane_wait_s) == (
        theirs.staging_lanes, theirs.staging_slots, theirs.staging_lane_wait_s) == (0, 2, 60.0)
    # What the environment resolves must still be runnable: a negative
    # lane count or a non-positive slot count or watchdog raises.
    for name, value in zip(names, ("-3", "2", "60")):
        monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match="staging_lanes"):
        spec_mod.TPUOffloadSpec(str(tmp_path), "m")
    for bad in ({"staging_slots": 0}, {"staging_lane_wait_s": 0.0}):
        with pytest.raises(ValueError, match="staging_"):
            spec_mod.TPUOffloadSpec(str(tmp_path), "m", staging_lanes=1, **bad)


STAGING_ENV = ("OFFLOAD_STAGING_LANES", "OFFLOAD_STAGING_SLOTS", "OFFLOAD_STAGING_WATCHDOG_S")


@pytest.mark.parametrize("env", [("2", "3", "7.5"), None], ids=["set", "unset"])
def test_default_spec_reads_the_staging_environment_as_the_reference_does(
        tmp_path, monkeypatch, env):
    """A default ``TPUOffloadSpec()`` resolves lanes, slots and the
    watchdog from ``OFFLOAD_STAGING_*`` as the JAX package's does (equal
    fields, exactly), and explicit values win over the environment in
    both."""
    for name, value in zip(STAGING_ENV, env or (None,) * 3):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    fields = lambda spec: (spec.staging_lanes, spec.staging_slots, spec.staging_lane_wait_s)
    ours = fields(spec_mod.TPUOffloadSpec(str(tmp_path), "m"))
    theirs = fields(JaxSpec(str(tmp_path), "m"))
    assert ours == theirs == ((2, 3, 7.5) if env else (0, 2, 60.0))
    explicit = dict(staging_lanes=1, staging_slots=4, staging_lane_wait_s=9.0)
    assert fields(spec_mod.TPUOffloadSpec(str(tmp_path), "m", **explicit)) == fields(
        JaxSpec(str(tmp_path), "m", **explicit)) == (1, 4, 9.0)


def test_connector_rejects_pools_it_cannot_describe(tmp_path):
    pool = port_pool()
    with pytest.raises(ValueError, match="block_size"):
        spec_mod.TPUOffloadConnector(
            spec_mod.TPUOffloadSpec(str(tmp_path), "m", 16, 32), pool)
    with pytest.raises(ValueError, match="dtype"):
        spec_mod.TPUOffloadConnector(
            spec_mod.TPUOffloadSpec(str(tmp_path), "m", 8, 16, dtype="float32"), pool)

    class Sharded(torch.Tensor):
        pass

    pool.kv = pool.kv.as_subclass(Sharded)
    with pytest.raises(ValueError, match="one plain tensor"):
        port_connector(tmp_path, pool)


# -------------------------------------------------- stores and loads, both ways

STORE_IDS = [3, 4, 7, 9, 11]  # 3 files, the last one partial
STORE_HASHES = [0xA, 0xB, 0xC]


@pytest.mark.parametrize("lanes", [0, 2], ids=["one_shot", "staged"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stores_write_identical_file_trees(tmp_path, dtype, lanes):
    blocks = random_blocks(dtype, len(STORE_IDS))
    ours, theirs = port_pool(dtype), jax_pool(dtype)
    ours.scatter_from_host(STORE_IDS, blocks)
    theirs.scatter_from_host(STORE_IDS, blocks)
    groups = group_blocks_per_file(STORE_HASHES, STORE_IDS, BLOCKS_PER_FILE)
    port_conn = port_connector(tmp_path / "port", ours, lanes)
    jax_conn = jax_connector(tmp_path / "jax", theirs, lanes)
    assert port_conn.engine.is_native
    for conn in (port_conn, jax_conn):
        conn.store_handler.transfer_async(1, groups)
        assert conn.store_handler.wait(1) == JobStatus.SUCCEEDED
        conn.close()
    got, want = read_tree(tmp_path / "port"), read_tree(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 3
    for rel in want:
        assert got[rel] == want[rel], f"byte drift in {rel}"
    # The partial tail file holds one block: the head of its group.
    sizes = sorted(len(b) for b in got.values())
    assert sizes == [ours.block_nbytes, 2 * ours.block_nbytes, 2 * ours.block_nbytes]


@pytest.mark.parametrize("lanes", [0, 2], ids=["one_shot", "staged"])
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_each_package_loads_the_others_files(tmp_path, dtype, writer, lanes):
    blocks = random_blocks(dtype, len(STORE_IDS), seed=1)
    source = jax_pool(dtype) if writer == "jax" else port_pool(dtype)
    source.scatter_from_host(STORE_IDS, blocks)
    make = jax_connector if writer == "jax" else port_connector
    store = make(tmp_path, source)
    store.store_handler.transfer_async(1, group_blocks_per_file(
        STORE_HASHES, STORE_IDS, BLOCKS_PER_FILE))
    assert store.store_handler.wait(1) == JobStatus.SUCCEEDED
    store.close()

    target_ids = [20, 21, 22, 23, 24]
    groups = group_blocks_per_file(STORE_HASHES, target_ids, BLOCKS_PER_FILE)
    target = port_pool(dtype) if writer == "jax" else jax_pool(dtype)
    load = (port_connector if writer == "jax" else jax_connector)(tmp_path, target, lanes)
    load.load_handler.transfer_async(2, groups)
    assert load.load_handler.wait(2) == JobStatus.SUCCEEDED
    load.close()
    np.testing.assert_array_equal(bits(target.gather_to_host(target_ids)), bits(blocks))


@pytest.mark.parametrize("lanes", [0, 2], ids=["one_shot", "staged"])
def test_load_of_a_missing_file_fails(tmp_path, lanes):
    conn = port_connector(tmp_path, port_pool(), lanes)
    conn.load_handler.transfer_async(20, group_blocks_per_file([0xDEAD], [1, 2], 2))
    assert conn.load_handler.wait(20) == JobStatus.FAILED
    conn.close()


def test_partial_store_then_full_load(tmp_path):
    """A partial tail group stores a head-sized file; the manager
    promises only full groups; a later full store upgrades the partial
    file; a partial head load reads coherent bytes."""
    pool = port_pool()
    pool.scatter_from_host([0, 1, 2], random_blocks("bfloat16", 3))
    conn = port_connector(tmp_path, pool)
    manager = conn.get_manager()
    conn.store_handler.transfer_async(30, group_blocks_per_file([0xA, 0xB], [0, 1, 2], 2))
    assert conn.store_handler.wait(30) == JobStatus.SUCCEEDED
    assert manager.lookup([0xA, 0xB]) == 1
    conn.load_handler.transfer_async(31, group_blocks_per_file([0xB], [10], 2))
    assert conn.load_handler.wait(31) == JobStatus.SUCCEEDED
    np.testing.assert_array_equal(pool.gather_to_host([10]), pool.gather_to_host([2]))
    conn.store_handler.transfer_async(32, group_blocks_per_file([0xA, 0xB], [0, 1, 2, 1], 2))
    assert conn.store_handler.wait(32) == JobStatus.SUCCEEDED
    assert manager.lookup([0xA, 0xB]) == 2
    conn.close()


def test_get_finished_routes_between_handlers(tmp_path):
    events = []
    pool = port_pool()
    pool.scatter_from_host([0, 1], random_blocks("bfloat16", 2))
    conn = port_connector(tmp_path, pool,
                          event_sink=lambda hashes, medium: events.append((tuple(hashes), medium)))
    conn.store_handler.transfer_async(10, group_blocks_per_file([0xC], [0, 1], 2))
    assert poll(conn) == [(10, JobStatus.SUCCEEDED)]
    assert events == [((0xC,), "shared_storage")]
    conn.load_handler.transfer_async(11, group_blocks_per_file([0xC], [5, 6], 2))
    assert poll(conn) == [(11, JobStatus.SUCCEEDED)]
    np.testing.assert_array_equal(pool.gather_to_host([5, 6]), pool.gather_to_host([0, 1]))
    assert conn.get_finished() == []
    conn.close()


@pytest.mark.parametrize("lanes", [0, 2], ids=["one_shot", "staged"])
def test_pool_tensor_held_outside_sees_the_load(tmp_path, lanes):
    """The serving path (and a captured decode graph) holds pool.kv
    across steps: a load writes that very tensor, in place."""
    pool = port_pool()
    blocks = random_blocks("bfloat16", 2, seed=4)
    pool.scatter_from_host([0, 1], blocks)
    conn = port_connector(tmp_path, pool, lanes)
    conn.store_handler.transfer_async(40, group_blocks_per_file([0xE], [0, 1], 2))
    assert conn.store_handler.wait(40) == JobStatus.SUCCEEDED
    held = pool.kv
    conn.load_handler.transfer_async(41, group_blocks_per_file([0xE], [4, 5], 2))
    assert conn.load_handler.wait(41) == JobStatus.SUCCEEDED
    assert pool.kv is held
    np.testing.assert_array_equal(
        held[:, 4:6].view(torch.uint16).numpy(), bits(blocks))
    conn.close()


@pytest.mark.parametrize("lanes", [0, 2], ids=["one_shot", "staged"])
def test_load_scatters_serialize_on_one_lock(tmp_path, lanes):
    """Every pool scatter of a connector, one-shot or staged, takes one
    lock: while another thread holds it, a harvest cannot write the pool."""
    pool = port_pool()
    blocks = random_blocks("bfloat16", 2, seed=6)
    pool.scatter_from_host([0, 1], blocks)
    conn = port_connector(tmp_path, pool, lanes)
    conn.store_handler.transfer_async(50, group_blocks_per_file([0xF], [0, 1], 2))
    assert conn.store_handler.wait(50) == JobStatus.SUCCEEDED
    lock = conn.load_handler._scatter_lock
    assert lock is (conn.staging.scatter_lock if lanes else lock)
    result = []
    with lock:
        conn.load_handler.transfer_async(51, group_blocks_per_file([0xF], [6, 7], 2))
        harvest = threading.Thread(target=lambda: result.append(conn.load_handler.wait(51)))
        harvest.start()
        harvest.join(0.3)
        assert harvest.is_alive() and not bool((pool.kv[:, 6:8] != 0).any())
    harvest.join(30)
    assert result == [JobStatus.SUCCEEDED]
    np.testing.assert_array_equal(pool.kv[:, 6:8].view(torch.uint16).numpy(), bits(blocks))
    conn.close()


def test_rtt_observer_sees_only_file_bytes(tmp_path):
    """A host-tier-served group pairs near-zero io time with its
    payload; the load RTT feed must be priced on file bytes only."""
    pool = port_pool()
    block_ids = [1, 2, 3, 4]
    pool.scatter_from_host(block_ids, random_blocks("bfloat16", 4))
    conn = port_connector(tmp_path, pool)
    conn.store_handler.transfer_async(1, group_blocks_per_file([0xA, 0xB], block_ids, 2))
    assert conn.store_handler.wait(1) == JobStatus.SUCCEEDED
    cache = host_tier.HostTierCache(1 << 20)
    assert cache.put(0xA, pool.gather_block_major([1, 2]))
    observed = []
    loader = worker.StorageToDeviceHandler(
        pool, conn.engine, conn.file_mapper, host_cache=cache,
        rtt_observer=lambda nbytes, s: observed.append((nbytes, s)))
    loader.transfer_async(5, group_blocks_per_file([0xA, 0xB], [20, 21, 22, 23], 2))
    assert loader.wait(5) == JobStatus.SUCCEEDED
    assert [n for n, _ in observed] == [2 * pool.block_nbytes] and observed[0][1] > 0
    assert cache.put(0xB, pool.gather_block_major([3, 4]))
    loader.transfer_async(6, group_blocks_per_file([0xA, 0xB], [24, 25, 26, 27], 2))
    assert loader.wait(6) == JobStatus.SUCCEEDED
    assert len(observed) == 1  # a fully host-served job: no observation
    np.testing.assert_array_equal(pool.gather_to_host([24, 25, 26, 27]),
                                  pool.gather_to_host(block_ids))
    conn.close()


# ---------------------------------------------------------------- manager


def test_manager_lookup_matches_the_reference(tmp_path):
    pool = port_pool()
    pool.scatter_from_host([0, 1, 2, 3, 4], random_blocks("bfloat16", 5))
    conn = port_connector(tmp_path, pool)
    conn.store_handler.transfer_async(
        1, group_blocks_per_file([0x1, 0x2, 0x3], [0, 1, 2, 3, 4], 2))
    assert conn.store_handler.wait(1) == JobStatus.SUCCEEDED
    ours = conn.get_manager()
    theirs = jax_connector(tmp_path, jax_pool()).get_manager()
    for probe in ([0x1, 0x2], [0x1, 0x2, 0x3], [0x3], [0x3, 0x1, 0x2], [0x9], []):
        assert ours.lookup(probe) == theirs.lookup(probe)
    assert ours.lookup([0x1, 0x2, 0x3]) == 2  # 0x3 holds one block of two
    assert ours.prepare_store([0x5, 0x6]).block_hashes_to_store == [0x5, 0x6]
    assert ours.prepare_load([0x1]) == [0x1]
    conn.close()


def test_manager_touch_refreshes_mtime(tmp_path):
    pool = port_pool()
    conn = port_connector(tmp_path, pool)
    conn.store_handler.transfer_async(1, group_blocks_per_file([0x9], [0, 1], 2))
    assert conn.store_handler.wait(1) == JobStatus.SUCCEEDED
    path = conn.file_mapper.get_file_name(0x9)
    old = time.time() - 3600
    os.utime(path, (old, old))
    conn.get_manager().touch([0x9, 0xDEAD])  # a missing file is skipped
    assert os.path.getmtime(path) > old + 1800
    conn.close()


# -------------------------------------------------------------- host tier


class TestHostTierCache:
    def test_put_get_refresh(self):
        cache = host_tier.HostTierCache(max_bytes=1 << 20)
        group = np.ones((2, 8), np.uint8)
        cache.put(1, group)
        assert cache.get(1) is group
        assert cache.get(2) is None
        assert cache.stats() == {"entries": 1, "bytes": 16, "hits": 1, "misses": 1}

    def test_budget_evicts_lru(self):
        evicted = []
        cache = host_tier.HostTierCache(max_bytes=100, on_evict=evicted.append)
        for key in (1, 2):
            cache.put(key, np.zeros(40, np.uint8))
        cache.get(1)  # refresh 1; 2 becomes LRU
        cache.put(3, np.zeros(40, np.uint8))
        assert evicted == [2] and cache.get(2) is None
        assert cache.get(1) is not None and cache.get(3) is not None
        assert cache.resident_bytes <= 100

    def test_oversized_group_not_admitted(self):
        cache = host_tier.HostTierCache(max_bytes=10)
        assert not cache.put(1, np.zeros(100, np.uint8))
        assert cache.get(1) is None

    def test_lookup_consecutive(self):
        cache = host_tier.HostTierCache()
        for key in (1, 2, 4):
            cache.put(key, np.zeros(4, np.uint8))
        assert cache.lookup_consecutive([1, 2, 3, 4]) == 2
        assert cache.lookup_consecutive([5]) == 0
        assert cache.evict(2) and not cache.evict(2)

    def test_eviction_policy_chooses_and_failures_fall_back(self):
        class Biggest:
            sample = 8

            def select_victim(self, sample):
                return max(range(len(sample)), key=lambda i: sample[i][1])

        class Broken:
            def select_victim(self, sample):
                raise RuntimeError("policy bug")

        cache = host_tier.HostTierCache(max_bytes=100, eviction_policy=Biggest())
        cache.put(1, np.zeros(20, np.uint8))
        cache.put(2, np.zeros(50, np.uint8))
        cache.put(3, np.zeros(40, np.uint8))
        assert cache.contains(1) and not cache.contains(2) and cache.contains(3)
        cache = host_tier.HostTierCache(max_bytes=100, eviction_policy=Broken())
        cache.put(1, np.zeros(60, np.uint8))
        cache.put(2, np.zeros(60, np.uint8))
        assert not cache.contains(1) and cache.contains(2)  # the LRU victim


@pytest.mark.parametrize("lanes", [0, 2], ids=["one_shot", "staged"])
def test_host_tier_serves_a_load_without_files(tmp_path, lanes):
    """After a store, a load succeeds with the files deleted: the groups
    are host-resident; the events name both tiers."""
    pool = port_pool()
    events = []
    conn = spec_mod.TPUOffloadConnector(
        spec_mod.TPUOffloadSpec(**spec_kwargs(tmp_path, "bfloat16", staging_lanes=lanes,
                                              host_cache_bytes=64 << 20)),
        pool, event_sink=lambda h, m: events.append((list(h), m)))
    ref = random_blocks("bfloat16", 4, seed=2)
    pool.scatter_from_host([0, 1, 2, 3], ref)
    hashes = [0x11, 0x22]
    conn.store_handler.transfer_async(1, group_blocks_per_file(hashes, [0, 1, 2, 3], 2))
    assert conn.store_handler.wait(1) == JobStatus.SUCCEEDED
    assert (hashes, "host") in events and (hashes, "shared_storage") in events
    for h in hashes:
        os.unlink(conn.file_mapper.get_file_name(h))
    pool.scatter_from_host([0, 1, 2, 3], np.zeros_like(ref))
    conn.load_handler.transfer_async(2, group_blocks_per_file(hashes, [9, 8, 7, 6], 2))
    assert conn.load_handler.wait(2) == JobStatus.SUCCEEDED
    np.testing.assert_array_equal(bits(pool.gather_to_host([9, 8, 7, 6])), bits(ref))
    assert conn.host_cache.stats()["hits"] == 2
    conn.close()


def test_host_tier_miss_falls_back_to_files(tmp_path):
    pool = port_pool()
    conn = spec_mod.TPUOffloadConnector(
        spec_mod.TPUOffloadSpec(**spec_kwargs(tmp_path, "bfloat16", host_cache_bytes=64 << 20)),
        pool)
    ref = random_blocks("bfloat16", 2, seed=3)
    pool.scatter_from_host([0, 1], ref)
    groups = group_blocks_per_file([0x33], [0, 1], 2)
    conn.store_handler.transfer_async(1, groups)
    assert conn.store_handler.wait(1) == JobStatus.SUCCEEDED
    conn.host_cache.evict(0x33)  # force the file path
    pool.scatter_from_host([0, 1], np.zeros_like(ref))
    conn.load_handler.transfer_async(2, groups)
    assert conn.load_handler.wait(2) == JobStatus.SUCCEEDED
    np.testing.assert_array_equal(bits(pool.gather_to_host([0, 1])), bits(ref))
    conn.close()


def test_disabled_host_tier_publishes_storage_only(tmp_path):
    events = []
    conn = port_connector(tmp_path, port_pool(), event_sink=lambda h, m: events.append(m))
    assert conn.host_cache is None
    conn.store_handler.transfer_async(1, group_blocks_per_file([0x44], [0, 1], 2))
    assert conn.store_handler.wait(1) == JobStatus.SUCCEEDED
    assert events == ["shared_storage"]
    conn.close()


# ------------------------------------------------------ counters and spans


def _offload_counts(metrics):
    """{(series, labels): value} of the offload counters."""
    out = {}
    for counter in (metrics.offload_jobs, metrics.offload_bytes,
                    metrics.offload_staging_lane_waits):
        for family in counter.collect():
            for sample in family.samples:
                if not sample.name.endswith("_created"):
                    out[(sample.name, tuple(sorted(sample.labels.items())))] = sample.value
    return out


def _traced_round_trip(tmp_path, pool, connector, metrics, tracer, lanes, dtype):
    """A store of three files, a load of them into other blocks and a
    load of a missing file, every job traced: the counters' movement
    and each trace's name, status, attributes and spans (names,
    parents, attributes; not times)."""
    pool.scatter_from_host(STORE_IDS, random_blocks(dtype, len(STORE_IDS), seed=4))
    before = _offload_counts(metrics)
    rate = tracer.config.sample_rate
    tracer.configure(sample_rate=1.0)
    tracer.reset()
    conn = connector(tmp_path, pool, lanes)
    try:
        conn.store_handler.transfer_async(1, group_blocks_per_file(
            STORE_HASHES, STORE_IDS, BLOCKS_PER_FILE))
        assert conn.store_handler.wait(1) == JobStatus.SUCCEEDED
        conn.load_handler.transfer_async(2, group_blocks_per_file(
            STORE_HASHES, [20, 21, 22, 23, 24], BLOCKS_PER_FILE))
        assert conn.load_handler.wait(2) == JobStatus.SUCCEEDED
        conn.load_handler.transfer_async(3, group_blocks_per_file([0xDEAD], [25, 26], 2))
        assert conn.load_handler.wait(3) == JobStatus.FAILED
    finally:
        conn.close()
        tracer.configure(sample_rate=rate)
    after = _offload_counts(metrics)
    moved = {key: value - before.get(key, 0.0) for key, value in after.items()
             if value != before.get(key, 0.0)}
    traces = []
    for trace in reversed(tracer.recorder.recent()):
        view = trace.to_dict()
        traces.append((view["name"], view["status"], sorted(view["attributes"].items()), [
            (s["name"], s["parent"], sorted(s["attributes"].items())) for s in view["spans"]]))
    tracer.reset()
    return moved, traces


@pytest.mark.parametrize("lanes", [0, 2], ids=["one_shot", "staged"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_offload_counters_and_spans_match_reference(tmp_path, dtype, lanes):
    """The same store and loads through both connectors move
    ``offload_jobs_total`` and ``offload_bytes_total`` alike and leave
    the same ``offload.store`` / ``offload.load`` traces: an
    ``offload.stage`` span (with ``offload.stage.dma`` children when
    staged) and an ``offload.io`` span each."""
    ours = _traced_round_trip(tmp_path / "port", port_pool(dtype), port_connector,
                              port("metrics.collector").METRICS, port("obs.trace").TRACER,
                              lanes, dtype)
    theirs = _traced_round_trip(tmp_path / "jax", jax_pool(dtype), jax_connector, JAX_METRICS,
                                JAX_TRACER, lanes, dtype)
    assert ours == theirs
    moved, traces = ours
    nbytes = len(STORE_IDS) * port_pool(dtype).block_nbytes
    assert moved[("kvtpu_offload_bytes_total", (("direction", "store"),))] == nbytes
    assert moved[("kvtpu_offload_jobs_total", (("direction", "load"), ("status", "failed")))] == 1
    assert [t[0] for t in traces] == ["offload.store", "offload.load", "offload.load"]
    spans = {name for trace in traces for name, _, _ in trace[3]}
    assert spans == ({"offload.stage", "offload.io", "offload.stage.dma"} if lanes
                     else {"offload.stage", "offload.io"})
