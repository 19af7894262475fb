"""The index contract suite of the JAX package's ``tests/test_index_backends.py``
on both packages, on the CPU, with the port's Redis backend.

Every case runs on both packages (``m`` is either one's names) over every
backend: in-memory, cost-aware, instrumented, Redis (against
``tests/helpers/miniresp.py`` as the server: the card's machine has no Redis
server, so this backend is checked here only) and the remote index of a
3-replica strict-wire ``LocalCluster``.  Then the two packages' Redis
backends against each other, exactly: the same operations leave the same
keys and fields on the server, and the RESP client frames the same bytes.
"""

import random

import pytest

from llm_d_kv_cache_manager_tpu import cluster as ref_cluster
from llm_d_kv_cache_manager_tpu.kvcache import kvblock as ref_kvblock
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import cost_aware as ref_cost_aware
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import in_memory as ref_in_memory
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import index as ref_index
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import instrumented as ref_instrumented
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import redis_index as ref_redis_index
from tests.helpers.miniresp import MiniRespServer
from tests.helpers.torch_port import namespace

SIDES = ("ref", "port")
_REF = {
    "cluster": ref_cluster,
    "kvcache.kvblock": ref_kvblock,
    "kvcache.kvblock.cost_aware": ref_cost_aware,
    "kvcache.kvblock.in_memory": ref_in_memory,
    "kvcache.kvblock.index": ref_index,
    "kvcache.kvblock.instrumented": ref_instrumented,
    "kvcache.kvblock.redis_index": ref_redis_index,
}
_NAMES = {
    "cluster": ("LocalCluster",),
    "kvcache.kvblock": ("IndexConfig", "PodEntry", "new_index"),
    "kvcache.kvblock.cost_aware": ("CostAwareMemoryIndex",),
    "kvcache.kvblock.in_memory": ("InMemoryIndex",),
    "kvcache.kvblock.index": ("CostAwareIndexConfig", "InMemoryIndexConfig",
                              "RedisIndexConfig"),
    "kvcache.kvblock.instrumented": ("InstrumentedIndex",),
    "kvcache.kvblock.redis_index": ("RedisIndex", "RespClient"),
}


def mods(side):
    m = namespace(side, _REF, _NAMES)
    m.POD1 = m.PodEntry("pod-1", "hbm")
    m.POD1_HOST = m.PodEntry("pod-1", "host")
    m.POD2 = m.PodEntry("pod-2", "hbm")
    return m


@pytest.fixture(params=SIDES)
def m(request):
    return mods(request.param)


BACKENDS = ["in_memory", "cost_aware", "redis", "instrumented", "remote"]


@pytest.fixture(scope="module")
def resp_server():
    server = MiniRespServer()
    yield server
    server.close()


@pytest.fixture(params=BACKENDS)
def index(m, request, resp_server):
    if request.param == "in_memory":
        yield m.InMemoryIndex(m.InMemoryIndexConfig(size=10_000))
    elif request.param == "cost_aware":
        yield m.CostAwareMemoryIndex(
            m.CostAwareIndexConfig(max_cost_bytes=64 * 1024 * 1024)
        )
    elif request.param == "instrumented":
        yield m.InstrumentedIndex(m.InMemoryIndex(m.InMemoryIndexConfig(size=10_000)))
    elif request.param == "remote":
        # 3 in-process replicas through the strict wire codec: the
        # same method table the HTTP endpoint serves, so contract
        # parity here covers the RPC serialization too.
        cluster = m.LocalCluster(strict_wire=True)
        yield cluster.remote_index
        cluster.close()
    else:
        idx = m.RedisIndex(m.RedisIndexConfig(address=resp_server.address))
        yield idx
        idx._client.execute("FLUSHALL")


class TestIndexContract:
    def test_add_then_lookup(self, m, index):
        index.add([101, 102], [201, 202], [m.POD1])
        found = index.lookup([201, 202])
        assert set(found) == {201, 202}
        assert found[201] == [m.POD1]

    def test_lookup_filters_by_pod_set(self, m, index):
        index.add([110], [210], [m.POD1, m.POD2])
        found = index.lookup([210], {"pod-2"})
        assert found == {210: [m.POD2]}

    def test_lookup_missing_keys_skipped(self, m, index):
        index.add([120], [220], [m.POD1])
        found = index.lookup([9999, 220])
        assert found == {220: [m.POD1]}

    def test_lookup_empty_keys_raises(self, m, index):
        with pytest.raises(ValueError):
            index.lookup([])

    def test_multiple_tiers_per_pod(self, m, index):
        index.add([130], [230], [m.POD1, m.POD1_HOST])
        found = index.lookup([230])
        assert set(found[230]) == {m.POD1, m.POD1_HOST}

    def test_get_request_key_and_eviction(self, m, index):
        index.add([140], [240], [m.POD1, m.POD2])
        assert index.get_request_key(140) == 240

        index.evict(140, [m.POD1])
        assert index.lookup([240]) == {240: [m.POD2]}

        index.evict(140, [m.POD2])
        # Fully evicted: the key disappears and the engine mapping with it.
        assert index.lookup([240, 240]) == {}
        with pytest.raises(KeyError):
            index.get_request_key(140)

    def test_evict_unknown_engine_key_is_noop(self, m, index):
        index.evict(31337, [m.POD1])

    def test_add_validates_lengths(self, m, index):
        with pytest.raises(ValueError):
            index.add([1, 2], [1], [m.POD1])
        with pytest.raises(ValueError):
            index.add([], [], [m.POD1])
        with pytest.raises(ValueError):
            index.evict(1, [])

    def test_purge_pod_removes_only_that_pod(self, m, index):
        both = [m.POD1, m.POD2]
        index.add([301, 302], [401, 402], both)
        index.add([303], [403], [m.POD1])  # POD1-only key

        removed = index.purge_pod(m.POD1.pod_identifier)
        assert removed == 3

        found = index.lookup([401, 402, 403])
        # Shared keys keep POD2; the POD1-only key is gone entirely
        # (an empty pod set would break every pod's prefix chain).
        assert set(found) == {401, 402}
        assert all(
            p.pod_identifier == m.POD2.pod_identifier
            for pods in found.values()
            for p in pods
        )
        # Unknown pods purge nothing.
        assert index.purge_pod("no-such-pod") == 0

    def test_purge_pod_removes_every_tier(self, m, index):
        tiers = [
            m.PodEntry(m.POD1.pod_identifier, "hbm"),
            m.PodEntry(m.POD1.pod_identifier, "host"),
            m.PodEntry(m.POD1.pod_identifier, "shared_storage"),
        ]
        index.add([311], [411], tiers)
        assert index.purge_pod(m.POD1.pod_identifier) == 3
        assert index.lookup([411]) == {}

    def test_readd_after_evict(self, m, index):
        index.add([150], [250], [m.POD1])
        index.evict(150, [m.POD1])
        index.add([150], [250], [m.POD2])
        assert index.lookup([250]) == {250: [m.POD2]}
        assert index.get_request_key(150) == 250

    # -- the modern contract surface (fast lane + batched apply + dump) --

    def test_lookup_chain_aligned_and_truncated(self, m, index):
        """lookup_chain is the fast lane's shape: aligned per-key pod
        lists, truncated at the first key with no resident pods —
        whether the backend overrides it (in-memory, redis, remote) or
        inherits the default adapter."""
        index.add([501, 502, 503], [601, 602, 603], [m.POD1, m.POD2])
        chain = index.lookup_chain([601, 602, 603])
        assert len(chain) == 3
        for pods in chain:
            assert set(pods) == {m.POD1, m.POD2}
        # A missing key cuts the chain for every pod.
        truncated = index.lookup_chain([601, 9999, 603])
        assert len(truncated) == 1
        assert index.lookup_chain([9999, 601]) == []

    def test_lookup_chain_agrees_with_lookup(self, m, index):
        """Chain results must be lookup's view of the same keys (the
        scorer relies on either shape producing identical scores)."""
        index.add([511, 512], [611, 612], [m.POD1])
        keys = [611, 612, 613]
        chain = index.lookup_chain(keys)
        flat = index.lookup(keys)
        for key, pods in zip(keys, chain):
            assert set(pods) == set(flat[key])
        assert len(chain) == 2  # 613 never added

    def test_batched_apply_surface(self, m, index):
        """add_mappings + add_entries_batch (the kvevents batched-apply
        split) must equal a plain add; backends without the surface
        are exercised through the applier's fallback path instead
        (the reference's tests/test_read_path_fastlane.py)."""
        if not (
            callable(getattr(index, "add_mappings", None))
            and callable(getattr(index, "add_entries_batch", None))
        ):
            pytest.skip("backend has no batched-apply surface")
        index.add_mappings([701, 702], [801, 802])
        index.add_entries_batch(
            [([801], [m.POD1]), ([802], [m.POD1, m.POD2])]
        )
        assert index.get_request_key(701) == 801
        found = index.lookup([801, 802])
        assert found[801] == [m.POD1]
        assert set(found[802]) == {m.POD1, m.POD2}
        # The mapping resolves evictions exactly like add's would.
        index.evict(701, [m.POD1])
        assert index.lookup([802, 801]).get(801) is None

    def test_dump_restore_round_trip(self, m, index):
        """Every backend answers the persistence contract with a real
        round trip — including Redis (SCAN-based, replacing the old
        documented no-op) and the remote cluster (concatenated replica
        dumps routed back to their owners)."""
        index.add([160, 161], [260, 261], [m.POD1, m.POD2])
        block_entries, engine_map = index.dump_entries()
        assert {k for k, _ in block_entries} >= {260, 261}
        assert dict(engine_map)[160] == 260
        restored = index.restore_entries(block_entries, engine_map)
        assert restored == len(
            [e for _, e in block_entries if e]
        )  # idempotent re-add
        assert set(index.lookup([260, 261])) == {260, 261}


class TestInMemorySpecifics:
    def test_pod_cache_bounded(self, m):
        index = m.InMemoryIndex(m.InMemoryIndexConfig(size=100, pod_cache_size=3))
        pods = [m.PodEntry(f"pod-{i}", "hbm") for i in range(6)]
        index.add([1], [2], pods)
        resident = index.lookup([2])[2]
        assert len(resident) == 3
        # Most recently added pods survive.
        assert set(resident) == set(pods[3:])

    def test_key_lru_eviction(self, m):
        # shards=1 pins the exact single-LRU capacity semantics this
        # test asserts; the sharded default bounds capacity per shard
        # (see InMemoryIndexConfig.shards).
        index = m.InMemoryIndex(m.InMemoryIndexConfig(size=2, shards=1))
        index.add([1, 2, 3], [11, 12, 13], [m.POD1])
        # Capacity 2: the oldest request key fell out.
        assert index.lookup([11, 12, 13]) == {12: [m.POD1], 13: [m.POD1]}

    def test_per_shard_lru_eviction(self, m):
        """Sharded capacity: eviction is LRU within each stripe, so
        keys landing on distinct shards never evict each other."""
        index = m.InMemoryIndex(m.InMemoryIndexConfig(size=4, shards=4))
        # Keys 0..3 hit four distinct shards (key & 3); per-shard
        # capacity is 1, so a same-shard key (4 -> shard 0) evicts key
        # 0 while the other shards keep theirs.
        index.add([0, 1, 2, 3], [0, 1, 2, 3], [m.POD1])
        index.add([4], [4], [m.POD1])
        assert index.lookup([4]) == {4: [m.POD1]}
        found = index.lookup([1, 2, 3])
        assert found == {1: [m.POD1], 2: [m.POD1], 3: [m.POD1]}
        assert index.lookup([0]) == {}

    def test_empty_podcache_stops_scan(self, m):
        """A present-but-empty key must cut the lookup early."""
        index = m.InMemoryIndex(m.InMemoryIndexConfig(size=100))
        index.add([1, 2], [21, 22], [m.POD1])
        index.add([3], [23], [m.POD1])
        # Drain key 22's pods without removing the key.
        index._shard(22).get(22).remove_all([m.POD1])
        found = index.lookup([21, 22, 23])
        assert found == {21: [m.POD1]}

    def test_lookup_batched_get_refreshes_recency(self, m):
        """lookup batches its locking (LRUCache.peek_many, then one
        touch_many for the keys that yielded pods); a looked-up key
        must end as recency-fresh as a per-key get would have left it
        — the next insert evicts an UNTOUCHED key, not the looked-up
        one.  shards=1: the assertion depends on exact global LRU."""
        index = m.InMemoryIndex(m.InMemoryIndexConfig(size=2, shards=1))
        index.add([1], [11], [m.POD1])
        index.add([2], [12], [m.POD1])
        index.lookup([11])  # refreshes 11; 12 is now the LRU victim
        index.add([3], [13], [m.POD1])
        assert index.lookup([11, 13]) == {11: [m.POD1], 13: [m.POD1]}
        assert index.lookup([11, 12, 13]) == {11: [m.POD1], 13: [m.POD1]}


class TestCostAwareSpecifics:
    def test_budget_eviction(self, m):
        index = m.CostAwareMemoryIndex(m.CostAwareIndexConfig(max_cost_bytes=2000))
        for i in range(100):
            index.add([1000 + i], [2000 + i], [m.POD1])
        assert index.resident_cost_bytes <= 2000
        keys = list(range(2000, 2100))
        found = index.lookup(keys)
        assert 0 < len(found) < 100
        # Most recent keys survive.
        assert 2099 in found


def test_factory_backend_priority(m, resp_server):
    assert isinstance(m.new_index(m.IndexConfig()), m.InMemoryIndex)
    assert isinstance(
        m.new_index(m.IndexConfig(cost_aware_config=m.CostAwareIndexConfig())),
        m.CostAwareMemoryIndex,
    )
    assert isinstance(
        m.new_index(
            m.IndexConfig(
                in_memory_config=None,
                redis_config=m.RedisIndexConfig(address=resp_server.address),
            )
        ),
        m.RedisIndex,
    )
    wrapped = m.new_index(m.IndexConfig(enable_metrics=True))
    assert isinstance(wrapped, m.InstrumentedIndex)
    assert isinstance(wrapped.inner, m.InMemoryIndex)


# ------------------------------------------------- the two packages, exactly


def test_both_packages_leave_the_same_server_state():
    """One seeded history (adds over two tiers, batched adds, evictions,
    a purge) through each package's ``RedisIndex``, each against its own
    server: the servers end with the same strings and hashes (exact), and
    lookups agree."""
    rng = random.Random(5)
    ops = []
    for _ in range(200):
        roll = rng.random()
        pod = rng.choice(["pod-1", "pod-2", "pod-3"])
        tier = rng.choice(["hbm", "host"])
        if roll < 0.6:
            n = rng.randint(1, 4)
            ops.append(("add", [rng.randrange(1 << 20) for _ in range(n)],
                        [rng.randrange(1 << 20) for _ in range(n)], pod, tier))
        elif roll < 0.75:
            ops.append(("batch", [rng.randrange(1 << 20) for _ in range(2)], pod, tier))
        elif roll < 0.98 and any(op[0] == "add" for op in ops):
            op = rng.choice([op for op in ops if op[0] == "add"])
            ops.append(("evict", rng.choice(op[1]), op[3], op[4]))
        else:
            ops.append(("purge", pod))
    states, found = {}, {}
    for side in SIDES:
        m = mods(side)
        server = MiniRespServer()
        try:
            index = m.RedisIndex(m.RedisIndexConfig(address=server.address))
            for op in ops:
                if op[0] == "add":
                    index.add(op[1], op[2], [m.PodEntry(op[3], op[4])])
                elif op[0] == "batch":
                    index.add_entries_batch([(op[1], [m.PodEntry(op[2], op[3])])])
                elif op[0] == "evict":
                    index.evict(op[1], [m.PodEntry(op[2], op[3])])
                else:
                    index.purge_pod(op[1])
            keys = sorted({k for op in ops if op[0] == "add" for k in op[2]})
            found[side] = {k: sorted(str(e) for e in v) for k, v in index.lookup(keys).items()}
            state = server.state
            states[side] = (dict(state.strings),
                            {k: dict(v) for k, v in state.hashes.items()})
        finally:
            server.close()
    assert states["port"] == states["ref"]
    assert found["port"] == found["ref"] and len(found["port"]) > 20


@pytest.mark.parametrize("command", [
    ("PING",), ("HSET", "123", "pod-1@hbm", "1"), ("HKEYS", 7), ("SET", "engine:9", b"\x00\xff"),
    ("EVAL", "return 0", 2, "k1", "k2"), ("AUTH", "user", "p@ss"), ("SELECT", "3"),
], ids=lambda c: c[0])
def test_resp_frames_are_byte_equal(command):
    """Both clients frame a command as the same RESP2 bytes (exact)."""
    assert mods("port").RespClient._encode(command) == mods("ref").RespClient._encode(command)


def test_new_index_builds_the_ports_redis_backend(resp_server):
    """``new_index(IndexConfig(redis_config=...))`` builds the port's own
    ``RedisIndex`` (no fallback onto a private in-memory index), a durable
    backend as the reference's is."""
    m = mods("port")
    index = m.new_index(m.IndexConfig(redis_config=m.RedisIndexConfig(
        address=resp_server.address)))
    assert type(index) is m.RedisIndex and index.durable_backend
    assert type(index).__module__ == "llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.redis_index"
    assert mods("ref").RedisIndex.durable_backend is True
