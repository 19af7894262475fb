"""The concurrency storms of ``tests/test_concurrency.py`` and
``tests/test_kvevents_fuzz.py::TestPoolSurvivesStorm``, on the PyTorch
port's own structures.

Every storm of the reference's file runs here against the port's index
backends, sharded index, score memo, event pool, subscriber manager,
TTL cache and cluster fan-out, under the port's lock-order watchdog, and
asserts the same invariants: no lost updates, no exceptions, ordered
per-pod event processing, a consistent index, reads equal to the
pre-storm oracle.  The subscriber churn flips endpoints between loopback
ports only.  ``python -m hack.racefuzz_torch`` re-runs these storms under
the port's raceguard with microsecond preemption.
"""

import random
import threading
import time

import msgpack
import pytest

from tests.helpers.torch_port import port


def _mod(fn, module: str, name: str):
    """``name`` of the port's ``module``: an attribute, or a submodule."""
    found = getattr(fn(module), name, None)
    return found if found is not None else fn(f"{module}.{name}")

CostAwareMemoryIndex = _mod(port, "kvcache.kvblock.cost_aware", "CostAwareMemoryIndex")
InMemoryIndex = _mod(port, "kvcache.kvblock.in_memory", "InMemoryIndex")
CostAwareIndexConfig = _mod(port, "kvcache.kvblock.index", "CostAwareIndexConfig")
InMemoryIndexConfig = _mod(port, "kvcache.kvblock.index", "InMemoryIndexConfig")
PodEntry = _mod(port, "kvcache.kvblock.index", "PodEntry")
BlockStored = _mod(port, "kvevents.events", "BlockStored")
EventBatch = _mod(port, "kvevents.events", "EventBatch")
Message = _mod(port, "kvevents.pool", "Message")
Pool = _mod(port, "kvevents.pool", "Pool")
PoolConfig = _mod(port, "kvevents.pool", "PoolConfig")
ChunkedTokenDatabase = _mod(port, "kvcache.kvblock.token_processor", "ChunkedTokenDatabase")
TokenProcessorConfig = _mod(port, "kvcache.kvblock.token_processor", "TokenProcessorConfig")
lockorder = _mod(port, "utils", "lockorder")
TTLCache = _mod(port, "utils.ttl_cache", "TTLCache")

THREADS = 8
OPS = 300
# The churn storm's endpoints: loopback ports nothing listens on, so a
# connect is refused at once and never leaves the machine.
LOOPBACK_PORT = 45570


@pytest.fixture(autouse=True)
def lock_order_watchdog():
    """Arm the runtime lock-order watchdog for every storm in this
    module: the structures under test are constructed inside the tests
    (after enable), so their locks become order-asserting TrackedLocks
    and any acquisition against the declared KV006 order raises
    LockOrderViolation instead of deadlocking flakily.  `make
    lockorder-smoke` runs this same suite with KVTPU_LOCK_ORDER_DEBUG=1
    so even import-time-constructed locks are covered."""
    previous = lockorder.enable(True)
    try:
        yield
    finally:
        lockorder.enable(previous)


class TestIndexUnderContention:
    def test_concurrent_add_lookup_evict(self):
        index = InMemoryIndex(InMemoryIndexConfig(size=50_000))
        errors = []
        barrier = threading.Barrier(THREADS)

        def worker(worker_id: int):
            rng = random.Random(worker_id)
            pod = PodEntry(f"pod-{worker_id}", "hbm")
            try:
                barrier.wait()
                for i in range(OPS):
                    key = rng.randrange(1000)
                    index.add([key], [key], [pod])
                    index.lookup([key], None)
                    if i % 7 == 0:
                        index.evict(key, [pod])
            except Exception as exc:  # pragma: no cover - failure path
                errors.append(exc)

        threads = [
            threading.Thread(target=worker, args=(i,))
            for i in range(THREADS)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors

    def test_no_lost_adds_across_threads(self):
        """Every pod's final add for a key must be visible: N threads
        add disjoint pods to the same keys; all must survive."""
        index = InMemoryIndex(
            InMemoryIndexConfig(size=10_000, pod_cache_size=THREADS + 1)
        )
        keys = list(range(64))
        barrier = threading.Barrier(THREADS)

        def worker(worker_id: int):
            pod = PodEntry(f"pod-{worker_id}", "hbm")
            barrier.wait()
            for key in keys:
                index.add([key], [key], [pod])

        threads = [
            threading.Thread(target=worker, args=(i,))
            for i in range(THREADS)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)

        hits = index.lookup(keys, None)
        for key in keys:
            assert len(hits[key]) == THREADS, (
                f"key {key} lost adds: {hits[key]}"
            )


def _make_backend(name):
    if name == "in_memory":
        return InMemoryIndex(
            InMemoryIndexConfig(size=10_000, pod_cache_size=THREADS + 2)
        )
    return CostAwareMemoryIndex(
        CostAwareIndexConfig(pod_cache_size=THREADS + 2)
    )


class TestBackendStorm:
    """The runtime counterpart of kvlint's KV001 lock rule: hammer each
    index backend with a mixed add/evict/lookup/dump_entries storm and
    assert the guarded invariants actually hold under contention."""

    @pytest.mark.parametrize("backend", ["in_memory", "cost_aware"])
    def test_mixed_storm_no_lost_updates(self, backend):
        index = _make_backend(backend)
        keys = list(range(96))
        errors = []
        barrier = threading.Barrier(THREADS)

        def worker(worker_id: int):
            rng = random.Random(worker_id)
            pod = PodEntry(f"pod-{worker_id}", "hbm")
            try:
                barrier.wait()
                for i in range(OPS):
                    key = rng.choice(keys)
                    # Engine key is per-pod so one thread's evict can
                    # only target its own entries.
                    engine_key = key * 1000 + worker_id
                    index.add([engine_key], [key], [pod])
                    roll = i % 10
                    if roll < 5:
                        index.lookup([key], None)
                    elif roll < 7:
                        index.evict(engine_key, [pod])
                    elif roll == 7:
                        block_entries, engine_map = index.dump_entries()
                        # A dump taken mid-storm must be structurally
                        # sound even while writers churn under it.
                        for _, pods in block_entries:
                            assert isinstance(pods, list)
                        assert isinstance(engine_map, list)
                # Final pass: every key ends with this pod present.
                for key in keys:
                    index.add([key * 1000 + worker_id], [key], [pod])
            except Exception as exc:  # pragma: no cover - failure path
                errors.append(exc)

        threads = [
            threading.Thread(target=worker, args=(i,))
            for i in range(THREADS)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors

        # No lost updates: after the storm every thread's final add for
        # every key must be visible (disjoint pods, ample capacity).
        hits = index.lookup(keys, None)
        for key in keys:
            pods = {entry.pod_identifier for entry in hits.get(key, [])}
            missing = {
                f"pod-{worker_id}" for worker_id in range(THREADS)
            } - pods
            assert not missing, f"key {key} lost adds from {missing}"

        # And the post-storm dump agrees with lookup (same snapshot
        # machinery persistence relies on).
        block_entries, engine_map = index.dump_entries()
        dumped = {request_key for request_key, _ in block_entries}
        assert set(keys) <= dumped
        assert len(engine_map) >= THREADS * len(keys)


class TestShardedIndexStorm:
    """Reader/writer storms across the lock-striped shards: scoring
    readers (lookup + lookup_chain), kvevents-style writers (add /
    batched add / evict), and admin sweeps (dump, purge) all at once.
    The per-shard locks must never lose an update, deadlock, or hand a
    reader a torn snapshot."""

    @pytest.mark.parametrize("shards", [1, 4, 16])
    def test_reader_writer_storm_across_shards(self, shards):
        index = InMemoryIndex(
            InMemoryIndexConfig(
                size=50_000, pod_cache_size=THREADS + 2, shards=shards
            )
        )
        keys = list(range(256))
        errors = []
        barrier = threading.Barrier(THREADS)

        def writer(worker_id: int):
            rng = random.Random(worker_id)
            pod = PodEntry(f"pod-{worker_id}", "hbm")
            try:
                barrier.wait()
                for i in range(OPS):
                    start = rng.randrange(len(keys) - 8)
                    chain = keys[start:start + 8]
                    engine = [k * 1000 + worker_id for k in chain]
                    if i % 3 == 0:
                        # The kvevents batched-apply surface.
                        index.add_mappings(engine, chain)
                        index.add_entries_batch([(chain, [pod])])
                    else:
                        index.add(engine, chain, [pod])
                    if i % 5 == 0:
                        index.evict(engine[0], [pod])
                for key in keys:
                    index.add([key * 1000 + worker_id], [key], [pod])
            except Exception as exc:  # pragma: no cover - failure path
                errors.append(exc)

        def reader(worker_id: int):
            rng = random.Random(1000 + worker_id)
            try:
                barrier.wait()
                for i in range(OPS):
                    start = rng.randrange(len(keys) - 16)
                    chain = keys[start:start + 16]
                    if i % 2 == 0:
                        for pods in index.lookup_chain(chain):
                            # A torn snapshot would not be a tuple of
                            # PodEntry.
                            assert all(
                                isinstance(p, PodEntry) for p in pods
                            )
                    else:
                        index.lookup(chain, None)
                    if i % 29 == 0:
                        index.dump_entries()
                    if i % 97 == 0:
                        index.purge_pod(f"pod-{rng.randrange(4)}")
            except Exception as exc:  # pragma: no cover - failure path
                errors.append(exc)

        threads = [
            threading.Thread(target=writer, args=(i,))
            for i in range(THREADS // 2)
        ] + [
            threading.Thread(target=reader, args=(i,))
            for i in range(THREADS - THREADS // 2)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors

        # Writers' final adds all visible (readers' purges only target
        # pods 0-3 mid-storm; re-add them to normalize, then assert no
        # lost updates for every writer pod).
        writer_ids = range(THREADS // 2)
        for worker_id in writer_ids:
            pod = PodEntry(f"pod-{worker_id}", "hbm")
            for key in keys:
                index.add([key * 1000 + worker_id], [key], [pod])
        hits = index.lookup(keys, None)
        for key in keys:
            pods = {entry.pod_identifier for entry in hits.get(key, [])}
            missing = {
                f"pod-{worker_id}" for worker_id in writer_ids
            } - pods
            assert not missing, f"key {key} lost adds from {missing}"


class TestScoreMemoStorm:
    """Scoring readers hammering the memoized read path (fills, hits,
    version-invalidated re-walks) while writers mutate the index: no
    exceptions, and at quiesce the memoized fast lane agrees exactly
    with a straight-path walk over the same index."""

    def test_memoized_scoring_vs_concurrent_writers(self):
        Indexer = _mod(port, "kvcache.indexer", "Indexer")
        IndexerConfig = _mod(port, "kvcache.indexer", "IndexerConfig")
        EMPTY_BLOCK_HASH = _mod(port, "kvcache.kvblock.index", "EMPTY_BLOCK_HASH")
        IndexConfig = _mod(port, "kvcache.kvblock.index", "IndexConfig")
        Encoding = _mod(port, "tokenization.tokenizers", "Encoding")

        class WordTokenizer:
            def type(self):
                return "storm-word"

            def encode(self, prompt, model_name, add_special_tokens):
                tokens, offsets, pos = [], [], 0
                for word in prompt.split(" "):
                    tokens.append(int(word[1:]))
                    offsets.append((pos, pos + len(word)))
                    pos += len(word) + 1
                return Encoding(tokens=tokens, offsets=offsets)

        indexer = Indexer(
            IndexerConfig(
                token_processor_config=TokenProcessorConfig(block_size=4),
                kvblock_index_config=IndexConfig(
                    in_memory_config=InMemoryIndexConfig(
                        size=50_000, shards=4
                    )
                ),
                read_path_fast_lane=True,
            ),
            tokenizer=WordTokenizer(),
        )
        indexer.run()
        index = indexer.kv_block_index
        rng = random.Random(5)
        convos = [
            [rng.randrange(1, 60_000) for _ in range(80)]
            for _ in range(4)
        ]
        prompts = [" ".join(f"t{t}" for t in c) for c in convos]
        chains = [
            indexer.token_processor.tokens_to_kv_block_keys(
                EMPTY_BLOCK_HASH, c, "m"
            )
            for c in convos
        ]
        errors = []
        barrier = threading.Barrier(THREADS)

        def writer(worker_id):
            w_rng = random.Random(worker_id)
            pod = PodEntry(f"pod-{worker_id}", "hbm")
            try:
                barrier.wait()
                for _ in range(OPS):
                    chain = chains[w_rng.randrange(len(chains))]
                    cut = w_rng.randrange(1, len(chain) + 1)
                    index.add(chain[:cut], chain[:cut], [pod])
                    if w_rng.random() < 0.3:
                        index.evict(chain[0], [pod])
            except Exception as exc:  # pragma: no cover - failure path
                errors.append(exc)

        def reader(worker_id):
            r_rng = random.Random(100 + worker_id)
            try:
                barrier.wait()
                for _ in range(OPS):
                    prompt = prompts[r_rng.randrange(len(prompts))]
                    scores = indexer.get_pod_scores(prompt, "m")
                    assert all(v > 0 for v in scores.values()), scores
            except Exception as exc:  # pragma: no cover - failure path
                errors.append(exc)

        threads = [
            threading.Thread(target=writer, args=(i,))
            for i in range(THREADS // 2)
        ] + [
            threading.Thread(target=reader, args=(i,))
            for i in range(THREADS - THREADS // 2)
        ]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errors, errors
            # Quiesced: the memoized fast lane must agree bit-exactly
            # with the straight-line oracle over the same index, twice
            # (fill/validate, then a pure memo hit).
            for prompt in prompts:
                oracle = indexer._get_pod_scores_straight(prompt, "m")
                assert indexer.get_pod_scores(prompt, "m") == oracle
                assert indexer.get_pod_scores(prompt, "m") == oracle
        finally:
            indexer.shutdown()


class TestEventPoolOrdering:
    def test_per_pod_ordering_under_concurrency(self):
        """Events from one pod must apply in publish order even with
        many workers: a store chain built out of order would break the
        parent linkage and drop request keys."""
        token_db = ChunkedTokenDatabase(TokenProcessorConfig(block_size=4))
        index = InMemoryIndex(InMemoryIndexConfig(size=100_000))
        pool = Pool(index, token_db, PoolConfig(concurrency=4))
        pool.start()
        try:
            n_chains = 6
            chain_len = 20
            for pod_i in range(n_chains):
                pod = f"pod-{pod_i}"
                for j in range(chain_len):
                    event = BlockStored(
                        block_hashes=[0x1000 * (pod_i + 1) + j],
                        parent_block_hash=(
                            0x1000 * (pod_i + 1) + j - 1 if j else None
                        ),
                        token_ids=[j * 4 + t for t in range(4)],
                        block_size=4,
                        medium="hbm",
                    )
                    batch = EventBatch(ts=time.time(), events=[event])
                    pool.add_task(
                        Message(
                            topic=f"kv@{pod}@m",
                            payload=batch.encode(),
                            pod_identifier=pod,
                            model_name="m",
                            seq=j,
                        )
                    )
            pool.drain()
            # Every chain's full depth resolved: the last engine key of
            # each chain has a request key (parent linkage held).
            for pod_i in range(n_chains):
                last = 0x1000 * (pod_i + 1) + chain_len - 1
                assert index.get_request_key(last)
        finally:
            pool.shutdown()


class TestSubscriberManagerChurn:
    """Fleet churn storm over the consolidated poller registry:
    concurrent ensure_subscriber endpoint-flip restarts +
    remove_subscriber + shutdown racing the poller threads.  Asserts
    the registry stays consistent, no poller threads or sockets leak
    (thread names are the observable; sockets close when their poller
    exits or processes the detach — KV008 pins the static half), and
    no events are delivered for a pod after its detach returned."""

    def test_ensure_remove_shutdown_storm(self):
        import uuid as _uuid

        import zmq

        SubscriberManager = _mod(port, "kvevents.subscriber_manager", "SubscriberManager")

        def poller_threads():
            return [
                t
                for t in threading.enumerate()
                if t.name.startswith("kvtpu-evplane-poller-")
            ]

        before = len(poller_threads())
        context = zmq.Context.instance()
        run = _uuid.uuid4().hex
        manager = SubscriberManager(
            sink=lambda m: None,
            context=context,
            pollers=2,
            poll_interval_ms=5,
        )
        pods = [f"churn-{run}-{i}" for i in range(16)]
        stop = threading.Event()
        errors = []

        def churner(worker: int):
            rng = random.Random(worker)
            try:
                while not stop.is_set():
                    pod = rng.choice(pods)
                    op = rng.random()
                    if op < 0.5:
                        # Endpoint flip forces detach+attach restarts.
                        manager.ensure_subscriber(
                            pod,
                            f"tcp://127.0.0.1:{LOOPBACK_PORT + rng.randrange(1, 9)}",
                        )
                    elif op < 0.8:
                        manager.remove_subscriber(pod)
                    else:
                        manager.active_pods()
            except Exception as exc:  # noqa: BLE001 - surfaced below
                errors.append(exc)

        threads = [
            threading.Thread(target=churner, args=(i,)) for i in range(THREADS)
        ]
        for t in threads:
            t.start()
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert not errors, errors
        # Registry consistent: every listed pod detaches cleanly.
        for pod in manager.active_pods():
            assert manager.remove_subscriber(pod)
        assert manager.active_pods() == []
        manager.shutdown()
        # Shutdown is idempotent and racing churn can't resurrect it.
        assert not manager.ensure_subscriber(
            pods[0], f"tcp://127.0.0.1:{LOOPBACK_PORT + 1}"
        )
        manager.shutdown()
        assert len(poller_threads()) == before, (
            "poller threads leaked by the churn storm"
        )

    def test_no_events_after_detach_under_churn(self):
        import struct
        import uuid as _uuid

        import zmq

        SubscriberManager = _mod(port, "kvevents.subscriber_manager", "SubscriberManager")

        context = zmq.Context.instance()
        run = _uuid.uuid4().hex
        endpoint = f"inproc://churn-detach-{run}"
        delivered = []
        lock = threading.Lock()

        def sink(message):
            with lock:
                delivered.append(message.seq)

        pub = context.socket(zmq.PUB)
        pub.setsockopt(zmq.LINGER, 0)
        pub.bind(endpoint)
        manager = SubscriberManager(
            sink=sink, context=context, poll_interval_ms=5
        )
        try:
            manager.ensure_subscriber("cd", endpoint)
            seq = 0
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline and not delivered:
                seq += 1
                pub.send_multipart(
                    [b"kv@cd@m", struct.pack(">Q", seq), b"p"]
                )
                time.sleep(0.02)
            assert delivered, "subscription never became live"
            manager.remove_subscriber("cd")
            detach_marker = seq
            for _ in range(50):
                seq += 1
                pub.send_multipart(
                    [b"kv@cd@m", struct.pack(">Q", seq), b"p"]
                )
                time.sleep(0.002)
            time.sleep(0.2)
            with lock:
                late = [s for s in delivered if s > detach_marker]
            assert late == [], "events delivered after detach"
        finally:
            manager.shutdown()
            pub.close()


class TestTTLCacheUnderContention:
    def test_concurrent_set_sweep(self):
        evicted = []
        cache = TTLCache(0.02, on_evict=lambda k, v: evicted.append(k))
        stop = threading.Event()

        def setter():
            i = 0
            while not stop.is_set():
                cache.set(f"k{i % 50}", i)
                i += 1

        def sweeper():
            while not stop.is_set():
                cache.sweep()

        threads = [threading.Thread(target=setter) for _ in range(4)] + [
            threading.Thread(target=sweeper) for _ in range(2)
        ]
        for t in threads:
            t.start()
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        # No exceptions and the cache still functions.
        cache.set("alive", 1)
        assert cache.get("alive") == 1

    def test_eviction_skipped_when_key_reinserted(self):
        """A set() landing between expiry-removal and the on_evict call
        must not have its fresh entry torn down by the stale eviction
        (the subscriber-lifecycle race in the scheduler plugin)."""
        evicted = []
        cache = TTLCache(60.0, on_evict=lambda k, v: evicted.append((k, v)))

        # Deterministic interleave of the race window: the key was
        # already removed under the lock, and a concurrent set()
        # re-inserted it before the callback fires.
        cache.set("pod", "fresh-subscriber")
        cache._fire_eviction("pod", "stale-subscriber")
        assert evicted == []

        # Once the key is truly absent the eviction does fire.
        cache.delete("pod")
        cache._fire_eviction("pod", "stale-subscriber")
        assert evicted == [("pod", "stale-subscriber")]


class TestClusterFanoutStorm:
    """Pipelined fan-out vs membership kills: scoring readers drive the
    overlapped cluster read path (chunk pipelining + concurrent owner
    RPCs, arming forced) while a chaos thread kills and revives one
    replica at a time.  Every replica is seeded with the FULL record
    set (not just its slice + standby) and nothing writes during the
    storm, so no matter how kills, re-routes, and late failure reports
    interleave — a reader's in-flight mark_dead can land after the
    chaos thread already revived the victim, briefly removing two
    replicas from the ring — every read must equal the pre-storm
    oracle, not merely 'no exceptions'."""

    def test_pipelined_reads_survive_kill_revive(self, tmp_path):
        LocalCluster = _mod(port, "cluster", "LocalCluster")
        Indexer = _mod(port, "kvcache.indexer", "Indexer")
        IndexerConfig = _mod(port, "kvcache.indexer", "IndexerConfig")
        EMPTY_BLOCK_HASH = _mod(port, "kvcache.kvblock.index", "EMPTY_BLOCK_HASH")
        IndexConfig = _mod(port, "kvcache.kvblock.index", "IndexConfig")
        PodEntry = _mod(port, "kvcache.kvblock.index", "PodEntry")
        TokenizationPoolConfig = _mod(port, "tokenization.pool", "TokenizationPoolConfig")
        Encoding = _mod(port, "tokenization.tokenizers", "Encoding")

        class WordTokenizer:
            def type(self):
                return "storm-word"

            def encode(self, prompt, model_name, add_special_tokens):
                tokens, offsets, pos = [], [], 0
                for word in prompt.split(" "):
                    tokens.append(int(word[1:]))
                    offsets.append((pos, pos + len(word)))
                    pos += len(word) + 1
                return Encoding(tokens=tokens, offsets=offsets)

        cluster = LocalCluster(
            journal_root=str(tmp_path),
            # Force arming: the in-process transport's latency EWMA
            # would otherwise keep the storm on the sequential path.
            overlap_min_rpc_s=0,
        )
        indexer = Indexer(
            IndexerConfig(
                token_processor_config=TokenProcessorConfig(block_size=4),
                kvblock_index_config=IndexConfig(
                    in_memory_config=InMemoryIndexConfig(size=50_000)
                ),
                # Exact tokenization keeps every read on the chunked
                # drive (the prefix store would otherwise serve warm
                # repeats as one pre-hashed chunk and the storm would
                # stop exercising chunk pipelining after pass one).
                tokenizers_pool_config=TokenizationPoolConfig(
                    min_prefix_overlap_ratio=1.01
                ),
                read_path_fast_lane=True,
                lookup_chunk_size=8,
            ),
            tokenizer=WordTokenizer(),
            kv_block_index=cluster.remote_index,
        )
        indexer.run()
        try:
            rng = random.Random(11)
            pods = [
                PodEntry("pod-a", "hbm"),
                PodEntry("pod-b", "host"),
                PodEntry("pod-c", "shared_storage"),
            ]
            prompts = []
            for _ in range(6):
                tokens = [
                    rng.randrange(1, 60_000) for _ in range(96)
                ]
                chain = indexer.token_processor.tokens_to_kv_block_keys(
                    EMPTY_BLOCK_HASH, tokens, "m"
                )
                chosen = pods[: rng.randrange(1, len(pods) + 1)]
                cluster.remote_index.add(chain, chain, chosen)
                # Top every replica up to the full record set directly
                # (adds are idempotent): the ring can then route a key
                # anywhere during the storm — including the two-dead
                # window a late mark_dead opens — without changing what
                # a lookup returns.
                for replica in cluster.replicas.values():
                    replica.index.add(chain, chain, chosen)
                prompts.append(" ".join(f"t{t}" for t in tokens))
            # Drain the journal followers too, so the replication plane
            # is quiet (not mid-apply) when the storm starts.
            while cluster.sync_followers():
                pass

            # Two pre-storm passes pin the oracle and prove the read
            # path is repeat-stable before any chaos starts.
            oracle = [indexer.get_pod_scores(p, "m") for p in prompts]
            assert all(oracle), oracle
            assert [
                indexer.get_pod_scores(p, "m") for p in prompts
            ] == oracle

            readers = THREADS - 1
            errors = []
            stop = threading.Event()
            barrier = threading.Barrier(readers + 1)

            def reader(worker_id):
                r_rng = random.Random(200 + worker_id)
                try:
                    barrier.wait()
                    for _ in range(OPS):
                        pick = r_rng.randrange(len(prompts))
                        scores = indexer.get_pod_scores(
                            prompts[pick], "m"
                        )
                        assert scores == oracle[pick], (
                            pick,
                            scores,
                            oracle[pick],
                        )
                except Exception as exc:  # pragma: no cover - failure
                    errors.append(exc)

            def chaos():
                ids = list(cluster.replicas)
                turn = 0
                try:
                    barrier.wait()
                    while not stop.is_set():
                        victim = ids[turn % len(ids)]
                        turn += 1
                        cluster.kill(victim)
                        time.sleep(0.005)
                        cluster.transports[victim].revive()
                        cluster.membership.mark_alive(victim)
                        time.sleep(0.005)
                except Exception as exc:  # pragma: no cover - failure
                    errors.append(exc)

            threads = [
                threading.Thread(target=reader, args=(i,))
                for i in range(readers)
            ]
            chaos_thread = threading.Thread(target=chaos)
            for t in threads:
                t.start()
            chaos_thread.start()
            for t in threads:
                t.join(timeout=120)
            stop.set()
            chaos_thread.join(timeout=30)
            assert not errors, errors

            # Quiesce: revive everyone, then the pipelined lane must
            # still agree with the oracle AND the straight-path walk.
            for replica_id in cluster.transports:
                cluster.transports[replica_id].revive()
                cluster.membership.mark_alive(replica_id)
            for pick, prompt in enumerate(prompts):
                assert indexer.get_pod_scores(prompt, "m") == oracle[pick]
                assert (
                    indexer._get_pod_scores_straight(prompt, "m")
                    == oracle[pick]
                )

            stats = cluster.remote_index.rpc_stats()
            assert stats["fanout"]["armed"], stats["fanout"]
            assert stats["critical_path"]["speculative_rpcs"] > 0, stats
        finally:
            indexer.shutdown()
            cluster.close()


MODEL = "m"


def _random_value(rng: random.Random, depth: int = 0):
    """A random msgpack-encodable value (tests/test_kvevents_fuzz.py's),
    weighted toward the shapes the codec inspects."""
    kinds = ["int", "str", "bytes", "none", "float", "bool", "list", "dict"]
    if depth >= 3:
        kinds = kinds[:6]
    kind = rng.choice(kinds)
    if kind == "int":
        return rng.randint(-(2**63), 2**64 - 1)
    if kind == "str":
        return rng.choice(
            ["BlockStored", "BlockRemoved", "AllBlocksCleared", "x", ""]
        )
    if kind == "bytes":
        return rng.randbytes(rng.randint(0, 12))
    if kind == "none":
        return None
    if kind == "float":
        return rng.choice(
            [rng.random() * 1e9, float("inf"), float("-inf"), float("nan")]
        )
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "list":
        return [
            _random_value(rng, depth + 1) for _ in range(rng.randint(0, 5))
        ]
    return {
        str(i): _random_value(rng, depth + 1)
        for i in range(rng.randint(0, 3))
    }


class TestPoolSurvivesStorm:
    """tests/test_kvevents_fuzz.py's storm on the port's pool, which
    decodes with its own msgpack codec: garbage payloads are dropped and
    valid events delivered afterwards still index."""

    def test_garbage_storm_then_valid_events(self):
        EMPTY_BLOCK_HASH = _mod(port, "kvcache.kvblock.token_processor", "EMPTY_BLOCK_HASH")
        rng = random.Random(4)
        index = InMemoryIndex(InMemoryIndexConfig(size=10_000))
        db = ChunkedTokenDatabase(TokenProcessorConfig(block_size=4))
        pool = Pool(index, db, PoolConfig(concurrency=2))
        pool.start()
        try:
            payloads = []
            for _ in range(100):
                payloads.append(msgpack.packb(_random_value(rng)))
                payloads.append(rng.randbytes(rng.randint(0, 48)))
                event = ["BlockStored"] + [
                    _random_value(rng) for _ in range(rng.randint(0, 8))
                ]
                payloads.append(msgpack.packb([1.0, [event], None]))
            for i, payload in enumerate(payloads):
                pod = f"pod-{i % 4}"
                pool.add_task(
                    Message(
                        topic=f"kv@{pod}@{MODEL}",
                        payload=payload,
                        pod_identifier=pod,
                        model_name=MODEL,
                    )
                )
            pool.drain()  # storm fully digested, no wedged worker

            # Workers still index valid events after the storm.
            tokens = [1, 2, 3, 4]
            batch = EventBatch(
                ts=2.0,
                events=[
                    BlockStored(
                        block_hashes=[0x77],
                        parent_block_hash=None,
                        token_ids=tokens,
                        block_size=4,
                    )
                ],
            )
            pool.add_task(
                Message(
                    topic="kv@pod-0@" + MODEL,
                    payload=batch.encode(),
                    pod_identifier="pod-0",
                    model_name=MODEL,
                )
            )
            pool.drain()
            keys = db.tokens_to_kv_block_keys(
                EMPTY_BLOCK_HASH, tokens, MODEL
            )
            hits = index.lookup(keys)
            assert hits and "pod-0" in {
                e.pod_identifier for pods in hits.values() for e in pods
            }
        finally:
            pool.shutdown()
