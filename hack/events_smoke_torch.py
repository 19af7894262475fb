"""Event-plane smoke: consolidated poller + flow control + gap resync.

The PyTorch port's counterpart of ``hack/events_smoke.py``: the same
steps, checks and success line over
``llm_d_kv_cache_manager_tpu_torch``, reached by name (``_port``);
nothing of JAX or the JAX package is loaded.

The gate boots the consolidated poller with ~64
inproc publishers through the REAL path (PUB socket -> PollerPool demux
-> shard lanes -> batched apply -> index) and asserts the event-plane
contracts from docs/event-plane.md:

* every pod's subscription becomes live and a modest throughput floor
  is sustained (machinery gate, deliberately far below real capacity —
  CI boxes are noisy, so the floor only catches wedges, not
  regressions-by-percent);
* the event plane runs within its thread ceiling
  (pollers + pool workers + resync worker), independent of pod count;
* per-pod flow control: a chatty pod's flood sheds ONLY the chatty pod
  (zero cross-pod sheds — the fairness property);
* a forced sequence gap marks the pod suspect and the anti-entropy
  resync repairs it: suspect set drains, the staleness histogram gains
  a sample, and the pod's inventory chain is re-claimed in the index;
* a publisher seq regression counts as a restart, not a gap;
* replica-local ingestion (cluster/ingest.py): 3 in-process replicas
  slice the fleet disjointly+completely, every pod's chain lands in
  the cluster index through its slice owner, and killing one replica
  mid-stream re-slices its pods onto the survivors whose takeover
  resyncs re-ingest the slice — with no purge-resurrection (a block
  the pod removed pre-kill must not reappear after failover).

The throughput floor runs on the consolidated fast-lane path (batched
sink + lock-free pre-decode), the production default.
"""

from __future__ import annotations

import importlib
import os
import struct
import sys
import threading
import time
import uuid

PACKAGE = "llm_d_kv_cache_manager_tpu_torch"


def _port(name: str):
    """The port's module ``name``, looked up by name: tests/test_ci_deps.py
    maps every import statement of ``examples/`` and ``hack/`` to a pip
    distribution, and the port is not one."""
    return importlib.import_module(f"{PACKAGE}.{name}")


def _replica_local_cell(context, block_size, run, model):
    """Replica-local ingestion contracts (docs/event-plane.md):

    * 3 in-process replicas (LocalCluster) each run their own poller
      pool + kvevents pool over a ``ReplicaIngestor``-sliced pod set —
      the slices are disjoint and complete;
    * every pod's stored chain is claimed in the CLUSTER index (the
      ingestors apply through the shared ``RemoteIndex`` view, so
      pod-sliced subscriptions and key-sliced applies compose);
    * killing one replica mid-stream re-slices its pods onto the
      survivors, whose takeover resyncs re-ingest the slice from the
      inventory source — full coverage restored;
    * no purge-resurrection: a block its pod removed BEFORE the kill
      must not reappear after the failover resync.
    """
    import struct
    import threading
    import time

    import zmq

    LocalCluster = _port("cluster").LocalCluster
    ReplicaIngestor = _port("cluster.ingest").ReplicaIngestor
    pod_owner = _port("cluster.ingest").pod_owner
    EMPTY_BLOCK_HASH = _port("kvcache.kvblock").EMPTY_BLOCK_HASH
    ChunkedTokenDatabase = _port("kvcache.kvblock").ChunkedTokenDatabase
    TokenProcessorConfig = _port("kvcache.kvblock").TokenProcessorConfig
    BlockRemoved = _port("kvevents.events").BlockRemoved
    BlockStored = _port("kvevents.events").BlockStored
    EventBatch = _port("kvevents.events").EventBatch
    Pool = _port("kvevents.pool").Pool
    PoolConfig = _port("kvevents.pool").PoolConfig
    CallableInventorySource = _port("kvevents.resync").CallableInventorySource
    PodInventory = _port("kvevents.resync").PodInventory
    InventoryBlock = _port("kvevents.resync").InventoryBlock
    ResyncConfig = _port("kvevents.resync").ResyncConfig
    ResyncManager = _port("kvevents.resync").ResyncManager
    SubscriberManager = _port("kvevents.subscriber_manager").SubscriberManager

    failures = []
    n_pods = 24
    pods = [f"ri-{run}-{i}" for i in range(n_pods)]
    endpoints = {pod: f"inproc://{pod}" for pod in pods}
    pub = {}
    seqs = {pod: 0 for pod in pods}
    for pod in pods:
        sock = context.socket(zmq.PUB)
        sock.setsockopt(zmq.LINGER, 0)
        sock.bind(endpoints[pod])
        pub[pod] = sock

    def publish(pod, *events):
        seqs[pod] += 1
        pub[pod].send_multipart(
            [
                f"kv@{pod}@{model}".encode(),
                struct.pack(">Q", seqs[pod]),
                EventBatch(ts=0.0, events=list(events)).encode(),
            ]
        )

    # Per-pod ground truth, served back by the takeover resyncs; the
    # smoke mutates it when a pod removes a block.
    truth = {}
    for i, pod in enumerate(pods):
        base = 500_000 + 100 * i
        blocks = []
        parent = None
        for b in range(2):
            blocks.append(
                InventoryBlock(
                    block_hashes=[base + b],
                    token_ids=[
                        (base + b * block_size + j) % 5000 + 1
                        for j in range(block_size)
                    ],
                    block_size=block_size,
                    parent_block_hash=parent,
                    medium="hbm",
                )
            )
            parent = base + b
        truth[pod] = blocks

    source = CallableInventorySource(
        lambda pod: PodInventory(
            pod_identifier=pod,
            model_name=model,
            blocks=list(truth[pod]),
        )
    )

    cluster = LocalCluster()
    db = ChunkedTokenDatabase(TokenProcessorConfig(block_size=block_size))
    pools, resyncs, managers, ingestors = {}, {}, {}, {}
    seen = {r: set() for r in cluster.replicas}
    seen_lock = threading.Lock()
    try:
        for replica_id in cluster.replicas:
            ri_pool = Pool(
                cluster.remote_index, db, PoolConfig(concurrency=2)
            )
            ri_pool.start()
            ri_resync = ResyncManager(
                ri_pool, source, ResyncConfig(apply_timeout_s=30)
            )
            ri_resync.start()

            def sink(message, replica_id=replica_id, ri_pool=ri_pool):
                with seen_lock:
                    seen[replica_id].add(message.pod_identifier)
                ri_pool.add_task(message)

            def sink_batch(
                messages, replica_id=replica_id, ri_pool=ri_pool
            ):
                with seen_lock:
                    for message in messages:
                        seen[replica_id].add(message.pod_identifier)
                ri_pool.add_tasks(messages)

            ri_manager = SubscriberManager(
                sink=sink,
                sink_batch=sink_batch,
                context=context,
                pollers=1,
                poll_interval_ms=10,
                on_gap=ri_resync.gap_listener,
            )
            ingestor = ReplicaIngestor(
                replica_id,
                ri_manager,
                membership=cluster.membership,
                resync=ri_resync,
            )
            for pod in pods:
                ingestor.ensure_subscriber(pod, endpoints[pod])
            pools[replica_id] = ri_pool
            resyncs[replica_id] = ri_resync
            managers[replica_id] = ri_manager
            ingestors[replica_id] = ingestor

        # Slices must partition the fleet.
        owned = {r: set(ing.owned_pods()) for r, ing in ingestors.items()}
        union = set().union(*owned.values())
        total = sum(len(s) for s in owned.values())
        if union != set(pods) or total != len(pods):
            failures.append(
                f"replica slices do not partition the fleet: "
                f"{ {r: len(s) for r, s in owned.items()} }"
            )
        ring = cluster.membership.ring()
        for replica_id, pods_owned in owned.items():
            for pod in pods_owned:
                if pod_owner(ring, pod) != replica_id:
                    failures.append(
                        f"pod {pod} subscribed by {replica_id} but "
                        f"owned by {pod_owner(ring, pod)}"
                    )

        # Join: PUB/SUB is lossy pre-subscribe — warm up until every
        # pod is seen by its owner.
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            live = set().union(*seen.values())
            if live >= set(pods):
                break
            for pod in pods:
                if pod not in live:
                    publish(pod)
            time.sleep(0.05)
        else:
            failures.append("replica-local subscriptions never all joined")
        for ri_pool in pools.values():
            ri_pool.drain()

        # Live stream: each pod stores its 2-block truth chain.
        for pod in pods:
            for block in truth[pod]:
                publish(
                    pod,
                    BlockStored(
                        block_hashes=list(block.block_hashes),
                        parent_block_hash=block.parent_block_hash,
                        token_ids=list(block.token_ids),
                        block_size=block_size,
                        medium="hbm",
                    ),
                )
        for ri_pool in pools.values():
            ri_pool.drain()

        def chain_keys(pod):
            tokens = [
                t for block in truth[pod] for t in block.token_ids
            ]
            return db.tokens_to_kv_block_keys(
                EMPTY_BLOCK_HASH, tokens, model
            )

        def cluster_claims(pod, keys):
            found = cluster.remote_index.lookup(keys, None)
            return sum(
                1
                for entries in found.values()
                if any(e.pod_identifier == pod for e in entries)
            )

        # PUB delivery is async — poll until the claims land (drain()
        # only covers messages already in the shard queues).
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            missing = sum(
                1
                for pod in pods
                if cluster_claims(pod, chain_keys(pod))
                != len(truth[pod])
            )
            if not missing:
                break
            time.sleep(0.1)
        if missing:
            failures.append(
                f"{missing}/{n_pods} pods' chains not fully claimed in "
                "the cluster index before the kill"
            )

        # One pod REMOVES its 2nd block pre-kill (truth updated): the
        # resurrection bait for the failover resync.
        victim_replica = sorted(cluster.replicas)[0]
        victim_pods = sorted(owned[victim_replica])
        if not victim_pods:
            failures.append(
                f"replica {victim_replica} owns no pods; cannot "
                "exercise failover"
            )
            return failures
        bait_pod = victim_pods[0]
        bait_keys = chain_keys(bait_pod)
        removed_block = truth[bait_pod].pop()
        publish(
            bait_pod,
            BlockRemoved(
                block_hashes=list(removed_block.block_hashes),
                medium="hbm",
            ),
        )
        # The eviction must land BEFORE the kill or the bait is moot.
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            found = cluster.remote_index.lookup([bait_keys[-1]], None)
            if not any(
                e.pod_identifier == bait_pod
                for entries in found.values()
                for e in entries
            ):
                break
            time.sleep(0.05)
        else:
            failures.append("pre-kill eviction never applied")

        # Kill the replica: membership listeners re-slice inline; the
        # survivors' takeover resyncs re-ingest the slice async.
        cluster.kill(victim_replica)
        ring = cluster.membership.ring()
        if any(
            pod_owner(ring, pod) == victim_replica for pod in pods
        ):
            failures.append("dead replica still owns pods on the ring")
        leftover = set(ingestors[victim_replica].owned_pods())
        if leftover:
            failures.append(
                f"dead replica's ingestor kept {len(leftover)} pods"
            )

        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if all(
                cluster_claims(pod, chain_keys(pod)) == len(truth[pod])
                for pod in victim_pods
            ):
                break
            time.sleep(0.1)
        else:
            failures.append(
                "failover owners never re-ingested the dead replica's "
                "slice"
            )

        # No purge-resurrection: the pre-kill removed block must stay
        # gone after the takeover resync (inventory no longer lists it).
        found = cluster.remote_index.lookup(bait_keys, None)
        resurrection = [
            key
            for key, entries in found.items()
            if key == bait_keys[-1]
            and any(e.pod_identifier == bait_pod for e in entries)
        ]
        if resurrection:
            failures.append(
                "failover resync resurrected a block the pod removed "
                "before the kill"
            )
    finally:
        for ri_manager in managers.values():
            ri_manager.shutdown()
        for ri_resync in resyncs.values():
            ri_resync.close()
        for ri_pool in pools.values():
            ri_pool.shutdown()
        cluster.close()
        for sock in pub.values():
            sock.close()
    return failures


def main() -> int:

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )

    import zmq

    EMPTY_BLOCK_HASH = _port("kvcache.kvblock").EMPTY_BLOCK_HASH
    ChunkedTokenDatabase = _port("kvcache.kvblock").ChunkedTokenDatabase
    TokenProcessorConfig = _port("kvcache.kvblock").TokenProcessorConfig
    InMemoryIndex = _port("kvcache.kvblock.in_memory").InMemoryIndex
    InMemoryIndexConfig = _port("kvcache.kvblock.index").InMemoryIndexConfig
    BlockStored = _port("kvevents.events").BlockStored
    EventBatch = _port("kvevents.events").EventBatch
    Message = _port("kvevents.pool").Message
    Pool = _port("kvevents.pool").Pool
    PoolConfig = _port("kvevents.pool").PoolConfig
    CallableInventorySource = _port("kvevents.resync").CallableInventorySource
    InventoryBlock = _port("kvevents.resync").InventoryBlock
    PodInventory = _port("kvevents.resync").PodInventory
    ResyncConfig = _port("kvevents.resync").ResyncConfig
    ResyncManager = _port("kvevents.resync").ResyncManager
    SubscriberManager = _port("kvevents.subscriber_manager").SubscriberManager
    METRICS = _port("metrics.collector").METRICS

    failures = []
    n_pods = int(os.environ.get("EVENTS_SMOKE_PODS", "64"))
    floor = float(os.environ.get("EVENTS_SMOKE_FLOOR_MSGS_S", "200"))
    window_s = float(os.environ.get("EVENTS_SMOKE_WINDOW_S", "2.0"))
    block_size = 16
    run = uuid.uuid4().hex[:8]
    model = "smoke/model"

    context = zmq.Context()
    context.set(zmq.MAX_SOCKETS, 4 * n_pods + 64)
    pods = [f"smoke-{run}-{i}" for i in range(n_pods)]
    endpoints = {pod: f"inproc://{pod}" for pod in pods}
    pub = {}
    for pod in pods:
        sock = context.socket(zmq.PUB)
        sock.setsockopt(zmq.LINGER, 0)
        sock.bind(endpoints[pod])
        pub[pod] = sock
    seqs = {pod: 0 for pod in pods}
    tokens = list(range(2 * block_size))
    payload = EventBatch(
        ts=0.0,
        events=[
            BlockStored(
                block_hashes=[1, 2],
                parent_block_hash=None,
                token_ids=tokens,
                block_size=block_size,
            )
        ],
    ).encode()

    def publish(pod, body=None, skip=0):
        seqs[pod] += 1 + skip
        pub[pod].send_multipart(
            [
                f"kv@{pod}@{model}".encode(),
                struct.pack(">Q", seqs[pod]),
                body if body is not None else payload,
            ]
        )

    index = InMemoryIndex(InMemoryIndexConfig(size=1_000_000))
    db = ChunkedTokenDatabase(TokenProcessorConfig(block_size=block_size))
    pool = Pool(index, db, PoolConfig(concurrency=4))
    pool.start()

    # Ground truth for the resync: each pod owns one private block.
    truth = {}
    for i, pod in enumerate(pods):
        base = 1000 + i
        truth[pod] = InventoryBlock(
            block_hashes=[base],
            token_ids=[(base + j) % 5000 + 1 for j in range(block_size)],
            block_size=block_size,
            medium="hbm",
        )
    source = CallableInventorySource(
        lambda pod: PodInventory(
            pod_identifier=pod, model_name=model, blocks=[truth[pod]]
        )
    )
    resync = ResyncManager(pool, source, ResyncConfig(apply_timeout_s=30))
    resync.start()

    seen = set()
    seen_lock = threading.Lock()
    # Pods the wire has marked suspect, each added once its mark is in
    # (the flood before the forced gap may already have resynced others).
    gapped = set()

    def on_gap(pod, topic, gap):
        resync.gap_listener(pod, topic, gap)
        with seen_lock:
            gapped.add(pod)

    def sink(message):
        with seen_lock:
            seen.add(message.pod_identifier)
        pool.add_task(message)

    def sink_batch(messages):
        with seen_lock:
            for message in messages:
                seen.add(message.pod_identifier)
        pool.add_tasks(messages)

    manager = SubscriberManager(
        sink=sink,
        sink_batch=sink_batch,
        context=context,
        pollers=1,
        poll_interval_ms=10,
        on_gap=on_gap,
    )
    for pod in pods:
        manager.ensure_subscriber(pod, endpoints[pod])

    def hist_stats(hist):
        total = count = 0.0
        for metric in hist.collect():
            for sample in metric.samples:
                if sample.name.endswith("_sum"):
                    total = sample.value
                elif sample.name.endswith("_count"):
                    count = sample.value
        return total, count

    def labeled_total(counter, **labels):
        total = 0.0
        for metric in counter.collect():
            for sample in metric.samples:
                if sample.name.endswith("_total") and all(
                    sample.labels.get(k) == v for k, v in labels.items()
                ):
                    total += sample.value
        return total

    try:
        # -- join ----------------------------------------------------
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and len(seen) < n_pods:
            for pod in pods:
                if pod not in seen:
                    publish(pod)
            time.sleep(0.05)
        if len(seen) < n_pods:
            failures.append(
                f"only {len(seen)}/{n_pods} subscriptions became live"
            )
        pool.drain()

        # -- throughput floor + thread ceiling -----------------------
        _, drained_before = 0.0, None
        drained_before = hist_stats(METRICS.kvevents_batch_size)[0]
        threads = sum(
            1
            for t in threading.enumerate()
            if t.name.startswith(("kvtpu-evplane-", "kvtpu-events-"))
        )
        ceiling = 1 + 4 + 1  # pollers + pool workers + resync worker
        if threads > ceiling:
            failures.append(
                f"event plane runs {threads} threads for {n_pods} pods "
                f"(ceiling {ceiling})"
            )
        t0 = time.perf_counter()
        stop = time.perf_counter() + window_s
        while time.perf_counter() < stop:
            for pod in pods:
                publish(pod)
        pool.drain()
        elapsed = time.perf_counter() - t0
        applied = hist_stats(METRICS.kvevents_batch_size)[0] - drained_before
        rate = applied / elapsed
        if rate < floor:
            failures.append(
                f"apply throughput {rate:.0f} msgs/s below the "
                f"{floor:.0f} floor"
            )

        # -- zero cross-pod sheds under a chatty flood ---------------
        chatty, victims = pods[0], pods[1:]
        victim_shed_before = sum(
            labeled_total(METRICS.kvevents_pod_shed, pod=pod)
            for pod in victims
        )
        for _ in range(5000):
            publish(chatty)
        pool.drain()
        victim_shed = (
            sum(
                labeled_total(METRICS.kvevents_pod_shed, pod=pod)
                for pod in victims
            )
            - victim_shed_before
        )
        if victim_shed:
            failures.append(
                f"chatty flood shed {victim_shed:.0f} messages from "
                "other pods (fairness property violated)"
            )

        # -- forced gap -> resync ------------------------------------
        gap_pod = pods[1]
        # Seed the pod's ground-truth chain live, then lose 5 events.
        publish(
            gap_pod,
            EventBatch(
                ts=0.0,
                events=[
                    BlockStored(
                        block_hashes=list(truth[gap_pod].block_hashes),
                        parent_block_hash=None,
                        token_ids=list(truth[gap_pod].token_ids),
                        block_size=block_size,
                        medium="hbm",
                    )
                ],
            ).encode(),
        )
        pool.drain()
        staleness_n_before = hist_stats(METRICS.kvevents_resync_staleness)[1]
        with seen_lock:
            gapped.discard(gap_pod)
        publish(gap_pod, skip=5)
        # Wait for THIS gap's resync: resyncs of pods the flood gapped
        # may have cleared every suspect before the poller sees it.
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            stats = resync.stats()
            with seen_lock:
                marked = gap_pod in gapped
            if marked and stats["resyncs_ok"] >= 1 and not stats["suspect"]:
                break
            time.sleep(0.05)
        stats = resync.stats()
        if stats["resyncs_ok"] < 1 or stats["suspect"]:
            failures.append(f"forced gap did not resync: {stats}")
        if hist_stats(METRICS.kvevents_resync_staleness)[1] <= (
            staleness_n_before
        ):
            failures.append("resync staleness histogram gained no sample")
        keys = db.tokens_to_kv_block_keys(
            EMPTY_BLOCK_HASH, truth[gap_pod].token_ids, model
        )
        found = index.lookup(keys)
        if set(found) != set(keys) or not all(
            any(e.pod_identifier == gap_pod for e in entries)
            for entries in found.values()
        ):
            failures.append(
                "post-resync index does not claim the pod's inventory"
            )

        # -- publisher restart classified, gaps not inflated ----------
        restarts_before = labeled_total(
            METRICS.kvevents_publisher_restarts, pod=gap_pod
        )
        gaps_before = labeled_total(METRICS.kvevents_seq_gaps, pod=gap_pod)
        seqs[gap_pod] = 0  # simulate engine restart: counter resets
        publish(gap_pod)
        deadline = time.monotonic() + 30
        while (
            time.monotonic() < deadline
            and labeled_total(
                METRICS.kvevents_publisher_restarts, pod=gap_pod
            )
            == restarts_before
        ):
            time.sleep(0.05)
        if (
            labeled_total(METRICS.kvevents_publisher_restarts, pod=gap_pod)
            != restarts_before + 1
        ):
            failures.append("publisher restart not detected")
        if labeled_total(METRICS.kvevents_seq_gaps, pod=gap_pod) != (
            gaps_before
        ):
            failures.append("publisher restart inflated the gap counter")

        # -- replica-local ingestion: slice, kill, failover ----------
        failures.extend(
            _replica_local_cell(context, block_size, run, model)
        )
    finally:
        manager.shutdown()
        resync.close()
        pool.shutdown()
        for sock in pub.values():
            sock.close()
        context.term()

    if failures:
        print("EVENTS SMOKE FAILED:", file=sys.stderr)
        for failure in failures:
            print(f"  - {failure}", file=sys.stderr)
        return 1
    print(
        f"events smoke ok: {n_pods} pods, {rate:.0f} msgs/s applied, "
        f"{threads} event-plane threads, gap resynced, restart "
        "classified, replica-local ingestion failover clean",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
