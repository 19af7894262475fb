"""The port's event plane against the JAX package's, on the CPU: sequence
tracking and frame parsing, the wire both ways over ZMQ on the loopback
(the port's ``Publisher`` into the reference's ``SubscriberManager`` and
``Pool``, and the reverse), publisher coalescing, gap-driven resync and
the Kubernetes pod reconciler (with a fake API client: no network).
The card's machine has no pyzmq, so these socket paths are checked here
only."""

import random
import struct
import threading
import time

import pytest
import zmq

from llm_d_kv_cache_manager_tpu.kvcache.kvblock import (
    ChunkedTokenDatabase as RefTokenDB,
    TokenProcessorConfig as RefTokenConfig,
)
from llm_d_kv_cache_manager_tpu.kvcache.kvblock.in_memory import InMemoryIndex as RefIndex
from llm_d_kv_cache_manager_tpu.kvcache.kvblock.index import (
    InMemoryIndexConfig as RefIndexConfig,
)
from llm_d_kv_cache_manager_tpu.kvevents import events as ref_events
from llm_d_kv_cache_manager_tpu.kvevents import pod_reconciler as ref_reconciler
from llm_d_kv_cache_manager_tpu.kvevents import pool as ref_pool
from llm_d_kv_cache_manager_tpu.kvevents import publisher as ref_publisher
from llm_d_kv_cache_manager_tpu.kvevents import resync as ref_resync
from llm_d_kv_cache_manager_tpu.kvevents import subscriber_manager as ref_manager
from llm_d_kv_cache_manager_tpu.kvevents import zmq_subscriber as ref_zs
from tests.helpers.torch_port import port

MODEL = "m"
BLOCK = 4


def mods(side: str):
    """One package's event-plane modules, by the reference's names."""
    if side == "ref":
        return dict(events=ref_events, pool=ref_pool, publisher=ref_publisher,
                    resync=ref_resync, manager=ref_manager, zs=ref_zs,
                    reconciler=ref_reconciler)
    return {name: port(f"kvevents.{mod}") for name, mod in (
        ("events", "events"), ("pool", "pool"), ("publisher", "publisher"),
        ("resync", "resync"), ("manager", "subscriber_manager"), ("zs", "zmq_subscriber"),
        ("reconciler", "pod_reconciler"))}


def make_pool(side: str, journal=None, **config):
    if side == "ref":
        index = RefIndex(RefIndexConfig(size=100_000))
        db = RefTokenDB(RefTokenConfig(block_size=BLOCK))
    else:
        im, index_mod = port("kvcache.kvblock.in_memory"), port("kvcache.kvblock.index")
        tp = port("kvcache.kvblock.token_processor")
        index = im.InMemoryIndex(index_mod.InMemoryIndexConfig(size=100_000))
        db = tp.ChunkedTokenDatabase(tp.TokenProcessorConfig(block_size=BLOCK))
    m = mods(side)["pool"]
    return m.Pool(index, db, m.PoolConfig(**config), journal=journal), index, db


def index_state(index):
    block_entries, engine_map = index.dump_entries()
    return (sorted((key, tuple(sorted((e.pod_identifier, e.device_tier) for e in pods)))
                   for key, pods in block_entries), sorted(engine_map))


def event_calls(side: str, seed: int, n: int = 30):
    """A seeded list of publish calls (each a list of one package's
    events): chained stores, removals and the occasional clear."""
    ev = mods(side)["events"]
    rng = random.Random(seed)
    calls, tail, stored = [], None, []
    for i in range(n):
        roll = rng.random()
        if roll < 0.2 and stored:
            victim = stored.pop(rng.randrange(len(stored)))
            tail = None if victim == tail else tail
            calls.append([ev.BlockRemoved(block_hashes=[victim])])
        elif roll < 0.25:
            calls.append([ev.AllBlocksCleared()])
        else:
            hashes = [5000 + 10 * i + j for j in range(rng.randint(1, 3))]
            calls.append([ev.BlockStored(
                block_hashes=hashes, parent_block_hash=tail if rng.random() < 0.6 else None,
                token_ids=[(7 * i + j) % 3000 + 1 for j in range(BLOCK * len(hashes))],
                block_size=BLOCK, medium=rng.choice([None, "gpu", "host"]))])
            tail = hashes[-1]
            stored.extend(hashes)
    return calls


# ------------------------------------------------------------ seq tracking


def test_topic_seq_tracker_classifies_as_the_reference():
    """In order, gaps, duplicates and restarts over three topics."""
    rng = random.Random(3)
    observations, last = [], {}
    for _ in range(2000):
        topic = rng.choice(["a", "b", "c"])
        seq = max(1, last.get(topic, 0) + rng.choice([-30, -1, 0, 1, 1, 1, 2, 6]))
        last[topic] = seq
        observations.append((topic, seq))
    results = {}
    for side in ("ref", "port"):
        tracker = mods(side)["zs"].TopicSeqTracker()
        seen = [tracker.observe(topic, seq) for topic, seq in observations]
        results[side] = ([(o.gap, o.restarted, o.duplicate) for o in seen],
                         tracker.gap_count, tracker.restart_count)
    assert results["port"] == results["ref"]
    assert results["ref"][1] and results["ref"][2]


def _frames():
    seq = lambda n: struct.pack(">Q", n)  # noqa: E731
    return [
        [b"kv@p@m", seq(5), b"x"], [b"kv@p@m", seq(6), b"y"], [b"kv@p@m", seq(6), b"dup"],
        [b"kv@p@m", seq(2), b"restart"], [b"kv@p@m", seq(9), b"gap"],
        [b"kv@p@lora@x", seq(1), b"lora"], [b"kv@p@m", b"short", b"noseq"],
        [b"kv@p@m", seq(10)], [b"kv@p@m", seq(11), b"a", b"b"], [b"\xff\xfe", seq(1), b"z"],
        [b"xx@p@m", seq(1), b"z"], [b"kv@@m", seq(1), b"z"], [b"kv@p@", seq(1), b"z"],
        [b"kv@other@m", seq(1), memoryview(b"mv")],
    ]


def test_parse_event_message_is_the_references():
    """Each frame: the same Message (or None) and the same gap callbacks,
    duplicates dropped, restarts not counted as gaps."""
    outs = {}
    for side in ("ref", "port"):
        zs = mods(side)["zs"]
        tracker, gaps, got = zs.TopicSeqTracker(), [], []
        for parts in _frames():
            m = zs.parse_event_message(parts, endpoint="e", pod_identifier="p",
                                       tracker=tracker,
                                       on_gap=lambda pod, topic, gap: gaps.append((pod, gap)))
            got.append(None if m is None else (m.topic, bytes(m.payload), m.pod_identifier,
                                               m.model_name, m.seq, m.seq_gap))
        outs[side] = (got, gaps, tracker.gap_count, tracker.restart_count)
    assert outs["port"] == outs["ref"]
    assert outs["ref"][1] == [("p", 6)]
    for name in ("kv@pod@model", "kv@pod@lora@x", "kv@@m", "xx", "kv@p@"):
        assert mods("port")["zs"].parse_topic(name) == ref_zs.parse_topic(name)


# ----------------------------------------------------- the wire, both ways


def _wire(pub_side: str, sub_side: str, calls, pod: str):
    """``pub_side``'s Publisher bound on the loopback, ``sub_side``'s
    SubscriberManager + Pool connected to it.  Empty batches are
    published until the subscription is live (PUB/SUB drops frames
    before the join), then the calls; returns the subscriber's index."""
    pool, index, _ = make_pool(sub_side, concurrency=2)
    pool.start()
    seen, seen_lock = [], threading.Lock()

    def sink_batch(messages):
        with seen_lock:
            seen.extend(messages)
        pool.add_tasks(messages)

    manager = mods(sub_side)["manager"].SubscriberManager(sink=pool.add_task,
                                                          sink_batch=sink_batch)
    pub = mods(pub_side)["publisher"].Publisher("tcp://127.0.0.1:0", pod, MODEL, bind=True)
    try:
        manager.ensure_subscriber(pod, pub.endpoint)
        deadline = time.monotonic() + 20
        while not seen and time.monotonic() < deadline:
            pub.publish()
            time.sleep(0.02)
        assert seen, "the subscription never joined"
        with seen_lock:
            joined = len(seen)
        for call in calls:
            pub.publish(*call)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            with seen_lock:
                if len(seen) >= joined + len(calls):
                    break
            time.sleep(0.01)
        pool.drain()
        gaps = manager.gap_count(pod)
    finally:
        pub.close()
        manager.shutdown()
        pool.shutdown()
    return index, gaps


def _direct(side: str, calls, pod: str):
    """The same calls applied without a socket."""
    pool, index, _ = make_pool(side, concurrency=2)
    ev, m = mods(side)["events"], mods(side)["pool"]
    pool.start()
    pool.add_tasks([m.Message(topic=f"kv@{pod}@{MODEL}",
                              payload=ev.EventBatch(ts=0.0, events=call).encode(),
                              pod_identifier=pod, model_name=MODEL, seq=i + 1)
                    for i, call in enumerate(calls)])
    pool.drain()
    pool.shutdown()
    return index


@pytest.mark.parametrize("pub_side,sub_side", [("port", "ref"), ("ref", "port")])
def test_wire_compatibility_both_ways(pub_side, sub_side):
    """Frames published by either package's Publisher are ingested by the
    other's SubscriberManager + Pool with the index the frames give when
    applied directly."""
    pod = f"wire-{pub_side}"
    index, gaps = _wire(pub_side, sub_side, event_calls(pub_side, 1), pod)
    want = index_state(_direct("ref", event_calls("ref", 1), pod))
    assert index_state(index) == want and want[0]
    assert gaps == 0


def _drain_sub(zs, sock, tracker, pod):
    out = []
    while True:
        try:
            parts = sock.recv_multipart(zmq.NOBLOCK)
        except zmq.Again:
            return out
        message = zs.parse_event_message(parts, endpoint="e", pod_identifier=pod,
                                         tracker=tracker)
        if message is not None:
            out.append(message)


def _publish_inproc(side: str, coalesce: int, seed: int):
    """Every call through one Publisher over inproc, a forced skip of 3
    seqs midway; returns the received messages and the tracker."""
    m, zs = mods(side), mods(side)["zs"]
    context = zmq.Context.instance()
    name = f"co-{side}-{coalesce}-{seed}"
    pub = m["publisher"].Publisher(f"inproc://{name}", "co", MODEL, context=context,
                                   coalesce_events=coalesce, coalesce_ms=60_000.0)
    sub = context.socket(zmq.SUB)
    sub.setsockopt(zmq.LINGER, 0)
    sub.setsockopt(zmq.SUBSCRIBE, b"")
    sub.connect(f"inproc://{name}")
    time.sleep(0.05)
    calls = event_calls(side, seed, 40)
    for j, call in enumerate(calls):
        if j == len(calls) // 2:
            pub.flush()
            pub.advance_seq(3)
        pub.publish(*call)
    pub.flush()
    time.sleep(0.05)
    tracker = zs.TopicSeqTracker()
    messages = _drain_sub(zs, sub, tracker, "co")
    pub.close()
    sub.close()
    return messages, tracker


def test_coalesced_publisher_equals_uncoalesced():
    """The port's coalescing publisher: fewer frames, the same gap count
    and the same index as its uncoalesced stream and as the reference's."""
    states, frames = {}, {}
    for side, coalesce in (("port", 8), ("port", 0), ("ref", 0)):
        messages, tracker = _publish_inproc(side, coalesce, 9)
        assert tracker.gap_count == 3 and tracker.restart_count == 0
        pool, index, _ = make_pool("port", concurrency=1)
        pool.start()
        pool.add_tasks([port("kvevents.pool").Message(
            topic=msg.topic, payload=msg.payload, pod_identifier=msg.pod_identifier,
            model_name=msg.model_name, seq=msg.seq) for msg in messages])
        pool.drain()
        pool.shutdown()
        states[(side, coalesce)] = index_state(index)
        frames[(side, coalesce)] = len(messages)
    assert states[("port", 8)] == states[("port", 0)] == states[("ref", 0)]
    assert frames[("port", 8)] < frames[("port", 0)] == frames[("ref", 0)]


def test_publisher_seqs_flush_and_close():
    pub = mods("port")["publisher"].Publisher("inproc://port-flush", "p", MODEL,
                                              context=zmq.Context.instance(),
                                              coalesce_events=10, coalesce_ms=60_000.0)
    ev = mods("port")["events"]
    stored = ev.BlockStored(block_hashes=[1], parent_block_hash=None, token_ids=[1, 2, 3, 4],
                            block_size=BLOCK)
    assert pub.publish(stored) is None and pub.publish(stored) is None
    assert pub.flush() == 1 and pub.flush() is None
    seqs = [pub.publish(stored) for _ in range(10)]
    assert seqs[:-1] == [None] * 9 and seqs[-1] == 2
    assert pub.advance_seq(4) == 6
    assert pub.topic == f"kv@p@{MODEL}"
    pub.close()
    with pytest.raises(zmq.ZMQError):
        pub.publish(stored)


# ------------------------------------------------------------------ resync


def _seeded_pool(side: str):
    """A pool whose index holds a live chain for two pods and a stale
    claim for pod-r that its inventory will not contain."""
    pool, index, db = make_pool(side, concurrency=2)
    ev, m = mods(side)["events"], mods(side)["pool"]
    pool.start()
    for pod, base in (("pod-r", 0xA0), ("pod-s", 0xB0)):
        pool.add_tasks([m.Message(topic=f"kv@{pod}@{MODEL}", payload=ev.EventBatch(
            ts=1.0, events=[ev.BlockStored(block_hashes=[base, base + 1], parent_block_hash=None,
                                           token_ids=[base + j for j in range(2 * BLOCK)],
                                           block_size=BLOCK)]).encode(),
            pod_identifier=pod, model_name=MODEL, seq=1)])
    pool.drain()
    return pool, index


@pytest.mark.parametrize("source_kind", ["inventory", "empty", "failing"])
def test_resync_purges_and_reapplies_as_the_reference(source_kind):
    outcomes = {}
    for side in ("ref", "port"):
        r = mods(side)["resync"]
        pool, index = _seeded_pool(side)
        if source_kind == "inventory":
            source = r.CallableInventorySource(lambda pod, r=r: r.PodInventory(
                pod, MODEL, [r.InventoryBlock(block_hashes=[0xC1, 0xC2],
                                              token_ids=[9] * BLOCK + [8] * BLOCK,
                                              block_size=BLOCK, medium="host"),
                             r.InventoryBlock(block_hashes=[0xC3], token_ids=[7] * BLOCK,
                                              block_size=BLOCK, parent_block_hash=0xC2)]))
        elif source_kind == "empty":
            source = r.EmptyInventorySource()
        else:
            source = r.CallableInventorySource(lambda pod: None)
        manager = r.ResyncManager(pool, source, r.ResyncConfig(max_attempts=1,
                                                               retry_backoff_s=0.0))
        # Marked twice before the worker starts: one queued resync.
        assert manager.mark_suspect("pod-r", MODEL)
        assert not manager.mark_suspect("pod-r", MODEL)
        manager.start()
        try:
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                stats = manager.stats()
                if stats["resyncs_ok"] + stats["resyncs_failed"]:
                    break
                time.sleep(0.005)
            pool.drain()
        finally:
            manager.close()
            pool.shutdown()
        stats = manager.stats()
        outcomes[side] = (index_state(index), stats["suspect"], stats["resyncs_ok"],
                          stats["resyncs_failed"])
    assert outcomes["port"] == outcomes["ref"]
    if source_kind == "failing":
        assert outcomes["ref"][1] == ["pod-r"]
    else:
        assert outcomes["ref"][1] == [] and outcomes["ref"][2] == 1


def test_gap_listener_marks_the_pod_suspect():
    r, zs = mods("port")["resync"], mods("port")["zs"]
    pool, _index, _ = make_pool("port")
    manager = r.ResyncManager(pool, r.EmptyInventorySource())
    tracker = zs.TopicSeqTracker()
    for seq in (1, 2, 8):
        zs.parse_event_message([b"kv@g@m", struct.pack(">Q", seq), b"x"], endpoint="e",
                               pod_identifier="g", tracker=tracker,
                               on_gap=manager.gap_listener)
    assert manager.suspect_pods() == ["g"] and tracker.gap_count == 5


# ---------------------------------------------------------- pod reconciler


class FakeManager:
    """A subscriber registry double: records calls, opens no socket."""

    def __init__(self):
        self.calls, self.pods = [], {}

    def ensure_subscriber(self, pod, endpoint, topic_filter=None):
        self.calls.append(("ensure", pod, endpoint, topic_filter))
        new = self.pods.get(pod) != endpoint
        self.pods[pod] = endpoint
        return new

    def remove_subscriber(self, pod):
        self.calls.append(("remove", pod))
        return self.pods.pop(pod, None) is not None

    def active_pods(self):
        return sorted(self.pods)


def make_pod(name, ip="10.1.0.1", phase="Running", ready=True):
    return {"kind": "Pod", "metadata": {"name": name, "namespace": "llm-d"},
            "status": {"phase": phase, "podIP": ip,
                       "conditions": [{"type": "Ready", "status": "True" if ready else "False"}]}}


class FakeClient:
    """The two API calls, from lists: no network."""

    def __init__(self, pods, events):
        self.pods, self.events = pods, events

    def list_pods(self):
        return {"metadata": {"resourceVersion": "7"}, "items": self.pods}

    def watch_pods(self, resource_version):
        assert resource_version == "7"
        yield from self.events
        raise TimeoutError("read timed out")


def test_pod_reconciler_converges_as_the_reference():
    pods = [make_pod("pod-a"), make_pod("pod-b", ip="fd00::2", ready=False), "junk",
            make_pod("pod-c", phase="Pending"), make_pod("pod-d", ip="10.1.0.4")]
    events = [42, {"type": "BOOKMARK"}, {"type": "ADDED", "object": "x"},
              {"type": "MODIFIED", "object": make_pod("pod-b", ip="fd00::2")},
              {"type": "DELETED", "object": make_pod("pod-a")},
              {"type": "ADDED", "object": {"kind": "Service"}},
              {"type": "ADDED", "object": make_pod("pod-e", ip=" 10.1.0.5 ")}]
    outcomes = {}
    for side in ("ref", "port"):
        rec = mods(side)["reconciler"]
        manager = FakeManager()
        manager.pods["llm-d/gone"] = "tcp://10.9.9.9:5557"
        manager.pods["local-subscriber"] = "tcp://x:1"
        reconciler = rec.PodReconciler(
            manager, rec.PodReconcilerConfig(api_server="http://fake", token="t"),
            client=FakeClient(pods, events))
        reconciler.run_once()
        outcomes[side] = (manager.calls, manager.active_pods())
        assert [rec.PodReconciler.should_subscribe(p) for p in pods[:2]] == [True, False]
    assert outcomes["port"] == outcomes["ref"]
    assert outcomes["ref"][1] == ["llm-d/pod-b", "llm-d/pod-d", "llm-d/pod-e",
                                  "local-subscriber"]
