"""The port's KV-event write path against the JAX package's, on the CPU:
the port's own msgpack codec against the ``msgpack`` library (values,
bytes and raises, hypothesis over structures, raw bytes and mutated
batches), the wire model (``EventBatch.encode`` byte-equal, each side
decoding the other's payloads, the same payloads refused), and the
ingestion pool (one seeded event stream through both pools gives the
same index entries, the same engine -> request map and the same journal
records; the lock-free decode, the batched enqueue and the shard
queue's flow control and shed victims as in the reference)."""

import random
import struct
import threading

import msgpack
import numpy as np
import pytest

from llm_d_kv_cache_manager_tpu.kvcache.kvblock import (
    ChunkedTokenDatabase as RefTokenDB,
    TokenProcessorConfig as RefTokenConfig,
)
from llm_d_kv_cache_manager_tpu.kvcache.kvblock.in_memory import InMemoryIndex as RefIndex
from llm_d_kv_cache_manager_tpu.kvcache.kvblock.index import (
    InMemoryIndexConfig as RefIndexConfig,
)
from llm_d_kv_cache_manager_tpu.kvevents import events as ref_events
from llm_d_kv_cache_manager_tpu.kvevents import pool as ref_pool
from tests.helpers.torch_port import port

# Reached as the other port tests reach it (tests/test_ci_deps.py maps
# import statements to pip distributions).
hypothesis = pytest.importorskip("hypothesis")
HealthCheck, given, settings = hypothesis.HealthCheck, hypothesis.given, hypothesis.settings
st = hypothesis.strategies

codec = port("kvevents.msgpack_codec")
events = port("kvevents.events")
kvpool = port("kvevents.pool")

MODEL = "m"
BLOCK = 4
FUZZ = settings(deadline=None, suppress_health_check=list(HealthCheck), derandomize=True)


# ------------------------------------------------------------------ codec


def _norm(value):
    """A comparable form of a decoded value: timestamps and ext types of
    either package as tuples, floats by their bits (NaN included)."""
    if isinstance(value, (msgpack.Timestamp, codec.Timestamp)):
        return ("ts", value.seconds, value.nanoseconds)
    if isinstance(value, (msgpack.ExtType, codec.ExtType)):
        return ("ext", value.code, value.data)
    if isinstance(value, float):
        return ("f", struct.pack(">d", value))
    if isinstance(value, list):
        return [_norm(v) for v in value]
    if isinstance(value, dict):
        return [(_norm(k), _norm(v)) for k, v in value.items()]
    return value


def _kind(exc: Exception) -> str:
    """The class of a raise, in msgpack's vocabulary."""
    for name in ("ExtraData", "FormatError", "StackError", "UnicodeDecodeError",
                 "UnicodeEncodeError", "TypeError", "OverflowError"):
        if type(exc).__name__ == name:
            return name
    return "ValueError" if isinstance(exc, ValueError) else type(exc).__name__


def _unpack(fn, data):
    try:
        return ("ok", _norm(fn(data)))
    except Exception as exc:  # noqa: BLE001 - the raise is the result
        return ("raise", _kind(exc))


def _pack(fn, obj):
    try:
        return ("ok", fn(obj))
    except Exception as exc:  # noqa: BLE001 - the raise is the result
        return ("raise", _kind(exc))


def ref_unpackb(data):
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


def ref_packb(obj):
    return msgpack.packb(obj, use_bin_type=True)


_INTS = st.one_of(st.integers(-40, 300), st.integers(-2**63, 2**64 - 1),
                  st.integers(-2**70, 2**70))
_LEAVES = st.one_of(
    st.none(), st.booleans(), _INTS, st.floats(), st.text(max_size=40),
    st.text(min_size=30, max_size=300), st.binary(max_size=300),
    st.builds(lambda c, d: ("ext", c, d), st.integers(0, 127), st.binary(max_size=20)),
    st.builds(lambda s, n: ("ts", s, n), st.integers(-2**40, 2**40),
              st.integers(0, 10**9 - 1)))
_KEYS = st.one_of(st.text(max_size=5), st.integers(-5, 300), st.binary(max_size=3))
_TREES = st.recursive(
    _LEAVES,
    lambda inner: st.one_of(st.lists(inner, max_size=20), st.tuples(inner, inner),
                            st.dictionaries(_KEYS, inner, max_size=18)),
    max_leaves=60)


def _build(tree, ext, ts):
    """A drawn tree with its ext and timestamp leaves made by one
    package's classes."""
    if isinstance(tree, tuple) and len(tree) == 3 and tree[0] in ("ext", "ts"):
        return (ext if tree[0] == "ext" else ts)(tree[1], tree[2])
    if isinstance(tree, list):
        return [_build(t, ext, ts) for t in tree]
    if isinstance(tree, tuple):
        return tuple(_build(t, ext, ts) for t in tree)
    if isinstance(tree, dict):
        return {k: _build(v, ext, ts) for k, v in tree.items()}
    return tree


@settings(FUZZ, max_examples=300)
@given(_TREES)
def test_packb_is_byte_equal_to_msgpack(tree):
    """Over drawn structures (every format family: nil, bool, fixint and
    the 8-64 bit ints, float64, str, bin, array, map, ext and
    timestamps), ``packb`` gives msgpack's bytes or its raise, and
    ``unpackb`` reads them back as msgpack does."""
    want = _pack(ref_packb, _build(tree, msgpack.ExtType, msgpack.Timestamp))
    got = _pack(codec.packb, _build(tree, codec.ExtType, codec.Timestamp))
    assert got == want
    if want[0] == "ok":
        assert _unpack(codec.unpackb, want[1]) == _unpack(ref_unpackb, want[1])


@settings(FUZZ, max_examples=600)
@given(st.binary(max_size=64))
def test_unpackb_matches_msgpack_on_raw_bytes(data):
    assert _unpack(codec.unpackb, data) == _unpack(ref_unpackb, data)


def _valid_batch(rng: random.Random) -> bytes:
    evs = []
    for _ in range(rng.randint(0, 3)):
        kind = rng.random()
        if kind < 0.6:
            n = rng.randint(1, 3)
            hashes = [rng.randbytes(32) if rng.random() < 0.5 else rng.randrange(2**64)
                      for _ in range(n)]
            evs.append(ref_events.BlockStored(
                block_hashes=hashes, parent_block_hash=rng.choice([None, 7, b"\x01" * 32]),
                token_ids=[rng.randrange(1, 128256) for _ in range(n * BLOCK)],
                block_size=BLOCK, lora_id=rng.choice([None, 3]),
                medium=rng.choice([None, "gpu", "cpu"]),
                lora_name=rng.choice([None, "adapter"])))
        elif kind < 0.9:
            evs.append(ref_events.BlockRemoved(block_hashes=[rng.randrange(2**64)],
                                               medium=rng.choice([None, "gpu"])))
        else:
            evs.append(ref_events.AllBlocksCleared())
    return ref_events.EventBatch(ts=rng.random() * 1e9, events=evs,
                                 data_parallel_rank=rng.choice([None, 0, 2])).encode()


@settings(FUZZ, max_examples=300)
@given(st.integers(0, 2**32), st.data())
def test_unpackb_matches_msgpack_on_mutated_batches(seed, data):
    """Valid event batches with bytes flipped, cut, inserted or set to
    the reserved 0xc1: the same value or the same raise."""
    payload = bytearray(_valid_batch(random.Random(seed)))
    for _ in range(data.draw(st.integers(1, 4))):
        op = data.draw(st.sampled_from(["flip", "cut", "insert", "c1"]))
        if op == "insert" or not payload:
            at = data.draw(st.integers(0, len(payload)))
            payload[at:at] = bytes([data.draw(st.integers(0, 255))])
            continue
        at = data.draw(st.integers(0, len(payload) - 1))
        if op == "flip":
            payload[at] = data.draw(st.integers(0, 255))
        elif op == "cut":
            del payload[at:]
        else:
            payload[at] = 0xC1
    assert _unpack(codec.unpackb, bytes(payload)) == _unpack(ref_unpackb, bytes(payload))


def _nested(depth: int, leaf):
    for _ in range(depth):
        leaf = [leaf]
    return leaf


@pytest.mark.parametrize("data", [
    b"", b"\x92\x01", b"\x01\x02", b"\xc1", b"\x91\xc1", b"\xa2\xff\xfe",
    b"\xa3\xed\xa0\x80", b"\x81\x91\x01\x02", b"\x81\x80\x02", b"\x82\x01\x02\x01\x03",
    b"\xd6\xff" + struct.pack(">I", 5), b"\xd7\xff" + struct.pack(">Q", (2**30 - 1) << 34),
    b"\xc7\x0c\xff" + struct.pack(">Iq", 5, -3), b"\xc7\x03\xff\x00\x00\x00",
    b"\xd4\x05\x01", b"\xd4\x85\x01", b"\xc7\x00\x05", b"\xdb\xff\xff\xff\xff",
    b"\xdd\xff\xff\xff\xff", b"\xdc\x00\x05\x01", b"\xdf\x00\x00\x00\x03",
    b"\xca" + struct.pack(">f", 1.5), b"\xcb\x7f\xf8" + bytes(6), b"\xcf" + b"\xff" * 8,
    b"\xd3\x80" + bytes(7), b"\x81\xc0\xc0", b"\x81\xd6\xff\x00\x00\x00\x05\x01",
    b"\x91" * 1024 + b"\x01", b"\x91" * 1024 + b"\x90", b"\x91" * 1025 + b"\x01",
    b"\x91" * 1024 + b"\xdc\x00", b"\x91" * 1030, b"\x81\x01" * 1024 + b"\x01",
    b"\x81\x01" * 1025 + b"\x01",
], ids=lambda d: d[:12].hex() + (f"..{len(d)}" if len(d) > 12 else ""))
def test_unpackb_edges_match_msgpack(data):
    """Truncation, trailing bytes, the reserved byte, bad UTF-8,
    unhashable keys, timestamps (4, 8, 12 bytes and bad), ext codes,
    headers longer than the input, and the 1024-container stack."""
    assert _unpack(codec.unpackb, data) == _unpack(ref_unpackb, data)
    assert _unpack(codec.unpackb, memoryview(data)) == _unpack(ref_unpackb, data)


@pytest.mark.parametrize("depth", [510, 511, 512, 513])
def test_packb_nesting_limit_matches_msgpack(depth):
    for obj in (_nested(depth, 1), _nested(depth, []), [_nested(depth - 1, 1), []]):
        assert _pack(codec.packb, obj) == _pack(ref_packb, obj)


@pytest.mark.parametrize("obj", [
    2**64, -2**63 - 1, 2**63, -33, -32, "\ud800", object(), True, memoryview(b"ab"),
    bytearray(b"cd"), (1, 2), float("nan"), -0.0, {(1, 2): 3}, list(range(200)),
    [2**32, 2**16, 255, 128, -1, -129], "x" * 70000, b"y" * 70000,
], ids=lambda o: type(o).__name__ if type(o) in (object, memoryview) else repr(o)[:40])
def test_packb_edges_match_msgpack(obj):
    assert _pack(codec.packb, obj) == _pack(ref_packb, obj)


@pytest.mark.parametrize("seconds,nanos", [
    (2**32 - 1, 0), (2**32, 0), (0, 1), (2**34 - 1, 999_999_999), (2**34, 0), (-1, 0),
    (-2**63, 5)])
def test_timestamps_pack_as_msgpack_does(seconds, nanos):
    want = ref_packb(msgpack.Timestamp(seconds, nanos))
    assert codec.packb(codec.Timestamp(seconds, nanos)) == want
    assert _unpack(codec.unpackb, want) == _unpack(ref_unpackb, want)


@pytest.mark.parametrize("length", [0, 1, 2, 3, 4, 8, 16, 17, 255, 256, 65536])
def test_ext_types_pack_as_msgpack_does(length):
    assert codec.packb(codec.ExtType(1, b"x" * length)) == ref_packb(
        msgpack.ExtType(1, b"x" * length))


# ------------------------------------------------------------- wire model


def _event_pairs(rng: random.Random):
    """The same random events built by both packages."""
    pairs = []
    for _ in range(rng.randint(0, 6)):
        kind = rng.random()
        if kind < 0.6:
            n = rng.randint(1, 4)
            kw = dict(
                block_hashes=[rng.randbytes(32) if rng.random() < 0.5 else rng.randrange(2**64)
                              for _ in range(n)],
                parent_block_hash=rng.choice([None, rng.randrange(2**64), rng.randbytes(32)]),
                token_ids=[rng.randrange(1, 128256) for _ in range(n * BLOCK)],
                block_size=BLOCK, lora_id=rng.choice([None, 7]),
                medium=rng.choice([None, "gpu", "cpu"]), lora_name=rng.choice([None, "lora-a"]))
            pairs.append((ref_events.BlockStored(**kw), events.BlockStored(**kw)))
        elif kind < 0.9:
            kw = dict(block_hashes=[rng.randrange(2**64) for _ in range(rng.randint(1, 3))],
                      medium=rng.choice([None, "gpu"]))
            pairs.append((ref_events.BlockRemoved(**kw), events.BlockRemoved(**kw)))
        else:
            pairs.append((ref_events.AllBlocksCleared(), events.AllBlocksCleared()))
    return pairs


@pytest.mark.parametrize("seed", range(8))
def test_event_batch_encode_is_byte_equal_and_decodes_both_ways(seed):
    rng = random.Random(seed)
    pairs = _event_pairs(rng)
    ts = rng.random() * 1e9
    rank = rng.choice([None, 0, 3])
    ref_payload = ref_events.EventBatch(ts=ts, events=[r for r, _ in pairs],
                                        data_parallel_rank=rank).encode()
    port_payload = events.EventBatch(ts=ts, events=[p for _, p in pairs],
                                     data_parallel_rank=rank).encode()
    assert port_payload == ref_payload
    ref_batch = ref_events.decode_event_batch(port_payload)
    port_batch = events.decode_event_batch(ref_payload)
    assert (port_batch.ts, port_batch.data_parallel_rank, port_batch.events) == (
        ref_batch.ts, ref_batch.data_parallel_rank, ref_batch.events)
    for raw in ref_batch.events:
        want = ref_events.decode_event(raw)
        got = events.decode_event(raw)
        assert type(got).__name__ == type(want).__name__
        assert vars(got) == vars(want)


_POISON = [
    b"", b"\x01garbage", b"\xc1", ref_packb([1.0]), ref_packb([float("nan"), []]),
    ref_packb(["x", []]), ref_packb([1.0, 5]), ref_packb([1.0, [], "r"]),
    ref_packb([1.0, [["BlockStored", 5, None, "x", 4]]]),
    ref_packb([1.0, [["BlockStored", [1], None, [{"a": 1}], 4]]]),
    ref_packb([1.0, [["BlockStored", [1], None, [1, 2], float("inf")]]]),
    ref_packb([1.0, [["BlockStored", [1], None]]]), ref_packb([1.0, [["Nope"]]]),
    ref_packb([1.0, [[b"\xff\xfe"]]]), ref_packb([1.0, [["BlockRemoved"]]]),
    ref_packb([1.0, [["BlockRemoved", [1], b"\xff"]]]), ref_packb([1.0, [[]]]),
    ref_packb([1.0, [5]]), ref_packb([1.0, [["AllBlocksCleared", 1, 2]]]),
    ref_packb([1.0, [["BlockStored", [1], None, [1, 2, 3, 4], 4, None, b"GPU", b"lora"]]]),
]


@pytest.mark.parametrize("payload", _POISON, ids=lambda p: p[:16].hex())
def test_decoders_refuse_the_same_payloads(payload):
    """Poison pills and type-confused events: both packages raise
    ``EventDecodeError`` on the same payloads and events, and give equal
    events where they accept."""
    def outcome(mod):
        try:
            batch = mod.decode_event_batch(payload)
        except mod.EventDecodeError:
            return "refused"
        out = []
        for raw in batch.events:
            try:
                ev = mod.decode_event(raw)
                out.append((type(ev).__name__, vars(ev)))
            except mod.EventDecodeError:
                out.append("refused")
        return (batch.ts, batch.data_parallel_rank, out)

    assert outcome(events) == outcome(ref_events)


# ------------------------------------------------------------------- pool


class RecordingJournal:
    """A journal double: the records of the applied operations."""

    def __init__(self):
        self._lock = threading.Lock()
        self.records = []

    def record_add(self, pod, seq, engine_keys, request_keys, entries):
        with self._lock:
            self.records.append(("add", pod, seq, tuple(engine_keys), tuple(request_keys),
                                 tuple((e.pod_identifier, e.device_tier) for e in entries)))

    def record_evict(self, pod, seq, engine_keys, entries):
        with self._lock:
            self.records.append(("evict", pod, seq, tuple(engine_keys),
                                 tuple((e.pod_identifier, e.device_tier) for e in entries)))

    def record_purge(self, pod, seq=0):
        with self._lock:
            self.records.append(("purge", pod))

    def per_pod(self, pod):
        with self._lock:
            return [r for r in self.records if r[1] == pod]


def _make(side: str, journal=None, **config):
    """A pool of one package over its own index and token processor."""
    if side == "ref":
        index = RefIndex(RefIndexConfig(size=100_000))
        db = RefTokenDB(RefTokenConfig(block_size=BLOCK))
        return ref_pool.Pool(index, db, ref_pool.PoolConfig(**config), journal=journal), index
    im, index_mod = port("kvcache.kvblock.in_memory"), port("kvcache.kvblock.index")
    tp = port("kvcache.kvblock.token_processor")
    index = im.InMemoryIndex(index_mod.InMemoryIndexConfig(size=100_000))
    db = tp.ChunkedTokenDatabase(tp.TokenProcessorConfig(block_size=BLOCK))
    return kvpool.Pool(index, db, kvpool.PoolConfig(**config), journal=journal), index


def _message(side: str, pod: str, seq: int, payload):
    mod = ref_pool if side == "ref" else kvpool
    return mod.Message(topic=f"kv@{pod}@{MODEL}", payload=payload, pod_identifier=pod,
                       model_name=MODEL, seq=seq)


def event_stream(seed: int, pods: int = 6, messages: int = 30):
    """A seeded event stream, ``{pod: [payload, ...]}``: chained stores
    whose parents lie in earlier events and messages, engine hashes as
    ints and as 32-byte strings, LoRA names, media, removals (of single
    blocks and of chain tails), unknown parents, poison pills and
    ``AllBlocksCleared``.  Each pod's tokens and hashes are its own (a
    key two pods share would make the result depend on the order in
    which two workers apply them)."""
    rng = np.random.default_rng(seed)
    streams = {}
    for p in range(pods):
        pod = f"pod-{p}"
        stored, tail, out = [], None, []
        for m in range(messages):
            roll = rng.random()
            if roll < 0.07:
                out.append(rng.choice([b"\x01garbage", b"\xc1",
                                       ref_packb([float("nan"), []])]))
                continue
            evs = []
            for e in range(int(rng.integers(1, 4))):
                kind = rng.random()
                if kind < 0.2 and stored:
                    victim = stored.pop(int(rng.integers(len(stored))))
                    if victim == tail:
                        tail = None
                    evs.append(ref_events.BlockRemoved(
                        block_hashes=[victim], medium=rng.choice([None, "hbm", "HOST"])))
                elif kind < 0.27:
                    evs.append(ref_events.AllBlocksCleared())
                else:
                    n = int(rng.integers(1, 4))
                    base = (p << 40) + (m << 8) + (e << 4)
                    hashes = [base + j if rng.random() < 0.5
                              else struct.pack(">Q", base + j).rjust(32, b"\x07")
                              for j in range(n)]
                    parent = tail if rng.random() < 0.6 else None
                    if rng.random() < 0.05:
                        parent = (p << 40) + 0xFFFFF  # never stored: the event drops
                    tokens = [int(t) for t in 30_000 * p + rng.integers(1, 30_000, n * BLOCK)]
                    if rng.random() < 0.1:
                        tokens = tokens[:-1]  # a partial block: fewer keys than hashes
                    evs.append(ref_events.BlockStored(
                        block_hashes=hashes, parent_block_hash=parent, token_ids=tokens,
                        block_size=BLOCK, medium=rng.choice([None, "hbm", "GPU", "host"]),
                        lora_name=None if rng.random() < 0.8 else "lora-x"))
                    tail = hashes[-1]
                    stored.extend(hashes)
            out.append(ref_events.EventBatch(ts=float(m), events=evs).encode())
        streams[pod] = out
    return streams


def _engine_keys(streams):
    keys = set()
    for payloads in streams.values():
        for payload in payloads:
            try:
                batch = ref_events.decode_event_batch(payload)
            except ref_events.EventDecodeError:
                continue
            for raw in batch.events:
                for h in list(raw[1]) if len(raw) > 1 and isinstance(raw[1], list) else []:
                    keys.add(h & (2**64 - 1) if isinstance(h, int)
                             else int.from_bytes(h[-8:], "big"))
    return keys


def run_stream(side: str, streams, journal=None, batched=True, burst=16, **config):
    """Feed ``streams`` through one package's pool, pod by pod in turn in
    bursts (``add_tasks``) or one message at a time (``add_task``)."""
    pool, index = _make(side, journal, **config)
    pool.start()
    try:
        cursor = dict.fromkeys(streams, 0)
        while any(cursor[p] < len(s) for p, s in streams.items()):
            for pod, payloads in streams.items():
                chunk = payloads[cursor[pod]:cursor[pod] + burst]
                messages = [_message(side, pod, cursor[pod] + i + 1, payload)
                            for i, payload in enumerate(chunk)]
                cursor[pod] += len(chunk)
                if batched:
                    pool.add_tasks(messages)
                else:
                    for message in messages:
                        pool.add_task(message)
        pool.drain()
    finally:
        pool.shutdown()
    return index


def index_state(index, engine_keys):
    """Sorted entries, the engine -> request map, and ``get_request_key``
    of every engine key of the stream (None where it raises KeyError)."""
    block_entries, engine_map = index.dump_entries()
    entries = sorted((key, tuple(sorted((e.pod_identifier, e.device_tier) for e in pods)))
                     for key, pods in block_entries)
    lookups = {}
    for key in sorted(engine_keys):
        try:
            lookups[key] = index.get_request_key(key)
        except KeyError:
            lookups[key] = None
    return entries, sorted(engine_map), lookups


@pytest.mark.parametrize("concurrency", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_pool_digest_parity(seed, concurrency):
    """One seeded stream through the JAX pool and the port's: equal
    ``dump_entries()`` and the same request key for every engine key,
    whatever the pool's concurrency (shedding off: the queues hold the
    whole stream)."""
    streams = event_stream(seed)
    keys = _engine_keys(streams)
    want = index_state(run_stream("ref", streams, concurrency=concurrency), keys)
    got = index_state(run_stream("port", streams, concurrency=concurrency), keys)
    assert got == want
    assert want[0] and any(v is None for v in want[2].values())


@pytest.mark.parametrize("side", ["ref", "port"])
def test_lockfree_decode_on_equals_off(side):
    streams = event_stream(3)
    keys = _engine_keys(streams)
    states = [index_state(run_stream(side, streams, lockfree_decode=flag, digest_memo=memo),
                          keys)
              for flag, memo in ((True, 64), (False, 0))]
    assert states[0] == states[1]
    assert states[0] == index_state(run_stream("ref", streams), keys)


def test_add_tasks_equals_add_task():
    streams = event_stream(4)
    keys = _engine_keys(streams)
    got = [index_state(run_stream("port", streams, batched=flag, concurrency=2), keys)
           for flag in (True, False)]
    assert got[0] == got[1] == index_state(run_stream("ref", streams, concurrency=2), keys)


def _resync_job(side: str, pod: str, done: threading.Event):
    ev = ref_events if side == "ref" else events
    mod = ref_pool if side == "ref" else kvpool
    index = int(pod.rsplit("-", 1)[1])
    return mod.ResyncJob(
        pod_identifier=pod, model_name=MODEL,
        events=[ev.BlockStored(block_hashes=[99_000_000 + index], parent_block_hash=None,
                               token_ids=[1_000_000 + index * BLOCK + j
                                          for j in range(1, BLOCK + 1)],
                               block_size=BLOCK)],
        on_done=lambda job, ok, purged, detail: done.set())


@pytest.mark.parametrize("lockfree", [True, False])
def test_journal_records_are_the_references(lockfree):
    """A recording journal receives the same records, pod by pod and in
    order, from both packages (a mid-stream resync's purge included)."""
    streams = event_stream(5, pods=4, messages=24)
    records = {}
    for side in ("ref", "port"):
        journal = RecordingJournal()
        pool, _ = _make(side, journal, concurrency=2, lockfree_decode=lockfree)
        pool.start()
        done = []
        try:
            for pod, payloads in streams.items():
                for i, payload in enumerate(payloads):
                    pool.add_tasks([_message(side, pod, i + 1, payload)])
                    if i == len(payloads) // 2:
                        done.append(threading.Event())
                        pool.enqueue_resync(_resync_job(side, pod, done[-1]))
            pool.drain()
            assert all(d.wait(10) for d in done)
        finally:
            pool.shutdown()
        records[side] = {pod: journal.per_pod(pod) for pod in streams}
    assert records["port"] == records["ref"]
    assert any(r[0] == "purge" for rs in records["ref"].values() for r in rs)


def test_predecode_poison_and_memoryview_payloads():
    """The lock-free stage marks a poison pill before the queue and the
    worker skips it; a ``memoryview`` payload decodes; ``stage_stats``
    counts the decode on the enqueueing thread."""
    pool, index = _make("port", concurrency=1, lockfree_decode=True)
    poison = _message("port", "p", 1, b"\x01garbage")
    good = _message("port", "p", 2, memoryview(ref_events.EventBatch(ts=0.0, events=[
        ref_events.BlockStored(block_hashes=[5], parent_block_hash=None,
                               token_ids=list(range(1, BLOCK + 1)), block_size=BLOCK)]).encode()))
    pool.add_tasks([poison, good])
    assert poison.decoded is not None and isinstance(good.decoded, events.EventBatch)
    assert pool.stage_stats()["decode_msgs"] == 2 and pool.stage_stats()["apply_msgs"] == 0
    pool.start()
    pool.drain()
    pool.shutdown()
    assert pool.stage_stats()["apply_msgs"] == 1
    block_entries, engine_map = index.dump_entries()
    assert len(block_entries) == 1 and engine_map == [(5, block_entries[0][0])]


def test_default_tier_is_hbm_and_shard_choice_is_fnv1a():
    assert kvpool.PoolConfig().default_device_tier == "hbm"
    for pod in ("pod-a", "10.0.0.7", "", "ns/name"):
        assert kvpool.fnv1a_32(pod.encode()) == ref_pool.fnv1a_32(pod.encode())


# -------------------------------------------- flow control and shed victims


def _queue(side: str, **kw):
    return (ref_pool if side == "ref" else kvpool)._ShardQueue(**kw)


def _msg(side: str, pod: str, i: int = 0, resync=None):
    mod = ref_pool if side == "ref" else kvpool
    return mod.Message(topic=f"kv@{pod}@{MODEL}", payload=str(i).encode(), pod_identifier=pod,
                       model_name=MODEL, seq=i, resync=resync)


def _shed_trace(side: str, case: str):
    """One flow-control scenario of the reference's tests
    (``test_event_plane.py``, ``test_write_path_fastlane.py``), as the
    sequence of (pod, seq, reason) sheds, lane depths and drains."""
    trace = []

    def put(q, message):
        shed, depth = q.put(message)
        trace.append(("put", depth, [(m.pod_identifier, m.seq, r) for m, r in shed]))

    if case == "budget":
        q = _queue(side, max_depth=100, pod_budget=4, per_pod=True)
        for i in range(10):
            put(q, _msg(side, "a", i))
    elif case == "fairness":
        q = _queue(side, max_depth=16, pod_budget=16, per_pod=True)
        for i in range(3):
            put(q, _msg(side, "quiet", i))
        for i in range(100):
            put(q, _msg(side, "chatty", i))
    elif case in ("queue_full_legacy", "queue_full_per_pod"):
        q = _queue(side, max_depth=4, pod_budget=4, per_pod=case.endswith("per_pod"))
        for i in range(6):
            put(q, _msg(side, "a", i))
    elif case == "global_fifo":
        q = _queue(side, max_depth=4, pod_budget=4, per_pod=False)
        for i in range(6):
            put(q, _msg(side, "a" if i % 2 else "b", i))
    elif case == "commands":
        q = _queue(side, max_depth=2, pod_budget=2, per_pod=True)
        job = (ref_pool if side == "ref" else kvpool).ResyncJob(pod_identifier="a",
                                                                model_name=MODEL)
        put(q, _msg(side, "a", 0, resync=job))
        for i in range(1, 6):
            put(q, _msg(side, "a", i))
    elif case == "longest_lane":
        rng = random.Random(11)
        q = _queue(side, max_depth=32, pod_budget=1000, per_pod=True)
        pods = [f"s{i}" for i in range(9)]
        for step in range(1500):
            before = q.lane_depths()
            shed, _ = q.put(_msg(side, rng.choice(pods), step))
            for victim, reason in shed:
                assert reason == "queue_full"
                assert before[victim.pod_identifier] == max(before.values())
            trace.append([(m.pod_identifier, m.seq, r) for m, r in shed])
            if rng.random() < 0.2:
                batch, _, _ = q.get_batch(rng.randrange(1, 8))
                trace.append([m.seq for m in batch])
        assert sum(q.lane_depths().values()) == q.qsize()
    elif case == "closed":
        q = _queue(side, max_depth=4, pod_budget=4, per_pod=True)
        put(q, _msg(side, "a", 0))
        q.close()
        put(q, _msg(side, "a", 1))
        shed, depths = q.put_batch([_msg(side, f"p{i}") for i in range(3)])
        trace.append((depths, [r for _, r in shed]))
    trace.append(("depths", q.lane_depths()))
    batch, closed, depths = q.get_batch(1000) if case != "closed" else q.get_batch(10)
    trace.append(("drain", [(m.pod_identifier, m.seq, m.resync is not None) for m in batch],
                  closed, depths))
    return trace


@pytest.mark.parametrize("case", ["budget", "fairness", "queue_full_legacy",
                                  "queue_full_per_pod", "global_fifo", "commands",
                                  "longest_lane", "closed"])
def test_shard_queue_flow_control_is_the_references(case):
    got, want = _shed_trace("port", case), _shed_trace("ref", case)
    assert got == want
    if case == "fairness":
        assert want[-2][1]["quiet"] == 3
        assert all(p == "chatty" for step in want[:-2] for p, _, _ in step[2])


@pytest.mark.parametrize("per_pod", [True, False])
def test_pool_sheds_like_the_reference(per_pod):
    """The pool's add_tasks over a small shard queue, workers not started:
    the same messages shed with the same reasons, then the same index."""
    outcomes = {}
    streams = event_stream(6, pods=3, messages=20)
    keys = _engine_keys(streams)
    for side in ("ref", "port"):
        pool, index = _make(side, concurrency=1, max_queue_depth=12, pod_budget=5,
                            per_pod_flow_control=per_pod)
        messages = [_message(side, pod, i + 1, p) for pod, ps in streams.items()
                    for i, p in enumerate(ps)]
        pool.add_tasks(messages)
        snapshot = [(m.pod_identifier, m.seq) for m in pool._queues[0].snapshot()]
        pool.start()
        pool.drain()
        pool.shutdown()
        outcomes[side] = (snapshot, index_state(index, keys))
    assert outcomes["port"] == outcomes["ref"]
    assert len(outcomes["ref"][0]) < sum(map(len, streams.values()))  # it shed


def test_shard_of_a_pod_matches_and_inline_drain_is_deterministic():
    """``process_inline`` on an unstarted pool: the same state as the
    reference's inline drain."""
    streams = event_stream(7, pods=3, messages=12)
    keys = _engine_keys(streams)
    states = {}
    for side in ("ref", "port"):
        pool, index = _make(side, concurrency=3)
        for pod, payloads in streams.items():
            pool.add_tasks([_message(side, pod, i + 1, p) for i, p in enumerate(payloads)])
        assert pool.process_inline() == sum(map(len, streams.values()))
        states[side] = index_state(index, keys)
        assert [pool._shard_index(p) for p in streams] == [
            ref_pool.fnv1a_32(p.encode()) % 3 for p in streams]
    assert states["port"] == states["ref"] and states["ref"][0]
