"""The port's spans on a torch profiler's timeline, on the CPU.

While a ``torch.profiler.profile`` records, every span of the port
opens a ``kvtpu.<name>`` range (function scope: a CPU op, never a user
annotation, so the profiler draws no device-side copy of it); when none
records, a span is the shared no-op and allocates nothing.  Also: the
model step's nested ranges, the router's, the event pool's hand-off and
its ``queue_s`` / ``lag_s`` counters, ``kvtpu_kernel_builds_total`` on a
work-list miss, the ``gc`` range and the tracer's lock-free count of
unsampled starts."""

import gc
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.helpers.torch_port import port

trace = port("obs.trace")
collector = port("metrics.collector")
llama = port("models.llama")
tile_plan = port("ops.tile_plan")
events = port("kvevents.events")
kvpool = port("kvevents.pool")

BLOCK = 4
CFG = llama.LlamaConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                        d_ff=64, block_size=BLOCK, dtype="float32")


def ranges(prof):
    """``[(name, start_ns, end_ns, thread, kwinputs, is_user_annotation)]``
    of the profile's ``kvtpu.`` events, in start order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.RANGE_PREFIX):
            out.append((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(), e.kwinputs(),
                        e.is_user_annotation()))
    return sorted(out, key=lambda r: r[1])


def inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2] and child[3] == parent[3]


def named(rs, name):
    return [r for r in rs if r[0] == "kvtpu." + name]


# ------------------------------------------------------------ the bridge


@pytest.mark.parametrize("traced", [False, True])
def test_a_span_opens_a_range_while_the_profiler_records(traced):
    tr = trace.Trace("t", "1" * 32, "2" * 16, trace.TRACER.recorder) if traced else None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.use_trace(tr):
            with trace.span("tokenize") as s:
                s.set_attr("tokens", 3)
                with trace.profiler_range("hash_blocks", {"blocks": 2}):
                    torch.ones(2).add_(1)
    rs = ranges(prof)
    assert [r[0] for r in rs] == ["kvtpu.tokenize", "kvtpu.hash_blocks"]
    assert inside(rs[1], rs[0])
    assert not any(r[5] for r in rs)  # function scope: no device-side annotation
    if traced:
        spans = tr.to_dict()["spans"]
        assert [(sp["name"], sp["attributes"]) for sp in spans] == [("tokenize", {"tokens": 3})]


def test_range_attributes_ride_on_the_range_with_shapes_recorded():
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with trace.profiler_range("model.prefill_paged", {"batch": 2, "new": 16, "prefix": 0}):
            pass
    (rng,) = ranges(prof)
    assert rng[4] == {"batch": 2, "new": 16, "prefix": 0}


def test_nothing_records_or_allocates_without_a_profiler_or_a_trace():
    assert not torch.autograd.profiler._is_profiler_enabled
    attrs = {"batch": 1}
    assert trace.span("tokenize") is trace._NULL_SPAN_CTX
    assert trace.profiler_range("model.decode_step", attrs) is trace._NULL_SPAN_CTX
    path = trace.__file__

    def burst():
        for _ in range(2000):
            with trace.span("tokenize") as s:
                s.set_attr("tokens", 1)
            with trace.profiler_range("model.decode_step", attrs):
                pass

    burst()  # warm every code path before counting
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        burst()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == path and d.size_diff > 0]
    assert grown == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert ranges(prof) == []


def test_a_thread_the_profiler_does_not_follow_records_no_range():
    """Ranges on a worker thread reach the trace only when the profiler
    follows every thread; the flag the bridge reads is process-wide, so
    the worker still opens them."""
    def work():
        with trace.span("kvevents.apply"):
            pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        worker = threading.Thread(target=work)
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive()
    assert ranges(prof) == []


# ---------------------------------------------------------- the model step


@pytest.fixture(scope="module")
def params():
    return llama.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


def _pool(blocks):
    c = CFG
    return torch.zeros((c.n_layers, blocks, 2, c.block_size, c.n_kv_heads, c.head_dim))


def test_prefill_and_decode_ranges_nest(params):
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, CFG.vocab_size, (1, 16)))
    pool = _pool(9)
    table = torch.arange(1, 5, dtype=torch.int32)[None]
    step = llama.make_decode_step(params, pool, CFG, 2, 6)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        llama.prefill_paged(params, tokens[:, :8], pool, table[:, :2], CFG)
        llama.prefill_continue(params, tokens[:, 8:], pool, table, 8, CFG)
        step(torch.tensor([3, 4]), torch.stack((table[0], table[0] + 4)),
             torch.tensor([17, 9], dtype=torch.int32))
    rs = ranges(prof)
    (paged,) = named(rs, "model.prefill_paged")
    (cont,) = named(rs, "model.prefill_continue")
    (dec,) = named(rs, "model.decode_step")
    assert paged[4] == {"batch": 1, "new": 8, "prefix": 0}
    assert cont[4] == {"batch": 1, "new": 8, "prefix": 8}
    assert dec[4] == {"batch": 2}
    for parent in (paged, cont):
        kids = [r for r in rs if r is not parent and inside(r, parent)]
        assert [r[0] for r in kids] == [
            "kvtpu.model.prefill.inputs", "kvtpu.model.prefill.layers",
            "kvtpu.model.prefill.logits"]
    kids = [r for r in rs if r is not dec and inside(r, dec)]
    # On the CPU nothing is captured: the step runs eagerly, every call.
    assert [r[0] for r in kids] == ["kvtpu.model.decode.inputs", "kvtpu.model.decode.eager"]
    assert step.replays == 0


def test_ranges_change_no_result(params):
    """The same prefill with the profiler on and off writes the same
    pool and gives the same logits."""
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, CFG.vocab_size, (1, 8)))
    table = torch.arange(1, 3, dtype=torch.int32)[None]
    pools = [_pool(3), _pool(3)]
    plain = llama.prefill_paged(params, tokens, pools[0], table, CFG)[0]
    with profile(activities=[ProfilerActivity.CPU]):
        ranged = llama.prefill_paged(params, tokens, pools[1], table, CFG)[0]
    assert torch.equal(plain, ranged) and torch.equal(pools[0], pools[1])


# ------------------------------------------------------------- the builds


def _builds(what):
    return sum(s.value for f in collector.METRICS.kernel_builds.collect() for s in f.samples
               if s.name.endswith("_total") and s.labels.get("what") == what)


def _build_seconds_count(what):
    return sum(s.value for f in collector.METRICS.kernel_build_seconds.collect()
               for s in f.samples
               if s.name.endswith("_count") and s.labels.get("what") == what)


def test_work_list_counts_a_build_on_a_miss_and_none_on_a_hit():
    shape = (1, 3, 4099, 4111, 12)  # a shape no other test asks for: the first call misses
    before, seconds_before = _builds("plan"), _build_seconds_count("plan")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first = tile_plan.work_list(*shape, torch.device("cpu"), sms=132)
        again = tile_plan.work_list(*shape, torch.device("cpu"), sms=132)
    assert again is first
    assert _builds("plan") == before + 1
    assert _build_seconds_count("plan") == seconds_before + 1
    assert [r[0] for r in ranges(prof)] == ["kvtpu.ops.plan_build"]


def test_the_kernel_builds_family_is_on_metrics():
    collector.count_build("graph", 0.01)
    text = collector.METRICS.exposition().decode()
    assert 'kvtpu_kernel_builds_total{what="graph"}' in text
    assert "kvtpu_kernel_build_seconds_bucket" in text


# ---------------------------------------------------------- the event pool


def _frames(pod, n):
    out = []
    for seq in range(1, n + 1):
        batch = events.EventBatch(ts=float(seq), events=[events.BlockStored(
            block_hashes=[(seq << 8) + 1], parent_block_hash=None,
            token_ids=list(range(seq * BLOCK, (seq + 1) * BLOCK)), block_size=BLOCK)])
        out.append(kvpool.Message(topic=f"kv@{pod}@m", payload=batch.encode(),
                                  pod_identifier=pod, model_name="m", seq=seq))
    return out


def _pool_of_one():
    im, index_mod = port("kvcache.kvblock.in_memory"), port("kvcache.kvblock.index")
    tp = port("kvcache.kvblock.token_processor")
    index = im.InMemoryIndex(index_mod.InMemoryIndexConfig(size=10_000))
    db = tp.ChunkedTokenDatabase(tp.TokenProcessorConfig(block_size=BLOCK))
    return kvpool.Pool(index, db, kvpool.PoolConfig(concurrency=1))


@pytest.mark.parametrize("lockfree", [True, False])
def test_stage_stats_count_each_applied_frames_queue_and_lag(lockfree):
    pool = _pool_of_one()
    pool.config.lockfree_decode = lockfree
    pool._lockfree_decode = lockfree
    start = pool.stage_stats()
    assert start["queue_s"] == 0.0 and start["lag_s"] == 0.0
    frames = _frames("p", 12) + [kvpool.Message(topic="kv@p@m", payload=b"\x01garbage",
                                                pod_identifier="p", model_name="m", seq=13)]
    pool.add_tasks(frames[:5])  # queued before any worker runs: they wait
    pool.start()
    try:
        pool.add_tasks(frames[5:])
        pool.drain()
    finally:
        pool.shutdown()
    stats = pool.stage_stats()
    assert stats["apply_msgs"] == 12  # the poison pill is never applied
    assert all(f.enqueued_at > 0.0 for f in frames)
    assert 0.0 < stats["queue_s"] <= stats["lag_s"]
    assert stats["lag_s"] >= stats["queue_s"] + stats["apply_s"] - 1e-9


def test_add_tasks_is_a_range_on_the_callers_thread():
    pool = _pool_of_one()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pool.add_tasks(_frames("p", 2))
    assert [r[0] for r in ranges(prof)] == ["kvtpu.kvevents.add_tasks"]
    assert pool.backlog() == 2


# ------------------------------------------------------------ the router


class WordTokenizer:
    def __init__(self):
        self._encoding = port("tokenization.tokenizers").Encoding

    def type(self):
        return "word"

    def encode(self, prompt, model_name, add_special_tokens):
        tokens, offsets, pos = [], [], 0
        for word in prompt.split(" "):
            tokens.append(int(word[1:]))
            offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return self._encoding(tokens=tokens, offsets=offsets)


def test_get_pod_scores_is_a_router_range_around_its_stages():
    ix_mod = port("kvcache.indexer")
    tp = port("kvcache.kvblock.token_processor")
    ix = ix_mod.Indexer(ix_mod.IndexerConfig(
        token_processor_config=tp.TokenProcessorConfig(block_size=BLOCK)),
        tokenizer=WordTokenizer())
    ix.run()
    try:
        prompt = " ".join(f"t{i}" for i in range(1, 41))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ix.get_pod_scores(prompt, "m", ["pod-a"])
    finally:
        ix.shutdown()
    rs = ranges(prof)
    (router,) = named(rs, "router.get_pod_scores")
    kids = {r[0] for r in rs if r is not router and inside(r, router)}
    assert {"kvtpu.tokenize", "kvtpu.tokenize.queue_wait", "kvtpu.hash_blocks",
            "kvtpu.index_lookup"} <= kids
    (wait,) = named(rs, "tokenize.queue_wait")
    assert inside(wait, named(rs, "tokenize")[0])


# --------------------------------------------------------------- the gc


def test_a_forced_collection_opens_a_gc_range():
    installed = collector._gc_installed
    collector.install_gc_metrics()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            gc.collect()
    finally:
        if not installed:
            collector.uninstall_gc_metrics()
    assert "kvtpu.gc" in [r[0] for r in ranges(prof)]
    assert collector._gc_ranges == {}


# ------------------------------------------------------ the tracer's count


def test_unsampled_starts_are_counted_exactly_without_the_lock():
    tracer = trace.Tracer(trace.TracerConfig(sample_rate=0.0))
    threads, each = 12, 2000
    reads = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def start():
            for i in range(each):
                assert tracer.start_trace("m") is None
                if i % 500 == 0:
                    reads.append(tracer.stats()["traces_unsampled"])

        workers = [threading.Thread(target=start) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(w.is_alive() for w in workers)
    assert tracer.stats()["traces_unsampled"] == threads * each
    assert tracer.stats()["traces_unsampled"] == threads * each  # a read changes nothing
    assert all(0 < r <= threads * each for r in reads)
    tracer.reset()
    assert tracer.stats()["traces_unsampled"] == 0
    assert tracer.stats()["traces_sampled"] == 0
