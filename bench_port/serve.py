"""The serving loop: a stand-in for the vLLM pods this system routes
among, calling the port for everything the system does.

One host thread.  Each iteration:

1. Admit: every request now due is scored over the pods by the port's
   ``Indexer.get_pod_scores`` (with the pods' loads) and queued on the
   best-scoring pod.
2. Prefill one waiting request, first come first served among those
   whose pod has room: the model's ``prefill_continue`` over the uncached
   suffix where the pod's prefix cache holds a prefix of the prompt,
   ``prefill_paged`` over the whole prompt otherwise.  The first token is
   the argmax of the last position's logits.
3. Publish the pod's KV events to the port's event pool, which applies
   them on its own threads; nothing waits for it.
4. Decode one step of every running sequence, all pods at once, through
   the port's captured decode step for the smallest batch bucket that
   holds them; pad rows point at a scratch block.  Greedy, no end token.

The model is the configuration's family's (``families/<family>.py``:
``model(config, mix)``): its entry points into the port and its KV pool.
The pods are partitions of the pool's block ids (``pods.Pod``).  A
request holds blocks for its prompt and its whole output from its
prefill on, so a running sequence never waits for memory.
"""

from __future__ import annotations

import contextlib
import importlib
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bench_port.pods import Pod, Publisher, Stored, chain_hashes
from bench_port.traffic.plan import Plan, Request

PORT = "llm_d_kv_cache_manager_tpu_torch"
MEDIUM = "gpu"  # the tier vLLM pods on GPUs publish their device blocks under
# One worker each for the event pool and the tokenizer pool: the loop's
# host thread is what the cells time, and every further thread contends
# with it for the interpreter.
WORKERS = 1
clock = time.perf_counter


def port(name: str):
    """A module of the port, by its name inside the package."""
    return importlib.import_module(f"{PORT}.{name}")


def words(tokens: np.ndarray) -> str:
    """A prompt's text for the word tokenizer: ``t<id>`` per token."""
    return " ".join(f"t{t}" for t in tokens.tolist())


class WordTokenizer:
    """``t<id>`` words to ids, with byte offsets: the tokenizer the
    router is given (the card's machine has no tokenizer library)."""

    def __init__(self) -> None:
        self._encoding = port("tokenization.tokenizers").Encoding

    def type(self) -> str:
        return "word"

    def encode(self, prompt: str, model_name: str, add_special_tokens: bool):
        tokens, offsets, pos = [], [], 0
        for word in prompt.split(" "):
            tokens.append(int(word[1:]))
            offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return self._encoding(tokens=tokens, offsets=offsets)


class AppliedTap:
    """A journal for the port's event pool, which calls it after each
    operation it has applied to the index: per pod, the last frame all of
    whose events have landed."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._left: Dict[Tuple[str, int], int] = {}
        self._applied: Dict[str, int] = {}

    def expect(self, pod: str, seq: int, records: int) -> None:
        with self._lock:
            self._left[(pod, seq)] = records

    def _record(self, pod: str, seq: int) -> None:
        with self._lock:
            left = self._left.get((pod, seq), 1) - 1
            self._left[(pod, seq)] = left
            if left <= 0 and seq > self._applied.get(pod, 0):
                self._applied[pod] = seq

    def record_add(self, pod, seq, *_args) -> None:
        self._record(pod, seq)

    def record_evict(self, pod, seq, *_args) -> None:
        self._record(pod, seq)

    def record_purge(self, pod) -> None:
        pass

    def applied(self, pod: str) -> int:
        with self._lock:
            return self._applied.get(pod, 0)


@dataclass(eq=False)
class Live:
    """A request as the loop serves it."""

    req: Request
    rid: int
    text: str
    hashes: List[bytes]  # the engine's hash of each prompt block
    in_window: bool
    due: float = 0.0  # host clock at which it was due
    pod: Optional[Pod] = None
    scores: Optional[Dict[str, float]] = None
    bracket: Optional[Dict[str, Tuple[int, int]]] = None  # frames applied .. published
    route_s: float = 0.0
    blocks: Optional[np.ndarray] = None  # pool block ids: prompt, then output
    cached: int = 0  # prompt blocks reused from the pod's cache
    tokens: List[int] = field(default_factory=list)
    times: List[float] = field(default_factory=list)
    done: bool = False


@dataclass
class Call:
    """One prefill or decode step, for the per-layer metrics."""

    kind: str  # "prefill" or "decode"
    t0: float
    t1: float
    prefix: int = 0  # prefill: cached tokens
    new: int = 0  # prefill: tokens computed
    contexts: Tuple[int, ...] = ()  # decode: live rows' context lengths
    rows: Tuple[int, ...] = ()  # decode: the request id in each live row
    kv_tokens: Optional[int] = None  # decode, in a traced slice: distinct pool slots read
    events: Optional[Tuple[Any, Any]] = None  # CUDA events around the call


def distinct_slots(table: np.ndarray, ctx: np.ndarray, bs: int) -> int:
    """Pool slots a decode step's rows read, each counted once: rows that
    share a cached prefix share its blocks."""
    blocks = (ctx + bs - 1) // bs
    cols = np.arange(table.shape[1])[None, :]
    live = cols < blocks[:, None]
    last = ctx[:, None] - (blocks[:, None] - 1) * bs
    used = np.where(cols == blocks[:, None] - 1, last, bs)
    most = np.zeros(int(table.max()) + 1, dtype=np.int64)
    np.maximum.at(most, table[live], used[live])
    return int(most.sum())


class Server:
    """The port's serving stack over one pool, driven by the loop."""

    def __init__(self, lm, mix: Dict[str, Any], params, plan: Plan, pool_blocks: int,
                 device: torch.device, model_name: str, timed_calls: bool = False) -> None:
        """``lm``: the family's model (``family.model(config, mix)``)."""
        indexer_mod = port("kvcache.indexer")
        tp_mod = port("kvcache.kvblock.token_processor")
        events_pool = port("kvevents.pool")
        self.lm, self.events_mod = lm, port("kvevents.events")
        self.subscriber = port("kvevents.zmq_subscriber")
        self.metrics = port("metrics.collector")
        bs = self.bs = lm.block_size
        self.params, self.device, self.model = params, device, model_name
        self.pool = lm.pool(pool_blocks, device)
        per = (pool_blocks - 1) // plan.pods  # block 0: the pad rows' scratch block
        self.pods = [Pod(f"pod-{i}", range(1 + i * per, 1 + (i + 1) * per))
                     for i in range(plan.pods)]
        self.indexer = indexer_mod.Indexer(
            indexer_mod.IndexerConfig(
                token_processor_config=tp_mod.TokenProcessorConfig(block_size=bs, hash_seed="0"),
                tokenizers_pool_config=port("tokenization.pool").TokenizationPoolConfig(
                    workers=WORKERS)),
            tokenizer=WordTokenizer())
        self.tap = AppliedTap()
        self.events = events_pool.Pool(self.indexer.kv_block_index,
                                       self.indexer.token_processor,
                                       events_pool.PoolConfig(concurrency=WORKERS),
                                       journal=self.tap)
        self.events.start()
        self.publishers = {p.name: Publisher(p.name, model_name, bs, MEDIUM) for p in self.pods}
        self.trackers = {p.name: self.subscriber.TopicSeqTracker() for p in self.pods}
        self.width = math.ceil(plan.max_context / bs)
        self.buckets = sorted(int(b) for b in mix["decode_buckets"])
        self.steps: Dict[int, Any] = {}
        self.tables = {b: np.zeros((b, self.width), dtype=np.int32) for b in self.buckets}
        self.waiting: deque = deque()
        self.running: List[Live] = []
        self.lives: List[Live] = []
        self.calls: List[Call] = []
        self.timed_calls = timed_calls and device.type == "cuda"
        self.frames_lost = 0
        self.profiler = None  # set while a traced slice is recorded
        self._next_rid = 0

    # -- set-up ---------------------------------------------------------

    def capture(self) -> None:
        """Make and capture the decode step of every bucket, on pad rows."""
        for b in self.buckets:
            self.steps[b] = self.lm.make_decode_step(self.params, self.pool.kv, b, self.width)
            table = np.zeros((b, self.width), dtype=np.int32)
            for _ in range(2):  # the first call captures, the second replays
                self.steps[b](torch.zeros(b, dtype=torch.long), torch.from_numpy(table),
                              torch.ones(b, dtype=torch.int32))
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def live(self, req: Request, in_window: bool) -> Live:
        self._next_rid += 1
        return Live(req=req, rid=self._next_rid, text=words(req.prompt),
                    hashes=chain_hashes(req.prompt, self.bs), in_window=in_window)

    def serve_setup(self, reqs: List[Request]) -> List[Live]:
        """Serve set-up requests one by one through the window's path.
        Those that run on into the window are left running."""
        out = []
        for req in reqs:
            lv = self.live(req, in_window=False)
            lv.due = clock()
            self.admit(lv)
            while lv in self.waiting:
                if not self.prefill_one():
                    raise RuntimeError("a set-up request does not fit its pod")
            out.append(lv)
        self.sync()
        return out

    # -- the loop's steps -----------------------------------------------

    def phase(self, label: str):
        if self.profiler is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(label)

    def loads(self) -> Dict[str, float]:
        loads = {p.name: 0.0 for p in self.pods}
        for lv in list(self.waiting) + self.running:
            loads[lv.pod.name] += 1
        return loads

    def admit(self, lv: Live) -> None:
        names = [p.name for p in self.pods]
        loads = self.loads()
        lo = {n: self.tap.applied(n) for n in names}
        hi = {n: self.publishers[n].seq for n in names}
        t0 = clock()
        scores = self.indexer.get_pod_scores(lv.text, self.model, names, pod_loads=loads)
        lv.route_s = clock() - t0
        lv.scores = dict(scores)
        lv.bracket = {n: (lo[n], hi[n]) for n in names}
        # Best score; then the least loaded pod; then the one holding fewest blocks.
        order = sorted(range(len(self.pods)), key=lambda i: (
            -scores.get(names[i], 0.0), loads[names[i]],
            self.pods[i].capacity - len(self.pods[i].free), i))
        lv.pod = self.pods[order[0]]
        self.waiting.append(lv)
        self.lives.append(lv)

    def prefill_one(self) -> bool:
        """Prefill the first waiting request whose pod has room; False
        where none has."""
        for lv in self.waiting:
            if self._prefill(lv):
                self.waiting.remove(lv)
                return True
        return False

    def _timed(self, kind: str, fn, **meta):
        events = None
        if self.timed_calls:
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = clock()
        out = fn()
        if events is not None:
            events[1].record()
        return out, Call(kind, t0, 0.0, events=events, **meta)

    def _prefill(self, lv: Live) -> bool:
        pod, req, bs = lv.pod, lv.req, self.bs
        n_prompt = len(req.prompt) // bs
        need = math.ceil((len(req.prompt) + req.output - 1) / bs)
        cached = pod.cached_prefix(lv.hashes)[: n_prompt - 1]  # compute one block at least
        for bid in cached:
            pod.acquire(bid)
        got = pod.take(need - len(cached))
        if got is None:
            for bid in reversed(cached):
                pod.release(bid)
            return False
        fresh, evicted = got
        lv.blocks = np.asarray(cached + fresh, dtype=np.int32)
        lv.cached = len(cached)
        table = torch.from_numpy(lv.blocks[None, :n_prompt].copy())
        prefix = len(cached) * bs
        tokens = torch.from_numpy(req.prompt[None, prefix:].astype(np.int64))
        with self.phase("loop.prefill"):
            if cached:
                run = lambda: self.lm.prefill_continue(  # noqa: E731
                    self.params, tokens, self.pool.kv, table, prefix)[0]
            else:
                run = lambda: self.lm.prefill_paged(  # noqa: E731
                    self.params, tokens, self.pool.kv, table)[0]
            logits, call = self._timed("prefill", run, prefix=prefix,
                                       new=len(req.prompt) - prefix)
            first = int(logits[0, -1].argmax())
            call.t1 = clock()
        del logits
        self.calls.append(call)
        lv.tokens.append(first)
        lv.times.append(call.t1)
        with self.phase("loop.publish"):
            runs = self._commit(pod, lv.blocks, lv.hashes, range(len(cached), n_prompt),
                                req.prompt)
            self.publish(pod, evicted, runs)
        if len(lv.tokens) >= req.output:
            self.finish(lv)
        else:
            self.running.append(lv)
        return True

    def _commit(self, pod: Pod, blocks, hashes, span, tokens) -> List[Stored]:
        """Cache the blocks ``span`` of a sequence; the runs newly cached."""
        runs: List[Stored] = []
        last = None
        for j in span:
            if not pod.commit(int(blocks[j]), hashes[j]):
                last = None
                continue
            if last is None or last != j - 1:
                runs.append(Stored([], hashes[j - 1] if j else None, []))
            runs[-1].hashes.append(hashes[j])
            runs[-1].tokens.extend(tokens[j * self.bs:(j + 1) * self.bs].tolist())
            last = j
        return runs

    def publish(self, pod: Pod, removed, runs) -> None:
        pub = self.publishers[pod.name]
        seq = pub.seq + 1
        self.tap.expect(pod.name, seq, len(runs) + (1 if removed else 0))
        frame = pub.frame(self.events_mod, removed, runs)
        if frame is None:
            return
        msg = self.subscriber.parse_event_message(
            frame, endpoint=f"bench://{pod.name}", pod_identifier=pod.name,
            tracker=self.trackers[pod.name])
        if msg is None:
            self.frames_lost += 1
            return
        self.events.add_tasks([msg])

    def finish(self, lv: Live) -> None:
        """Cache and publish the full blocks of generated tokens, then let
        go of the request's blocks, its last ones first."""
        pod, bs = lv.pod, self.bs
        n_prompt = len(lv.req.prompt) // bs
        seq = np.concatenate([lv.req.prompt, np.asarray(lv.tokens[:-1], dtype=np.int32)])
        full = len(seq) // bs
        hashes = lv.hashes + chain_hashes(seq[n_prompt * bs:full * bs], bs, lv.hashes[-1])
        with self.phase("loop.publish"):
            runs = self._commit(pod, lv.blocks, hashes, range(n_prompt, full), seq)
            self.publish(pod, [], runs)
        for bid in reversed(lv.blocks.tolist()):
            pod.release(bid)
        lv.done = True

    def decode(self) -> List[Live]:
        """One step of every running sequence; returns those it finished."""
        rows = self.running
        n = len(rows)
        bucket = next(b for b in self.buckets if b >= n)
        table = self.tables[bucket]
        table.fill(0)
        tokens = np.zeros(bucket, dtype=np.int64)
        ctx = np.ones(bucket, dtype=np.int32)
        for i, lv in enumerate(rows):
            tokens[i] = lv.tokens[-1]
            ctx[i] = len(lv.req.prompt) + len(lv.tokens)
            table[i, :len(lv.blocks)] = lv.blocks
        step = self.steps[bucket]
        with self.phase("loop.decode"):
            logits, call = self._timed(
                "decode", lambda: step(torch.from_numpy(tokens), torch.from_numpy(table),
                                       torch.from_numpy(ctx)),
                contexts=tuple(int(c) for c in ctx[:n]), rows=tuple(lv.rid for lv in rows))
            nxt = logits[:n].argmax(-1).tolist()
            call.t1 = clock()
        if self.profiler is not None:
            call.kv_tokens = distinct_slots(table[:n], ctx[:n], self.bs)
        self.calls.append(call)
        done = []
        for lv, tok in zip(rows, nxt):
            lv.tokens.append(int(tok))
            lv.times.append(call.t1)
            if len(lv.tokens) >= lv.req.output:
                done.append(lv)
        for lv in done:
            self.running.remove(lv)
            self.finish(lv)
        return done

    def dropped(self) -> float:
        return self.metrics.counter_total(self.metrics.METRICS.kvevents_dropped)

    def close(self) -> None:
        self.events.shutdown()
        self.indexer.shutdown()
        self.steps.clear()
        self.pool = None


@dataclass
class Window:
    """What the window and its drain saw."""

    t0: float
    seconds: float
    lives: List[Live]  # the window's own requests (closed loop: those it started)
    carried: List[Live]  # set-up requests decoding on into the window
    profiled: Optional[Tuple[float, float]] = None  # host clock of the traced slice
    prof: Any = None
    stages: Tuple[dict, dict] = ({}, {})  # the event pool's stage stats at open and close
    drained_s: float = 0.0
    late_s: List[float] = field(default_factory=list)  # how late each admission ran
    backlog: int = 0  # requests waiting for their prefill when the window closed


def run_window(server: Server, plan: Plan, carried: List[Live], seconds: float,
               drain_s: float, trace_slice: Optional[Tuple[float, float]] = None) -> Window:
    """Serve the plan's window, then drain the open loop's requests due in
    it (at most ``drain_s``).  ``trace_slice`` (seconds into the window):
    record a torch.profiler trace over it."""
    pending = [server.live(r, in_window=True) for r in sorted(plan.window, key=lambda r: r.arrival)]
    streams = [list(q) for q in plan.streams]
    stream_of = {lv.rid: lv.req.stream for lv in carried}
    mine: List[Live] = list(pending)
    t0 = clock()
    win = Window(t0=t0, seconds=seconds, lives=mine, carried=carried,
                 stages=(server.events.stage_stats(), {}))
    for lv in pending:
        lv.due = t0 + lv.req.arrival
    i = 0
    closed_at = None
    while True:
        now = clock()
        if trace_slice is not None:
            if server.profiler is None and win.prof is None and now - t0 >= trace_slice[0]:
                server.sync()
                server.profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                server.profiler.start()
                win.profiled = (clock(), 0.0)
            elif server.profiler is not None and now - t0 >= trace_slice[1]:
                server.sync()
                win.profiled = (win.profiled[0], clock())
                server.profiler.stop()
                win.prof, server.profiler = server.profiler, None
        open_ = now - t0 < seconds
        if not open_ and closed_at is None:
            closed_at = now
            win.stages = (win.stages[0], server.events.stage_stats())
            win.backlog = len(server.waiting)
        with server.phase("loop.admit"):
            while i < len(pending) and pending[i].due <= now:
                win.late_s.append(now - pending[i].due)
                server.admit(pending[i])
                i += 1
        if not open_:
            if plan.streams or all(lv.done for lv in mine) or now - t0 > seconds + drain_s:
                break
        worked = False
        if server.waiting and len(server.running) < server.buckets[-1]:
            worked = server.prefill_one()
        if server.running:
            for lv in server.decode():
                s = stream_of.get(lv.rid)
                if s is not None and streams[s] and clock() - t0 < seconds:
                    nxt = server.live(streams[s].pop(0), in_window=True)
                    nxt.due = clock()
                    stream_of[nxt.rid] = s
                    mine.append(nxt)
                    server.admit(nxt)
            worked = True
        if not worked:
            wait = (pending[i].due - clock()) if i < len(pending) else 0.0005
            with server.phase("loop.wait"):
                time.sleep(min(max(wait, 0.0), 0.0005))
    if server.profiler is not None:  # a window shorter than the slice
        server.sync()
        win.profiled = (win.profiled[0], clock())
        server.profiler.stop()
        win.prof, server.profiler = server.profiler, None
    server.sync()
    win.drained_s = clock() - closed_at if closed_at else 0.0
    return win
