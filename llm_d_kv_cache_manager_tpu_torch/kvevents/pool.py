"""Sharded, per-pod-ordered event ingestion pool (the index write path).

Messages are sharded onto worker threads by ``FNV-1a-32(pod_id) % N`` so
events from one pod are always processed in publish order while the fleet
fans out across workers (reference: pkg/kvevents/pool.go:161-173).

Digest semantics (reference pool.go:233-334):

* ``BlockStored``: engine keys come from the event's hashes (normalized to
  uint64); request keys are *recomputed* from the event's token IDs with
  the indexer's own hash chain, chaining off the parent block's request key
  via ``index.get_request_key`` — the dual-key design that makes routing
  independent of per-engine hash configuration.  LoRA name, when present,
  replaces the model name in the hash chain.  Tier comes from ``medium``
  (lowercased), default "hbm" for TPU fleets.
* ``BlockRemoved``: evict each engine key.
* ``AllBlocksCleared``: intentionally a no-op, matching the reference
  (pool.go:328-329) — engines emit granular removals too.

Poison pills (undecodable payloads) are dropped, never retried.

An optional persistence journal (``persistence/journal.py``) taps the
post-apply path: every successful ``index.add``/``evict`` is appended as
an applied-operation record, which is what makes warm indexer restarts
possible (see docs/persistence.md).

**Per-pod flow control** (docs/event-plane.md): each shard queue keeps a
FIFO *lane per pod* instead of one global FIFO.  Workers drain lanes
round-robin (one message per pod per rotation), so a chatty pod shares
the batch with everyone else instead of monopolizing it.  Shedding is
budgeted per pod: a pod whose lane reaches ``PoolConfig.pod_budget``
sheds its OWN oldest message, and when the whole shard is full the
victim is the pod with the longest lane — which is always at or over
its fair share (``max_queue_depth // active pods``), so **a pod under
its effective budget** (``min(pod_budget, max_queue_depth // active
pods)``) **is never shed** — the fairness property the event_storm
bench and the property tests pin.  Within one pod, drop-oldest is
unchanged: the newest events describe the pod's current cache contents;
stale ones were about to be superseded anyway, and per-pod relative
ordering of the survivors is preserved.  Sheds are counted both in
``kvtpu_kvevents_dropped_total{reason}`` (``queue_full`` — whole-shard
overflow, ``pod_budget`` — over-budget pod, ``shutdown``) and per pod
in ``kvtpu_kvevents_pod_shed_total{pod=...}``; per-pod backlog rides
the ``kvtpu_kvevents_pod_backlog{pod=...}`` gauge.
``PoolConfig.per_pod_flow_control=False`` restores the legacy global
FIFO + drop-oldest (the bench A/B baseline).

**Write-path fast lane** (docs/event-plane.md): enqueue is batched
(``add_tasks``: one shard-lock round trip per drained socket burst,
metrics batched outside every lock) and the overflow victim — the
longest lane — is picked O(1) from depth buckets instead of an
O(lanes) ``max`` scan under the shard lock (the scan serialized
enqueueing pollers against draining workers at saturation; BENCH_r06's
pollers=4 < pollers=1 inversion).  With ``PoolConfig.lockfree_decode``
(``KVEVENTS_LOCKFREE_DECODE``, default on) payloads are msgpack-decoded
on the enqueueing thread BEFORE the shard queue — a lock-free stage
over (possibly zero-copy ``memoryview``) payloads — and workers apply
pre-decoded batches; off restores the straight in-worker decode, the
parity oracle the write-path tests pin.  ``KVEVENTS_DIGEST_MEMO``
bounds a per-worker LRU of digested request-key chains so repeated
stores of the same block chain skip re-hashing (pure function of
parent key + model + tokens, so no invalidation exists to get wrong).
``stage_stats()`` reports the cumulative decode/apply wall-time split
for the bench's bottleneck attribution, and each applied frame's wait:
``queue_s`` from the ``add_tasks`` hand-off until a worker takes its
batch, ``lag_s`` from the hand-off until the batch is flushed into the
index (both summed over the ``apply_msgs`` frames).

**Resync commands**: the anti-entropy path (``kvevents/resync.py``)
repairs a pod whose event stream gapped by enqueueing a
:class:`ResyncJob` through :meth:`Pool.enqueue_resync`.  The job rides
the pod's normal shard lane — so it is ordered against that pod's live
events — and is applied by the worker as *purge, then re-apply the
inventory snapshot* through the same batched-apply surface live events
use.  Resync commands are never shed (shedding one would strand the
pod suspect forever); a shutdown drop reports failure to the waiter.

Copied from the JAX reference's ``kvevents/pool.py``.  ``journal=`` takes
the port's ``persistence.Journal`` (``record_add``, ``record_evict``,
``record_purge``), as the reference's takes its own.  ``capture=`` (or
:meth:`Pool.set_capture`) takes the port's ``obs.capture.InputCaptureRecorder``:
the pool calls its ``record_admitted_messages`` and ``record_kvevents_batch``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index, PodEntry
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
    EMPTY_BLOCK_HASH,
    TokenProcessor,
    engine_hash_to_uint64,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.events import (
    AllBlocksCleared,
    BlockRemoved,
    BlockStored,
    EventBatch,
    EventDecodeError,
    decode_event,
    decode_event_batch,
)
from llm_d_kv_cache_manager_tpu_torch.metrics.collector import (
    METRICS,
    safe_label,
)
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.obs.trace import (
    TRACER,
    Trace,
    current_trace,
    profiler_range,
    span as obs_span,
    use_trace,
)
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger, trace

logger = get_logger("kvevents.pool")

# Pool lifecycle sits above the index in the lock hierarchy: a worker
# never holds the pool lock while applying into index shards, and the
# index never calls back into the pool.  Declared so both KV006 halves
# catch a future inversion (e.g. a drain that applies under _lock).
# kvlint: lock-order: Pool._lock < LRUCache._lock
lockorder.declare_order("Pool._lock", "LRUCache._lock")
# Shard-queue lanes are a leaf: put/get hold it only for deque surgery;
# metrics, trace bookkeeping, and index applies all happen outside.
# kvlint: lock-order: Pool._lock < ShardQueue._lock
lockorder.declare_order("Pool._lock", "ShardQueue._lock")

# TPU pods' on-chip tier; events without an explicit medium default here
# (GPU-era fleets default to "gpu" — both score 1.0 by default).
DEFAULT_EVENT_SOURCE_DEVICE_TIER = "hbm"


def resolve_lockfree_decode_env() -> bool:
    """The KVEVENTS_LOCKFREE_DECODE knob, shared by the pool's
    pre-decode stage and the poller's zero-copy receive so the two
    halves of the fast lane cannot drift apart.  Programmatic A/B runs
    that force ``PoolConfig(lockfree_decode=...)`` should set the
    poller's ``zero_copy`` to match."""
    return os.environ.get(
        "KVEVENTS_LOCKFREE_DECODE", "1"
    ).lower() not in ("0", "false", "no")

_FNV32_OFFSET = 0x811C9DC5
_FNV32_PRIME = 0x01000193


def fnv1a_32(data: bytes) -> int:
    h = _FNV32_OFFSET
    for byte in data:
        h = ((h ^ byte) * _FNV32_PRIME) & 0xFFFFFFFF
    return h


@dataclass
class ResyncJob:
    """An anti-entropy repair for one pod, applied in shard-lane order.

    ``events`` are decoded ``BlockStored`` inventory records in
    parent-chain order (``kvevents/resync.py`` builds them from an
    ``InventorySource`` snapshot).  The worker purges the pod's index
    entries, re-applies the inventory through the batched-apply
    surface, then calls ``on_done(job, ok, purged, detail)`` exactly
    once — also on shutdown-drop, so a waiter never hangs.
    """

    pod_identifier: str
    model_name: str
    events: List[object] = field(default_factory=list)
    # perf_counter timestamp when the pod was first marked suspect;
    # done-time minus this is the index-staleness window the bench and
    # the resync histogram report.
    suspect_since: float = 0.0
    on_done: Optional[Callable[["ResyncJob", bool, int, str], None]] = None
    purged: int = 0
    # First _finish wins: a job drained by a worker during shutdown and
    # then swept by the orphan pass must report exactly once.
    _done_lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False
    )
    _done: bool = field(default=False, repr=False)  # guarded-by: _done_lock

    def _finish(self, ok: bool, purged: int, detail: str) -> None:
        with self._done_lock:
            if self._done:
                return
            self._done = True
        self.purged = purged
        if self.on_done is not None:
            try:
                self.on_done(self, ok, purged, detail)
            except Exception:  # noqa: BLE001 — waiter bugs stay theirs
                logger.exception(
                    "resync on_done callback failed for pod %s",
                    self.pod_identifier,
                )


# Sentinel marking a message whose payload failed the lock-free
# pre-decode stage (poison pill discovered before the shard queue):
# the worker drops it without re-decoding.
_DECODE_FAILED = object()


@dataclass
class Message:
    """One raw event-stream message as received from a pod.

    ``payload`` may be ``bytes`` or a ``memoryview`` over the ZMQ frame
    (the poller's zero-copy path); it is only ever read by the decode
    stage, which accepts any bytes-like object.
    """

    topic: str
    payload: bytes
    pod_identifier: str
    model_name: str
    seq: int = 0
    # Events lost to a publisher sequence gap *immediately before* this
    # message (set by the subscriber); traced messages surface it so a
    # slow/strange apply can be correlated with upstream loss.
    seq_gap: int = 0
    # Sampled ingestion trace (obs/trace.py) riding the shard queue:
    # explicit propagation across the pool's thread boundary.
    trace: Optional[Trace] = None
    # Host clock of the hand-off (``add_tasks``, after its pre-decode,
    # or ``enqueue_resync``), just before the shard put: stage_stats()'s
    # queue_s and lag_s and a trace's queue_wait start here.
    enqueued_at: float = 0.0
    # Anti-entropy command (see module docstring): when set the worker
    # purges + re-applies instead of decoding ``payload``; such command
    # messages are never shed by flow control.
    resync: Optional[ResyncJob] = None
    # Decoded EventBatch produced by the lock-free pre-decode stage
    # (``Pool.add_tasks`` with ``lockfree_decode`` on, running on the
    # enqueueing thread with no locks held): the worker skips its own
    # decode when set.  ``_DECODE_FAILED`` marks a poison pill already
    # counted/logged at pre-decode time.
    decoded: Optional[object] = None
    # Payload reference stashed by the input-capture tap BEFORE the
    # pre-decode stage clears ``payload`` (obs/capture.py): the
    # capture ring holds the message, and this field keeps the raw
    # bytes (possibly a zero-copy memoryview — pinned memory is
    # bounded by CAPTURE_MAX_BYTES) reachable for dump-time
    # serialization.  Never read by the pool itself.
    capture_payload: Optional[object] = None


@dataclass
class PoolConfig:
    concurrency: int = 4
    default_device_tier: str = DEFAULT_EVENT_SOURCE_DEVICE_TIER
    # Per-shard queue bound.  At the default, 4 shards hold up to 16k
    # in-flight messages (~tens of MB of msgpack) before load-shedding.
    max_queue_depth: int = 4096
    # Messages a worker drains per wake-up.  Under a backlog the whole
    # batch is decoded together and its index adds are grouped per
    # index shard before any lock is taken (``add_entries_batch``);
    # an idle stream degenerates to batch size 1 with no added
    # latency.  Observed in the kvtpu_kvevents_batch_size histogram.
    apply_batch_size: int = 32
    # Per-pod in-flight budget: a pod with this many queued messages in
    # its shard lane sheds its OWN oldest to admit a new one, whatever
    # the rest of the shard is doing.  None -> max_queue_depth (the
    # budget then only engages via whole-shard overflow, where the
    # longest lane is shed).  See module docstring for the fairness
    # property.
    pod_budget: Optional[int] = None
    # False restores the legacy single global FIFO per shard with
    # drop-oldest shedding (no lanes, no budget) — the event_storm
    # bench's A/B baseline and an escape hatch.
    per_pod_flow_control: bool = True
    # Lock-free decode stage: payloads are msgpack-decoded on the
    # enqueueing (poller) thread BEFORE the shard queue, with no locks
    # held, so workers spend their time applying.  None -> the
    # KVEVENTS_LOCKFREE_DECODE env (default on); False keeps the
    # straight in-worker decode path — the parity oracle the
    # write-path tests pin (docs/event-plane.md).
    lockfree_decode: Optional[bool] = None
    # Per-worker LRU of digested request-key chains keyed by
    # (parent request key, model, token ids): repeated stores of the
    # same block chain (shared prefixes fleet-wide, resync re-applies)
    # skip re-hashing entirely — block keys are pure functions of that
    # key, so the memo never needs invalidation (the read path's score
    # memo argument, applied to the write path).  None -> the
    # KVEVENTS_DIGEST_MEMO env (default 4096 entries); 0 disables.
    digest_memo: Optional[int] = None

    def effective_pod_budget(self) -> int:
        if self.pod_budget is None:
            return self.max_queue_depth
        return max(1, self.pod_budget)

    def resolved_lockfree_decode(self) -> bool:
        if self.lockfree_decode is not None:
            return self.lockfree_decode
        return resolve_lockfree_decode_env()

    def resolved_digest_memo(self) -> int:
        if self.digest_memo is not None:
            return max(0, self.digest_memo)
        try:
            return max(
                0, int(os.environ.get("KVEVENTS_DIGEST_MEMO", "4096"))
            )
        except ValueError:
            return 4096


class _ShardQueue:
    """Bounded per-shard message store with per-pod FIFO lanes.

    Replaces ``queue.Queue``: same blocking get / task accounting /
    close semantics, plus lane-aware shedding and round-robin drain
    (module docstring).  All methods are thread-safe; the lock is a
    leaf (deque surgery only — metrics and trace finishing happen in
    the caller, outside the lock).
    """

    def __init__(
        self, max_depth: int, pod_budget: int, per_pod: bool
    ) -> None:
        self._max_depth = max_depth
        self._pod_budget = pod_budget
        self._per_pod = per_pod
        # One Condition serves as both the mutex and the wake channel
        # (workers wait for work, join() waits for quiescence — the
        # while-loops disambiguate).  Tracked as the Condition itself,
        # the same shape as StagingBudget._cond: tracking the inner
        # lock would trip the watchdog on Condition's ownership probe.
        # kvlint: lock-order: Pool._lock < ShardQueue._lock
        self._lock = lockorder.tracked(
            threading.Condition(), "ShardQueue._lock"
        )
        # Lane order IS the drain rotation: the front lane serves one
        # message, then rotates to the back.
        self._lanes: "OrderedDict[str, Deque[Message]]" = (
            OrderedDict()
        )  # guarded-by: _lock
        self._regular: Dict[str, int] = {}  # guarded-by: _lock
        # Inverse index of ``_regular`` (depth -> ordered set of lane
        # keys at that depth) plus the current maximum, so the
        # overflow victim — the longest lane — is an O(1) pick.  The
        # old ``max(self._regular, key=...)`` was an O(lanes) scan
        # UNDER THE SHARD LOCK on every overflowing put: at saturation
        # with ~250 lanes/shard every enqueue paid it, pollers and
        # workers convoyed on the lock, and adding pollers made apply
        # throughput WORSE (the pollers=4 < pollers=1 inversion in
        # BENCH_r06).  Depths change by ±1 per operation, so bucket
        # moves (and the max's downward walk) are amortized O(1).
        self._by_depth: Dict[int, Dict[str, None]] = {}  # guarded-by: _lock
        self._max_lane = 0  # guarded-by: _lock
        self._size = 0  # guarded-by: _lock  (regular messages only)
        self._unfinished = 0  # guarded-by: _lock  (incl. commands)
        self._closed = False  # guarded-by: _lock

    def _lane_key(self, message: Message) -> str:
        return message.pod_identifier if self._per_pod else ""

    def _depth_move_locked(self, key: str, old: int, new: int) -> None:
        """Track one lane's regular-depth change in the depth buckets."""
        if old > 0:
            bucket = self._by_depth[old]
            del bucket[key]
            if not bucket:
                del self._by_depth[old]
        if new > 0:
            self._by_depth.setdefault(new, {})[key] = None
            if new > self._max_lane:
                self._max_lane = new
        while self._max_lane and self._max_lane not in self._by_depth:
            self._max_lane -= 1

    def _shed_from_locked(
        self, key: str, reason: str, shed: List[Tuple[Message, str]]
    ) -> None:
        """Pop the oldest REGULAR message from a lane (commands are
        never shed); caller holds the lock and guarantees one exists."""
        lane = self._lanes[key]
        stash: List[Message] = []
        victim: Optional[Message] = None
        while lane:
            candidate = lane.popleft()
            if candidate.resync is None:
                victim = candidate
                break
            stash.append(candidate)
        for command in reversed(stash):
            lane.appendleft(command)
        if victim is None:  # pragma: no cover — guarded by _regular
            return
        depth = self._regular[key]
        self._regular[key] = depth - 1
        self._depth_move_locked(key, depth, depth - 1)
        self._size -= 1
        self._unfinished -= 1
        if not lane:
            del self._lanes[key]
            del self._regular[key]
        shed.append((victim, reason))

    def _put_locked(
        self, message: Message, shed: List[Tuple[Message, str]]
    ) -> int:
        """Admit one message (caller holds the lock, queue not closed);
        returns the admitting lane's post-put regular depth."""
        key = self._lane_key(message)
        is_command = message.resync is not None
        lane = self._lanes.get(key)
        if not is_command:
            # Overflow outranks the budget label: at whole-shard
            # capacity the drop IS a queue_full event (the reason
            # dashboards have always alerted on), whoever the
            # victim — the longest lane, which is at or above its
            # effective budget by construction.  The pod_budget
            # reason is reserved for a pod hitting its own budget
            # while the shard still has room (otherwise legacy
            # single-lane mode, whose budget equals the depth,
            # would relabel every overflow drop).
            if self._size >= self._max_depth:
                victim_key = next(iter(self._by_depth[self._max_lane]))
                self._shed_from_locked(victim_key, "queue_full", shed)
            elif (
                lane is not None
                and self._regular.get(key, 0) >= self._pod_budget
            ):
                self._shed_from_locked(key, "pod_budget", shed)
            lane = self._lanes.get(key)
        if lane is None:
            lane = deque()
            self._lanes[key] = lane
            self._regular[key] = 0
        lane.append(message)
        if not is_command:
            depth = self._regular[key] + 1
            self._regular[key] = depth
            self._depth_move_locked(key, depth - 1, depth)
            self._size += 1
        self._unfinished += 1
        return self._regular[key]

    def put(self, message: Message) -> Tuple[List[Tuple[Message, str]], int]:
        """Admit a message, shedding per the flow-control policy.

        Returns ``(shed, lane_depth)``: messages displaced (with their
        shed reason) for the caller to count/finish outside the lock,
        and the admitting pod's lane depth after the put (-1 when the
        message itself was rejected at shutdown).
        """
        shed: List[Tuple[Message, str]] = []
        with self._lock:
            if self._closed:
                return [(message, "shutdown")], -1
            depth = self._put_locked(message, shed)
            self._lock.notify_all()
        return shed, depth

    def put_batch(
        self, messages: Sequence[Message]
    ) -> Tuple[List[Tuple[Message, str]], Dict[str, int]]:
        """Admit many messages under ONE lock round-trip (the batched
        poller sink).  Returns ``(shed, depths)``: displaced messages
        as in :meth:`put`, and each admitting pod's post-put lane depth
        (shutdown-rejected messages land in ``shed`` only)."""
        shed: List[Tuple[Message, str]] = []
        depths: Dict[str, int] = {}
        with self._lock:
            if self._closed:
                return [(m, "shutdown") for m in messages], {}
            for message in messages:
                depths[message.pod_identifier] = self._put_locked(
                    message, shed
                )
            self._lock.notify_all()
        return shed, depths

    def get_batch(
        self, limit: int
    ) -> Tuple[List[Message], bool, Dict[str, int]]:
        """Block for work; drain up to ``limit`` messages round-robin
        across lanes.  Returns ``(batch, closed, depths)`` where
        ``closed`` means the queue is closed AND fully drained, and
        ``depths`` is the post-drain regular backlog of every lane the
        batch touched (for the backlog gauge)."""
        with self._lock:
            while not self._lanes and not self._closed:
                self._lock.wait()
            if not self._lanes:
                return [], True, {}
            batch, depths = self._drain_locked(limit)
            return batch, False, depths

    def try_get_batch(
        self, limit: int
    ) -> Tuple[List[Message], Dict[str, int]]:
        """Non-blocking :meth:`get_batch`: returns ``([], {})``
        immediately when no lane holds work.  The deterministic inline
        drain path (``Pool.process_inline``) uses it — a blocking wait
        would deadlock a caller that IS the only producer."""
        with self._lock:
            if not self._lanes:
                return [], {}
            return self._drain_locked(limit)

    def _drain_locked(
        self, limit: int
    ) -> Tuple[List[Message], Dict[str, int]]:
        """Pop up to ``limit`` messages round-robin across lanes
        (caller holds the lock and guarantees at least one lane)."""
        batch: List[Message] = []
        depths: Dict[str, int] = {}
        while self._lanes and len(batch) < limit:
            key, lane = next(iter(self._lanes.items()))
            message = lane.popleft()
            batch.append(message)
            if message.resync is None:
                depth = self._regular[key]
                self._regular[key] = depth - 1
                self._depth_move_locked(key, depth, depth - 1)
                self._size -= 1
            depths[key] = self._regular.get(key, 0)
            if lane:
                self._lanes.move_to_end(key)
            else:
                del self._lanes[key]
                del self._regular[key]
        return batch, depths

    def task_done(self, count: int) -> None:
        if count <= 0:
            return
        with self._lock:
            self._unfinished -= count
            if self._unfinished <= 0:
                self._lock.notify_all()

    def join(self) -> None:
        with self._lock:
            while self._unfinished > 0:
                self._lock.wait()

    def close(self) -> List[Tuple[Message, str]]:
        """Mark closed and wake workers; queued messages still drain.
        Returns queued resync commands so the pool can fail their
        waiters if its workers are already gone."""
        with self._lock:
            if self._closed:
                return []
            self._closed = True
            self._lock.notify_all()
            return [
                message
                for lane in self._lanes.values()
                for message in lane
                if message.resync is not None
            ]

    def qsize(self) -> int:
        with self._lock:
            return self._size

    def lane_stats(self) -> Tuple[int, int]:
        """(queued regular messages, live lanes) — the timeline's
        shard-backlog/lane series (docs/observability.md)."""
        with self._lock:
            return self._size, len(self._lanes)

    def snapshot(self) -> List[Message]:
        """Queued messages in drain (round-robin) order — tests only."""
        with self._lock:
            lanes = [list(lane) for lane in self._lanes.values()]
        out: List[Message] = []
        index = 0
        while any(index < len(lane) for lane in lanes):
            for lane in lanes:
                if index < len(lane):
                    out.append(lane[index])
            index += 1
        return out

    def lane_depths(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._regular)


class _BatchApplier:
    """Groups index admissions across one drained message batch.

    Engine->request mappings publish EAGERLY (``add_mappings``): later
    events in the same batch resolve their parents through
    ``index.get_request_key``, so the map must always be current.  Pod
    entry admissions DEFER and flush grouped per index shard
    (``add_entries_batch``) — one lock round-trip per shard per batch
    instead of one per key.  Evictions act as barriers (the caller
    flushes before applying one) so an add->evict pair inside a batch
    never reorders into evict->add.  Journal records for deferred adds
    are written only after their flush succeeds, preserving the "a
    failed apply is never journaled" invariant; record order matches
    digest order (per-pod order is structural: one pod -> one shard
    queue).

    Backends without the batched surface (Redis, cost-aware) fall back
    to the per-event ``add`` path transparently.
    """

    __slots__ = (
        "_index",
        "_journal",
        "_batched",
        "_adds",
        "_records",
        "_traces",
        "_mappings",
    )

    def __init__(self, index: Index, journal) -> None:
        self._index = index
        self._journal = journal
        self._batched = callable(
            getattr(index, "add_entries_batch", None)
        ) and callable(getattr(index, "add_mappings", None))
        self._adds: List[tuple] = []  # (request_keys, entries)
        self._records: List[tuple] = []  # deferred journal record args
        # Traces owning the deferred adds.  A flush failure must error
        # exactly these — a mid-batch (eviction-barrier) flush can
        # discard admissions from EARLIER messages in the batch, whose
        # traces would otherwise finish "ok" at batch end.
        self._traces: List[Trace] = []
        # Engine->request mappings published by THIS batch: parent
        # resolution consults it before the index, so a parent stored
        # earlier in the batch resolves without a backend round trip —
        # for a remote backend (cluster/remote_index.py) that is one
        # RPC saved per chained event; for local backends it is merely
        # a dict hit instead of an LRU lock.  Mirrors already-published
        # state (add_mappings is eager), so semantics are unchanged.
        self._mappings: Dict[int, int] = {}

    def add(
        self,
        pod_identifier: str,
        seq: int,
        engine_keys: Sequence[int],
        request_keys: Sequence[int],
        entries: Sequence[PodEntry],
        owner_trace: Optional[Trace] = None,
    ) -> None:
        self._mappings.update(zip(engine_keys, request_keys))
        if not self._batched:
            self._index.add(engine_keys, request_keys, entries)
            if self._journal is not None:
                self._journal.record_add(
                    pod_identifier, seq, engine_keys, request_keys, entries
                )
            return
        self._index.add_mappings(engine_keys, request_keys)
        self._adds.append((request_keys, entries))
        if owner_trace is not None:
            self._traces.append(owner_trace)
        if self._journal is not None:
            self._records.append(
                (pod_identifier, seq, engine_keys, request_keys, entries)
            )

    def resolve_request_key(self, engine_key: int) -> int:
        """Parent resolution for chained events: the batch's own
        published mappings first, the index second.  Raises KeyError
        like ``Index.get_request_key``."""
        request_key = self._mappings.get(engine_key)
        if request_key is not None:
            return request_key
        return self._index.get_request_key(engine_key)

    def forget_mapping(self, engine_key: int) -> None:
        """Drop a batch-cached mapping after an eviction so parent
        resolution falls back to the index — the ground truth for
        whether the key survived.  Without this, a store chaining off
        an in-batch-evicted parent resolved or skipped depending on
        where the worker's batch boundary happened to fall (and the
        coalesced/uncoalesced streams could diverge the same way)."""
        self._mappings.pop(engine_key, None)

    def flush(self) -> None:
        """Apply deferred admissions (grouped per shard), then journal
        them.  Called before any eviction and at batch end."""
        if self._adds:
            adds, self._adds = self._adds, []
            traces, self._traces = self._traces, []
            try:
                self._index.add_entries_batch(adds)
            except Exception as exc:
                # The admissions never landed: their journal records
                # must die with them, or a later flush would journal
                # operations the live index never held ("a failed
                # apply is never journaled") — and their owning traces
                # must finish errored NOW, because the batch loop only
                # sees this exception through the triggering message
                # and would finish the earlier owners "ok".
                self._records = []
                for tr in traces:
                    tr.set_error(f"batched apply flush failed: {exc!r}")
                    tr.finish("error")
                raise
        if self._records:
            records, self._records = self._records, []
            for args in records:
                self._journal.record_add(*args)


class Pool:
    """N worker threads, each draining its own lane-structured queue.

    Each wake-up drains up to ``PoolConfig.apply_batch_size`` queued
    messages (round-robin across the shard's pod lanes), decodes them
    together, and applies them through a :class:`_BatchApplier` so
    admissions group per index shard before any lock is taken.
    Per-message traces, poison-pill handling, and per-pod ordering are
    unchanged from the one-message-at-a-time path; batch sizes land in
    ``kvtpu_kvevents_batch_size``.
    """

    def __init__(
        self,
        index: Index,
        token_processor: TokenProcessor,
        config: Optional[PoolConfig] = None,
        journal=None,
        capture=None,
    ) -> None:
        self.config = config or PoolConfig()
        if self.config.concurrency <= 0:
            raise ValueError("pool concurrency must be positive")
        self._index = index
        self._token_processor = token_processor
        # Optional persistence journal (persistence.Journal), tapped
        # AFTER each index apply succeeds: the journal records applied
        # operations, so replay needs no token re-hashing and a failed
        # apply is never journaled.  Per-pod order in the journal
        # matches apply order structurally (one pod -> one shard).
        self._journal = journal
        # Optional input flight recorder (obs/capture.py), tapped in
        # add_tasks POST shed decision: every ingress message lands in
        # the capture ring with its admitted/shed disposition so an
        # incident bundle can be replayed to a divergence
        # (obs/replay.py).  Resync commands are synthesized repairs,
        # not ingress, and are never recorded.  None (the default and
        # the CAPTURE=0 path) leaves the hot path with a single
        # ``is None`` check.
        self._capture = capture
        if self.config.max_queue_depth <= 0:
            raise ValueError("pool max_queue_depth must be positive")
        self._queues: List[_ShardQueue] = [
            _ShardQueue(
                self.config.max_queue_depth,
                self.config.effective_pod_budget(),
                self.config.per_pod_flow_control,
            )
            for _ in range(self.config.concurrency)
        ]
        self._threads: List[threading.Thread] = []  # guarded-by: _lock
        self._started = False  # guarded-by: _lock
        # Digest memo for the inline (single-threaded) drain path;
        # lazily built by process_inline, never shared with workers.
        self._inline_memo: Optional[OrderedDict] = None
        self._lock = lockorder.tracked(threading.Lock(), "Pool._lock")
        self._lockfree_decode = self.config.resolved_lockfree_decode()
        self._digest_memo_size = self.config.resolved_digest_memo()
        # Hot-path caches (racy-benign: values are deterministic, a
        # lost write is recomputed).  Bounded so a malformed-topic
        # flood cannot grow them without limit.
        self._shard_cache: Dict[str, int] = {}
        self._backlog_gauges: Dict[str, object] = {}
        self._shed_counters: Dict[str, object] = {}
        # Cumulative decode/apply wall-time split, wherever each stage
        # ran (pre-decode on the enqueueing thread or in-worker).  Fed
        # per batch, read by stage_stats() — the bench's
        # decode-vs-apply attribution.
        self._stage_lock = lockorder.tracked(
            threading.Lock(), "Pool._stage_lock"
        )
        self._stage = {  # guarded-by: _stage_lock
            "decode_s": 0.0,
            "decode_msgs": 0,
            "apply_s": 0.0,
            "apply_msgs": 0,
            "queue_s": 0.0,
            "lag_s": 0.0,
        }

    def set_capture(self, capture) -> None:
        """Attach/detach the input flight recorder (obs/capture.py)
        after construction — embedders that build the recorder late.
        Racy-benign: enqueueing threads read the attribute once per
        batch."""
        # gil-atomic: single ref store; enqueuers read one snapshot per batch
        self._capture = capture

    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
            for i in range(self.config.concurrency):
                thread = threading.Thread(
                    target=self._worker,
                    args=(i,),
                    name=f"kvtpu-events-{i}",
                    daemon=True,
                )
                thread.start()
                self._threads.append(thread)

    def shutdown(self) -> None:
        with self._lock:
            if not self._started:
                return
            orphaned: List[Message] = []
            for q in self._queues:
                orphaned.extend(q.close())
            threads = list(self._threads)
            self._threads.clear()
            self._started = False
        for thread in threads:
            thread.join(timeout=10)
        # Workers that exited without draining (or never existed) must
        # not leave resync waiters hanging.
        for message in orphaned:
            if message.resync is not None:
                message.resync._finish(False, 0, "pool shutdown")

    def drain(self) -> None:
        """Block until every queued message has been processed (tests)."""
        for q in self._queues:
            q.join()

    def process_inline(self, limit: int = 0) -> int:
        """Synchronously decode + apply queued messages on the CALLING
        thread — the deterministic drain primitive the what-if engine's
        virtual clock schedules against (obs/whatif.py).

        The pool must never have been ``start()``ed: with no workers,
        ``add_tasks`` flow-control decisions are pure data-structure
        ops and this call owns the only drain, so a given enqueue/drain
        schedule processes messages in exactly one order.  Drains up to
        ``limit`` messages (0 = everything currently queued), one
        apply-batch per shard per rotation (shard order, then each
        shard's own round-robin lanes).  Returns messages processed.
        """
        with self._lock:
            if self._started:
                raise RuntimeError(
                    "process_inline requires an un-started pool "
                    "(workers would race the inline drain)"
                )
        batch_limit = max(1, self.config.apply_batch_size)
        memo = self._inline_memo
        if memo is None and self._digest_memo_size:
            memo = self._inline_memo = OrderedDict()
        processed = 0
        while True:
            progressed = False
            for q in self._queues:
                take = batch_limit
                if limit > 0:
                    take = min(take, limit - processed)
                    if take <= 0:
                        return processed
                batch, depths = q.try_get_batch(take)
                if not batch:
                    continue
                for pod, depth in depths.items():
                    if pod:
                        self._backlog_gauge(pod).set(depth)
                try:
                    self._process_batch(batch, 0, memo)
                except Exception:  # noqa: BLE001 — mirror the worker
                    logger.exception(
                        "inline drain failed processing a batch; "
                        "dropping"
                    )
                finally:
                    q.task_done(len(batch))
                processed += len(batch)
                progressed = True
            if not progressed:
                return processed

    @staticmethod
    def _finish_dropped(dropped: Message, reason: str) -> None:
        """A shed message's trace must still reach the recorder: drops
        ARE the incident the flight recorder exists to explain."""
        if dropped.trace is not None:
            dropped.trace.set_error(f"dropped: {reason}")
            dropped.trace.finish("error")
        if dropped.resync is not None:
            dropped.resync._finish(False, 0, f"dropped: {reason}")

    def _shard_index(self, pod_identifier: str) -> int:
        shard = self._shard_cache.get(pod_identifier)
        if shard is None:
            shard = fnv1a_32(pod_identifier.encode()) % len(self._queues)
            if len(self._shard_cache) < 131072:
                # gil-atomic: idempotent memo; value is a pure function of the key
                self._shard_cache[pod_identifier] = shard
        return shard

    def _shard_for(self, pod_identifier: str) -> _ShardQueue:
        return self._queues[self._shard_index(pod_identifier)]

    def _backlog_gauge(self, pod_identifier: str):
        gauge = self._backlog_gauges.get(pod_identifier)
        if gauge is None:
            gauge = METRICS.kvevents_pod_backlog.labels(
                pod=safe_label(pod_identifier)
            )
            if len(self._backlog_gauges) < 131072:
                # gil-atomic: idempotent memo; racing put re-derives the same value
                self._backlog_gauges[pod_identifier] = gauge
        return gauge

    def _shed_counter(self, pod_identifier: str):
        counter = self._shed_counters.get(pod_identifier)
        if counter is None:
            counter = METRICS.kvevents_pod_shed.labels(
                pod=safe_label(pod_identifier)
            )
            if len(self._shed_counters) < 131072:
                # gil-atomic: idempotent memo; racing put re-derives the same value
                self._shed_counters[pod_identifier] = counter
        return counter

    def _stage_account(self, stage: str, seconds: float, msgs: int) -> None:
        with self._stage_lock:
            self._stage[f"{stage}_s"] += seconds
            self._stage[f"{stage}_msgs"] += msgs

    def _frames_account(
        self, apply_s: float, frames: int, queue_s: float, lag_s: float
    ) -> None:
        with self._stage_lock:
            stage = self._stage
            stage["apply_s"] += apply_s
            stage["apply_msgs"] += frames
            stage["queue_s"] += queue_s
            stage["lag_s"] += lag_s

    def stage_stats(self) -> dict:
        """Cumulative decode vs apply wall-time split (seconds and
        message counts), wherever each stage ran — the bench's
        bottleneck attribution (docs/event-plane.md) — and the applied
        frames' summed ``queue_s`` (hand-off to a worker's take) and
        ``lag_s`` (hand-off to the flush into the index)."""
        with self._stage_lock:
            return dict(self._stage)

    def lane_stats(self) -> Tuple[int, int]:
        """(queued-not-applied messages, pods holding a live lane)
        across every shard in ONE walk — the timeline samples both
        series every second off a single call, so the shard locks
        are taken once, not once per series (shards are sampled one
        lock at a time: a near-instant, not atomic, view)."""
        queued = 0
        lanes = 0
        for q in self._queues:
            shard_queued, shard_lanes = q.lane_stats()
            queued += shard_queued
            lanes += shard_lanes
        return queued, lanes

    def backlog(self) -> int:
        """Queued-not-applied messages across every shard."""
        return self.lane_stats()[0]

    def lane_count(self) -> int:
        """Pods holding a live (non-empty) lane across every shard."""
        return self.lane_stats()[1]

    def _prepare_message(self, message: Message) -> None:
        if message.trace is None:
            tr = TRACER.start_trace("kvevents.message")
            if tr is not None:
                tr.set_attr("pod", message.pod_identifier)
                tr.set_attr("topic", message.topic)
                tr.set_attr("seq", message.seq)
                message.trace = tr

    def _predecode(self, message: Message) -> None:
        """Lock-free decode stage: runs on the ENQUEUEING thread with
        no locks held, so workers never parse msgpack and enqueueing
        threads never hold a lock while parsing."""
        try:
            message.decoded = decode_event_batch(message.payload)
            # The payload is never read again once decoded; dropping it
            # now releases the zero-copy ZMQ frame instead of pinning
            # raw msgpack alongside the decoded batch for the whole
            # queue backlog lifetime.
            message.payload = b""
        except EventDecodeError as exc:
            message.decoded = _DECODE_FAILED
            logger.warning(
                "dropping poison-pill message from pod %s (topic %s): %s",
                message.pod_identifier,
                message.topic,
                exc,
            )
            if message.trace is not None:
                message.trace.set_error(f"poison pill: {exc}")
        except Exception as exc:  # noqa: BLE001 — decoder bug, not fatal
            message.decoded = _DECODE_FAILED
            logger.exception(
                "pre-decode failed for a message from pod %s; dropping",
                message.pod_identifier,
            )
            if message.trace is not None:
                message.trace.set_error(f"pre-decode crashed: {exc!r}")

    def add_task(self, message: Message) -> None:
        self.add_tasks((message,))

    def add_tasks(self, messages: Sequence[Message]) -> None:
        """Batched enqueue — the consolidated poller's sink.

        One shard-lock round trip per touched shard per call (vs one
        per message), metrics and trace bookkeeping batched outside
        every lock.  The lock-free decode stage runs here when enabled
        (``PoolConfig.lockfree_decode``): payloads are parsed on this
        thread with no locks held, and workers apply pre-decoded
        batches.
        """
        if not messages:
            return
        with profiler_range("kvevents.add_tasks"):
            self._add_tasks(messages)

    def _add_tasks(self, messages: Sequence[Message]) -> None:
        per_shard: Dict[int, List[Message]] = {}
        # Input capture copies payload bytes BEFORE the lock-free
        # pre-decode stage releases them (zero-copy ZMQ frames must
        # not be pinned by the ring, and pre-decode clears payload).
        cap = self._capture
        captured: Optional[List[Message]] = (
            [] if cap is not None else None
        )
        # Trace start BEFORE pre-decode: a poison pill found at decode
        # must still error its sampled trace for the flight recorder.
        for message in messages:
            self._prepare_message(message)
            if captured is not None and message.resync is None:
                message.capture_payload = message.payload
                captured.append(message)
            per_shard.setdefault(
                self._shard_index(message.pod_identifier), []
            ).append(message)
        if self._lockfree_decode:
            t0 = time.perf_counter()
            n_decoded = 0
            for message in messages:
                if message.resync is None and message.decoded is None:
                    self._predecode(message)
                    n_decoded += 1
            if n_decoded:
                self._stage_account(
                    "decode", time.perf_counter() - t0, n_decoded
                )
        shed_map: Dict[int, Tuple[Message, str]] = {}
        for shard, batch in per_shard.items():
            # The hand-off: after the caller's pre-decode, just before
            # the put that lets a worker take the frames.
            now = time.perf_counter()
            for message in batch:
                message.enqueued_at = now
            shed, depths = self._queues[shard].put_batch(batch)
            # Metrics + trace finishing OUTSIDE the shard lock.
            for dropped, reason in shed:
                if captured is not None:
                    shed_map[id(dropped)] = (dropped, reason)
                METRICS.kvevents_dropped.labels(reason=reason).inc()
                self._shed_counter(dropped.pod_identifier).inc()
                self._finish_dropped(dropped, reason)
                logger.debug(
                    "event shard shed a message from pod %s (%s)",
                    dropped.pod_identifier,
                    reason,
                )
            for pod, depth in depths.items():
                self._backlog_gauge(pod).set(depth)
        if captured is not None:
            try:
                self._capture_batch(cap, captured, shed_map)
            except Exception:  # noqa: BLE001 — capture never sheds work
                logger.exception("input capture failed for a batch")

    @staticmethod
    def _capture_batch(
        cap,
        captured: List[Message],
        shed_map: Dict[int, Tuple[Message, str]],
    ) -> None:
        """Record this enqueue burst post shed decision: every message
        of the burst lands once (admitted, or its shed reason); a
        message from an EARLIER burst displaced by this one gets a
        payload-free displacement record — replay cancels its admitted
        record against it (obs/replay.py).  The whole burst rides ONE
        recorder lock round trip so the tap stays inside the
        event_storm capture_ab overhead bound; the common no-shed
        burst takes the allocation-free admitted fast path (the ring
        holds the Message itself, expanded at dump time)."""
        if not shed_map:
            cap.record_admitted_messages(captured)
            return
        items = []
        for message in captured:
            entry = shed_map.pop(id(message), None)
            items.append(
                (
                    message.pod_identifier,
                    message.topic,
                    message.model_name,
                    message.seq,
                    message.seq_gap,
                    bytes(message.capture_payload),
                    "admitted" if entry is None else entry[1],
                )
            )
        for dropped, reason in shed_map.values():
            if dropped.resync is not None:
                continue
            items.append(
                (
                    dropped.pod_identifier,
                    dropped.topic,
                    dropped.model_name,
                    dropped.seq,
                    dropped.seq_gap,
                    None,
                    reason,
                )
            )
        cap.record_kvevents_batch(items)

    def enqueue_resync(self, job: ResyncJob, trace_: Optional[Trace] = None):
        """Queue an anti-entropy repair in the pod's shard lane (so it
        is ordered against the pod's live events)."""
        message = Message(
            topic=f"resync@{job.pod_identifier}",
            payload=b"",
            pod_identifier=job.pod_identifier,
            model_name=job.model_name,
            trace=trace_,
            resync=job,
            enqueued_at=time.perf_counter(),
        )
        shed, _depth = self._shard_for(job.pod_identifier).put(message)
        for dropped, reason in shed:
            # Only "shutdown" can reject a command message.
            METRICS.kvevents_dropped.labels(reason=reason).inc()
            self._finish_dropped(dropped, reason)

    def _worker(self, worker_index: int) -> None:
        q = self._queues[worker_index]
        batch_limit = max(1, self.config.apply_batch_size)
        # Per-worker digest memo: no cross-thread sharing, no lock —
        # a worker owns its pods (pod -> shard affinity), so its memo
        # naturally concentrates on the chains those pods re-store.
        memo: Optional[OrderedDict] = (
            OrderedDict() if self._digest_memo_size else None
        )
        while True:
            batch, closed, depths = q.get_batch(batch_limit)
            if closed:
                return
            for pod, depth in depths.items():
                if pod:
                    self._backlog_gauge(pod).set(depth)
            try:
                self._process_batch(batch, worker_index, memo)
            except Exception:
                # The batch loop guards decode and apply per message,
                # but the worker must survive ANYTHING escaping
                # (metrics observe, trace bookkeeping): a dead worker
                # means its shard's queue fills and every later event
                # for those pods is silently shed for the process
                # lifetime.
                logger.exception(
                    "event worker %d failed processing a batch; dropping",
                    worker_index,
                )
            finally:
                # task_done only after the batch (including the
                # deferred-add flush) has fully applied: drain() must
                # imply visibility.
                q.task_done(len(batch))

    def _process_batch(
        self,
        batch: List[Message],
        worker_index: int,
        memo: Optional[OrderedDict] = None,
    ) -> None:
        taken = time.perf_counter()
        METRICS.kvevents_batch_size.observe(len(batch))
        applier = _BatchApplier(self._index, self._journal)
        decoded: List[Optional[EventBatch]] = []
        decode_t = 0.0
        decode_n = 0
        for message in batch:
            tr = message.trace
            if tr is not None:
                # Queue wait vs apply time is the shard-health split: a
                # storm shows up as queue_wait, a stuck index backend
                # as apply.
                tr.add_completed("kvevents.queue_wait", message.enqueued_at)
                if message.seq_gap:
                    tr.set_attr("seq_gap", message.seq_gap)
            if message.resync is not None:
                decoded.append(None)
                continue
            if message.decoded is not None:
                # Pre-decoded by the lock-free stage (poison pills were
                # already counted and their traces errored there).
                decoded.append(
                    None
                    if message.decoded is _DECODE_FAILED
                    else message.decoded
                )
                continue
            try:
                t0 = time.perf_counter()
                with use_trace(tr):
                    decoded.append(self._decode_message(message))
                decode_t += time.perf_counter() - t0
                decode_n += 1
            except Exception:
                logger.exception(
                    "event worker %d failed decoding a message; dropping",
                    worker_index,
                )
                decoded.append(None)
                if tr is not None:
                    tr.finish("error")
        if decode_n:
            self._stage_account("decode", decode_t, decode_n)
        # Traces of successfully-digested messages stay open until the
        # final flush lands: their adds may still be deferred in the
        # applier, and a trace that reported "ok" before its admissions
        # were applied would hide a flush failure from the flight
        # recorder.
        pending_traces: List[Trace] = []
        apply_t0 = time.perf_counter()
        apply_n = 0
        handed_off = 0.0  # sum of the applied frames' enqueued_at
        for message, events in zip(batch, decoded):
            tr = message.trace
            if message.resync is not None:
                # Barrier like evictions: the purge must not reorder
                # ahead of admissions digested earlier in this batch.
                applier.flush()
                self._apply_resync(message, worker_index, memo)
                continue
            if events is None:
                if tr is not None:
                    # Poison pill (error already set) or decode crash
                    # (already finished — finish() is idempotent).
                    tr.finish()
                continue
            try:
                with use_trace(tr):
                    self._apply_events(message, events, applier, memo)
                apply_n += 1
                handed_off += message.enqueued_at
            except Exception as exc:
                if tr is not None:
                    tr.set_error(repr(exc))
                    tr.finish("error")
                logger.exception(
                    "event worker %d failed processing a message; dropping",
                    worker_index,
                )
                continue
            if tr is not None:
                pending_traces.append(tr)
        try:
            applier.flush()
        except Exception:
            logger.exception(
                "event worker %d failed flushing batched index adds; "
                "dropping the batch's deferred admissions",
                worker_index,
            )
        if apply_n:
            flushed = time.perf_counter()
            self._frames_account(
                flushed - apply_t0,
                apply_n,
                apply_n * taken - handed_off,
                apply_n * flushed - handed_off,
            )
        # Applied messages may be retained by the input-capture ring
        # (compact records hold the Message itself); dropping the
        # decoded-batch and trace refs here keeps that retention at
        # payload cost, not payload + decoded-object + finished-trace
        # cost (the flight recorder holds its own trace refs, and
        # pending_traces below carries the ones still to finish).
        # The poison sentinel is a process-wide singleton — keep it
        # (it is the observable that pre-decode already classified
        # the message).
        for message in batch:
            if message.decoded is not _DECODE_FAILED:
                message.decoded = None
            message.trace = None
        # The applier already finished the traces owning any discarded
        # adds as errored (whether the failing flush was this final one
        # or a mid-batch eviction barrier); for everyone else the work
        # landed, so "ok" — finish() is idempotent, first call wins.
        for tr in pending_traces:
            tr.finish()

    def _apply_resync(
        self,
        message: Message,
        worker_index: int,
        memo: Optional[OrderedDict] = None,
    ) -> None:
        """Purge + re-apply one pod's inventory snapshot, atomically
        with respect to this worker (the pod's only event applier)."""
        job = message.resync
        assert job is not None
        tr = message.trace
        try:
            with use_trace(tr):
                with obs_span("kvevents.resync.apply") as s:
                    purged = self._index.purge_pod(job.pod_identifier)
                    if self._journal is not None:
                        # The purge must replay before the re-applied
                        # inventory (recovery + replication followers
                        # replay in journal order), or a crash between
                        # here and the next snapshot resurrects the
                        # purged claims.
                        self._journal.record_purge(job.pod_identifier)
                    applier = _BatchApplier(self._index, self._journal)
                    applied = 0
                    for event in job.events:
                        self._digest(message, event, applier, memo)
                        applied += 1
                    applier.flush()
                    s.set_attr("purged", purged)
                    s.set_attr("inventory_events", applied)
        except Exception as exc:
            logger.exception(
                "event worker %d failed resyncing pod %s",
                worker_index,
                job.pod_identifier,
            )
            if tr is not None:
                tr.set_error(f"resync apply failed: {exc!r}")
                tr.finish("error")
            job._finish(False, 0, f"apply failed: {exc!r}")
            return
        if tr is not None:
            tr.finish()
        job._finish(True, purged, "ok")

    def _decode_message(self, message: Message) -> Optional[EventBatch]:
        with obs_span("kvevents.decode") as s:
            try:
                batch = decode_event_batch(message.payload)
            except EventDecodeError as exc:
                # Data loss, not noise: this pod's cache state is now
                # stale until its next re-store event.
                logger.warning(
                    "dropping poison-pill message from pod %s (topic %s): %s",
                    message.pod_identifier,
                    message.topic,
                    exc,
                )
                active = current_trace()
                if active is not None:
                    active.set_error(f"poison pill: {exc}")
                return None
            s.set_attr("events", len(batch.events))
        return batch

    def _apply_events(
        self,
        message: Message,
        batch: EventBatch,
        applier: _BatchApplier,
        memo: Optional[OrderedDict] = None,
    ) -> None:
        with obs_span("kvevents.apply") as s:
            applied = 0
            for raw_event in batch.events:
                try:
                    event = decode_event(raw_event)
                except (EventDecodeError, TypeError, ValueError) as exc:
                    # Per-event skip: one malformed event must not drop
                    # the rest of the batch.
                    logger.debug("skipping undecodable event: %s", exc)
                    continue
                self._digest(message, event, applier, memo)
                applied += 1
            s.set_attr("applied", applied)

    def _digest(
        self,
        message: Message,
        event,
        applier: _BatchApplier,
        memo: Optional[OrderedDict] = None,
    ) -> None:
        if isinstance(event, BlockStored):
            self._digest_block_stored(message, event, applier, memo)
        elif isinstance(event, BlockRemoved):
            self._digest_block_removed(message, event, applier)
        elif isinstance(event, AllBlocksCleared):
            # Intentional no-op; granular BlockRemoved events follow.
            return

    def _tier(self, medium: Optional[str]) -> str:
        if medium:
            return medium.lower()
        return self.config.default_device_tier

    def _digest_block_stored(
        self,
        message: Message,
        event: BlockStored,
        applier: _BatchApplier,
        memo: Optional[OrderedDict] = None,
    ) -> None:
        entries = [PodEntry(message.pod_identifier, self._tier(event.medium))]

        # LoRA adapters have their own KV-incompatible hash space.
        effective_model = event.lora_name or message.model_name

        engine_keys = []
        for raw_hash in event.block_hashes:
            try:
                engine_keys.append(engine_hash_to_uint64(raw_hash))
            except (TypeError, ValueError) as exc:
                logger.debug("skipping bad block hash %r: %s", raw_hash, exc)
        if not engine_keys:
            return

        parent_request_key = EMPTY_BLOCK_HASH
        if event.parent_block_hash is not None:
            try:
                parent_engine_key = engine_hash_to_uint64(
                    event.parent_block_hash
                )
                parent_request_key = applier.resolve_request_key(
                    parent_engine_key
                )
            except (TypeError, ValueError, KeyError) as exc:
                # Parent unknown (evicted or never seen): skip the event
                # rather than index keys hashed off the wrong root.
                trace(
                    logger,
                    "parent block unresolvable for pod %s: %s",
                    message.pod_identifier,
                    exc,
                )
                return

        # Digest memo: request keys are a pure function of
        # (parent request key, model, token ids) — the token-processor
        # identity is fixed per pool — so a repeated chain skips the
        # hash work entirely.  Values are treated read-only everywhere
        # downstream (the overlap trim below slices a copy).
        memo_key = None
        request_keys = None
        if memo is not None:
            memo_key = (
                parent_request_key,
                effective_model,
                tuple(event.token_ids),
            )
            request_keys = memo.get(memo_key)
            if request_keys is not None:
                memo.move_to_end(memo_key)
        if request_keys is None:
            request_keys = self._token_processor.tokens_to_kv_block_keys(
                parent_request_key, event.token_ids, effective_model
            )
            if memo is not None:
                memo[memo_key] = request_keys
                if len(memo) > self._digest_memo_size:
                    memo.popitem(last=False)
        if len(request_keys) != len(engine_keys):
            logger.debug(
                "engine reported %d hashes but token ids produced %d request "
                "keys (pod %s); indexing the overlapping prefix",
                len(engine_keys),
                len(request_keys),
                message.pod_identifier,
            )
            overlap = min(len(request_keys), len(engine_keys))
            if overlap == 0:
                return
            engine_keys = engine_keys[:overlap]
            request_keys = request_keys[:overlap]

        applier.add(
            message.pod_identifier,
            message.seq,
            engine_keys,
            request_keys,
            entries,
            owner_trace=message.trace,
        )

    def _digest_block_removed(
        self, message: Message, event: BlockRemoved, applier: _BatchApplier
    ) -> None:
        # Eviction barrier: deferred adds must land first so an
        # add->evict pair inside one batch keeps its order.
        applier.flush()
        entries = [PodEntry(message.pod_identifier, self._tier(event.medium))]
        evicted_keys = []
        for raw_hash in event.block_hashes:
            try:
                engine_key = engine_hash_to_uint64(raw_hash)
            except (TypeError, ValueError) as exc:
                logger.debug("skipping bad removal hash %r: %s", raw_hash, exc)
                continue
            self._index.evict(engine_key, entries)
            applier.forget_mapping(engine_key)
            evicted_keys.append(engine_key)
        if self._journal is not None and evicted_keys:
            self._journal.record_evict(
                message.pod_identifier, message.seq, evicted_keys, entries
            )
