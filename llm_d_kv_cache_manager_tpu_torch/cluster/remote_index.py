"""RemoteIndex: the Index contract over a replica fleet.

An :class:`~..kvcache.kvblock.index.Index` implementation that routes
every operation to the rendezvous owner of its block key and fans
grouped operations out one RPC per owner — so the whole read/write
stack above it (fast-lane chunked ``lookup_chain``, the kvevents
pool's ``add_mappings`` + ``add_entries_batch`` batched apply, the
analytics ledger, the tiering feed, persistence dumps) works unchanged
against N replicas.

Routing discipline:

* **Reads** (``lookup`` / ``lookup_chain``): keys group per owner
  under ONE ring snapshot; one RPC per owner per call, and with the
  fan-out executor armed (``CLUSTER_FANOUT_WORKERS``, default on) the
  owners of a chunk are dispatched CONCURRENTLY — a chunk costs ~one
  RTT instead of ``owners x RTT``.  ``lookup_chain_async`` additionally
  lets the fast lane keep chunk N+1 in flight while chunk N resolves
  (docs/replication.md "Pipelined read path"); merge order is plan
  order either way, so results are bit-identical to the sequential
  path (``CLUSTER_FANOUT_WORKERS=0``).  Arming is latency-adaptive:
  both overlap and pipelining engage only once the observed per-RPC
  latency EWMA reaches ``CLUSTER_OVERLAP_MIN_RPC_S`` (default 250us)
  — against an in-process or loopback transport cheaper than a pool
  handoff they stay sequential, and real network transports cross the
  threshold on the first call.  0 forces always-armed.
* **Writes**: pod-entry admissions live at ``owner(request_key)``;
  engine->request mappings are published BOTH at
  ``owner(engine_key)`` (where ``get_request_key`` routes) and at
  ``owner(request_key)`` (whose local backend resolves them during
  ``evict``).  An eviction is two hops: resolve the request key at the
  engine-key owner, evict at the request-key owner.
* **Failover**: a transport failure marks the replica dead in the
  membership (ring version bump, failover counter) and the operation
  retries against the new owner — the rendezvous runner-up, whose
  replication follower has been keeping that slice warm
  (``replication.py``).  Application errors propagate; only transport
  failures fail over.
* **Observability** (docs/observability.md "Fleet tracing"): when the
  calling context carries a sampled trace, every owner RPC records a
  ``cluster.rpc`` span (replica + method attrs) and forwards the
  trace context on the wire; span summaries piggybacked on the reply
  are stitched back in as children — ONE trace covers the whole
  fan-out, including a failed RPC and its re-routed retry.  Always-on
  fan-out attribution (``rpc_stats()``, the ``/debug/cluster`` rpc
  panel) tallies per-replica latency/error/retry counters plus the
  sequential critical-path breakdown (owner RPCs per lookup) that
  baselines the read-path pipelining work.

Cluster score memo (``version_vector`` / ``touch_chain``): every
successful replica reply piggybacks the backend's per-shard version
snapshot (``replica.py``), which the router folds — elementwise-max,
so late replies cannot regress a counter — into a per-replica vector
cache.  ``version_vector()`` composes ``(ring.version, ((replica,
vector), ...))`` over the current ring; a replica whose vector is
missing or older than ``CLUSTER_VV_TTL_S`` contributes a unique
never-equal sentinel, so the indexer's exact-prompt memo simply
misses (and the recompute's own replies refresh the cache) rather
than ever validating against stale state.  Router-driven mutations
(add / evict / purge) refresh the mutated owner's vector on their own
reply, so the memo invalidates synchronously; out-of-band writes
(replication followers, ``CLUSTER_LOCAL_INGEST``) are bounded by the
TTL plus the hit path's own ``touch_chain`` RPCs, whose replies
re-arm validation — an advisory-index coherence bound, documented in
docs/replication.md.  ``touch_chain`` fans recency touches to the
keys' owners off-thread (never journaled, never on the hit path's
critical path).

Deadline budget: each fan-out (and each routed single-key op) gets
one wall-clock budget (``CLUSTER_FANOUT_BUDGET_S``); a re-routed
retry after ``mark_dead`` runs against the budget's REMAINDER rather
than restarting the full transport timeout, so p99 under a dead
replica is bounded by ~one timeout.  ``dump_entries`` concatenates
every alive replica's dump; standby slices may duplicate keys, which
``restore_entries`` absorbs idempotently.

Copied from the JAX reference's ``cluster/remote_index.py``.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Set, Tuple

from llm_d_kv_cache_manager_tpu_torch.cluster.membership import ClusterMembership
from llm_d_kv_cache_manager_tpu_torch.cluster.replica import (
    ReplicaUnavailable,
    decode_entries,
    encode_entries,
    resolve_trace_piggyback_env,
)
from llm_d_kv_cache_manager_tpu_torch.cluster.ring import HashRing
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index, PodEntry
from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS, safe_label
from llm_d_kv_cache_manager_tpu_torch.obs.trace import (
    Span,
    current_trace,
    shield_trace,
)
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("cluster.remote_index")

# Leaf lock: per-replica RPC tallies only — never a transport call or
# a membership flip under it.
# kvlint: lock-order: RemoteIndex._stats_lock ascending
lockorder.declare_ascending("RemoteIndex._stats_lock")
# Leaf lock: the per-replica version-vector cache only — noted on the
# RPC completion path (fan-out workers included), so nothing blocking
# may ever run under it.
# kvlint: lock-order: RemoteIndex._vv_lock ascending
lockorder.declare_ascending("RemoteIndex._vv_lock")
# Leaf lock: executor lazy-create/close handshake (the fan-out
# executor's completion lock) — pool construction only, never an RPC.
# kvlint: lock-order: RemoteIndex._exec_lock ascending
lockorder.declare_ascending("RemoteIndex._exec_lock")


def resolve_fanout_workers_env() -> int:
    """CLUSTER_FANOUT_WORKERS: size of the per-RemoteIndex RPC
    executor that overlaps owner RPCs within a fan-out round (each
    worker reuses its own HttpReplicaTransport connection).  0 forces
    the sequential dispatch path (the bit-identical parity oracle and
    the pre-pipelining behavior).  Default 4."""
    raw = os.environ.get("CLUSTER_FANOUT_WORKERS")
    if raw is None:
        return 4
    try:
        return max(0, int(raw))
    except ValueError:
        return 4


def resolve_fanout_budget_env() -> float:
    """CLUSTER_FANOUT_BUDGET_S: wall-clock budget for one whole
    fan-out including failover retries — a re-routed retry spends the
    remainder, not a fresh transport timeout.  0 disables (each
    attempt gets the transport's own timeout).  Default 5.0, matching
    HttpReplicaTransport's construction-time timeout."""
    raw = os.environ.get("CLUSTER_FANOUT_BUDGET_S")
    if raw is None:
        return 5.0
    try:
        return max(0.0, float(raw))
    except ValueError:
        return 5.0


def resolve_vv_ttl_env() -> float:
    """CLUSTER_VV_TTL_S: how long a replica's piggybacked version
    vector stays valid for score-memo validation.  Bounds the
    staleness window for OUT-OF-BAND mutations (replication followers,
    CLUSTER_LOCAL_INGEST) — router-driven mutations invalidate
    synchronously regardless.  0 keeps every composed vector a
    sentinel, i.e. disables the cluster score memo.  Default 2.0."""
    raw = os.environ.get("CLUSTER_VV_TTL_S")
    if raw is None:
        return 2.0
    try:
        return max(0.0, float(raw))
    except ValueError:
        return 2.0


def resolve_overlap_min_rpc_env() -> float:
    """CLUSTER_OVERLAP_MIN_RPC_S: adaptive-arming threshold for the
    overlapped fan-out and the pipelined chunk drive.  Thread-pool
    handoff costs a few hundred microseconds per dispatch; against an
    in-process or same-host transport whose whole "RPC" is cheaper
    than that, overlapping is a net loss.  The fan-out arms only once
    the observed per-RPC latency EWMA reaches this threshold — real
    network transports cross it on the first call, free local
    transports never do.  0 forces always-armed (tests pin the
    overlapped paths this way).  Default 250e-6."""
    raw = os.environ.get("CLUSTER_OVERLAP_MIN_RPC_S")
    if raw is None:
        return 0.00025
    try:
        return max(0.0, float(raw))
    except ValueError:
        return 0.00025


class _CompletedLookup:
    """Degenerate async-lookup handle: the sequential fallback resolves
    inline, so ``result()`` is just the stored value (keeps the fast
    lane's pipelined drive shape-agnostic)."""

    __slots__ = ("_value",)

    def __init__(self, value) -> None:
        self._value = value

    def result(self, timeout=None):
        return self._value


class RemoteIndex(Index):
    """See module docstring."""

    _OWNER_CACHE_MAX = 65536

    # Stitched cluster.rpc spans nest under the stage whose time they
    # attribute: read fan-out inside the fast lane's "index_lookup",
    # everything else inside the event plane's "kvevents.apply".
    _RPC_TRACE_PARENT = {
        "lookup": "index_lookup",
        "lookup_chain": "index_lookup",
    }

    # Chunk-level async lookups get their own small pool so a task
    # waiting on fan-out futures can never starve the leaf RPCs it
    # depends on (two-level pools make the wait graph acyclic).
    _PIPE_WORKERS = 4

    def __init__(
        self,
        membership: ClusterMembership,
        trace_rpcs: Optional[bool] = None,
        rpc_accounting: bool = True,
        fanout_workers: Optional[int] = None,
        fanout_budget_s: Optional[float] = None,
        vv_ttl_s: Optional[float] = None,
        overlap_min_rpc_s: Optional[float] = None,
    ) -> None:
        self.membership = membership
        # Owner-RPC overlap (None -> CLUSTER_FANOUT_WORKERS, default
        # 4; 0 = sequential parity path).
        self.fanout_workers = (
            resolve_fanout_workers_env()
            if fanout_workers is None
            else max(0, int(fanout_workers))
        )
        # Whole-fan-out deadline budget (None ->
        # CLUSTER_FANOUT_BUDGET_S, default 5.0; 0 disables).
        self.fanout_budget_s = (
            resolve_fanout_budget_env()
            if fanout_budget_s is None
            else max(0.0, float(fanout_budget_s))
        )
        # Version-vector freshness bound (None -> CLUSTER_VV_TTL_S).
        self.vv_ttl_s = (
            resolve_vv_ttl_env()
            if vv_ttl_s is None
            else max(0.0, float(vv_ttl_s))
        )
        # Adaptive-arming threshold (None ->
        # CLUSTER_OVERLAP_MIN_RPC_S, default 250us; 0 = always armed).
        self.overlap_min_rpc_s = (
            resolve_overlap_min_rpc_env()
            if overlap_min_rpc_s is None
            else max(0.0, float(overlap_min_rpc_s))
        )
        # Trace-context forwarding + span stitching on traced calls
        # (None -> CLUSTER_TRACE_PIGGYBACK, default on; untraced calls
        # never pay for it either way).
        self.trace_rpcs = (
            resolve_trace_piggyback_env()
            if trace_rpcs is None
            else trace_rpcs
        )
        # Per-replica tallies + the kvtpu_cluster_rpc_* families; the
        # bench's trace A/B cell flips this off to price the whole
        # observability plane on the untraced path.
        self.rpc_accounting = rpc_accounting
        self._stats_lock = lockorder.tracked(
            threading.Lock(), "RemoteIndex._stats_lock"
        )
        self._rpc_tallies: Dict[str, dict] = {}  # guarded-by: _stats_lock
        self._reroutes = 0  # guarded-by: _stats_lock
        # Outstanding transport calls right now — the timeline's
        # cluster_rpc_in_flight series (obs/timeline.py).  Locked,
        # unlike the shard version counters: those only ever advance
        # (a lost bump merely lags), but a PAIRED inc/dec gauge
        # drifts permanently on one lost store.  Two leaf-lock ops
        # per RPC are noise next to the transport call itself.
        self._in_flight = 0  # guarded-by: _stats_lock
        self._lookup_calls = 0  # guarded-by: _stats_lock
        self._lookup_owner_rpcs = 0  # guarded-by: _stats_lock
        self._lookup_owner_max = 0  # guarded-by: _stats_lock
        self._lookup_rpc_s = 0.0  # guarded-by: _stats_lock
        # Overlap/speculation attribution (/debug/cluster rpc panel):
        # high-water of concurrently outstanding transport calls, and
        # the fast lane's speculative chunk dispatches vs the ones a
        # dead chain dropped on the floor.
        self._overlap_depth = 0  # guarded-by: _stats_lock
        self._speculative_rpcs = 0  # guarded-by: _stats_lock
        self._speculative_wasted = 0  # guarded-by: _stats_lock
        self._budget_exhausted = 0  # guarded-by: _stats_lock
        # Observed per-RPC latency EWMA (0.8/0.2, seeded by the first
        # call) — the adaptive-arming signal.  Only ever compared
        # against overlap_min_rpc_s; never affects results.
        self._rpc_ewma_s = 0.0  # guarded-by: _stats_lock
        # Per-replica piggybacked version vectors:
        # replica -> (vector tuple, monotonic note time).
        self._vv_lock = lockorder.tracked(
            threading.Lock(), "RemoteIndex._vv_lock"
        )
        self._vectors: Dict[str, Tuple[Tuple[int, ...], float]] = (
            {}
        )  # guarded-by: _vv_lock
        self._vv_unknown_seq = 0  # guarded-by: _vv_lock
        # Fan-out executor completion lock: lazy pool creation and the
        # close() handshake only.
        self._exec_lock = lockorder.tracked(
            threading.Lock(), "RemoteIndex._exec_lock"
        )
        self._rpc_pool: Optional[ThreadPoolExecutor] = None
        self._pipe_pool: Optional[ThreadPoolExecutor] = None
        self._closed = False
        # Ring changes invalidate the composed vector by construction
        # (ring.version is part of it); the listener additionally
        # drops departed members' vectors and refreshes the rest.
        self.membership.add_listener(self._on_ring_change)
        # method -> labeled histogram child (labels() does a lock +
        # dict lookup per call; the method set is tiny and fixed).
        self._latency_children: Dict[str, object] = {}
        # key -> (ring, owner), validated by ring IDENTITY on read: a
        # membership change produces a new immutable ring object, so a
        # stale entry can never validate (same single-key-dict-op
        # pattern as InMemoryIndex._group_cache; benign under the GIL).
        self._owner_cache: Dict[int, Tuple[HashRing, str]] = {}

    # -- executors ------------------------------------------------------

    def _rpc_pool_get(self) -> Optional[ThreadPoolExecutor]:
        """The leaf owner-RPC pool, lazily created (None when overlap
        is off or the index is closed)."""
        if self.fanout_workers <= 0 or self._closed:
            return None
        # gil-atomic: single ref read; creation races resolve under _exec_lock
        pool = self._rpc_pool
        if pool is None:
            with self._exec_lock:
                pool = self._rpc_pool
                if pool is None and not self._closed:
                    pool = ThreadPoolExecutor(
                        max_workers=self.fanout_workers,
                        thread_name_prefix="kvtpu-cluster-rpc",
                    )
                    self._rpc_pool = pool
        return pool

    def _overlap_armed(self) -> bool:
        """Whether overlapping/pipelining is worth its handoff cost
        right now: armed once the per-RPC latency EWMA reaches
        ``overlap_min_rpc_s`` (0 = always).  Arming never changes
        results, only which dispatch path computes them."""
        threshold = self.overlap_min_rpc_s
        if threshold <= 0.0:
            return True
        with self._stats_lock:
            return self._rpc_ewma_s >= threshold

    def _pipe_pool_get(self) -> Optional[ThreadPoolExecutor]:
        """The chunk-level pipeline pool (lookup_chain_async tasks);
        armed only when owner overlap is — with workers=0 the whole
        async surface degenerates to the sequential path."""
        if self.fanout_workers <= 0 or self._closed:
            return None
        # gil-atomic: single ref read; creation races resolve under _exec_lock
        pool = self._pipe_pool
        if pool is None:
            with self._exec_lock:
                pool = self._pipe_pool
                if pool is None and not self._closed:
                    pool = ThreadPoolExecutor(
                        max_workers=self._PIPE_WORKERS,
                        thread_name_prefix="kvtpu-cluster-pipe",
                    )
                    self._pipe_pool = pool
        return pool

    def close(self) -> None:
        """Shut both executors down (speculative futures are dropped,
        not awaited); subsequent calls fall back to the sequential
        path, so a racing scorer still completes correctly."""
        with self._exec_lock:
            self._closed = True
            rpc_pool, self._rpc_pool = self._rpc_pool, None
            pipe_pool, self._pipe_pool = self._pipe_pool, None
        for pool in (pipe_pool, rpc_pool):
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)

    # -- version-vector cache -------------------------------------------

    def _note_vector(self, replica_id: str, vector) -> None:
        """Fold one reply's piggybacked vector into the cache.
        Elementwise max: replies complete out of order (the fan-out
        executor), and a late reply must never regress a shard counter
        — counters only ever advance, so max is exact."""
        try:
            vec = tuple(int(v) for v in vector)
        except (TypeError, ValueError):
            return
        now = time.monotonic()
        with self._vv_lock:
            cached = self._vectors.get(replica_id)
            if cached is not None and len(cached[0]) == len(vec):
                vec = tuple(
                    a if a > b else b for a, b in zip(cached[0], vec)
                )
            self._vectors[replica_id] = (vec, now)

    def _on_ring_change(self, ring: HashRing) -> None:
        """Membership listener: departed members' vectors are dropped
        (they may rejoin with rebuilt, i.e. regressed, counters), and
        the survivors are refreshed best-effort off-thread so the memo
        re-validates quickly after a failover."""
        members = set(ring.members)
        with self._vv_lock:
            for replica_id in list(self._vectors):
                if replica_id not in members:
                    del self._vectors[replica_id]
        pool = self._rpc_pool_get()
        if pool is None:
            return
        for replica_id in ring.members:
            try:
                pool.submit(self._refresh_vector, replica_id)
            except RuntimeError:  # pool shut down under us
                return

    def _refresh_vector(self, replica_id: str) -> None:
        """Best-effort explicit vector fetch.  Bypasses ``_call`` on
        purpose: a refresh failure must not mark_dead (and so re-fire
        this listener) — the heartbeat monitor owns liveness here."""
        try:
            transport = self.membership.transport(replica_id)
            call_vv = getattr(transport, "call_vv", None)
            if call_vv is None:
                return
            payload, _, vector = call_vv("version_vector", [])
            vec = vector if vector is not None else payload
            if vec:
                self._note_vector(replica_id, vec)
        except Exception:  # noqa: BLE001 advisory refresh; kvlint: disable=KV005
            # Deliberately silent: the vector stays sentinel (memo
            # misses) and the heartbeat monitor owns liveness.
            pass

    def version_vector(self) -> tuple:
        """The cluster-wide memo validator: ``(ring.version,
        ((replica, vector), ...))`` over the current ring's members.
        A member with no fresh vector (never heard from, or older than
        ``vv_ttl_s``) contributes a unique sentinel that can never
        compare equal — the memo misses instead of trusting stale
        state, and the recompute's replies repopulate the cache."""
        ring = self.membership.ring()
        ttl = self.vv_ttl_s
        now = time.monotonic()
        parts = []
        with self._vv_lock:
            for replica_id in ring.members:
                cached = self._vectors.get(replica_id)
                if (
                    cached is None
                    or ttl <= 0.0
                    or now - cached[1] > ttl
                ):
                    self._vv_unknown_seq += 1
                    parts.append(
                        (replica_id, ("?", self._vv_unknown_seq))
                    )
                else:
                    parts.append((replica_id, cached[0]))
        return (ring.version, tuple(parts))

    def touch_chain(self, request_keys: Sequence[int]) -> None:
        """Recency refresh for a memo hit's keys, fanned to their
        owners off-thread (inline when overlap is off).  Best-effort:
        a lost touch costs at worst one early LRU eviction on one
        replica — never worth blocking the hit path.  The touch
        replies' piggybacked vectors also re-arm memo validation, so a
        hit stream stays coherent without lookups."""
        keys = [int(k) for k in request_keys]
        if not keys:
            return
        ring = self.membership.ring()
        pool = self._rpc_pool_get()
        for owner, owner_keys in self._group_by_owner(
            ring, keys
        ).items():
            if pool is None:
                self._touch_one(owner, owner_keys)
            else:
                try:
                    pool.submit(self._touch_one, owner, owner_keys)
                except RuntimeError:  # pool shut down under us
                    self._touch_one(owner, owner_keys)

    def _touch_one(self, owner: str, keys: List[int]) -> None:
        try:
            self._call(owner, "touch_chain", [keys])
        except Exception:  # noqa: BLE001 advisory touch; kvlint: disable=KV005
            # _call already did the mark_dead/metrics work for
            # transport failures; nothing to propagate to.
            pass

    # -- routing plumbing ----------------------------------------------

    def _owner(self, ring: HashRing, key: int) -> str:
        cached = self._owner_cache.get(key)
        if cached is not None and cached[0] is ring:
            return cached[1]
        owner = ring.owner(key)
        cache = self._owner_cache
        if len(cache) >= self._OWNER_CACHE_MAX:
            cache.clear()
        cache[key] = (ring, owner)
        return owner

    def _max_attempts(self) -> int:
        return len(self.membership.members()) + 1

    def _rpc_latency(self, method: str):
        child = self._latency_children.get(method)
        if child is None:
            child = METRICS.cluster_rpc_latency.labels(method=method)
            # gil-atomic: idempotent memo; racing put re-derives the same value
            self._latency_children[method] = child
        return child

    def _tally(
        self,
        replica_id: str,
        method: str,
        elapsed: float,
        error: Optional[Tuple[str, str]] = None,
    ) -> None:
        """Per-replica fan-out attribution (the /debug/cluster rpc
        panel): call/error counts, latency totals, per-method split,
        and the last transport error's context."""
        with self._stats_lock:
            entry = self._rpc_tallies.get(replica_id)
            if entry is None:
                entry = self._rpc_tallies[replica_id] = {
                    "calls": 0,
                    "errors": 0,
                    "total_s": 0.0,
                    "max_s": 0.0,
                    "methods": {},
                    "last_error": None,
                }
            entry["calls"] += 1
            entry["total_s"] += elapsed
            if elapsed > entry["max_s"]:
                entry["max_s"] = elapsed
            methods = entry["methods"]
            methods[method] = methods.get(method, 0) + 1
            if method in self._RPC_TRACE_PARENT:
                self._lookup_rpc_s += elapsed
            if error is not None:
                entry["errors"] += 1
                entry["last_error"] = {
                    "kind": error[0],
                    "method": method,
                    "detail": error[1][:200],
                    "unix": time.time(),
                }

    def _stitch(
        self, trace, wire_spans: list, anchor: float, replica_id: str
    ) -> None:
        """Re-anchor piggybacked server-side span records inside the
        RPC window (their clocks are replica-relative).  Malformed
        records never fail the call — the piggyback is advisory."""
        try:
            for record in wire_spans:
                name, parent, start_us, dur_us, status, attrs = record
                span = Span(
                    str(name),
                    str(parent) or "cluster.rpc",
                    anchor + float(start_us) / 1e6,
                )
                span.end = span.start + max(0.0, float(dur_us)) / 1e6
                span.status = str(status)
                for pair in attrs:
                    span.attrs[str(pair[0])] = pair[1]
                span.attrs.setdefault("replica", replica_id)
                trace.append_span(span)
        except Exception:  # noqa: BLE001 — advisory, never fails the RPC
            logger.debug(
                "garbled span piggyback from replica %s",
                replica_id,
                exc_info=True,
            )

    def _call_traced(
        self, trace, transport, replica_id: str, method: str,
        args: list, start: float, timeout: Optional[float],
    ):
        """Traced transport call: a cluster.rpc span per owner RPC,
        trace context on the wire, reply spans stitched back in.
        Returns ``(result, piggybacked_vector_or_None)``."""
        with trace.span(
            "cluster.rpc",
            parent=self._RPC_TRACE_PARENT.get(method, "kvevents.apply"),
        ) as rpc:
            rpc.set_attr("replica", replica_id)
            rpc.set_attr("method", method)
            call_vv = getattr(transport, "call_vv", None)
            if call_vv is not None:
                result, spans, vector = call_vv(
                    method,
                    args,
                    traceparent=trace.traceparent(),
                    timeout=timeout,
                )
            else:
                call_ex = getattr(transport, "call_ex", None)
                if call_ex is None:
                    # Foreign transport without the traced surface:
                    # the RPC span still attributes the hop.
                    return transport.call(method, args), None
                result, spans = call_ex(
                    method, args, traceparent=trace.traceparent()
                )
                vector = None
            if spans:
                rpc.set_attr("server_spans", len(spans))
                self._stitch(trace, spans, start, replica_id)
            return result, vector

    def _call(
        self,
        replica_id: str,
        method: str,
        args: list,
        timeout: Optional[float] = None,
    ):
        """One transport call with latency/error accounting; transport
        failures mark the replica dead (the failover trigger) before
        re-raising for the caller's re-route loop.  ``timeout`` is the
        fan-out deadline budget's remainder — forwarded to transports
        that support per-call deadlines, so a retry never restarts the
        full transport timeout.  A piggybacked version vector on the
        reply is folded into the memo-validation cache."""
        transport = self.membership.transport(replica_id)
        if timeout is not None and not getattr(
            transport, "supports_deadline", False
        ):
            timeout = None
        ambient = current_trace()
        trace = ambient if self.trace_rpcs else None
        vector = None
        start = time.perf_counter()
        with self._stats_lock:
            self._in_flight += 1
            if self._in_flight > self._overlap_depth:
                self._overlap_depth = self._in_flight
        try:
            try:
                if trace is None:
                    call_vv = getattr(transport, "call_vv", None)
                    if ambient is not None:
                        # trace_rpcs off with a live trace: shield the
                        # in-process transport so the replica's direct
                        # context-var record cannot leak orphan
                        # replica.* spans under a cluster.rpc parent
                        # that was never opened — the knob disables
                        # the WHOLE plane.
                        with shield_trace():
                            if call_vv is not None:
                                result, _, vector = call_vv(
                                    method, args, timeout=timeout
                                )
                            else:
                                result = transport.call(method, args)
                    elif call_vv is not None:
                        result, _, vector = call_vv(
                            method, args, timeout=timeout
                        )
                    else:
                        result = transport.call(method, args)
                else:
                    result, vector = self._call_traced(
                        trace, transport, replica_id, method, args,
                        start, timeout,
                    )
            except (ReplicaUnavailable, ConnectionError, OSError) as exc:
                elapsed = time.perf_counter() - start
                kind = getattr(exc, "kind", None) or "io"
                METRICS.cluster_rpc_errors.labels(
                    replica=safe_label(replica_id),
                    kind=safe_label(kind),
                ).inc()
                if self.rpc_accounting:
                    self._tally(
                        replica_id, method, elapsed,
                        error=(kind, str(exc)),
                    )
                self.membership.mark_dead(
                    replica_id, f"{method} failed: {exc}"
                )
                raise ReplicaUnavailable(str(exc), kind=kind) from exc
        finally:
            with self._stats_lock:
                # Paired -- with the += above; the overlap-depth read
                # between them is a high-water stat, not a decision.
                self._in_flight -= 1  # kvlint: atomic-ok
        elapsed = time.perf_counter() - start
        with self._stats_lock:
            self._rpc_ewma_s = (
                elapsed
                if self._rpc_ewma_s == 0.0
                else 0.8 * self._rpc_ewma_s + 0.2 * elapsed
            )
        self._rpc_latency(method).observe(elapsed)
        if self.rpc_accounting:
            self._tally(replica_id, method, elapsed)
        if vector is not None:
            self._note_vector(replica_id, vector)
        return result

    def in_flight(self) -> int:
        """Transport calls currently outstanding (gauge; see
        obs/timeline.py's cluster_rpc_in_flight series)."""
        with self._stats_lock:
            return self._in_flight

    def _deadline(self) -> Optional[float]:
        budget = self.fanout_budget_s
        if budget <= 0.0:
            return None
        return time.monotonic() + budget

    def _remaining(
        self, deadline: Optional[float], last_exc
    ) -> Optional[float]:
        """Budget remainder for the next attempt.  The FIRST attempt
        always runs (remainder floored, never refused); an exhausted
        budget after a failure re-raises instead of retrying — p99
        under a dead replica is bounded by ~one timeout, not one per
        re-route."""
        if deadline is None:
            return None
        remaining = deadline - time.monotonic()
        if remaining <= 0.0 and last_exc is not None:
            with self._stats_lock:
                self._budget_exhausted += 1
            raise last_exc
        return max(remaining, 0.05)

    def _call_routed(self, key: int, method: str, args: list):
        """Single-key op with failover re-route under one deadline
        budget."""
        last_exc: Optional[Exception] = None
        deadline = self._deadline()
        for _ in range(self._max_attempts()):
            timeout = self._remaining(deadline, last_exc)
            ring = self.membership.ring()
            owner = self._owner(ring, key)
            try:
                return self._call(owner, method, args, timeout=timeout)
            except ReplicaUnavailable as exc:
                last_exc = exc
                if self.membership.ring() is ring:
                    # mark_dead refused (last replica alive): re-routing
                    # would loop on the same owner forever.
                    break
                with self._stats_lock:
                    self._reroutes += 1
        assert last_exc is not None
        raise last_exc

    def _group_by_owner(
        self, ring: HashRing, keys: Sequence[int]
    ) -> Dict[str, List[int]]:
        groups: Dict[str, List[int]] = {}
        for key in keys:
            groups.setdefault(self._owner(ring, key), []).append(key)
        return groups

    def _fanout(self, pending: list, plan, on_result=None) -> None:
        """THE failover fan-out loop, shared by every grouped op.

        ``plan(ring, pending)`` returns ``[(owner, method, args,
        items)]`` — one RPC per owner, ``items`` being the subset of
        ``pending`` that re-enters the retry set if that owner's
        transport fails (the failed owner was marked dead by
        ``_call``, so the re-plan runs on the NEW ring and routes to
        the failover owner).  The loop stops when everything landed,
        when the ring identity did not change after a failure (the
        last-replica refusal — re-planning would loop on the same
        owner forever), when the deadline budget ran dry after a
        failure, or when attempts exhaust; undeliverable items
        re-raise the last transport error.  An item that rode more
        than one failed owner's call retries once (value-dedup for
        hashable items, identity for the rest).

        With the RPC executor armed, a round's owner RPCs dispatch
        concurrently; results are consumed (and ``on_result`` runs, on
        this thread) in PLAN ORDER, so merges are bit-identical to the
        sequential path and the failover/refusal invariants above are
        unchanged — overlap happens strictly within one round.
        """
        last_exc: Optional[Exception] = None
        deadline = self._deadline()
        for _ in range(self._max_attempts()):
            if not pending:
                return
            timeout = self._remaining(deadline, last_exc)
            ring = self.membership.ring()
            failed: list = []
            plans = plan(ring, pending)
            pool = (
                self._rpc_pool_get()
                if len(plans) > 1 and self._overlap_armed()
                else None
            )
            if pool is None:
                for owner, method, args, items in plans:
                    try:
                        result = self._call(
                            owner, method, args, timeout=timeout
                        )
                    except ReplicaUnavailable as exc:
                        last_exc = exc
                        failed.extend(items)
                        continue
                    if on_result is not None:
                        on_result(result)
            else:
                dispatched = []
                for owner, method, args, items in plans:
                    # Fresh context copy per task: the ambient trace
                    # rides into the worker (Trace appends are
                    # locked), and one Context can't be entered twice
                    # concurrently.
                    ctx = contextvars.copy_context()
                    try:
                        future = pool.submit(
                            ctx.run,
                            self._call,
                            owner,
                            method,
                            args,
                            timeout,
                        )
                    except RuntimeError:  # pool shut down under us
                        future = None
                    dispatched.append((owner, method, args, items, future))
                for owner, method, args, items, future in dispatched:
                    try:
                        if future is None:
                            result = self._call(
                                owner, method, args, timeout=timeout
                            )
                        else:
                            result = future.result()
                    except ReplicaUnavailable as exc:
                        last_exc = exc
                        failed.extend(items)
                        continue
                    if on_result is not None:
                        on_result(result)
            if not failed:
                return
            if self.membership.ring() is ring:
                break
            with self._stats_lock:
                self._reroutes += len(failed)
            seen = set()
            pending = []
            for item in failed:
                marker = (
                    item if isinstance(item, (int, tuple)) else id(item)
                )
                if marker in seen:
                    continue
                seen.add(marker)
                pending.append(item)
        if last_exc is not None:
            raise last_exc

    # -- read path ------------------------------------------------------

    def lookup(
        self,
        request_keys: Sequence[int],
        pod_identifier_set: Optional[Set[str]] = None,
    ) -> Dict[int, List[PodEntry]]:
        if not request_keys:
            raise ValueError("no request keys provided for lookup")
        pods_arg = sorted(pod_identifier_set) if pod_identifier_set else None
        result: Dict[int, List[PodEntry]] = {}
        rounds: List[int] = []

        def plan(ring, pending):
            plans = [
                (owner, "lookup", [keys, pods_arg], keys)
                for owner, keys in self._group_by_owner(
                    ring, pending
                ).items()
            ]
            rounds.append(len(plans))
            return plans

        def on_result(pairs):
            for key, raw_entries in pairs:
                result[key] = list(decode_entries(raw_entries))

        self._fanout(list(request_keys), plan, on_result)
        if self.rpc_accounting:
            # Sequential critical path: the fan-out loop issues one RPC
            # per owner per round, back to back — first-round width is
            # the per-chunk serial depth item 3's pipelining attacks.
            with self._stats_lock:
                self._lookup_calls += 1
                self._lookup_owner_rpcs += sum(rounds)
                if rounds and rounds[0] > self._lookup_owner_max:
                    self._lookup_owner_max = rounds[0]
        return result

    def rpc_stats(self) -> dict:
        """The /debug/cluster per-replica rpc panel: fan-out
        attribution tallies plus the sequential-owner critical-path
        breakdown (the read-path pipelining baseline)."""
        with self._stats_lock:
            replicas: Dict[str, dict] = {}
            for replica_id, entry in sorted(self._rpc_tallies.items()):
                calls = entry["calls"]
                view = {
                    "calls": calls,
                    "errors": entry["errors"],
                    "total_ms": round(entry["total_s"] * 1e3, 3),
                    "avg_ms": (
                        round(entry["total_s"] / calls * 1e3, 3)
                        if calls
                        else 0.0
                    ),
                    "max_ms": round(entry["max_s"] * 1e3, 3),
                    "methods": dict(entry["methods"]),
                }
                if entry["last_error"] is not None:
                    view["last_error"] = dict(entry["last_error"])
                replicas[replica_id] = view
            lookups = self._lookup_calls
            return {
                "replicas": replicas,
                "in_flight": self._in_flight,
                "reroutes": self._reroutes,
                "critical_path": {
                    "lookup_calls": lookups,
                    "owner_rpcs": self._lookup_owner_rpcs,
                    "avg_owners_per_lookup": (
                        round(self._lookup_owner_rpcs / lookups, 3)
                        if lookups
                        else 0.0
                    ),
                    "max_owners_per_lookup": self._lookup_owner_max,
                    "sequential_rpc_s": round(self._lookup_rpc_s, 6),
                    "overlap_depth": self._overlap_depth,
                    "speculative_rpcs": self._speculative_rpcs,
                    "speculative_wasted": self._speculative_wasted,
                },
                "fanout": {
                    "workers": self.fanout_workers,
                    "budget_s": self.fanout_budget_s,
                    "budget_exhausted": self._budget_exhausted,
                    "rpc_ewma_us": round(self._rpc_ewma_s * 1e6, 3),
                    "overlap_min_rpc_us": round(
                        self.overlap_min_rpc_s * 1e6, 3
                    ),
                    "armed": (
                        self.overlap_min_rpc_s <= 0.0
                        or self._rpc_ewma_s >= self.overlap_min_rpc_s
                    ),
                },
            }

    def lookup_chain(
        self, request_keys: Sequence[int]
    ) -> List[Sequence[PodEntry]]:
        """Aligned per-key pod snapshots (the fast-lane shape): group
        the chunk's keys per owner, ONE ``lookup`` RPC per owner, then
        truncate at the first key with no resident pods.  A replica's
        own present-but-empty early stop reads as "no pods" for its
        later keys, which can only move the truncation point EARLIER
        than or equal to the true break — never report residency past
        a dead chain (scores stay parity-exact; property-pinned)."""
        if not request_keys:
            return []
        found = self.lookup(request_keys, None)
        out: List[Sequence[PodEntry]] = []
        for key in request_keys:
            pods = found.get(key)
            if not pods:
                break
            out.append(pods)
        return out

    def lookup_chain_async(self, request_keys: Sequence[int]):
        """Dispatch one chunk's ``lookup_chain`` without blocking: the
        fast lane's pipelined drive keeps chunk N+1 (and speculated
        deeper chunks) in flight while it consumes chunk N.  Returns a
        handle whose ``result()`` yields exactly what ``lookup_chain``
        would (same fan-out, failover, and accounting — the task runs
        on the chunk-level pipe pool, its owner RPCs on the leaf RPC
        pool, so waiting tasks can never starve the RPCs they need).
        With overlap off — or not yet armed (the per-RPC latency EWMA
        below ``overlap_min_rpc_s``) — the chunk resolves inline
        (sequential parity).
        """
        keys = list(request_keys)
        pool = (
            self._pipe_pool_get() if self._overlap_armed() else None
        )
        if pool is None or not keys:
            return _CompletedLookup(self.lookup_chain(keys))
        ctx = contextvars.copy_context()
        try:
            return pool.submit(ctx.run, self.lookup_chain, keys)
        except RuntimeError:  # pool shut down under us
            return _CompletedLookup(self.lookup_chain(keys))

    def record_speculation(self, dispatched: int, wasted: int) -> None:
        """Fast-lane speculation attribution: chunks dispatched before
        their predecessor resolved, and the subset a dead chain then
        dropped unconsumed (the /debug/cluster rpc panel's
        ``speculative_rpcs`` / ``speculative_wasted``)."""
        with self._stats_lock:
            self._speculative_rpcs += int(dispatched)
            self._speculative_wasted += int(wasted)

    # -- write path -----------------------------------------------------

    def add(
        self,
        engine_keys: Sequence[int],
        request_keys: Sequence[int],
        entries: Sequence[PodEntry],
    ) -> None:
        if not engine_keys or not request_keys or not entries:
            raise ValueError("no keys or entries provided for add")
        if len(engine_keys) != len(request_keys):
            raise ValueError("engine/request key length mismatch")
        wire_entries = encode_entries(entries)

        def plan(ring, pending):
            # Aligned pairs grouped by request-key owner.
            groups: Dict[str, List[Tuple[int, int]]] = {}
            for pair in pending:
                groups.setdefault(
                    self._owner(ring, pair[1]), []
                ).append(pair)
            return [
                (
                    owner,
                    "add",
                    [
                        [ek for ek, _ in pairs],
                        [rk for _, rk in pairs],
                        wire_entries,
                    ],
                    pairs,
                )
                for owner, pairs in groups.items()
            ]

        self._fanout(list(zip(engine_keys, request_keys)), plan)
        # Mappings published for EVERY pair, not just cross-owner ones:
        # besides serving get_request_key at the engine-key owner, the
        # add_mappings RPC journals a mappings-only record whose
        # standby filter keys on EITHER side — a same-owner pair's
        # engine-key standby can differ from its request-key standby,
        # and without the record that standby would miss the mapping
        # and classify post-failover evictions as "already gone".
        # Idempotent where it duplicates the full add's mapping.
        self.add_mappings(engine_keys, request_keys)

    def add_mappings(
        self, engine_keys: Sequence[int], request_keys: Sequence[int]
    ) -> None:
        """Publish engine->request mappings at BOTH owners: the
        engine-key owner serves ``get_request_key``; the request-key
        owner's local backend resolves the mapping during ``evict``.
        A pair that failed on one of its two owners re-routes
        wholesale (idempotent on the surviving owner)."""

        def plan(ring, pending):
            groups: Dict[str, List[Tuple[int, int]]] = {}
            for pair in pending:
                for owner in {
                    self._owner(ring, pair[0]),
                    self._owner(ring, pair[1]),
                }:
                    groups.setdefault(owner, []).append(pair)
            return [
                (
                    owner,
                    "add_mappings",
                    [
                        [ek for ek, _ in pairs],
                        [rk for _, rk in pairs],
                    ],
                    pairs,
                )
                for owner, pairs in groups.items()
            ]

        self._fanout(list(zip(engine_keys, request_keys)), plan)

    def add_entries_batch(
        self,
        items: Sequence[Tuple[Sequence[int], Sequence[PodEntry]]],
    ) -> None:
        """The kvevents batched-apply surface: request keys group per
        owner across the whole batch — one RPC per owner per flush.
        An item whose keys straddled a failed owner retries whole on
        the re-planned ring; its slices that landed re-apply
        idempotently."""
        pending = [
            [list(request_keys), encode_entries(entries)]
            for request_keys, entries in items
            if request_keys
        ]

        def plan(ring, pending):
            # owner -> ([per-owner wire items], [source items]).
            groups: Dict[str, Tuple[List[list], List[list]]] = {}
            for item in pending:
                request_keys, wire_entries = item
                by_owner: Dict[str, List[int]] = {}
                for rk in request_keys:
                    by_owner.setdefault(
                        self._owner(ring, rk), []
                    ).append(rk)
                for owner, rks in by_owner.items():
                    bucket = groups.setdefault(owner, ([], []))
                    bucket[0].append([rks, wire_entries])
                    bucket[1].append(item)
            return [
                (owner, "add_entries_batch", [owner_items], sources)
                for owner, (owner_items, sources) in groups.items()
            ]

        self._fanout(pending, plan)

    def evict(self, engine_key: int, entries: Sequence[PodEntry]) -> None:
        """Two hops: resolve the request key at the engine-key owner,
        evict at the request-key owner.  When the eviction empties the
        key (the owner pruned its mapping), the mapping stub at the
        engine-key owner is evicted too, so ``get_request_key`` raises
        exactly like a local backend's would."""
        if not entries:
            raise ValueError("no entries provided for eviction")
        try:
            request_key = self.get_request_key(engine_key)
        except KeyError:
            return  # mapping already gone — same no-op as local backends
        wire_entries = encode_entries(entries)
        pruned = self._call_routed(
            request_key, "evict", [engine_key, wire_entries]
        )
        if pruned:
            ring = self.membership.ring()
            ek_owner = self._owner(ring, engine_key)
            if ek_owner != self._owner(ring, request_key):
                try:
                    self._call(
                        ek_owner, "evict", [engine_key, wire_entries]
                    )
                except ReplicaUnavailable:
                    # Stub cleanup is best-effort: the dead replica's
                    # stale mapping lingers exactly like a local LRU
                    # leftover would.
                    pass

    def get_request_key(self, engine_key: int) -> int:
        found, value = self._call_routed(
            engine_key, "get_request_key", [engine_key]
        )
        if not found:
            raise KeyError(f"engine key not found: {engine_key:#x}")
        return value

    # -- persistence / admin --------------------------------------------

    def dump_entries(
        self,
    ) -> Tuple[List[Tuple[int, List[PodEntry]]], List[Tuple[int, int]]]:
        """Concatenated dumps of every ALIVE replica.  Standby slices
        (replication followers warm peers' keys) may duplicate request
        keys across replicas; restore absorbs duplicates idempotently.
        An unreachable replica is skipped (and marked dead) — the dump
        is a best-effort snapshot, the journal covers the gap."""
        block_entries: List[Tuple[int, List[PodEntry]]] = []
        engine_map: List[Tuple[int, int]] = []
        for replica_id in self.membership.alive():
            try:
                raw_blocks, raw_map = self._call(
                    replica_id, "dump_entries", []
                )
            except ReplicaUnavailable:
                continue
            for key, raw_entries in raw_blocks:
                block_entries.append(
                    (key, list(decode_entries(raw_entries)))
                )
            engine_map.extend((ek, rk) for ek, rk in raw_map)
        return block_entries, engine_map

    def restore_entries(
        self,
        block_entries: Sequence[Tuple[int, Sequence[PodEntry]]],
        engine_map: Sequence[Tuple[int, int]],
    ) -> int:
        ring = self.membership.ring()
        blocks_by_owner: Dict[str, List[list]] = {}
        for request_key, entries in block_entries:
            blocks_by_owner.setdefault(
                self._owner(ring, request_key), []
            ).append([request_key, encode_entries(entries)])
        maps_by_owner: Dict[str, List[list]] = {}
        for ek, rk in engine_map:
            for owner in {self._owner(ring, ek), self._owner(ring, rk)}:
                maps_by_owner.setdefault(owner, []).append([ek, rk])
        restored = 0
        for owner in sorted(set(blocks_by_owner) | set(maps_by_owner)):
            try:
                restored += self._call(
                    owner,
                    "restore_entries",
                    [
                        blocks_by_owner.get(owner, []),
                        maps_by_owner.get(owner, []),
                    ],
                )
            except ReplicaUnavailable:
                logger.warning(
                    "restore skipped unreachable replica %s", owner
                )
        return restored

    def purge_pod(self, pod_identifier: str) -> int:
        removed = 0
        for replica_id in self.membership.alive():
            try:
                removed += self._call(
                    replica_id, "purge_pod", [pod_identifier]
                )
            except ReplicaUnavailable:
                continue  # dead replica holds no servable entries now
        return removed
