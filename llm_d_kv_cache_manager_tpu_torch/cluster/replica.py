"""Replica-side apply surface + the router->replica transports.

A :class:`ClusterReplica` wraps one local ``Index`` backend behind a
method table — the single dispatch surface shared by every transport:
the in-process :class:`LocalReplicaTransport` (tests, bench, the
cluster smoke) and the HTTP endpoint (``POST /replica`` in
``api/http_service.py``) both land in :meth:`ClusterReplica.handle`.

Wire format (canonical CBOR, the house serialization — lists only, no
maps): request ``[method, args]`` or ``[method, args, traceparent]``,
response ``[status, payload]``, ``[status, payload, spans]``, or
``[status, payload, spans, vector]`` with status 0=ok /
1=application error (payload is the message).  Transport failures
raise :class:`ReplicaUnavailable`; application errors raise
:class:`ReplicaError` — the router treats only the former as a
failover trigger.

Version piggyback (docs/replication.md "Pipelined read path"): every
successful reply may carry the replica backend's per-shard version
snapshot as a fourth element (the lists-only codec has no None, so a
reply with a vector but no spans carries ``[]`` in the spans slot).
The router folds the vectors into its cluster-wide
``version_vector()`` so the exact-prompt score memo can validate
against the whole cluster without extra RPCs.
``CLUSTER_VERSION_PIGGYBACK=0`` keeps replies at three elements for
rolling upgrades past routers whose decoder predates the fourth slot.

Trace piggyback (docs/observability.md "Fleet tracing"): a request
whose third element is a sampled W3C ``traceparent`` makes the replica
record server-side spans (wire decode + the method's lookup/apply
split) and return their summaries as the response's third element —
``[name, parent, start_us, dur_us, status, [[attr, value], ...]]``
records relative to the replica's receive time.  The router
(``remote_index.py``) stitches them under its own ``cluster.rpc`` span
so ONE trace covers the whole fan-out with no collector process.
Two-element frames remain valid in both directions (mixed-version
fleets, untraced requests pay zero bytes); ``CLUSTER_TRACE_PIGGYBACK=0``
disables the server-side harvest outright.

Journal tap (replication feed): every mutating call is appended to the
replica's own journal AFTER the local apply succeeds — the same
applied-ops discipline as the kvevents pool's persistence tap, so a
follower replays records as exact index calls.  Batched admissions
arrive without engine keys (the router publishes mappings eagerly via
``add_mappings``, which is journaled as a mappings-only record), so
the record stream splits one logical add into a mappings record plus
an entries record; replay is idempotent and order-preserved within one
router worker (RPCs from one worker are synchronous).

Copied from the JAX reference's ``cluster/replica.py``.  The port has no
HTTP service yet (``api/``, ROADMAP.md Queue A): ``HttpReplicaTransport``
is the client half, and a server of ``POST /replica`` only has to hand the
body to :meth:`ClusterReplica.handle_wire` and return its bytes.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.cbor_canonical import (
    CborDecodeError,
    decode_canonical,
    encode_canonical,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.in_memory import (
    InMemoryIndex,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import Index, PodEntry
from llm_d_kv_cache_manager_tpu_torch.obs.trace import (
    TRACER,
    Trace,
    _new_span_id,
    parse_traceparent,
    shield_trace,
    span as obs_span,
    use_trace,
)
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("cluster.replica")


def resolve_trace_piggyback_env() -> bool:
    """CLUSTER_TRACE_PIGGYBACK: "0"/"false"/"off" disables carrying
    span summaries on replica replies; unset/anything else keeps the
    piggyback on (docs/observability.md)."""
    raw = os.environ.get("CLUSTER_TRACE_PIGGYBACK")
    if raw is None:
        return True
    return raw.strip().lower() not in ("0", "false", "off", "no")


def resolve_version_piggyback_env() -> bool:
    """CLUSTER_VERSION_PIGGYBACK: "0"/"false"/"off" keeps replies at
    three elements (mixed-version fleets whose routers predate the
    vector slot); unset/anything else piggybacks the backend's version
    snapshot on every successful reply (docs/replication.md)."""
    raw = os.environ.get("CLUSTER_VERSION_PIGGYBACK")
    if raw is None:
        return True
    return raw.strip().lower() not in ("0", "false", "off", "no")


class ReplicaError(RuntimeError):
    """The replica executed the call and reports an application error."""


class ReplicaUnavailable(ConnectionError):
    """The replica could not be reached (transport-level failure).

    ``kind`` classifies the failure for the
    ``kvtpu_cluster_rpc_errors_total{replica,kind}`` attribution:
    ``timeout`` / ``refused`` / ``wire_decode`` / ``http_status`` /
    ``killed`` / ``io``.
    """

    def __init__(self, message: str, kind: str = "io") -> None:
        super().__init__(message)
        self.kind = kind


# -- wire helpers -------------------------------------------------------


def encode_entries(entries: Sequence[PodEntry]) -> List[List[str]]:
    return [[e.pod_identifier, e.device_tier] for e in entries]


def decode_entries(raw) -> Tuple[PodEntry, ...]:
    return tuple(PodEntry(str(p), str(t)) for p, t in raw)


def encode_request(
    method: str, args: list, traceparent: Optional[str] = None
) -> bytes:
    """Two elements untraced, three with a trace context — untraced
    requests pay zero extra wire bytes."""
    if traceparent is None:
        return encode_canonical([method, args])
    return encode_canonical([method, args, traceparent])


def decode_request(data: bytes) -> Tuple[str, list, Optional[str]]:
    doc = decode_canonical(data)
    if not isinstance(doc, list) or len(doc) not in (2, 3):
        raise CborDecodeError("unexpected replica request shape")
    method, args = doc[0], doc[1]
    traceparent = doc[2] if len(doc) == 3 else None
    if not isinstance(method, str) or not isinstance(args, list):
        raise CborDecodeError("unexpected replica request shape")
    if traceparent is not None and not isinstance(traceparent, str):
        raise CborDecodeError("unexpected replica request shape")
    return method, args, traceparent


def encode_response(
    status: int,
    payload,
    spans: Optional[list] = None,
    vector: Optional[list] = None,
) -> bytes:
    """Shortest frame that carries what is present: the lists-only
    codec has no None, so a vector with no spans rides behind an empty
    spans placeholder (decoders map ``[]`` back to "no spans")."""
    if vector is not None:
        return encode_canonical([status, payload, spans or [], vector])
    if spans is None:
        return encode_canonical([status, payload])
    return encode_canonical([status, payload, spans])


def _decode_response_frame(
    data: bytes,
) -> Tuple[object, Optional[list], Optional[list]]:
    doc = decode_canonical(data)
    if not isinstance(doc, list) or len(doc) not in (2, 3, 4):
        raise CborDecodeError("unexpected replica response shape")
    status, payload = doc[0], doc[1]
    spans = doc[2] if len(doc) >= 3 else None
    vector = doc[3] if len(doc) == 4 else None
    if spans is not None and not isinstance(spans, list):
        raise CborDecodeError("unexpected replica response shape")
    if vector is not None and not isinstance(vector, list):
        raise CborDecodeError("unexpected replica response shape")
    if status:
        raise ReplicaError(str(payload))
    # [] in the spans slot is the "vector but no spans" placeholder.
    if spans is not None and not spans and vector is not None:
        spans = None
    return payload, spans, vector


def decode_response_vv(
    data: bytes,
) -> Tuple[object, Optional[list], Optional[list]]:
    """(payload, piggybacked spans or None, piggybacked version vector
    or None); raises :class:`ReplicaError` on a status-1 frame."""
    return _decode_response_frame(data)


def decode_response_ex(data: bytes) -> Tuple[object, Optional[list]]:
    """(payload, piggybacked span records or None); raises
    :class:`ReplicaError` on a status-1 frame.  Tolerates (and drops)
    the four-element vector frame so pre-vector callers keep working
    against new replicas."""
    payload, spans, _ = _decode_response_frame(data)
    return payload, spans


def decode_response(data: bytes):
    """Payload-only view (the pre-piggyback contract, kept for every
    caller that does not stitch spans)."""
    payload, _ = decode_response_ex(data)
    return payload


def _wire_attr(value):
    """Span attribute values on the canonical-CBOR wire: ints and
    strings pass, everything else is stringified (lists-only codec —
    no floats, no maps)."""
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, (int, str)):
        return value
    return str(value)


def encode_harvest_spans(harvest: Trace) -> list:
    """Serialize a server-side span harvest for the reply piggyback:
    ``[name, parent, start_us, dur_us, status, [[attr, value], ...]]``
    with times relative to the harvest's start (the replica's receive
    point) — the router re-anchors them inside its RPC span."""
    out: list = []
    for view in harvest.to_dict(include_spans=True)["spans"]:
        out.append(
            [
                view["name"],
                view["parent"] or "",
                int(view["start_ms"] * 1000),
                int(view["duration_ms"] * 1000),
                view["status"],
                [
                    [str(key), _wire_attr(value)]
                    for key, value in view["attributes"].items()
                ],
            ]
        )
    return out


class ClusterReplica:
    """One replica: a local index slice + the RPC method table.

    ``journal`` (a ``persistence.Journal``) enables replication: every
    applied mutation is appended post-apply, and ``sync_snapshot``
    serves the follower-bootstrap boundary (rotate + watermarks + dump)
    — the exact shape ``PersistenceManager.snapshot`` uses, without the
    file layer.
    """

    # Server-side span vocabulary (docs/observability.md): the method
    # table split into the lookup/apply/admin stages a stitched trace
    # shows, all children of the router's "cluster.rpc" span.
    _READ_METHODS = frozenset({"lookup", "lookup_chain"})
    _ADMIN_METHODS = frozenset(
        {
            "ping",
            "get_request_key",
            "dump_entries",
            "sync_snapshot",
            "version_vector",
            "touch_chain",
        }
    )

    def __init__(
        self,
        replica_id: str,
        index: Optional[Index] = None,
        journal=None,
        journal_retain_segments: int = 64,
        trace_piggyback: Optional[bool] = None,
        version_piggyback: Optional[bool] = None,
    ) -> None:
        if not replica_id:
            raise ValueError("replica_id required")
        self.replica_id = replica_id
        self.index = index if index is not None else InMemoryIndex()
        self.journal = journal
        # Piggyback server-side spans on traced requests' replies
        # (None -> CLUSTER_TRACE_PIGGYBACK, default on).
        self.trace_piggyback = (
            resolve_trace_piggyback_env()
            if trace_piggyback is None
            else trace_piggyback
        )
        # Piggyback the backend's per-shard version snapshot on every
        # successful reply (None -> CLUSTER_VERSION_PIGGYBACK, default
        # on).  Off keeps the three-element reply frame for rolling
        # upgrades past pre-vector routers.
        self.version_piggyback = (
            resolve_version_piggyback_env()
            if version_piggyback is None
            else version_piggyback
        )
        # Replication journals have no snapshot boundary to compact
        # against, so they get size-based retention: the newest N
        # segments survive (~N x segment_max_bytes on disk), checked
        # every few hundred appends.  0 disables.  A follower lagging
        # past the window re-bootstraps (docs/replication.md).
        self.journal_retain_segments = journal_retain_segments
        self._journal_appends = 0  # racy-benign tick counter
        self._methods: Dict[str, Callable] = {
            "ping": self._ping,
            "lookup": self._lookup,
            "lookup_chain": self._lookup_chain,
            "add": self._add,
            "add_mappings": self._add_mappings,
            "add_entries_batch": self._add_entries_batch,
            "evict": self._evict,
            "get_request_key": self._get_request_key,
            "dump_entries": self._dump_entries,
            "restore_entries": self._restore_entries,
            "purge_pod": self._purge_pod,
            "sync_snapshot": self._sync_snapshot,
            "version_vector": self._version_vector,
            "touch_chain": self._touch_chain,
        }

    def vector_snapshot(self) -> Optional[List[int]]:
        """The backend's per-shard version snapshot as wire-ready ints,
        or None when the backend has no ``version_vector`` surface (the
        reply then stays vector-free and the router's memo treats this
        replica as unknown)."""
        version_vector = getattr(self.index, "version_vector", None)
        if not callable(version_vector):
            return None
        try:
            return [int(v) for v in version_vector()]
        except Exception:  # noqa: BLE001 piggyback is advisory; kvlint: disable=KV005
            # A backend whose snapshot raises just ships a vector-free
            # reply; the router's memo treats the replica as unknown.
            return None

    def close(self) -> None:
        if self.journal is not None:
            self.journal.close()

    def _journal_tick(self) -> None:
        """Periodic retention pass after an append (see __init__)."""
        if self.journal is None or self.journal_retain_segments <= 0:
            return
        self._journal_appends += 1
        if self._journal_appends % 256 == 0:
            self.journal.compact_keep_last(self.journal_retain_segments)

    # -- dispatch -------------------------------------------------------

    def _stage_for(self, method: str) -> str:
        if method in self._READ_METHODS:
            return "replica.lookup"
        if method in self._ADMIN_METHODS:
            return "replica.admin"
        return "replica.apply"

    def handle(self, method: str, args: list):
        """Execute one RPC; raises ``ReplicaError`` for unknown methods
        (application-level: the replica IS reachable).

        The dispatch records a server-side span on whatever trace is
        active in the context — the wire path's harvest trace, or (for
        the in-process transport) the router's own trace directly; a
        free no-op when nothing is traced, and ``trace_piggyback``
        disables server-side spans on EVERY path (the in-process
        direct record included, so the knob means the same thing over
        both transports)."""
        handler = self._methods.get(method)
        if handler is None:
            raise ReplicaError(f"unknown replica method: {method!r}")
        if not self.trace_piggyback:
            return handler(args)
        with obs_span(self._stage_for(method), parent="cluster.rpc") as s:
            s.set_attr("replica", self.replica_id)
            s.set_attr("method", method)
            return handler(args)

    def handle_wire(self, data: bytes) -> bytes:
        """Decode request bytes, execute, encode response bytes — the
        HTTP endpoint's whole body.  Application errors (including
        malformed requests) become status-1 responses, never transport
        failures.  A sampled traceparent in the request frame turns on
        the span harvest: server-side spans ride back on the reply."""
        received = time.perf_counter()
        try:
            method, args, traceparent = decode_request(data)
        except Exception as exc:  # noqa: BLE001 — becomes a wire error
            return encode_response(1, repr(exc))
        harvest: Optional[Trace] = None
        if traceparent is not None and self.trace_piggyback:
            parent = parse_traceparent(traceparent)
            if parent is not None and parent.sampled:
                # Never finished/recorded locally: the spans exist only
                # to ride the reply; the ROUTER's stitched trace is the
                # single record (no collector, no double counting).
                harvest = Trace(
                    f"replica.{self.replica_id}",
                    parent.trace_id,
                    _new_span_id(),
                    TRACER.recorder,
                    parent_span_id=parent.span_id,
                )
                harvest.add_completed(
                    "replica.decode", received, parent="cluster.rpc"
                )
        try:
            # shield_trace makes the in-process strict-wire transport
            # behave exactly like the HTTP one: server spans travel
            # only via the piggyback, never by context-var leakage.
            with shield_trace():
                if harvest is not None:
                    with use_trace(harvest):
                        payload = self.handle(method, args)
                else:
                    payload = self.handle(method, args)
        except Exception as exc:  # noqa: BLE001 — becomes a wire error
            if not isinstance(exc, ReplicaError):
                logger.exception(
                    "replica %s RPC failed", self.replica_id
                )
            return encode_response(1, repr(exc))
        spans = None
        if harvest is not None:
            try:
                spans = encode_harvest_spans(harvest)
            except Exception:  # noqa: BLE001 — piggyback is advisory
                logger.exception(
                    "replica %s span piggyback failed", self.replica_id
                )
        vector = (
            self.vector_snapshot() if self.version_piggyback else None
        )
        return encode_response(0, payload, spans, vector)

    # -- methods --------------------------------------------------------

    def _ping(self, args):
        return self.replica_id

    def _lookup(self, args):
        keys, pods = args
        pod_set = set(str(p) for p in pods) if pods else None
        found = self.index.lookup([int(k) for k in keys], pod_set)
        return [
            [key, encode_entries(entries)]
            for key, entries in found.items()
        ]

    def _lookup_chain(self, args):
        (keys,) = args
        chain = self.index.lookup_chain([int(k) for k in keys])
        return [encode_entries(entries) for entries in chain]

    def _add(self, args):
        engine_keys, request_keys, raw_entries = args
        entries = decode_entries(raw_entries)
        self.index.add(engine_keys, request_keys, entries)
        if self.journal is not None and entries:
            self.journal.record_add(
                entries[0].pod_identifier,
                0,
                engine_keys,
                request_keys,
                entries,
            )
            self._journal_tick()
        return None

    def _add_mappings(self, args):
        engine_keys, request_keys = args
        add_mappings = getattr(self.index, "add_mappings", None)
        if callable(add_mappings):
            add_mappings(engine_keys, request_keys)
        else:
            raise ReplicaError(
                "backend lacks add_mappings: "
                f"{type(self.index).__name__}"
            )
        if self.journal is not None:
            # Mappings-only record (empty entries): replayed via
            # add_mappings, never as an admission.
            self.journal.record_add(
                "", 0, engine_keys, request_keys, []
            )
            self._journal_tick()
        return None

    def _add_entries_batch(self, args):
        (items,) = args
        decoded = [
            (request_keys, decode_entries(raw_entries))
            for request_keys, raw_entries in items
        ]
        add_batch = getattr(self.index, "add_entries_batch", None)
        if callable(add_batch):
            add_batch(decoded)
        else:
            # Contract fallback (backends without the batched surface):
            # per-key add with an identity engine mapping.  Evictions
            # for these keys arrive under the real engine key and miss
            # (stale entries heal by churn); backends meant for replica
            # duty implement add_entries_batch.
            for request_keys, entries in decoded:
                self.index.add(request_keys, request_keys, entries)
        if self.journal is not None:
            for request_keys, entries in decoded:
                if entries:
                    self.journal.record_add(
                        entries[0].pod_identifier,
                        0,
                        [],
                        request_keys,
                        entries,
                    )
                    self._journal_tick()
        return None

    def _evict(self, args):
        engine_key, raw_entries = args
        entries = decode_entries(raw_entries)
        self.index.evict(int(engine_key), entries)
        if self.journal is not None and entries:
            self.journal.record_evict(
                entries[0].pod_identifier, 0, [int(engine_key)], entries
            )
            self._journal_tick()
        # Pruned flag: did this eviction empty the key (the local
        # backend then dropped the engine mapping)?  The router uses it
        # to clean the mapping stub at the engine-key owner, keeping
        # get_request_key's post-eviction KeyError contract exact
        # across the cluster.
        try:
            self.index.get_request_key(int(engine_key))
        except KeyError:
            return 1
        return 0

    def _get_request_key(self, args):
        (engine_key,) = args
        try:
            return [1, self.index.get_request_key(int(engine_key))]
        except KeyError:
            return [0, 0]

    def _dump_entries(self, args):
        block_entries, engine_map = self.index.dump_entries()
        return [
            [
                [key, encode_entries(entries)]
                for key, entries in block_entries
            ],
            [[ek, rk] for ek, rk in engine_map],
        ]

    def _restore_entries(self, args):
        raw_block_entries, engine_map = args
        block_entries = [
            (key, decode_entries(raw)) for key, raw in raw_block_entries
        ]
        return self.index.restore_entries(
            block_entries, [(ek, rk) for ek, rk in engine_map]
        )

    def _purge_pod(self, args):
        (pod,) = args
        removed = self.index.purge_pod(str(pod))
        if self.journal is not None:
            # Journaled even when removed == 0: a standby slice may
            # hold entries the primary never did, and replay order must
            # still drop them.
            self.journal.record_purge(str(pod))
            self._journal_tick()
        return removed

    def _version_vector(self, args):
        """Explicit vector fetch (ring-change refresh and the local
        transport's non-wire path); [] when the backend has no
        version surface — the router's memo then never validates
        against this replica."""
        return self.vector_snapshot() or []

    def _touch_chain(self, args):
        """Recency-only LRU touch for a memoized chain's keys.  Never
        journaled: followers rebuild recency from their own traffic,
        and a lost touch costs at worst one early eviction."""
        (keys,) = args
        touch = getattr(self.index, "touch_chain", None)
        if callable(touch):
            touch([int(k) for k in keys])
        return None

    def _sync_snapshot(self, args):
        """Follower bootstrap: journal boundary (rotate + per-pod
        watermarks) then a dump taken AFTER it — every record below the
        boundary is covered by the dump, so the follower tails from
        ``TailPosition(boundary, 0)`` and skips numbered records below
        the watermarks (mirroring recovery's replay rule)."""
        if self.journal is not None:
            boundary, watermarks, _ = self.journal.snapshot_boundary()
        else:
            boundary, watermarks = 0, {}
        dump = self._dump_entries([])
        return [
            boundary,
            [[pod, seq] for pod, seq in watermarks.items()],
            dump[0],
            dump[1],
        ]


# -- transports ---------------------------------------------------------


class LocalReplicaTransport:
    """In-process transport: calls ``ClusterReplica.handle`` directly.

    ``strict_wire=True`` round-trips every call through the CBOR codec
    (the contract-parity tests use it so the in-process and HTTP paths
    cannot drift); the default skips the codec for speed.  ``kill()``
    makes every subsequent call raise :class:`ReplicaUnavailable` — the
    failover trigger for tests, the bench, and the smoke.
    """

    # In-process calls either succeed immediately or fail immediately
    # (kill()), so a per-call deadline is accepted and trivially met —
    # the router's budget accounting stays uniform across transports.
    supports_deadline = True

    def __init__(
        self, replica: ClusterReplica, strict_wire: bool = False
    ) -> None:
        self.replica = replica
        self.strict_wire = strict_wire
        self._killed = threading.Event()

    def kill(self) -> None:
        self._killed.set()

    def revive(self) -> None:
        self._killed.clear()

    def call(self, method: str, args: list):
        payload, _, _ = self.call_vv(method, args)
        return payload

    def call_ex(
        self,
        method: str,
        args: list,
        traceparent: Optional[str] = None,
    ) -> Tuple[object, Optional[list]]:
        payload, spans, _ = self.call_vv(method, args, traceparent)
        return payload, spans

    def call_vv(
        self,
        method: str,
        args: list,
        traceparent: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> Tuple[object, Optional[list], Optional[list]]:
        """(payload, piggybacked spans, piggybacked version vector).
        The non-strict path runs the handler on the CALLER's thread, so
        an active trace receives the replica-side spans directly
        through the context var — no piggyback needed (None) — and the
        vector is read off the backend post-apply; the strict path
        round-trips the full wire contract including the trace context
        and the vector frame."""
        if self._killed.is_set():
            raise ReplicaUnavailable(
                f"replica {self.replica.replica_id} is down",
                kind="killed",
            )
        if not self.strict_wire:
            payload = self.replica.handle(method, args)
            vector = (
                self.replica.vector_snapshot()
                if self.replica.version_piggyback
                else None
            )
            return payload, None, vector
        response = self.replica.handle_wire(
            encode_request(method, args, traceparent)
        )
        return decode_response_vv(response)

    def close(self) -> None:
        return None


class HttpReplicaTransport:
    """HTTP transport: ``POST /replica`` with a CBOR body.

    One ``http.client`` connection per calling thread (the router's
    scoring threads, fan-out executor workers, and kvevents workers
    call concurrently — each worker reuses its own connection); any
    transport-level failure closes the connection and raises
    :class:`ReplicaUnavailable` — retries are the router's decision,
    not the transport's.
    """

    # Per-call timeouts tighten (never extend) the construction-time
    # timeout so a re-routed retry spends only the fan-out budget's
    # remainder (docs/replication.md "Deadline budget").
    supports_deadline = True

    def __init__(
        self,
        base_url: str,
        timeout: float = 5.0,
        token: Optional[str] = None,
    ) -> None:
        from urllib.parse import urlsplit

        parsed = urlsplit(base_url)
        if parsed.scheme not in ("http", ""):
            raise ValueError(
                f"unsupported replica URL scheme: {parsed.scheme!r}"
            )
        netloc = parsed.netloc or parsed.path
        host, _, port = netloc.partition(":")
        self._host = host or "127.0.0.1"
        self._port = int(port) if port else 8080
        self._timeout = timeout
        # The replica endpoint shares the admin gate; cluster
        # deployments pass ADMIN_TOKEN here (docs/replication.md).
        self._headers = {"Content-Type": "application/cbor"}
        if token:
            self._headers["Authorization"] = f"Bearer {token}"
        self._local = threading.local()

    def _connection(self):
        import http.client

        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(
                self._host, self._port, timeout=self._timeout
            )
            self._local.conn = conn
        return conn

    def _drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:  # pragma: no cover - best-effort teardown
                pass
            self._local.conn = None

    @staticmethod
    def _failure_kind(exc: BaseException) -> str:
        """Classify a transport failure for the per-replica error
        attribution (``kvtpu_cluster_rpc_errors_total{replica,kind}``):
        a timeout, a refused connect, and garbled bytes are three
        different operational stories."""
        if isinstance(exc, (TimeoutError, socket.timeout)):
            return "timeout"
        if isinstance(exc, ConnectionRefusedError):
            return "refused"
        return "io"

    def call(self, method: str, args: list):
        payload, _, _ = self.call_vv(method, args)
        return payload

    def call_ex(
        self,
        method: str,
        args: list,
        traceparent: Optional[str] = None,
    ) -> Tuple[object, Optional[list]]:
        payload, spans, _ = self.call_vv(method, args, traceparent)
        return payload, spans

    def _apply_timeout(self, conn, timeout: Optional[float]) -> None:
        """Clamp this call's socket timeout to the remaining deadline
        budget (never above the construction-time timeout); the
        connection is thread-local, so resetting it every call keeps
        reuse safe."""
        effective = self._timeout
        if timeout is not None:
            effective = max(0.05, min(timeout, self._timeout))
        conn.timeout = effective
        if conn.sock is not None:
            conn.sock.settimeout(effective)

    def call_vv(
        self,
        method: str,
        args: list,
        traceparent: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> Tuple[object, Optional[list], Optional[list]]:
        body = encode_request(method, args, traceparent)
        try:
            conn = self._connection()
            self._apply_timeout(conn, timeout)
            conn.request(
                "POST", "/replica", body=body, headers=self._headers
            )
            response = conn.getresponse()
            data = response.read()
        except (OSError, ConnectionError) as exc:
            self._drop_connection()
            raise ReplicaUnavailable(
                f"replica at {self._host}:{self._port} unreachable: "
                f"{exc}",
                kind=self._failure_kind(exc),
            ) from exc
        if response.status != 200:
            self._drop_connection()
            raise ReplicaUnavailable(
                f"replica at {self._host}:{self._port} returned HTTP "
                f"{response.status}",
                kind="http_status",
            )
        try:
            return decode_response_vv(data)
        except CborDecodeError as exc:
            self._drop_connection()
            raise ReplicaUnavailable(
                f"garbled replica response: {exc}",
                kind="wire_decode",
            ) from exc

    def close(self) -> None:
        self._drop_connection()
