"""Input flight recorder, config fingerprint, and incident bundler.

The observability planes built so far (traces, SLO envelopes,
profiler, timelines) answer *what happened*; none of them can answer
*run it again*.  This module adds the black-box: a bounded, always-on
recording of the service's two canonical ingress streams, bundled with
every other debug surface the moment an SLO envelope is violated, and
replayable to a first divergence by ``obs/replay.py``
(docs/observability.md "Incident response runbook").

Three pieces:

* :class:`InputCaptureRecorder` — per-source bounded rings over the
  two ingress points: decoded kvevents messages **post shed decision**
  (tapped in ``kvevents/pool.py::Pool.add_tasks``: pod, topic, model,
  seq, seq-gap classification, raw payload bytes, admitted/shed
  disposition) and scored requests (tapped in
  ``kvcache/indexer.py``: model, served token chain, pod filter,
  returned scores).  Records are kept as cheap Python tuples — the
  hot-path cost is one lock hop and an append (the read_path and
  event_storm ``capture_ab`` bench cells pin the end-to-end overhead
  ≤ 3%) — and serialized to canonical CBOR only at ``dump()`` time.
  Rings are bounded by ``CAPTURE_WINDOW_S`` (age) and
  ``CAPTURE_MAX_BYTES`` (estimated bytes, split across sources);
  pruning marks the source ``truncated`` so replay knows final-state
  comparison is off the table.  With ``CAPTURE=0`` nothing is
  constructed at all — no ring, no thread (the recorder never has a
  thread), no per-message branch beyond one ``is None`` check.

* :func:`config_fingerprint` — a stable hash of the resolved
  score-relevant env knobs plus the package version, exported as the
  ``kvtpu_build_info``-style gauge (:func:`set_build_info_metric`),
  shown in ``/healthz``, and stamped into every capture header and
  incident manifest so a replay against mismatched knobs refuses with
  the differing knob names instead of diverging mysteriously.

* :class:`IncidentManager` — subscribes to the SLO engine
  (``SloEngine.add_listener``); on a transition into ``violated`` (or
  ``POST /admin/incident``) it atomically dumps one versioned incident
  directory: the capture window, slow/errored traces, the profiler's
  top table + lock contention, the gauge-timeline rings, the cluster
  rpc panel, the SLO payload that fired, and the config fingerprint.
  Bundles are listed at ``GET /debug/incidents``, rate-limited
  (``INCIDENT_MIN_INTERVAL_S``) and pruned to ``INCIDENT_KEEP``.

Capture wire format (canonical CBOR, ``kvcache/kvblock/cbor_canonical``
— deliberately the same deterministic codec the persistence plane
uses; floats ride as 8-byte big-endian IEEE754 byte strings since the
canonical subset has no float major type):

    ["kvtpu-capture", 1, header, [record, ...], state-or-null]
    header  = [fingerprint, [[knob, value], ...], created_us,
               window_s, max_bytes, [truncated source, ...],
               [[meta key, value], ...]]
    kvevents record = [0, seq, ts_us, pod, topic, model, msg_seq,
                       seq_gap, payload-or-null, disposition]
    score record    = [1, seq, ts_us, model, [token, ...],
                       pod-filter-or-null, [[pod, f64 bytes], ...]]
    state   = [[[request_key, [[pod, tier], ...]], ...],
               [[engine_key, request_key], ...]]   (all sorted)

``seq`` is ONE monotone counter across both sources, so the merged
stream totally orders ingress — replay re-drives it in exactly this
order.  Resync commands (``Pool.enqueue_resync``) are anti-entropy
repairs synthesized by the service, not ingress input, and are
deliberately not recorded (docs/observability.md).

Copied from the JAX reference's ``obs/capture.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch import __version__
from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.cbor_canonical import (
    decode_canonical,
    encode_canonical,
)
from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("obs.capture")

CAPTURE_MAGIC = "kvtpu-capture"
CAPTURE_VERSION = 1

SOURCE_KVEVENTS = "kvevents"
SOURCE_SCORES = "scores"

DEFAULT_WINDOW_S = 300.0
DEFAULT_MAX_BYTES = 32 * 1024 * 1024

# Ring-occupancy gauges are refreshed every this-many appends (and at
# every status()/dump()) — a per-record gauge write would tax the very
# hot paths the ≤3% capture_ab budget protects.
_GAUGE_EVERY = 64

# Capture/IncidentManager locks are leaves: record() does deque
# surgery only; serialization, disk writes, and source callables all
# run outside them.
# kvlint: lock-order: InputCapture._lock ascending
lockorder.declare_ascending("InputCapture._lock")


def _env_flag(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default).strip().lower() not in (
        "0",
        "false",
        "off",
        "no",
    )


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


# --------------------------- config fingerprint ---------------------------

# The env knobs whose resolved values change what a replayed stack
# would compute: hash-chain identity, chunking, backend topology, and
# the write-path digest semantics.  Kept to documented knobs
# (docs/configuration.md) on purpose — the fingerprint is a contract
# surface, not a dump of os.environ.
FINGERPRINT_KNOBS: Tuple[str, ...] = (
    "PYTHONHASHSEED",
    "BLOCK_SIZE",
    "MODEL_NAME",
    "INDEX_BACKEND",
    "INDEX_SHARDS",
    "READ_PATH_FAST_LANE",
    "READ_PATH_LOOKUP_CHUNK",
    "READ_PATH_SCORE_MEMO",
    "KVEVENTS_LOCKFREE_DECODE",
    "KVEVENTS_COALESCE_EVENTS",
    "KVEVENTS_DIGEST_MEMO",
    "KVEVENTS_APPLY_BATCH",
    "KVEVENTS_POD_BUDGET",
    "KVEVENTS_POD_FLOW",
    "KVEVENTS_GAP_RESYNC",
    "CLUSTER_REPLICAS",
    "CLUSTER_SELF",
    "CLUSTER_MEMBERS",
)


def fingerprint_knobs() -> List[Tuple[str, str]]:
    """The resolved ``(knob, value)`` pairs the fingerprint hashes
    (unset knobs report the empty string so set-to-default and unset
    hash identically only when they really are the same value)."""
    return [
        (name, os.environ.get(name, "")) for name in FINGERPRINT_KNOBS
    ]


def config_fingerprint(
    knobs: Optional[Sequence[Tuple[str, str]]] = None,
) -> str:
    """16-hex-char blake2b over package version + resolved knobs."""
    digest = hashlib.blake2b(digest_size=8)
    digest.update(__version__.encode())
    for name, value in knobs if knobs is not None else fingerprint_knobs():
        digest.update(b"\x00")
        digest.update(str(name).encode())
        digest.update(b"\x01")
        digest.update(str(value).encode())
    return digest.hexdigest()


def fingerprint_status() -> dict:
    """The /healthz + incident-manifest fingerprint block."""
    knobs = fingerprint_knobs()
    return {
        "version": __version__,
        "fingerprint": config_fingerprint(knobs),
        "knobs": {name: value for name, value in knobs if value},
    }


def set_build_info_metric() -> str:
    """Publish ``kvtpu_build_info{version,fingerprint} = 1`` (the
    kube-style build-info gauge) and return the fingerprint."""
    fingerprint = config_fingerprint()
    METRICS.build_info.labels(
        version=__version__, fingerprint=fingerprint
    ).set(1)
    return fingerprint


def diff_knobs(
    recorded: Sequence[Sequence],
    current: Optional[Sequence[Tuple[str, str]]] = None,
) -> List[str]:
    """Human-readable knob differences between a capture header and
    this process — what the replay mismatch error names."""
    current_map = dict(current if current is not None else fingerprint_knobs())
    recorded_map = {str(k): str(v) for k, v in recorded}
    out = []
    for name in sorted(set(recorded_map) | set(current_map)):
        want = recorded_map.get(name, "")
        have = current_map.get(name, "")
        if want != have:
            out.append(f"{name}: recorded {want!r} vs current {have!r}")
    return out


# ------------------------------- float codec -------------------------------


def encode_f64(value: float) -> bytes:
    """Float as 8 big-endian IEEE754 bytes (canonical CBOR here has no
    float major type; byte strings round-trip bit-exactly)."""
    return struct.pack(">d", float(value))


def decode_f64(raw: bytes) -> float:
    return struct.unpack(">d", bytes(raw))[0]


# ------------------------------ capture rings ------------------------------


@dataclass
class CaptureConfig:
    """Knobs for the input flight recorder (docs/configuration.md §9:
    ``CAPTURE``, ``CAPTURE_WINDOW_S``, ``CAPTURE_MAX_BYTES``)."""

    window_s: float = DEFAULT_WINDOW_S
    max_bytes: int = DEFAULT_MAX_BYTES

    @classmethod
    def from_env(cls) -> "CaptureConfig":
        return cls(
            window_s=_env_float("CAPTURE_WINDOW_S", DEFAULT_WINDOW_S),
            max_bytes=_env_int("CAPTURE_MAX_BYTES", DEFAULT_MAX_BYTES),
        )


def capture_enabled_env() -> bool:
    """The CAPTURE knob (default on).  When off, the service wires NO
    recorder anywhere — zero allocation, zero per-message branch
    beyond one ``is None`` check (pinned by tests)."""
    return _env_flag("CAPTURE", "1")


class _SourceRing:
    """One source's bounded record ring (caller holds the recorder
    lock for every method)."""

    __slots__ = ("records", "bytes", "budget", "dropped", "appended")

    def __init__(self, budget: int) -> None:
        self.records: deque = deque()
        self.bytes = 0
        self.budget = budget
        self.dropped = 0
        self.appended = 0

    def append(self, record: tuple, horizon_us: int) -> None:
        self.records.append(record)
        self.bytes += _record_size(record)
        self.appended += 1
        self.prune(horizon_us)

    def prune(self, horizon_us: int) -> None:
        while self.records and (
            self.bytes > self.budget
            or self.records[0][2] < horizon_us
        ):
            old = self.records.popleft()
            self.bytes -= _record_size(old)
            self.dropped += 1


def _record_size(record: tuple) -> int:
    """Cheap size estimate for ring accounting (tokens count 9 bytes
    each — the worst-case canonical uint head; payloads their length).
    Estimation, not truth: the budget bounds memory order-of-magnitude,
    not byte-exactly (docs/observability.md).  Kvevents records come
    in two shapes: the compact admitted form ``(0, seq, ts, message)``
    and the expanded 10-element form (shed paths, single-record
    API)."""
    if record[0] == 0:
        if len(record) == 4:
            message = record[3]
            return 64 + len(message.topic) + len(
                message.capture_payload
            )
        payload = record[8]
        return 64 + (len(payload) if payload is not None else 0) + len(
            record[4]
        )
    tokens = record[4]
    scores = record[6]
    return 64 + 9 * len(tokens) + 24 * len(scores)


class InputCaptureRecorder:
    """Always-on bounded recording of the two ingress streams.

    Thread-safe; one leaf lock.  Records are raw tuples in memory
    (see the module docstring for the wire layout they serialize to):
    the kvevents tap stashes the raw payload BY REFERENCE (a pinned
    zero-copy ZMQ frame costs its own bytes, which is exactly what
    the ring budget bounds) and the scoring tap stores the served
    token list by reference (per-request, never mutated after
    scoring) — both are O(1) appends on the hot path; payloads
    materialize to ``bytes`` only at dump time.
    """

    def __init__(
        self,
        config: Optional[CaptureConfig] = None,
        meta: Optional[Dict[str, object]] = None,
    ) -> None:
        self.config = config or CaptureConfig()
        if self.config.max_bytes <= 0:
            raise ValueError("capture max_bytes must be positive")
        if self.config.window_s <= 0:
            raise ValueError("capture window_s must be positive")
        # Replay-relevant stack facts the embedding application knows
        # (block_size, hash_seed, model) — stamped into the header so
        # obs/replay.py can construct a matching fresh stack.
        self.meta: Dict[str, object] = dict(meta or {})
        self._knobs = fingerprint_knobs()
        self._fingerprint = config_fingerprint(self._knobs)
        self._lock = lockorder.tracked(
            threading.Lock(), "InputCapture._lock"
        )
        budget = max(1, self.config.max_bytes // 2)
        self._rings: Dict[str, _SourceRing] = {  # guarded-by: _lock
            SOURCE_KVEVENTS: _SourceRing(budget),
            SOURCE_SCORES: _SourceRing(budget),
        }
        self._seq = 0  # guarded-by: _lock
        self._gauges = {
            source: METRICS.capture_ring_bytes.labels(source=source)
            for source in self._rings
        }
        self._counters = {
            source: METRICS.capture_records.labels(source=source)
            for source in self._rings
        }
        self._pending_counts = {  # guarded-by: _lock
            source: 0 for source in self._rings
        }

    # -- hot-path appends ----------------------------------------------

    def _append(self, source: str, record_tail: tuple, now_us: int):
        """Allocate the global seq, append, prune, and (sampled)
        refresh the metrics — the single-record hot-path body."""
        horizon = now_us - int(self.config.window_s * 1e6)
        flush = None
        with self._lock:
            ring = self._rings[source]
            self._seq += 1
            record = (record_tail[0], self._seq, now_us) + record_tail[1:]
            ring.append(record, horizon)
            self._pending_counts[source] += 1
            if self._seq % _GAUGE_EVERY == 0:
                flush = {
                    name: (r.bytes, self._pending_counts[name])
                    for name, r in self._rings.items()
                }
                for name in self._pending_counts:
                    self._pending_counts[name] = 0
        if flush is not None:
            self._flush_metrics(flush)

    def _flush_metrics(self, flush: Dict[str, Tuple[int, int]]) -> None:
        for name, (ring_bytes, appended) in flush.items():
            self._gauges[name].set(ring_bytes)
            if appended:
                self._counters[name].inc(appended)

    def record_kvevents(
        self,
        pod: str,
        topic: str,
        model: str,
        seq: int,
        seq_gap: int,
        payload: Optional[bytes],
        disposition: str,
    ) -> None:
        """One wire message post shed decision.  ``disposition`` is
        ``"admitted"`` or the shed reason; a message admitted earlier
        and displaced later appears TWICE (admitted, then shed) — the
        honest stream, reconciled by replay."""
        self.record_kvevents_batch(
            ((pod, topic, model, seq, seq_gap, payload, disposition),)
        )

    def record_kvevents_batch(self, items) -> None:
        """One enqueue burst of wire messages, recorded under ONE lock
        round trip with one shared timestamp — the pool's batched tap
        (``Pool.add_tasks`` drains sockets in bursts of ~64; a
        per-message lock hop here would tax the apply path the
        event_storm ``capture_ab`` bound protects).  ``items`` are
        ``(pod, topic, model, seq, seq_gap, payload, disposition)``
        tuples in burst order."""
        if not items:
            return
        now_us = time.time_ns() // 1000
        horizon = now_us - int(self.config.window_s * 1e6)
        flush = None
        with self._lock:
            ring = self._rings[SOURCE_KVEVENTS]
            seq = self._seq
            rec_append = ring.records.append
            size = 0
            for pod, topic, model, mseq, gap, payload, disp in items:
                seq += 1
                rec_append(
                    (0, seq, now_us, pod, topic, model, int(mseq),
                     int(gap), payload, disp)
                )
                size += 64 + len(topic) + (
                    len(payload) if payload is not None else 0
                )
            self._seq = seq
            ring.bytes += size
            ring.appended += len(items)
            # One prune pass per burst (a burst may overshoot the
            # byte budget by its own size before it, which is noise
            # next to the estimation error the budget already has).
            ring.prune(horizon)
            flush = self._note_pending_locked(
                SOURCE_KVEVENTS, len(items)
            )
        if flush is not None:
            self._flush_metrics(flush)

    def record_admitted_messages(self, messages) -> None:
        """The pool's common-case burst tap: nothing was shed, every
        message is ``admitted``.  The ring holds the Message objects
        themselves in COMPACT records ``(0, seq, ts_us, message)`` —
        zero per-message allocation beyond one 4-tuple — expanded to
        the wire layout only at dump time.  Each message must carry
        ``capture_payload`` (the raw payload stashed before pre-decode
        cleared it) plus the usual pod_identifier / topic /
        model_name / seq / seq_gap attributes."""
        if not messages:
            return
        now_us = time.time_ns() // 1000
        horizon = now_us - int(self.config.window_s * 1e6)
        flush = None
        with self._lock:
            ring = self._rings[SOURCE_KVEVENTS]
            seq = self._seq
            rec_append = ring.records.append
            size = 0
            for message in messages:
                seq += 1
                rec_append((0, seq, now_us, message))
                size += 64 + len(message.topic) + len(
                    message.capture_payload
                )
            self._seq = seq
            ring.bytes += size
            ring.appended += len(messages)
            ring.prune(horizon)
            flush = self._note_pending_locked(
                SOURCE_KVEVENTS, len(messages)
            )
        if flush is not None:
            self._flush_metrics(flush)

    def _note_pending_locked(self, source: str, count: int):
        """Batched metrics bookkeeping (caller holds the lock);
        returns the flush payload when due."""
        pending = self._pending_counts
        pending[source] += count
        if pending[source] < _GAUGE_EVERY:
            return None
        flush = {
            name: (ring.bytes, pending[name])
            for name, ring in self._rings.items()
        }
        for name in pending:
            pending[name] = 0
        return flush

    def record_score(
        self,
        model: str,
        tokens: Sequence[int],
        pods: Optional[Sequence[str]],
        scores: Dict[str, float],
    ) -> None:
        """One scored request: the served token chain (the black-box
        input — chat templating and prefix-store truncation already
        applied), the pod filter, and the returned scores."""
        self._append(
            SOURCE_SCORES,
            (1, model, tokens, tuple(pods) if pods else None, scores),
            time.time_ns() // 1000,
        )

    # -- read side ------------------------------------------------------

    def status(self) -> dict:
        """Occupancy for /debug/incidents, /healthz and the beat."""
        with self._lock:
            rings = {
                name: {
                    "records": len(ring.records),
                    "bytes": ring.bytes,
                    "dropped": ring.dropped,
                    "appended": ring.appended,
                    "truncated": ring.dropped > 0,
                }
                for name, ring in self._rings.items()
            }
            seq = self._seq
        for name, view in rings.items():
            self._gauges[name].set(view["bytes"])
        return {
            "enabled": True,
            "window_s": self.config.window_s,
            "max_bytes": self.config.max_bytes,
            "records": seq,
            "fingerprint": self._fingerprint,
            "sources": rings,
        }

    def _snapshot_merged(self) -> Tuple[List[tuple], List[str]]:
        with self._lock:
            merged: List[tuple] = []
            truncated = [
                name
                for name, ring in self._rings.items()
                if ring.dropped > 0
            ]
            for ring in self._rings.values():
                merged.extend(ring.records)
        merged.sort(key=lambda record: record[1])
        return merged, sorted(truncated)

    def dump_bytes(self, index=None) -> bytes:
        """Serialize the current window to the canonical-CBOR artifact
        (module docstring).  ``index`` adds the canonicalized
        ``dump_entries`` state section — the replay harness compares
        final state against it only when no source was truncated."""
        merged, truncated = self._snapshot_merged()
        records = []
        for record in merged:
            if record[0] == 0:
                if len(record) == 4:
                    # Compact admitted form: expand from the retained
                    # Message (payload materialized to bytes here —
                    # zero-copy memoryviews ride the ring as-is).
                    message = record[3]
                    records.append(
                        [
                            0,
                            record[1],
                            record[2],
                            message.pod_identifier,
                            message.topic,
                            message.model_name,
                            int(message.seq),
                            int(message.seq_gap),
                            bytes(message.capture_payload),
                            "admitted",
                        ]
                    )
                    continue
                expanded = list(record)
                if expanded[8] is not None:
                    expanded[8] = bytes(expanded[8])
                records.append(expanded)
            else:
                kind, seq, ts_us, model, tokens, pods, scores = record
                records.append(
                    [
                        1,
                        seq,
                        ts_us,
                        model,
                        list(tokens),
                        list(pods) if pods is not None else None,
                        [
                            [pod, encode_f64(scores[pod])]
                            for pod in sorted(scores)
                        ],
                    ]
                )
        header = [
            self._fingerprint,
            [list(pair) for pair in self._knobs],
            time.time_ns() // 1000,
            int(self.config.window_s),
            int(self.config.max_bytes),
            truncated,
            [
                [str(key), str(value)]
                for key, value in sorted(self.meta.items())
            ],
        ]
        state = canonical_state(index) if index is not None else None
        return encode_canonical(
            [CAPTURE_MAGIC, CAPTURE_VERSION, header, records, state]
        )

    def dump(self, path: str, index=None) -> int:
        """Write the artifact atomically (tmp + rename); returns its
        size in bytes."""
        payload = self.dump_bytes(index=index)
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as handle:
            handle.write(payload)
        os.replace(tmp, path)
        return len(payload)

    def clear(self) -> None:
        """Drop all retained records (test isolation)."""
        with self._lock:
            for ring in self._rings.values():
                ring.records.clear()
                ring.bytes = 0
                ring.dropped = 0


def canonical_state(index) -> list:
    """Order-independent form of ``Index.dump_entries`` — pod-entry
    sets merged + sorted per key, keys sorted, engine map deduped +
    sorted — so two runs whose cross-pod applies interleaved
    differently (but commuted) compare equal, and a cluster
    ``RemoteIndex`` dump (which legitimately reports a key once per
    owning replica) compares equal to a single-index dump."""
    block_entries, engine_map = index.dump_entries()
    merged: Dict[int, set] = {}
    for key, pods in block_entries:
        bucket = merged.setdefault(int(key), set())
        bucket.update(
            (entry.pod_identifier, entry.device_tier) for entry in pods
        )
    return [
        [
            [key, [[pod, tier] for pod, tier in sorted(entries)]]
            for key, entries in sorted(merged.items())
        ],
        sorted(
            [ek, rk]
            for ek, rk in {
                (int(ek), int(rk)) for ek, rk in engine_map
            }
        ),
    ]


def load_artifact(data: bytes) -> dict:
    """Decode + structurally validate a capture artifact; returns
    ``{fingerprint, knobs, created_us, window_s, max_bytes, truncated,
    meta, records, state}``.  Raises ``ValueError`` on anything that
    is not a well-formed v1 capture."""
    doc = decode_canonical(bytes(data))
    if (
        not isinstance(doc, list)
        or len(doc) != 5
        or doc[0] != CAPTURE_MAGIC
    ):
        raise ValueError("not a kvtpu capture artifact")
    if doc[1] != CAPTURE_VERSION:
        raise ValueError(f"unsupported capture version {doc[1]!r}")
    header, records, state = doc[2], doc[3], doc[4]
    if not isinstance(header, list) or len(header) < 7:
        raise ValueError("malformed capture header")
    return {
        "fingerprint": str(header[0]),
        "knobs": [(str(k), str(v)) for k, v in header[1]],
        "created_us": int(header[2]),
        "window_s": int(header[3]),
        "max_bytes": int(header[4]),
        "truncated": [str(s) for s in header[5]],
        "meta": {str(k): str(v) for k, v in header[6]},
        "records": records,
        "state": state,
    }


def encode_capture(
    records: Sequence[list],
    fingerprint: Optional[str] = None,
    knobs: Optional[Sequence[Sequence]] = None,
    created_us: int = 0,
    window_s: int = 0,
    max_bytes: int = 0,
    truncated: Optional[Sequence[str]] = None,
    meta: Optional[Dict[str, object]] = None,
    state: Optional[list] = None,
) -> bytes:
    """Serialize already-shaped records to a valid v1 capture artifact
    — the writer for SYNTHETIC captures (the what-if engine's
    composition operators and the pinned reference generator,
    obs/whatif.py / hack/make_reference_capture.py).  ``records`` must
    be fully expanded wire-shape rows (the forms ``load_artifact``
    returns); ``knobs`` defaults to this process's resolved knob set
    and ``fingerprint`` to its hash, so a synthetic artifact replays
    under the same mismatch contract as a recorded one."""
    if knobs is None:
        knobs = fingerprint_knobs()
    knobs = [[str(k), str(v)] for k, v in knobs]
    if fingerprint is None:
        fingerprint = config_fingerprint(
            [(k, v) for k, v in knobs]
        )
    header = [
        str(fingerprint),
        knobs,
        int(created_us),
        int(window_s),
        int(max_bytes),
        [str(s) for s in (truncated or [])],
        [
            [str(key), str(value)]
            for key, value in sorted((meta or {}).items())
        ],
    ]
    return encode_canonical(
        [CAPTURE_MAGIC, CAPTURE_VERSION, header, list(records), state]
    )


# ----------------------------- incident bundler ----------------------------

DEFAULT_INCIDENT_KEEP = 8
DEFAULT_INCIDENT_MIN_INTERVAL_S = 60.0

# kvlint: lock-order: IncidentManager._lock ascending
lockorder.declare_ascending("IncidentManager._lock")


class IncidentManager:
    """Turns a live anomaly into one on-disk incident bundle.

    ``sources`` maps surface name -> zero-arg callable returning a
    JSON-serializable payload (traces, profile, timeline, cluster,
    slo...); each is written as ``<name>.json`` inside the bundle and
    a failing source records its error instead of killing the bundle.
    The capture window is written as ``capture.cbor`` (with the live
    index's canonical state when ``index`` is wired).  Bundles land
    atomically (``<id>.tmp`` → rename) under ``directory`` and are
    pruned oldest-first past ``keep``.
    """

    def __init__(
        self,
        directory: str,
        capture: Optional[InputCaptureRecorder] = None,
        sources: Optional[Dict[str, Callable[[], object]]] = None,
        index=None,
        keep: int = DEFAULT_INCIDENT_KEEP,
        min_interval_s: float = DEFAULT_INCIDENT_MIN_INTERVAL_S,
    ) -> None:
        if keep <= 0:
            raise ValueError("incident keep must be positive")
        self.directory = directory
        self.capture = capture
        self.sources = dict(sources or {})
        self.index = index
        self.keep = keep
        self.min_interval_s = min_interval_s
        self._lock = lockorder.tracked(
            threading.Lock(), "IncidentManager._lock"
        )
        self._counter = 0  # guarded-by: _lock
        self._last_trigger = 0.0  # guarded-by: _lock
        self._last_id: Optional[str] = None  # guarded-by: _lock
        os.makedirs(directory, exist_ok=True)

    # -- triggering -----------------------------------------------------

    def slo_listener(self) -> Callable[[str, str, dict], None]:
        """The callback to hand ``SloEngine.add_listener``: bundles on
        every transition INTO ``violated`` (rate-limited)."""

        def on_transition(old: str, new: str, payload: dict) -> None:
            if new != "violated" or old == "violated":
                return
            bad = sorted(
                name
                for name, view in (payload.get("slis") or {}).items()
                if view.get("state") == "violated"
            )
            self.trigger("slo:" + (",".join(bad) or "overall"))

        return on_transition

    def trigger(self, reason: str, force: bool = False) -> Optional[dict]:
        """Write one bundle; returns its manifest, or None when
        rate-limited (``force`` — the admin endpoint — bypasses)."""
        now = time.time()
        with self._lock:
            if (
                not force
                and now - self._last_trigger < self.min_interval_s
            ):
                logger.warning(
                    "incident trigger %r rate-limited (last bundle "
                    "%.1fs ago, min interval %.1fs)",
                    reason,
                    now - self._last_trigger,
                    self.min_interval_s,
                )
                return None
            self._last_trigger = now
            self._counter += 1
            counter = self._counter
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(now))
        incident_id = f"inc-{stamp}-{counter:04d}"
        try:
            manifest = self._write_bundle(incident_id, reason, now)
        except Exception:  # noqa: BLE001 — an incident must not cascade
            logger.exception("incident bundle %s failed", incident_id)
            METRICS.incident_bundles.labels(outcome="failed").inc()
            return None
        with self._lock:
            self._last_id = incident_id
        METRICS.incident_bundles.labels(outcome="ok").inc()
        self._prune()
        logger.warning(
            "incident bundle %s written (%s): %s",
            incident_id,
            reason,
            os.path.join(self.directory, incident_id),
        )
        return manifest

    def _write_bundle(
        self, incident_id: str, reason: str, now: float
    ) -> dict:
        tmp_dir = os.path.join(self.directory, f"{incident_id}.tmp")
        try:
            return self._write_bundle_into(
                tmp_dir, incident_id, reason, now
            )
        finally:
            # On success os.replace already moved tmp_dir away (this
            # is a no-op); on ANY failure the partial bundle must not
            # squat under INCIDENT_DIR — a disk-full incident is
            # exactly when orphaned multi-MB tmp dirs hurt most.
            shutil.rmtree(tmp_dir, ignore_errors=True)

    def _write_bundle_into(
        self, tmp_dir: str, incident_id: str, reason: str, now: float
    ) -> dict:
        final_dir = os.path.join(self.directory, incident_id)
        os.makedirs(tmp_dir, exist_ok=True)
        files: List[str] = []
        capture_stats = None
        if self.capture is not None:
            size = 0
            payload = self.capture.dump_bytes(index=self.index)
            with open(os.path.join(tmp_dir, "capture.cbor"), "wb") as out:
                out.write(payload)
                size = len(payload)
            files.append("capture.cbor")
            capture_stats = dict(
                self.capture.status(), artifact_bytes=size
            )
        source_errors: Dict[str, str] = {}
        for name, source in sorted(self.sources.items()):
            try:
                payload = source()
            except Exception as exc:  # noqa: BLE001 — bundle what works
                logger.exception("incident source %s failed", name)
                source_errors[name] = repr(exc)
                continue
            file_name = f"{name}.json"
            with open(os.path.join(tmp_dir, file_name), "w") as out:
                json.dump(payload, out, default=str)
            files.append(file_name)
        manifest = {
            "id": incident_id,
            "version": CAPTURE_VERSION,
            "reason": reason,
            "created_unix": now,
            "fingerprint": fingerprint_status(),
            "files": sorted(files),
            "capture": capture_stats,
        }
        if source_errors:
            manifest["source_errors"] = source_errors
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as out:
            json.dump(manifest, out, default=str)
        os.replace(tmp_dir, final_dir)
        return manifest

    def _prune(self) -> None:
        bundles = self._bundle_dirs()
        for stale in bundles[: max(0, len(bundles) - self.keep)]:
            shutil.rmtree(
                os.path.join(self.directory, stale), ignore_errors=True
            )

    def _bundle_dirs(self) -> List[str]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(
            name
            for name in names
            if name.startswith("inc-")
            and not name.endswith(".tmp")
            and os.path.isdir(os.path.join(self.directory, name))
        )

    # -- read side ------------------------------------------------------

    def last_incident_id(self) -> Optional[str]:
        with self._lock:
            return self._last_id

    def list(self) -> List[dict]:
        """Manifests of every retained bundle, newest first (the
        ``GET /debug/incidents`` payload)."""
        out: List[dict] = []
        for name in reversed(self._bundle_dirs()):
            manifest_path = os.path.join(
                self.directory, name, "manifest.json"
            )
            try:
                with open(manifest_path) as handle:
                    out.append(json.load(handle))
            except (OSError, ValueError) as exc:
                out.append({"id": name, "error": f"unreadable: {exc}"})
        return out

    def detail(self, incident_id: str) -> Optional[dict]:
        """One bundle's manifest + on-disk source inventory (the
        ``GET /debug/incidents/<id>`` payload): every file with its
        byte size, so forensics knows what a bundle actually holds
        before pulling multi-MB captures.  ``None`` for unknown or
        malformed ids (path separators never traverse)."""
        if (
            not incident_id
            or not incident_id.startswith("inc-")
            or incident_id != os.path.basename(incident_id)
        ):
            return None
        bundle_dir = os.path.join(self.directory, incident_id)
        if not os.path.isdir(bundle_dir):
            return None
        manifest: dict
        try:
            with open(os.path.join(bundle_dir, "manifest.json")) as fh:
                manifest = json.load(fh)
        except (OSError, ValueError) as exc:
            manifest = {"id": incident_id, "error": f"unreadable: {exc}"}
        inventory = []
        try:
            names = sorted(os.listdir(bundle_dir))
        except OSError:
            names = []
        for name in names:
            path = os.path.join(bundle_dir, name)
            try:
                size = os.path.getsize(path)
            except OSError:
                size = -1
            inventory.append({"file": name, "bytes": size})
        return {
            "id": incident_id,
            "directory": bundle_dir,
            "manifest": manifest,
            "inventory": inventory,
        }

    def status(self) -> dict:
        bundles = self._bundle_dirs()
        return {
            "directory": self.directory,
            "bundles": len(bundles),
            "keep": self.keep,
            "min_interval_s": self.min_interval_s,
            "last_incident": self.last_incident_id()
            or (bundles[-1] if bundles else None),
        }
