"""HTTP scoring service: the online-demo surface as a real module.

Counterpart of the reference's online example service
(examples/kv_events/online/main.go:273-385): ``POST /score_completions``
and ``POST /score_chat_completions`` against the live indexer,
``GET /metrics`` (Prometheus exposition), ``GET /healthz``.  Stdlib
``http.server`` — threaded, no framework dependency.

Observability surface (docs/observability.md): the scoring endpoints
ingest and echo W3C ``traceparent`` (a sampled flag forces tracing),
accept ``?explain=1`` for a per-stage latency breakdown plus per-pod
score provenance, and the read-only flight-recorder endpoints
``GET /debug/traces`` (``?kind=recent|slow|errored``) and
``GET /debug/traces/<id>`` expose recent sampled traces.

Run standalone (env-configured like the reference's example):

    PYTHONHASHSEED=42 BLOCK_SIZE=16 ZMQ_ENDPOINT=tcp://*:5557 \
    MODEL_NAME=meta-llama/Llama-3.1-8B-Instruct \
    python -m llm_d_kv_cache_manager_tpu_torch.api.http_service

Copied from the JAX reference's ``api/http_service.py``; the handler
also turns Nagle's algorithm off (``disable_nagle_algorithm``), so a
keep-alive client's requests do not wait on a delayed ACK.
"""

from __future__ import annotations

import http.server
import json
import os
import socket
import threading
import time
import urllib.parse
from typing import Dict, Optional

from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import Indexer
from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.obs.trace import TRACER, use_trace
from llm_d_kv_cache_manager_tpu_torch.preprocessing.chat_templating import (
    ApplyChatTemplateRequest,
)
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("api.http_service")

# Generous for scoring payloads (a 100k-token chat conversation is well
# under 2 MiB of JSON) while bounding per-request buffering.
MAX_BODY_BYTES = 16 * 1024 * 1024


def _make_handler(
    indexer: Indexer,
    admin_token: Optional[str] = None,
    persistence=None,
    recovery_report=None,
    event_plane_status=None,
    auditor=None,
    tiering=None,
    transfer=None,
    replica=None,
    cluster_status=None,
    slo=None,
    profiler=None,
    timeline=None,
    capture=None,
    incidents=None,
):
    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # Socket timeout (StreamRequestHandler applies it in setup()):
        # without one, a client that declares a Content-Length and goes
        # silent wedges a handler thread forever in rfile.read — a few
        # dozen such connections exhaust the ThreadingHTTPServer.
        timeout = 60
        # A reply is two writes (headers, then body).  With Nagle's
        # algorithm on, the body waits for the ACK of the headers, which
        # a keep-alive client delays (~40 ms on Linux): every request on
        # a reused connection would stall that long.  StreamRequestHandler
        # sets TCP_NODELAY in setup() when this is true.
        disable_nagle_algorithm = True

        def log_message(self, *args):  # route through our logger
            logger.debug("http: " + args[0], *args[1:])

        def _reply(
            self,
            status: int,
            body: bytes,
            content_type: str,
            extra_headers: Optional[Dict[str, str]] = None,
        ):
            # Centralized desync guard: replying while a declared
            # request body sits unconsumed (404 route, 403 admin gate,
            # any future early-reply path) leaves those bytes to be
            # parsed as the next request line on keep-alive.  Close —
            # and TELL the client (without the Connection: close
            # header a keep-alive pool marks the connection reusable
            # and its next non-idempotent POST dies with ECONNRESET).
            if not getattr(
                self, "_body_consumed", True
            ) and self._declares_body():
                self.close_connection = True
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for name, value in (extra_headers or {}).items():
                self.send_header(name, value)
            if self.close_connection:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(
            self,
            status: int,
            obj,
            extra_headers: Optional[Dict[str, str]] = None,
        ) -> None:
            self._reply(
                status,
                json.dumps(obj).encode(),
                "application/json",
                extra_headers,
            )

        def _error(self, status: int, message: str) -> None:
            self._reply(status, message.encode() + b"\n", "text/plain")

        def _read_body(self) -> Optional[bytes]:
            # A chunked body is never decoded here, so its framing bytes
            # would sit in the buffer and be parsed as the next request
            # line — the keep-alive desync the paths below guard
            # against.  Reject the encoding outright.
            if self.headers.get("Transfer-Encoding"):
                self.close_connection = True
                self._error(501, "Transfer-Encoding not supported")
                return None
            # Duplicate Content-Length headers are a request-smuggling
            # primitive: .get() would silently honor the first value and
            # leave the rest of the body buffered for the next request
            # line.  Reject conflicting duplicates outright.
            all_lengths = self.headers.get_all("Content-Length") or ["0"]
            if len(set(all_lengths)) > 1:
                self.close_connection = True
                self._error(400, "conflicting Content-Length headers")
                return None
            # Strict digit grammar, same policy as RespClient._parse_int:
            # Python's int() accepts ' 10 ', '+10' and '1_0', which are
            # corrupted headers, not lengths.  ASCII digits only also
            # rules out negatives (read-to-EOF wedge) by construction.
            raw_length = str(all_lengths[0])
            # The digit-count bound precedes int(): CPython (>=3.11)
            # raises ValueError past ~4300 digits of str->int, which
            # would escape the handler; anything longer than
            # len(str(MAX_BODY_BYTES)) digits is oversized regardless.
            if (
                not raw_length.isascii()
                or not raw_length.isdigit()
                or len(raw_length) > len(str(MAX_BODY_BYTES))
            ):
                # Rejecting without consuming the body desyncs HTTP/1.1
                # keep-alive (leftover bytes parse as the next request
                # line); drop the connection instead.
                self.close_connection = True
                self._error(400, "invalid Content-Length")
                return None
            length = int(raw_length)
            if length > MAX_BODY_BYTES:
                self.close_connection = True
                self._error(413, "request body too large")
                return None
            try:
                body = self.rfile.read(length)
            except (TimeoutError, socket.timeout, OSError):
                # Stalled client (declared length, stopped sending):
                # the socket timeout fired mid-read.  The connection is
                # in an unknown framing state — drop it.
                self.close_connection = True
                return None
            self._body_consumed = True
            return body

        def _read_json(self) -> Optional[dict]:
            body = self._read_body()
            if body is None:
                return None
            try:
                obj = json.loads(body)
            except (ValueError, json.JSONDecodeError):
                self._error(400, "invalid JSON body")
                return None
            if not isinstance(obj, dict):
                # `null`/arrays/scalars are valid JSON: without this an
                # object-assuming handler would send NO response (client
                # hang) or crash the connection mid-request.
                self._error(400, "JSON object body required")
                return None
            return obj

        @staticmethod
        def _split_path(raw_path: str):
            """(path, {query}) with single-valued query params."""
            parsed = urllib.parse.urlsplit(raw_path)
            query = {
                key: values[-1]
                for key, values in urllib.parse.parse_qs(
                    parsed.query
                ).items()
            }
            return parsed.path, query

        def _do_get(self):
            path, query = self._split_path(self.path)
            if path == "/metrics":
                self._reply(
                    200,
                    METRICS.exposition(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif path == "/healthz":
                health = {"status": "ok"}
                # Sampling health without a scrape: ring occupancy and
                # sampled/unsampled counters tell an operator whether
                # the flight recorder is alive.
                health["observability"] = TRACER.stats()
                if recovery_report is not None:
                    health["recovery"] = recovery_report.to_dict()
                if persistence is not None:
                    health["persistence"] = persistence.status()
                if event_plane_status is not None:
                    # Live view: poller fan-in, suspect pods, resync
                    # outcomes (docs/event-plane.md).
                    try:
                        health["event_plane"] = event_plane_status()
                    except Exception:  # noqa: BLE001 — health must answer
                        logger.exception("event-plane status failed")
                        health["event_plane"] = {"error": "unavailable"}
                analytics = {}
                try:
                    if indexer.cache_stats is not None:
                        analytics["cachestats"] = (
                            indexer.cache_stats.stats_summary()
                        )
                    if auditor is not None:
                        analytics["audit"] = auditor.status()
                except Exception:  # noqa: BLE001 — health must answer
                    logger.exception("analytics status failed")
                    analytics = {"error": "unavailable"}
                if analytics:
                    health["analytics"] = analytics
                if tiering is not None:
                    # Compact: full engine status lives at
                    # /debug/tiering; health carries the liveness bits.
                    try:
                        status = tiering.status()
                        health["tiering"] = {
                            "feed": status["feed"]["snapshot"],
                            "advice_counts": status["advisor"][
                                "advice_counts"
                            ],
                            "demotion_workers": len(status["demotion"]),
                        }
                    except Exception:  # noqa: BLE001 — health must answer
                        logger.exception("tiering status failed")
                        health["tiering"] = {"error": "unavailable"}
                if transfer is not None:
                    # Compact: full engine status lives at
                    # /debug/transfer; health carries the liveness bits.
                    try:
                        status = transfer.status()
                        health["transfer"] = {
                            "plans": status["planner"]["plans"],
                            "outcomes": status["planner"]["outcomes"],
                            "cold_pods": (
                                len(status["warmup"]["cold_pods"])
                                if status["warmup"]
                                else 0
                            ),
                        }
                    except Exception:  # noqa: BLE001 — health must answer
                        logger.exception("transfer status failed")
                        health["transfer"] = {"error": "unavailable"}
                if slo is not None:
                    # Compact degradation envelope; the full per-SLI
                    # payload lives at /debug/slo.
                    try:
                        health["slo"] = slo.healthz_block()
                    except Exception:  # noqa: BLE001 — health must answer
                        logger.exception("slo status failed")
                        health["slo"] = {"error": "unavailable"}
                # Config fingerprint + capture/incident liveness: the
                # same fingerprint stamped into capture headers and
                # incident bundles, so "would a replay of that bundle
                # match THIS process" is one healthz read away
                # (docs/observability.md "Incident capture & replay").
                try:
                    from llm_d_kv_cache_manager_tpu_torch.obs.capture import (
                        fingerprint_status,
                    )

                    health["fingerprint"] = fingerprint_status()
                    if capture is not None:
                        health["capture"] = capture.status()
                    if incidents is not None:
                        health["incidents"] = incidents.status()
                except Exception:  # noqa: BLE001 — health must answer
                    logger.exception("capture status failed")
                    health["capture"] = {"error": "unavailable"}
                self._reply_json(200, health)
            elif path in ("/debug", "/debug/"):
                self._debug_index()
            elif path == "/debug/traces":
                self._debug_traces(query)
            elif path.startswith("/debug/traces/"):
                self._debug_trace_by_id(path[len("/debug/traces/"):])
            elif path == "/debug/cachestats":
                self._debug_cachestats(query)
            elif path == "/debug/tiering":
                self._debug_tiering()
            elif path == "/debug/transfer":
                self._debug_transfer()
            elif path == "/debug/cluster":
                self._debug_cluster()
            elif path == "/debug/slo":
                self._debug_slo()
            elif path == "/debug/profile":
                self._debug_profile(query)
            elif path == "/debug/timeline":
                self._debug_timeline(query)
            elif path == "/debug/incidents":
                self._debug_incidents()
            elif path.startswith("/debug/incidents/"):
                self._debug_incident_detail(
                    path[len("/debug/incidents/"):]
                )
            elif path == "/debug/whatif":
                self._debug_whatif(query)
            else:
                self._error(404, "not found")

        def _debug_index(self):
            """The debug-surface directory: every registered surface,
            one line each, with its enabled state — replaces
            guess-the-path (docs/observability.md)."""
            surfaces = [
                {
                    "path": "/debug/traces",
                    "enabled": True,
                    "description": (
                        "flight recorder: recent/slow/errored sampled "
                        "traces (?kind=, ?limit=; /debug/traces/<id> "
                        "for full spans)"
                    ),
                },
                {
                    "path": "/debug/cachestats",
                    "enabled": indexer.cache_stats is not None,
                    "description": (
                        "hit-attribution ledger + index-truth audit "
                        "plane (?top=, ?family=<hex>)"
                    ),
                },
                {
                    "path": "/debug/tiering",
                    "enabled": tiering is not None,
                    "description": (
                        "predictive tiering: policy feed, advisor, "
                        "eviction and demotion state"
                    ),
                },
                {
                    "path": "/debug/transfer",
                    "enabled": transfer is not None,
                    "description": (
                        "KV-transfer planning plane: planner "
                        "outcomes, hot-family catalog, warm-up "
                        "queue, executor counters"
                    ),
                },
                {
                    "path": "/debug/cluster",
                    "enabled": cluster_status is not None,
                    "description": (
                        "replicated index: membership, ring, "
                        "per-replica rpc fan-out attribution"
                    ),
                },
                {
                    "path": "/debug/slo",
                    "enabled": slo is not None,
                    "description": (
                        "SLO engine: per-SLI burn rates and the "
                        "degradation envelope"
                    ),
                },
                {
                    # Enabled means the SAMPLER is live-able (wired
                    # AND PROFILE_HZ > 0) — a wired-but-off profiler
                    # must read disabled or the index lies exactly
                    # when the plane is off.  ?kind=locks stays
                    # served regardless (contention timing is armed
                    # by LOCK_CONTENTION_SAMPLE, not the sampler).
                    "path": "/debug/profile",
                    "enabled": (
                        profiler is not None and profiler.config.hz > 0
                    ),
                    "description": (
                        "continuous sampling profiler: top self-time "
                        "table (?kind=top), collapsed flamegraph "
                        "stacks (?kind=stacks), lock contention "
                        "(?kind=locks — served even with the sampler "
                        "off)"
                    ),
                },
                {
                    "path": "/debug/timeline",
                    "enabled": (
                        timeline is not None and timeline.window_s > 0
                    ),
                    "description": (
                        "1s-resolution gauge history rings "
                        "(?last=<seconds>, ?series=<name>)"
                    ),
                },
                {
                    "path": "/debug/incidents",
                    "enabled": incidents is not None,
                    "description": (
                        "incident capture plane: input flight-recorder "
                        "occupancy + SLO-triggered replayable bundles "
                        "(POST /admin/incident forces one)"
                    ),
                    "status": (
                        {
                            "capture": (
                                capture.status()["sources"]
                                if capture is not None
                                else None
                            ),
                            "last_incident": (
                                incidents.status()["last_incident"]
                                if incidents is not None
                                else None
                            ),
                        }
                        if capture is not None or incidents is not None
                        else None
                    ),
                },
                {
                    "path": "/debug/whatif",
                    # The engine is in-process library code with a
                    # module-level results ring — always answerable.
                    "enabled": True,
                    "description": (
                        "what-if engine verdicts: time-compressed "
                        "replays and A/B config canaries, newest "
                        "first (?full=1; POST /admin/whatif runs one "
                        "against a capture or incident bundle)"
                    ),
                },
            ]
            self._reply_json(
                200,
                {
                    "surfaces": surfaces,
                    "also": ["/metrics", "/healthz"],
                },
            )

        def _debug_profile(self, query):
            """Read-only continuous-profiling plane: the sampling
            profiler's top/collapsed views and the lock-contention
            table (docs/observability.md "Continuous profiling")."""
            kind = query.get("kind", "top")
            if kind == "locks":
                # The contention table is module-global lockorder
                # state, armed by LOCK_CONTENTION_SAMPLE — it answers
                # regardless of the sampler (or a profiler being
                # wired at all).
                from llm_d_kv_cache_manager_tpu_torch.utils import lockorder

                self._reply_json(
                    200,
                    {
                        "sample": lockorder.contention_sample(),
                        "locks": lockorder.contention_stats(),
                    },
                )
                return
            if profiler is None or profiler.config.hz <= 0:
                self._error(
                    404, "profiler disabled (set PROFILE_HZ > 0)"
                )
                return
            if kind == "stacks":
                # The standard collapsed/folded format — pipe into
                # flamegraph.pl or paste into speedscope.
                self._reply(
                    200,
                    profiler.collapsed().encode(),
                    "text/plain; charset=utf-8",
                )
                return
            if kind != "top":
                self._error(400, "kind must be one of top|stacks|locks")
                return
            try:
                top = max(1, min(int(query.get("top", "30")), 500))
            except ValueError:
                self._error(400, "invalid 'top'")
                return
            self._reply_json(200, profiler.status(top=top))

        def _debug_timeline(self, query):
            """Read-only gauge timelines: the 1s ring history that
            walks a burn-rate alert back to the minutes before it
            fired (docs/observability.md "Gauge timelines")."""
            if timeline is None or timeline.window_s <= 0:
                self._error(
                    404, "timeline disabled (set TIMELINE_WINDOW_S > 0)"
                )
                return
            last_s = None
            raw_last = query.get("last")
            if raw_last is not None:
                try:
                    last_s = max(0.0, float(raw_last))
                except ValueError:
                    self._error(400, "invalid 'last'")
                    return
            self._reply_json(
                200,
                timeline.snapshot(
                    last_s=last_s, series=query.get("series")
                ),
            )

        def _debug_incidents(self):
            """Read-only incident capture plane: flight-recorder ring
            occupancy (bytes, records, truncation) and every retained
            incident bundle's manifest, newest first
            (docs/observability.md "Incident response runbook")."""
            if capture is None and incidents is None:
                self._error(404, "capture disabled (CAPTURE=0)")
                return
            try:
                payload = {
                    "capture": (
                        capture.status() if capture is not None else None
                    ),
                }
                if incidents is not None:
                    payload.update(incidents.status())
                    payload["incidents"] = incidents.list()
                self._reply_json(200, payload)
            except Exception as exc:  # noqa: BLE001 — debug must answer
                logger.exception("incident status failed")
                self._error(500, f"error: {exc}")

        def _debug_incident_detail(self, incident_id):
            """One retained incident bundle's manifest + source-file
            inventory (byte sizes) — what an operator pulls before
            running the bundle through replay or the what-if engine
            (docs/observability.md "Incident response runbook")."""
            if incidents is None:
                self._error(404, "capture disabled (CAPTURE=0)")
                return
            try:
                detail = incidents.detail(incident_id)
            except Exception as exc:  # noqa: BLE001 — debug must answer
                logger.exception("incident detail failed")
                self._error(500, f"error: {exc}")
                return
            if detail is None:
                self._error(404, f"no such incident: {incident_id}")
                return
            self._reply_json(200, detail)

        def _debug_whatif(self, query):
            """Read-only what-if engine results ring: recent replay /
            A/B verdicts, newest first (?full=1 for complete results;
            POST /admin/whatif runs one; docs/observability.md
            "What-if engine")."""
            from llm_d_kv_cache_manager_tpu_torch.obs import whatif as whatif_mod

            try:
                full = query.get("full", "").lower() in (
                    "1",
                    "true",
                    "yes",
                )
                payload = whatif_mod.REGISTRY.status()
                payload["results_list"] = whatif_mod.REGISTRY.list(
                    full=full
                )
                self._reply_json(200, payload)
            except Exception as exc:  # noqa: BLE001 — debug must answer
                logger.exception("whatif status failed")
                self._error(500, f"error: {exc}")

        def _debug_slo(self):
            """Read-only degradation envelopes: per-SLI state, burn
            rates over both evaluation windows, and the declared
            bounds chaos cells assert against
            (docs/observability.md)."""
            if slo is None:
                self._error(404, "slo engine disabled (SLO_ENABLE=0)")
                return
            try:
                payload = slo.status()
            except Exception as exc:  # noqa: BLE001 — debug must answer
                logger.exception("slo status failed")
                self._error(500, f"error: {exc}")
                return
            self._reply_json(200, payload)

        def _debug_cluster(self):
            """Read-only cluster plane: membership + ring version +
            failovers on a router, replica identity + replication
            follower positions on a replica (docs/replication.md)."""
            if cluster_status is None:
                self._error(
                    404,
                    "cluster disabled (set CLUSTER_REPLICAS or "
                    "CLUSTER_SELF)",
                )
                return
            try:
                payload = cluster_status()
            except Exception as exc:  # noqa: BLE001 — debug must answer
                logger.exception("cluster status failed")
                self._error(500, f"error: {exc}")
                return
            self._reply_json(200, payload)

        def _debug_tiering(self):
            """Read-only tiering policy plane: feed/snapshot stats,
            compute-or-load advisor state, predictive-eviction
            counters, demotion worker status + recent transitions
            (docs/tiering.md)."""
            if tiering is None:
                self._error(404, "tiering disabled (set TIERING=1)")
                return
            try:
                payload = tiering.status()
            except Exception as exc:  # noqa: BLE001 — debug must answer
                logger.exception("tiering status failed")
                self._error(500, f"error: {exc}")
                return
            self._reply_json(200, payload)

        def _debug_transfer(self):
            """Read-only transfer planning plane: planner outcome
            counters + recent plans, the hot-family catalog, warm-up
            queue/cold-pod state, and executor counters
            (docs/transfer.md)."""
            if transfer is None:
                self._error(404, "transfer disabled (set TRANSFER=1)")
                return
            try:
                payload = transfer.status()
            except Exception as exc:  # noqa: BLE001 — debug must answer
                logger.exception("transfer status failed")
                self._error(500, f"error: {exc}")
                return
            self._reply_json(200, payload)

        def _debug_cachestats(self, query):
            """Read-only cache-efficiency analytics: ledger totals,
            windows, reuse distances, top families (?top=N), one
            family's drill-down (?family=<16-hex id from a listing>),
            and the index-truth audit plane (docs/observability.md)."""
            ledger = indexer.cache_stats
            if ledger is None:
                self._error(404, "cache analytics disabled (CACHESTATS=0)")
                return
            family_raw = query.get("family")
            if family_raw:
                try:
                    family = int(family_raw, 16)
                except ValueError:
                    self._error(400, "invalid 'family' (expect hex id)")
                    return
                detail = ledger.family_detail(family)
                if detail is None:
                    self._error(
                        404, "family not tracked (evicted or never seen)"
                    )
                    return
                self._reply_json(200, detail)
                return
            try:
                top = max(1, min(int(query.get("top", "20")), 500))
            except ValueError:
                self._error(400, "invalid 'top'")
                return
            payload = ledger.snapshot(top=top)
            if auditor is not None:
                payload["audit"] = auditor.status()
                payload["audit_log"] = auditor.recent(20)
                divergent = auditor.divergent(20)
                if divergent:
                    payload["audit_divergent"] = divergent
            self._reply_json(200, payload)

        def _debug_traces(self, query):
            """Read-only flight-recorder listing (span-free summaries;
            fetch /debug/traces/<id> for full spans)."""
            kind = query.get("kind", "recent")
            try:
                limit = max(1, min(int(query.get("limit", "50")), 1000))
            except ValueError:
                self._error(400, "invalid 'limit'")
                return
            recorder = TRACER.recorder
            if kind == "recent":
                traces = recorder.recent(limit)
            elif kind == "slow":
                traces = recorder.slow(limit)
            elif kind == "errored":
                traces = recorder.errored(limit)
            else:
                self._error(
                    400, "kind must be one of recent|slow|errored"
                )
                return
            self._reply_json(
                200,
                {
                    "kind": kind,
                    "count": len(traces),
                    "stats": TRACER.stats(),
                    "traces": [
                        t.to_dict(include_spans=False) for t in traces
                    ],
                },
            )

        def _debug_trace_by_id(self, trace_id: str):
            found = TRACER.recorder.get(trace_id)
            if found is None:
                self._error(404, "trace not found (evicted or never sampled)")
                return
            self._reply_json(200, found.to_dict())

        def _declares_body(self) -> bool:
            if self.headers.get("Transfer-Encoding"):
                return True
            # get_all: a conflicting duplicate pair like ('0', '100')
            # must count as declaring a body, or the smuggling guard
            # below is bypassed on paths that never reach _read_json.
            lengths = self.headers.get_all("Content-Length") or []
            return any(str(raw).strip() not in ("", "0") for raw in lengths)

        def do_POST(self):
            # Replies sent before the body is consumed (404 route, 403
            # admin gate, field validation) leave the body bytes
            # buffered to be parsed as the next request line on
            # keep-alive.  _read_json marks consumption; any exit
            # without it drops the connection.
            self._body_consumed = False
            try:
                path, query = self._split_path(self.path)
                if path == "/score_completions":
                    self._score_completions(query)
                elif path == "/score_chat_completions":
                    self._score_chat_completions(query)
                elif path == "/admin/purge_pod":
                    self._purge_pod()
                elif path == "/admin/snapshot":
                    self._snapshot()
                elif path == "/admin/incident":
                    self._incident()
                elif path == "/admin/whatif":
                    self._whatif()
                elif path == "/replica":
                    self._replica_call()
                else:
                    self._error(404, "not found")
            finally:
                if not self._body_consumed and self._declares_body():
                    self.close_connection = True

        def do_GET(self):
            # A GET that declares a body is pathological; its unread
            # bytes would desync keep-alive exactly like the POST case.
            # GET handlers never read a body, so marking it unconsumed
            # lets _reply's centralized guard close when one is declared.
            self._body_consumed = False
            self._do_get()

        def _admin_allowed(self) -> bool:
            """Scoring is read-only; /admin/* mutates, so it gets its
            own gate: a configured bearer token, or — when no token is
            set — loopback clients only (kubectl port-forward / exec),
            never the whole cluster network."""
            if admin_token:
                supplied = self.headers.get("Authorization", "")
                return supplied == f"Bearer {admin_token}"
            host = self.client_address[0]
            return host == "::1" or host.startswith("127.")

        def _replica_call(self):
            """Replica-serving RPC (docs/replication.md): one CBOR
            request per POST, dispatched through the cluster replica's
            method table (``ClusterReplica.handle_wire``).  Mutating
            like /admin/*, so it shares the admin gate — cluster
            deployments set ADMIN_TOKEN and give routers the same
            token; the tokenless default accepts loopback only."""
            if replica is None:
                self._error(
                    404, "not a cluster replica (set CLUSTER_SELF)"
                )
                return
            if not self._admin_allowed():
                self._error(
                    403, "replica endpoint: token or loopback only"
                )
                return
            body = self._read_body()
            if body is None:
                return
            self._reply(200, replica.handle_wire(body), "application/cbor")

        def _purge_pod(self):
            """Operator recovery: drop every index entry for one pod
            (Index.purge_pod) — e.g. after a pod dies or its event
            stream gapped badly.  O(index size), runs inline."""
            if not self._admin_allowed():
                self._error(403, "admin endpoint: token or loopback only")
                return
            request = self._read_json()
            if request is None:
                return
            pod = request.get("pod", "")
            if not pod:
                self._error(400, "field 'pod' required")
                return
            try:
                removed = indexer.kv_block_index.purge_pod(pod)
            except Exception as exc:
                logger.exception("purge_pod failed")
                self._error(500, f"error: {exc}")
                return
            reply = {"pod": pod, "removed": removed}
            if persistence is not None:
                # Journal the purge so recovery replays it in order —
                # without the record, replayed adds resurrect exactly
                # the entries this endpoint dropped.  The purge already
                # APPLIED: a journal failure (disk full) must not eat
                # the reply, but the operator needs to know recovery
                # would resurrect.
                try:
                    persistence.journal.record_purge(pod)
                    reply["journaled"] = True
                except Exception:  # noqa: BLE001 — purge applied; reply
                    logger.exception(
                        "purge applied but journaling failed: a "
                        "recovery would resurrect pod %s's entries",
                        pod,
                    )
                    reply["journaled"] = False
            self._reply_json(200, reply)

        def _snapshot(self):
            """Operator trigger: publish an index snapshot now (e.g.
            before a planned restart or rollout).  Admin-gated like
            purge_pod; 503 when the service runs without persistence.
            An empty body is allowed — the endpoint takes no fields."""
            if not self._admin_allowed():
                self._error(403, "admin endpoint: token or loopback only")
                return
            if self._declares_body():
                if self._read_json() is None:
                    return
            if persistence is None:
                self._error(503, "persistence not configured")
                return
            try:
                info = persistence.snapshot(indexer.kv_block_index)
            except Exception as exc:
                logger.exception("snapshot failed")
                self._error(500, f"error: {exc}")
                return
            self._reply_json(
                200,
                {
                    "path": info.path,
                    "bytes": info.size_bytes,
                    "block_keys": info.block_keys,
                    "engine_mappings": info.engine_mappings,
                },
            )

        def _incident(self):
            """Operator trigger: bundle the capture window + debug
            surfaces NOW (docs/observability.md "Incident response
            runbook") — e.g. to pin a live anomaly the SLO engine has
            not (yet) classified as violated.  Admin-gated like
            purge_pod; bypasses the SLO trigger's rate limit.  Body is
            optional: ``{"reason": "..."}``."""
            if not self._admin_allowed():
                self._error(403, "admin endpoint: token or loopback only")
                return
            reason = "admin"
            if self._declares_body():
                request = self._read_json()
                if request is None:
                    return
                reason = str(request.get("reason") or "admin")
            if incidents is None:
                self._error(503, "incident capture not configured")
                return
            try:
                manifest = incidents.trigger(
                    f"admin:{reason}", force=True
                )
            except Exception as exc:  # noqa: BLE001 — reply, don't wedge
                logger.exception("admin incident trigger failed")
                self._error(500, f"error: {exc}")
                return
            if manifest is None:
                self._error(500, "incident bundle failed (see logs)")
                return
            self._reply_json(200, manifest)

        def _whatif(self):
            """Operator what-if: replay a capture (or a retained
            incident bundle, by id) through candidate config arms
            IN-PROCESS and reply with the measured verdict.  Body:
            ``{"bundle": "inc-..."}`` or ``{"capture": "<path>"}``,
            plus optional ``"kind"`` ("run" | "ab", default "ab"),
            ``"arm"`` / ``"a"`` / ``"b"`` arm specs
            ("shards=8,mode=cluster"), and ``"speed"``.  Admin-gated:
            it reads operator-named filesystem paths and burns CPU for
            seconds.  The full result lands in the /debug/whatif ring;
            the reply carries the summary (docs/observability.md
            "What-if engine")."""
            if not self._admin_allowed():
                self._error(403, "admin endpoint: token or loopback only")
                return
            request = self._read_json() if self._declares_body() else {}
            if request is None:
                return
            from llm_d_kv_cache_manager_tpu_torch.obs import whatif as whatif_mod

            source = None
            bundle = request.get("bundle")
            if bundle:
                if incidents is None:
                    self._error(503, "incident capture not configured")
                    return
                detail = incidents.detail(str(bundle))
                if detail is None:
                    self._error(404, f"no such incident: {bundle}")
                    return
                source = detail["directory"]
            elif request.get("capture"):
                source = str(request["capture"])
            else:
                self._error(400, "body needs 'bundle' or 'capture'")
                return
            try:
                config = whatif_mod.WhatIfConfig.from_env()
                if request.get("speed"):
                    config.speed = float(request["speed"])
                capture_doc = whatif_mod.load_capture(
                    whatif_mod.resolve_capture_source(source),
                    allow_mismatch=True,
                )
                kind = str(request.get("kind") or "ab")
                if kind == "run":
                    result = whatif_mod.run_whatif(
                        capture_doc,
                        whatif_mod.StackConfig.parse(
                            str(request.get("arm") or ""), name="a"
                        ),
                        config,
                    )
                elif kind == "ab":
                    result = whatif_mod.run_ab(
                        capture_doc,
                        whatif_mod.StackConfig.parse(
                            str(request.get("a") or "shards=1"),
                            name="a",
                        ),
                        whatif_mod.StackConfig.parse(
                            str(request.get("b") or "shards=8"),
                            name="b",
                        ),
                        config,
                    )
                else:
                    self._error(400, f"unknown kind {kind!r}")
                    return
            except (ValueError, FileNotFoundError, OSError) as exc:
                self._error(400, f"whatif failed: {exc}")
                return
            except Exception as exc:  # noqa: BLE001 — reply, don't wedge
                logger.exception("admin whatif failed")
                self._error(500, f"error: {exc}")
                return
            self._reply_json(
                200,
                {
                    "source": source,
                    "summary": whatif_mod._summarize(result),
                },
            )

        @staticmethod
        def _wants_explain(query) -> bool:
            return query.get("explain", "").lower() in ("1", "true", "yes")

        @staticmethod
        def _cluster_rpc_rollup(spans) -> Optional[Dict[str, dict]]:
            """Per-replica rollup of a trace's ``cluster.rpc`` spans —
            which owner dominated this score (docs/observability.md
            "Fleet tracing")."""
            rollup: Dict[str, dict] = {}
            for view in spans:
                if view["name"] != "cluster.rpc":
                    continue
                replica = str(
                    view["attributes"].get("replica", "unknown")
                )
                entry = rollup.setdefault(
                    replica, {"rpcs": 0, "total_ms": 0.0, "errors": 0}
                )
                entry["rpcs"] += 1
                entry["total_ms"] = round(
                    entry["total_ms"] + view["duration_ms"], 3
                )
                if view["status"] != "ok":
                    entry["errors"] += 1
            return rollup or None

        def _run_scored(self, name, query, score_kwargs, plan=False):
            """Shared scoring execution: trace lifecycle (traceparent
            ingest/echo, ``?explain=1`` forcing a sample), the explain
            response shape, and error accounting.  ``score_kwargs`` are
            handed to ``Indexer.get_pod_scores[_explained|_planned]``;
            ``plan`` opts the request into the transfer-directive
            channel (the planned scoring variant, docs/transfer.md)."""
            explain = self._wants_explain(query)
            req_trace = TRACER.start_trace(
                name,
                traceparent=self.headers.get("traceparent"),
                force=explain,
            )
            started = time.perf_counter()
            directive = None
            try:
                with use_trace(req_trace):
                    if explain:
                        scores, detail = (
                            indexer.get_pod_scores_explained(**score_kwargs)
                        )
                    elif plan:
                        scores, directive = (
                            indexer.get_pod_scores_planned(**score_kwargs)
                        )
                        detail = None
                    else:
                        scores, detail = (
                            indexer.get_pod_scores(**score_kwargs),
                            None,
                        )
            except Exception as exc:
                # The SLO feeds see FAILED requests too: a fully
                # failing service must burn the availability SLI, not
                # read as a no-data latency SLI (obs/slo.py).
                METRICS.score_latency.observe(
                    time.perf_counter() - started
                )
                METRICS.score_requests.labels(outcome="error").inc()
                if req_trace is not None:
                    req_trace.set_error(repr(exc))
                    req_trace.finish("error")
                logger.exception("%s failed", name)
                self._error(500, f"error: {exc}")
                return
            elapsed = time.perf_counter() - started
            headers: Dict[str, str] = {}
            if req_trace is not None:
                # Finish BEFORE replying so the trace is retrievable
                # from /debug/traces the moment the client sees the
                # echoed traceparent.
                req_trace.finish()
                headers["traceparent"] = req_trace.traceparent()
            # Every request feeds the SLO latency/availability SLIs —
            # unsampled, unlike the trace-fed stage histogram
            # (obs/slo.py); the observations sit outside the trace
            # window so they cannot widen the stage-sum gap the
            # acceptance tests pin.
            METRICS.score_latency.observe(elapsed)
            METRICS.score_requests.labels(outcome="ok").inc()
            if not explain:
                if plan:
                    # The directive rides the scoring response: the
                    # scheduler routes to the directive's target with a
                    # fetch instruction, or falls back to the scores.
                    self._reply_json(
                        200,
                        {"scores": scores, "transfer": directive},
                        headers,
                    )
                    return
                self._reply_json(200, scores, headers)
                return
            # explain forces sampling, so req_trace is always live here.
            trace_view = req_trace.to_dict(include_spans=True)
            detail = dict(detail)
            detail["trace_id"] = req_trace.trace_id
            detail["duration_ms"] = trace_view["duration_ms"]
            detail["stages"] = trace_view["stages"]
            cluster_rpcs = self._cluster_rpc_rollup(trace_view["spans"])
            if cluster_rpcs is not None:
                detail["cluster_rpcs"] = cluster_rpcs
            self._reply_json(
                200, {"scores": scores, "explain": detail}, headers
            )

        def _parse_pod_loads(self, request):
            """Optional ``pod_loads`` field: {pod: queue_depth}.
            Returns (ok, loads_or_None); replies 400 itself on a
            malformed field."""
            raw = request.get("pod_loads")
            if raw is None:
                return True, None
            if not isinstance(raw, dict):
                self._error(400, "field 'pod_loads' must be an object")
                return False, None
            loads = {}
            for pod, depth in raw.items():
                try:
                    loads[str(pod)] = float(depth)
                except (TypeError, ValueError):
                    self._error(
                        400, "field 'pod_loads' values must be numbers"
                    )
                    return False, None
            return True, loads

        def _score_completions(self, query):
            request = self._read_json()
            if request is None:
                return
            prompt = request.get("prompt", "")
            if not prompt:
                self._error(400, "field 'prompt' required")
                return
            ok, pod_loads = self._parse_pod_loads(request)
            if not ok:
                return
            self._run_scored(
                "http.score_completions",
                query,
                dict(
                    prompt=prompt,
                    model_name=request.get("model", ""),
                    pod_identifiers=request.get("pods"),
                    pod_loads=pod_loads,
                ),
                plan=bool(request.get("plan")),
            )

        def _score_chat_completions(self, query):
            request = self._read_json()
            if request is None:
                return
            messages = request.get("messages")
            if not messages:
                self._error(400, "field 'messages' required")
                return
            model = request.get("model", "")
            render_req = ApplyChatTemplateRequest(
                conversation=messages,
                tools=request.get("tools"),
                documents=request.get("documents"),
                chat_template=request.get("chat_template"),
                add_generation_prompt=request.get(
                    "add_generation_prompt", True
                ),
                continue_final_message=request.get(
                    "continue_final_message", False
                ),
                chat_template_kwargs=request.get("chat_template_kwargs"),
                model=model,
            )
            ok, pod_loads = self._parse_pod_loads(request)
            if not ok:
                return
            self._run_scored(
                "http.score_chat_completions",
                query,
                dict(
                    prompt="",
                    model_name=model,
                    pod_identifiers=request.get("pods"),
                    render_req=render_req,
                    pod_loads=pod_loads,
                ),
                plan=bool(request.get("plan")),
            )

    return Handler


class _NamedThreadingHTTPServer(http.server.ThreadingHTTPServer):
    """ThreadingHTTPServer whose per-connection handler threads carry
    the stable ``kvtpu-http-handler`` role name instead of the stock
    anonymous ``Thread-N`` — the profiler attributes request-handling
    wall time by it (docs/observability.md "Thread roles")."""

    def process_request_thread(self, request, client_address):
        threading.current_thread().name = "kvtpu-http-handler"
        super().process_request_thread(request, client_address)


def serve(
    indexer: Indexer,
    host: str = "0.0.0.0",
    port: int = 8080,
    admin_token: Optional[str] = None,
    persistence=None,
    recovery_report=None,
    event_plane_status=None,
    auditor=None,
    tiering=None,
    transfer=None,
    replica=None,
    cluster_status=None,
    slo=None,
    profiler=None,
    timeline=None,
    capture=None,
    incidents=None,
) -> http.server.ThreadingHTTPServer:
    """Start the HTTP service on a background thread; returns the server
    (call ``.shutdown()`` to stop).  ``admin_token`` (env:
    ``ADMIN_TOKEN``) gates ``/admin/*``; without one, admin calls are
    accepted from loopback only.  ``persistence`` (a
    ``PersistenceManager``) enables ``POST /admin/snapshot`` and the
    persistence block in ``/healthz``; ``recovery_report`` surfaces the
    startup recovery outcome there too; ``event_plane_status`` (a
    zero-arg callable) adds the event-plane block.  The indexer's
    hit-attribution ledger (``indexer.cache_stats``) backs
    ``GET /debug/cachestats`` and the ``/healthz`` analytics block;
    ``auditor`` (an ``analytics.IndexAuditor``) adds the index-truth
    audit plane to both; ``tiering`` (a ``tiering.PolicyEngine``)
    backs ``GET /debug/tiering`` and the ``/healthz`` tiering block;
    ``transfer`` (a ``transfer.TransferEngine``) backs
    ``GET /debug/transfer``, the ``/healthz`` transfer block, and the
    scoring requests' ``plan``/``pod_loads`` fields
    (docs/transfer.md); ``replica`` (a ``cluster.ClusterReplica``)
    serves the
    ``POST /replica`` RPC surface and ``cluster_status`` (a zero-arg
    callable) backs ``GET /debug/cluster`` (docs/replication.md);
    ``slo`` (an ``obs.slo.SloEngine``) backs ``GET /debug/slo`` and
    the ``/healthz`` degradation-envelope block; ``profiler`` (an
    ``obs.SamplingProfiler``) backs ``GET /debug/profile`` and
    ``timeline`` (an ``obs.GaugeTimeline``) ``GET /debug/timeline``;
    ``capture`` (an ``obs.InputCaptureRecorder``) and ``incidents``
    (an ``obs.IncidentManager``) back ``GET /debug/incidents``,
    ``POST /admin/incident`` and the ``/healthz`` capture block —
    ``GET /debug/`` indexes every surface (docs/observability.md)."""
    server = _NamedThreadingHTTPServer(
        (host, port),
        _make_handler(
            indexer,
            admin_token=admin_token,
            persistence=persistence,
            recovery_report=recovery_report,
            event_plane_status=event_plane_status,
            auditor=auditor,
            tiering=tiering,
            transfer=transfer,
            replica=replica,
            cluster_status=cluster_status,
            slo=slo,
            profiler=profiler,
            timeline=timeline,
            capture=capture,
            incidents=incidents,
        ),
    )
    thread = threading.Thread(
        target=server.serve_forever,
        name="kvtpu-http-service",
        daemon=True,
    )
    thread.start()
    logger.info("http scoring service listening on %s:%d", host, port)
    return server


def main() -> None:  # pragma: no cover - CLI entry
    """Env-configured standalone service: indexer + event subscription
    (the reference's online example, main.go:93-148)."""
    from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import IndexerConfig
    from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import (
        IndexConfig,
        InMemoryIndexConfig,
        RedisIndexConfig,
    )
    from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.token_processor import (
        TokenProcessorConfig,
    )
    from llm_d_kv_cache_manager_tpu_torch.kvevents.pool import Pool, PoolConfig
    from llm_d_kv_cache_manager_tpu_torch.kvevents.subscriber_manager import (
        SubscriberManager,
    )
    from llm_d_kv_cache_manager_tpu_torch.metrics.collector import (
        start_metrics_logging,
    )
    from llm_d_kv_cache_manager_tpu_torch.tokenization.pool import (
        TokenizationPoolConfig,
    )

    config = IndexerConfig(
        token_processor_config=TokenProcessorConfig(
            block_size=int(os.environ.get("BLOCK_SIZE", "16")),
            hash_seed=os.environ.get("PYTHONHASHSEED", ""),
        ),
        kvblock_index_config=IndexConfig(
            enable_metrics=os.environ.get("ENABLE_METRICS", "true").lower()
            != "false",
            # Lock stripes for the in-memory backend (ignored for
            # Redis); power of two, docs/performance.md.
            in_memory_config=InMemoryIndexConfig(
                shards=int(os.environ.get("INDEX_SHARDS", "8"))
            ),
            # e.g. INDEX_BACKEND=valkey://valkey:6379 selects the shared
            # distributed index; unset keeps the in-memory backend.
            redis_config=(
                RedisIndexConfig(
                    address=os.environ["INDEX_BACKEND"],
                    tls_ca_file=os.environ.get("INDEX_TLS_CA_FILE")
                    or None,
                    tls_insecure_skip_verify=os.environ.get(
                        "INDEX_TLS_INSECURE", ""
                    ).lower()
                    in ("1", "true", "yes"),
                )
                if os.environ.get("INDEX_BACKEND")
                else None
            ),
        ),
        tokenizers_pool_config=TokenizationPoolConfig(
            model_name=os.environ.get("MODEL_NAME", "")
        ),
        local_tokenizers_dir=os.environ.get("LOCAL_TOKENIZER_DIR") or None,
        uds_tokenizer_path=os.environ.get("UDS_TOKENIZER_PATH") or None,
        # read_path_fast_lane stays None here: the Indexer resolves the
        # READ_PATH_FAST_LANE env knob itself (docs/performance.md).
        lookup_chunk_size=int(
            os.environ.get("READ_PATH_LOOKUP_CHUNK", "32")
        ),
    )
    # CLUSTER_REPLICAS makes this process a cluster ROUTER: the local
    # backend selection is replaced by a RemoteIndex fanning out to the
    # configured replicas over HTTP (docs/replication.md).  The rest of
    # the stack — scoring, kvevents pool, analytics, tiering — works
    # unchanged against the remote backend.
    cluster_membership = None
    cluster_heartbeat = None
    cluster_remote_index = None
    injected_index = None
    if os.environ.get("CLUSTER_REPLICAS"):
        from llm_d_kv_cache_manager_tpu_torch.cluster import (
            ClusterMembership,
            HeartbeatMonitor,
            RemoteIndex,
        )
        from llm_d_kv_cache_manager_tpu_torch.cluster.replica import (
            HttpReplicaTransport,
        )

        transports = {}
        for pair in os.environ["CLUSTER_REPLICAS"].split(","):
            replica_id, _, url = pair.strip().partition("=")
            if not replica_id or not url:
                raise ValueError(
                    "CLUSTER_REPLICAS expects id=url[,id=url...]; got "
                    f"{pair!r}"
                )
            transports[replica_id] = HttpReplicaTransport(
                url, token=os.environ.get("ADMIN_TOKEN")
            )
        cluster_membership = ClusterMembership(transports)
        cluster_heartbeat = HeartbeatMonitor(
            cluster_membership,
            interval_s=float(os.environ.get("CLUSTER_HEARTBEAT_S", "2")),
            misses=int(os.environ.get("CLUSTER_HEARTBEAT_MISSES", "2")),
        )
        cluster_heartbeat.start()
        # Explicit env resolution for the fan-out knobs (the
        # RemoteIndex would resolve them itself; naming them here
        # keeps the router's tuning surface discoverable —
        # docs/configuration.md): CLUSTER_FANOUT_WORKERS (0 =
        # sequential parity oracle), CLUSTER_FANOUT_BUDGET_S (whole
        # fan-out deadline across re-routes), CLUSTER_VV_TTL_S
        # (version-vector staleness bound for the score memo),
        # CLUSTER_OVERLAP_MIN_RPC_S (adaptive-arming latency
        # threshold; 0 forces overlap always-on).
        from llm_d_kv_cache_manager_tpu_torch.cluster.remote_index import (
            resolve_fanout_budget_env,
            resolve_fanout_workers_env,
            resolve_overlap_min_rpc_env,
            resolve_vv_ttl_env,
        )

        cluster_remote_index = RemoteIndex(
            cluster_membership,
            fanout_workers=resolve_fanout_workers_env(),
            fanout_budget_s=resolve_fanout_budget_env(),
            vv_ttl_s=resolve_vv_ttl_env(),
            overlap_min_rpc_s=resolve_overlap_min_rpc_env(),
        )
        injected_index = cluster_remote_index
        if config.kvblock_index_config.enable_metrics:
            from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.instrumented import (  # noqa: E501 - lazy: mirrors new_index's wrap
                InstrumentedIndex,
            )

            injected_index = InstrumentedIndex(injected_index)

    # CAPTURE (default on) wires the input flight recorder
    # (obs/capture.py): the kvevents pool and the indexer tap every
    # ingress message/scored request into bounded rings
    # (CAPTURE_WINDOW_S / CAPTURE_MAX_BYTES) that incident bundles
    # snapshot and obs/replay.py re-drives.  CAPTURE=0 is fully inert:
    # no recorder object, no ring, no thread — the taps see None.
    from llm_d_kv_cache_manager_tpu_torch.obs.capture import (
        CaptureConfig,
        InputCaptureRecorder,
        capture_enabled_env,
        set_build_info_metric,
    )

    set_build_info_metric()
    capture = None
    if capture_enabled_env():
        capture = InputCaptureRecorder(
            CaptureConfig.from_env(),
            meta={
                "block_size": config.token_processor_config.block_size,
                "hash_seed": config.token_processor_config.hash_seed,
                "model": os.environ.get("MODEL_NAME", ""),
            },
        )

    indexer = Indexer(
        config, kv_block_index=injected_index, capture_recorder=capture
    )
    indexer.run()

    # CLUSTER_SELF makes this process a cluster REPLICA: the local
    # index (built from the normal backend config above) serves the
    # POST /replica RPC surface, journals applied ops for replication
    # (CLUSTER_JOURNAL_DIR), and tails its peers' journals for the
    # standby slice (CLUSTER_FOLLOW, filtered by CLUSTER_MEMBERS).
    cluster_replica = None
    cluster_followers = []
    if os.environ.get("CLUSTER_SELF"):
        from llm_d_kv_cache_manager_tpu_torch.cluster import (
            ClusterReplica,
            ReplicationFollower,
            standby_record_filter,
        )
        from llm_d_kv_cache_manager_tpu_torch.cluster.ring import HashRing
        from llm_d_kv_cache_manager_tpu_torch.persistence.journal import Journal

        replica_journal = None
        if os.environ.get("CLUSTER_JOURNAL_DIR"):
            replica_journal = Journal(os.environ["CLUSTER_JOURNAL_DIR"])
        cluster_replica = ClusterReplica(
            os.environ["CLUSTER_SELF"],
            index=indexer.kv_block_index,
            journal=replica_journal,
            journal_retain_segments=int(
                os.environ.get("CLUSTER_JOURNAL_RETAIN", "64")
            ),
        )
        record_filter = None
        members_ring = None
        members_raw = os.environ.get("CLUSTER_MEMBERS", "")
        if members_raw:
            members_ring = HashRing(
                [m.strip() for m in members_raw.split(",") if m.strip()]
            )
            record_filter = standby_record_filter(
                members_ring, cluster_replica.replica_id
            )
        for pair in (os.environ.get("CLUSTER_FOLLOW") or "").split(","):
            if not pair.strip():
                continue
            peer, _, directory = pair.strip().partition("=")
            if not peer or not directory:
                raise ValueError(
                    "CLUSTER_FOLLOW expects peer=journal_dir[,...]; "
                    f"got {pair!r}"
                )
            follower = ReplicationFollower(
                peer,
                directory,
                indexer.kv_block_index,
                record_filter=record_filter,
                poll_interval_s=float(
                    os.environ.get("CLUSTER_FOLLOW_POLL_S", "0.2")
                ),
                # Scope the peer's purge replays to its primary slice
                # (needs the full member ring; unscoped otherwise).
                purge_scope=(
                    (
                        lambda key, peer=peer, ring=members_ring: (
                            ring.owner(key) == peer
                        )
                    )
                    if members_ring is not None
                    else None
                ),
            )
            follower.start()
            cluster_followers.append(follower)

    cluster_status = None
    if cluster_membership is not None or cluster_replica is not None:
        def cluster_status() -> dict:
            status = {
                "role": "router" if cluster_membership else "replica"
            }
            if cluster_membership is not None:
                status["membership"] = cluster_membership.status()
            if cluster_remote_index is not None:
                # Per-replica fan-out attribution + the sequential
                # critical-path breakdown (docs/observability.md).
                status["rpc"] = cluster_remote_index.rpc_stats()
            if cluster_replica is not None:
                status["replica"] = cluster_replica.replica_id
            if cluster_followers:
                status["replication"] = [
                    f.status() for f in cluster_followers
                ]
            return status

    # TIERING=1 attaches the predictive-tiering policy engine
    # (docs/tiering.md): the scoring stream feeds its PolicyFeed,
    # explain carries compute-or-load advice, and /debug/tiering
    # exposes the policy plane.  The demotion worker needs a pod-side
    # target, so the standalone indexer runs without one.
    policy_engine = None
    if os.environ.get("TIERING", "").lower() in ("1", "true", "yes"):
        from llm_d_kv_cache_manager_tpu_torch.tiering import PolicyEngine

        policy_engine = PolicyEngine(ledger=indexer.cache_stats)
        indexer.set_policy_engine(policy_engine)

    # TRANSFER=1 attaches the KV-transfer planning plane
    # (docs/transfer.md): scoring requests carrying pod_loads/plan get
    # transfer directives, executed transfers publish real KVEvents
    # through the pool (attached below, after the pool exists), and
    # /debug/transfer exposes the plane.  Shares the tiering advisor
    # when TIERING=1 so both planes price from one RTT model.
    transfer_engine = None
    if os.environ.get("TRANSFER", "").lower() in ("1", "true", "yes"):
        from llm_d_kv_cache_manager_tpu_torch.transfer import TransferEngine

        transfer_engine = TransferEngine(
            advisor=(
                policy_engine.advisor
                if policy_engine is not None
                else None
            ),
            ledger=indexer.cache_stats,
        )
        indexer.set_transfer_engine(transfer_engine)

    # PERSISTENCE_DIR enables warm restarts: recover the index from the
    # last snapshot + journal tail BEFORE the event pool starts, then
    # journal every applied event and snapshot periodically.
    persistence = None
    recovery_report = None
    stop_snapshots = None
    if os.environ.get("PERSISTENCE_DIR"):
        from llm_d_kv_cache_manager_tpu_torch.persistence import (
            PersistenceConfig,
            PersistenceManager,
        )

        persistence = PersistenceManager(
            PersistenceConfig(
                directory=os.environ["PERSISTENCE_DIR"],
                journal_fsync=os.environ.get(
                    "PERSISTENCE_FSYNC", ""
                ).lower()
                in ("1", "true", "yes"),
            )
        )
        recovery_report = persistence.recover(indexer.kv_block_index)
        stop_snapshots = persistence.start_auto_snapshot(
            indexer.kv_block_index,
            float(os.environ.get("PERSISTENCE_SNAPSHOT_INTERVAL", "300")),
        )

    pool = Pool(
        indexer.kv_block_index,
        indexer.token_processor,
        PoolConfig(
            concurrency=int(os.environ.get("POOL_CONCURRENCY", "4")),
            apply_batch_size=int(
                os.environ.get("KVEVENTS_APPLY_BATCH", "32")
            ),
            # Per-pod flow control (docs/event-plane.md): in-flight
            # budget per pod, fairness-aware shedding.  0/unset budget
            # -> whole-shard depth (budget engages only at overflow);
            # the 0 case must map to None here or PoolConfig would
            # clamp it to a 1-message budget.
            pod_budget=(
                int(os.environ.get("KVEVENTS_POD_BUDGET") or 0) or None
            ),
            per_pod_flow_control=os.environ.get(
                "KVEVENTS_POD_FLOW", "1"
            ).lower()
            not in ("0", "false", "no"),
        ),
        journal=persistence.journal if persistence else None,
        capture=capture,
    )
    pool.start()
    if transfer_engine is not None:
        # The directive channel's write side: executed transfers (and
        # cold-pod warm-up) publish through this pool, so every move
        # lands in the index/ledger/journal via the ordinary
        # decode/apply path.
        transfer_engine.attach_executor(
            indexer.kv_block_index,
            pool,
            os.environ.get("MODEL_NAME", ""),
        )
    # Gap-driven anti-entropy (docs/event-plane.md): a wire-level seq
    # gap marks the pod suspect and triggers purge + inventory
    # re-apply.  Without a fleet inventory surface the default "purge"
    # mode uses the empty source (purge-only repair); "off" disables.
    resync = None
    if os.environ.get("KVEVENTS_GAP_RESYNC", "purge").lower() not in (
        "off",
        "0",
        "false",
        "no",
    ):
        from llm_d_kv_cache_manager_tpu_torch.kvevents.resync import (
            EmptyInventorySource,
            ResyncManager,
        )

        resync = ResyncManager(pool, EmptyInventorySource())
        resync.start()
    # Two event-ingestion modes (reference online example supports both):
    # - POD_DISCOVERY=true: watch the k8s API and dial out to each serving
    #   pod's ZMQ socket (needs the pod list/watch RBAC grant);
    # - default: bind one global SUB socket engines connect to.
    discover = os.environ.get("POD_DISCOVERY", "").lower() in (
        "1",
        "true",
        "yes",
    )
    manager = SubscriberManager(
        sink=pool.add_task,
        # Batched fast-lane delivery: each poller burst is one
        # enqueue + one lock-free pre-decode pass (event-plane.md).
        sink_batch=pool.add_tasks,
        bind=not discover,
        on_gap=resync.gap_listener if resync else None,
    )
    # CLUSTER_LOCAL_INGEST=1 (replica mode + discovery): this replica
    # subscribes to only its pod slice of the fleet — the event plane's
    # write throughput then scales with the replica count instead of
    # funneling through one process (docs/event-plane.md).  The
    # reconciler announces the whole fleet; the ingestor slices it over
    # the member ring and re-slices on ring changes.
    ingestor = None
    if os.environ.get("CLUSTER_LOCAL_INGEST", "").lower() in (
        "1",
        "true",
        "yes",
    ):
        members_raw = os.environ.get("CLUSTER_MEMBERS", "")
        self_id = os.environ.get("CLUSTER_SELF", "")
        if not (
            discover
            and members_raw
            and self_id
            and cluster_membership is not None
        ):
            # CLUSTER_REPLICAS (the router wiring) is load-bearing,
            # not optional: it injects the RemoteIndex the pool
            # applies through (pod-sliced subscriptions + KEY-sliced
            # applies compose only then — a local backend would strand
            # ~(N-1)/N of claims on the wrong replica) and provides
            # the membership whose ring bumps drive re-slicing.
            logger.warning(
                "CLUSTER_LOCAL_INGEST needs POD_DISCOVERY, "
                "CLUSTER_SELF, CLUSTER_MEMBERS and CLUSTER_REPLICAS "
                "(the RemoteIndex apply path + ring membership); "
                "ignoring"
            )
        else:
            from llm_d_kv_cache_manager_tpu_torch.cluster.ingest import (
                ReplicaIngestor,
            )
            from llm_d_kv_cache_manager_tpu_torch.cluster.ring import HashRing

            ingestor = ReplicaIngestor(
                self_id,
                manager,
                ring=HashRing(
                    [
                        m.strip()
                        for m in members_raw.split(",")
                        if m.strip()
                    ]
                ),
                membership=cluster_membership,
                resync=resync,
            )

    reconciler = None
    if discover:
        from llm_d_kv_cache_manager_tpu_torch.kvevents.pod_reconciler import (
            DEFAULT_LABEL_SELECTOR,
            PodReconciler,
            PodReconcilerConfig,
        )

        reconciler = PodReconciler(
            ingestor if ingestor is not None else manager,
            PodReconcilerConfig(
                namespace=os.environ.get("POD_NAMESPACE") or None,
                label_selector=os.environ.get(
                    "POD_LABEL_SELECTOR", DEFAULT_LABEL_SELECTOR
                ),
                socket_port=int(os.environ.get("POD_SOCKET_PORT", "5557")),
                topic_filter=os.environ.get("ZMQ_TOPIC", "kv@"),
                # Out-of-cluster override (local runs / tests); in-cluster
                # the service-account environment is discovered.
                api_server=os.environ.get("POD_API_SERVER") or None,
                token=os.environ.get("POD_API_TOKEN") or None,
            ),
        )
        reconciler.start()
    else:
        endpoint = os.environ.get("ZMQ_ENDPOINT", "tcp://*:5557")
        manager.ensure_subscriber(
            "global",
            endpoint,
            topic_filter=os.environ.get("ZMQ_TOPIC", "kv@"),
        )

    stop_beat = start_metrics_logging(
        float(os.environ.get("METRICS_LOGGING_INTERVAL", "60"))
    )

    # Continuous profiling plane (docs/observability.md): the
    # always-on sampling profiler (PROFILE_HZ, 0 = fully inert), gc
    # pause accounting, and the 1s gauge timeline rings
    # (TIMELINE_WINDOW_S, 0 disables) feeding /debug/profile and
    # /debug/timeline.  Lock-contention timing arms itself from
    # LOCK_CONTENTION_SAMPLE at lock construction (utils/lockorder.py).
    from llm_d_kv_cache_manager_tpu_torch.metrics.collector import (
        install_gc_metrics,
    )
    from llm_d_kv_cache_manager_tpu_torch.obs.profiler import PROFILER
    from llm_d_kv_cache_manager_tpu_torch.obs.timeline import (
        GaugeTimeline,
        register_default_series,
    )

    install_gc_metrics()
    PROFILER.start()
    timeline = GaugeTimeline()
    register_default_series(
        timeline,
        pool=pool,
        remote_index=cluster_remote_index,
        resync=resync,
    )
    timeline.start()

    # SLO_ENABLE (default on) attaches the degradation-envelope engine
    # (obs/slo.py): the stock fleet SLIs are fed from existing metric
    # surfaces, evaluated over a fast and a slow window, and published
    # at GET /debug/slo + the /healthz slo block.
    slo_engine = None
    if os.environ.get("SLO_ENABLE", "1").lower() not in (
        "0",
        "false",
        "off",
        "no",
    ):
        from llm_d_kv_cache_manager_tpu_torch.obs.slo import default_fleet_slos

        slo_engine = default_fleet_slos(
            window_fast_s=float(
                os.environ.get("SLO_WINDOW_FAST_S", "300")
            ),
            window_slow_s=float(
                os.environ.get("SLO_WINDOW_SLOW_S", "3600")
            ),
            score_latency_s=(
                float(os.environ.get("SLO_SCORE_LATENCY_MS", "250"))
                / 1000.0
            ),
            hit_rate_objective=float(
                os.environ.get("SLO_HIT_RATE_OBJECTIVE", "0")
            ),
            membership=cluster_membership,
            pool=pool,
        )
        slo_engine.start(float(os.environ.get("SLO_POLL_S", "5")))

    # Incident bundler (obs/capture.py): subscribes to the SLO
    # engine's overall-state transitions — healthy→violated dumps the
    # capture window plus every other debug surface into one versioned
    # bundle under INCIDENT_DIR, rate-limited by
    # INCIDENT_MIN_INTERVAL_S and pruned to INCIDENT_KEEP;
    # POST /admin/incident forces one (docs/observability.md).
    incidents = None
    if capture is not None:
        from llm_d_kv_cache_manager_tpu_torch.obs.capture import (
            IncidentManager,
        )
        from llm_d_kv_cache_manager_tpu_torch.utils import lockorder

        incident_sources = {
            "traces": lambda: {
                "stats": TRACER.stats(),
                "slow": [
                    t.to_dict() for t in TRACER.recorder.slow(20)
                ],
                "errored": [
                    t.to_dict() for t in TRACER.recorder.errored(20)
                ],
                "recent": [
                    t.to_dict(include_spans=False)
                    for t in TRACER.recorder.recent(50)
                ],
            },
            "profile": lambda: {
                "profiler": (
                    PROFILER.status(top=30)
                    if PROFILER.config.hz > 0
                    else {"disabled": True}
                ),
                "locks": lockorder.contention_stats(),
            },
            "timeline": lambda: (
                timeline.snapshot()
                if timeline.window_s > 0
                else {"disabled": True}
            ),
        }
        if cluster_status is not None:
            incident_sources["cluster"] = cluster_status
        if slo_engine is not None:
            incident_sources["slo"] = (
                lambda: slo_engine.last_payload() or {"no_data": True}
            )
        incidents = IncidentManager(
            os.environ.get("INCIDENT_DIR", "incidents"),
            capture=capture,
            sources=incident_sources,
            index=indexer.kv_block_index,
            keep=int(os.environ.get("INCIDENT_KEEP", "8")),
            min_interval_s=float(
                os.environ.get("INCIDENT_MIN_INTERVAL_S", "60")
            ),
        )
        if slo_engine is not None:
            slo_engine.add_listener(incidents.slo_listener())

    def event_plane_status() -> dict:
        status = {
            "pollers": manager.poller_count(),
            "subscriptions": len(manager.active_pods()),
        }
        if resync is not None:
            status["resync"] = resync.stats()
        if ingestor is not None:
            status["local_ingest"] = ingestor.status()
        status["stages"] = pool.stage_stats()
        return status

    server = serve(
        indexer,
        port=int(os.environ.get("HTTP_PORT", "8080")),
        admin_token=os.environ.get("ADMIN_TOKEN"),
        persistence=persistence,
        recovery_report=recovery_report,
        event_plane_status=event_plane_status,
        tiering=policy_engine,
        transfer=transfer_engine,
        replica=cluster_replica,
        cluster_status=cluster_status,
        slo=slo_engine,
        profiler=PROFILER,
        timeline=timeline,
        capture=capture,
        incidents=incidents,
    )
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        stop_beat.set()
        timeline.close()
        PROFILER.close()
        if slo_engine is not None:
            slo_engine.close()
        if stop_snapshots is not None:
            stop_snapshots.set()
        server.shutdown()
        if reconciler is not None:
            reconciler.stop()
        manager.shutdown()
        if resync is not None:
            resync.close()
        pool.shutdown()
        if persistence is not None:
            # Parting snapshot: the next start recovers warm even if
            # the periodic beat never fired.
            try:
                persistence.snapshot(indexer.kv_block_index)
            except Exception:  # noqa: BLE001 - best-effort on the way out
                logger.exception("shutdown snapshot failed")
            persistence.close()
        if cluster_heartbeat is not None:
            cluster_heartbeat.close()
        if cluster_remote_index is not None:
            cluster_remote_index.close()
        for follower in cluster_followers:
            follower.close()
        if cluster_replica is not None:
            cluster_replica.close()
        if transfer_engine is not None:
            transfer_engine.close()
        if policy_engine is not None:
            policy_engine.close()
        indexer.shutdown()


if __name__ == "__main__":  # pragma: no cover
    main()
