"""The port's tracing debug surface (``api/http_service.py``,
``obs/trace.py``) against the JAX package's, on the CPU.

Every case of the reference's ``tests/test_debug_surface.py`` runs on
both packages (``m`` is either one's names) through that package's own
``serve()`` (and, for ``TestGrpcTraceparent``, its gRPC ``serve``): a scored request with a sampled
traceparent yields a retrievable trace whose spans cover templating,
tokenization, hashing, index lookup and scoring, with stage durations
summing to about the end-to-end latency; ``explain=1`` names the block
index where each pod's prefix chain broke; parallel traced requests lose
and duplicate nothing; ``/healthz`` carries the observability block;
a sampled traceparent in gRPC metadata is echoed in the initial metadata
and its trace is retrievable over HTTP.
"""

from __future__ import annotations

import gc
import json
import os
import tempfile
import threading
import time
import urllib.error
import urllib.request

import pytest

from tests.helpers.tiny_tokenizer import (
    build_transformers_tokenizer,
    save_tokenizer_json,
)

from llm_d_kv_cache_manager_tpu.api import http_service as ref_http_service
from llm_d_kv_cache_manager_tpu.api import indexer_pb2 as ref_indexer_pb2
from llm_d_kv_cache_manager_tpu.api import indexer_service as ref_indexer_service
from llm_d_kv_cache_manager_tpu.kvcache import indexer as ref_indexer
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as ref_token_processor
from llm_d_kv_cache_manager_tpu.kvevents import events as ref_events
from llm_d_kv_cache_manager_tpu.kvevents import pool as ref_kvevents_pool
from llm_d_kv_cache_manager_tpu.obs import trace as ref_trace
from llm_d_kv_cache_manager_tpu.tokenization import pool as ref_tokenization_pool
from llm_d_kv_cache_manager_tpu.tokenization import tokenizers as ref_tokenizers
from tests.helpers.torch_port import namespace, port

SIDES = ("ref", "port")
_REF = {
    "api.http_service": ref_http_service,
    "kvcache.indexer": ref_indexer,
    "kvcache.kvblock.token_processor": ref_token_processor,
    "kvevents.events": ref_events,
    "kvevents.pool": ref_kvevents_pool,
    "obs.trace": ref_trace,
    "tokenization.pool": ref_tokenization_pool,
    "tokenization.tokenizers": ref_tokenizers,
}
_NAMES = {
    "api.http_service": ("serve",),
    "kvcache.indexer": ("Indexer", "IndexerConfig"),
    "kvcache.kvblock.token_processor": ("TokenProcessorConfig",),
    "kvevents.events": ("BlockStored", "EventBatch"),
    "kvevents.pool": ("Message", "Pool", "PoolConfig"),
    "obs.trace": ("TRACER",),
    "tokenization.pool": ("TokenizationPoolConfig",),
    "tokenization.tokenizers": ("LocalFastTokenizer",),
}


@pytest.fixture(params=SIDES)
def m(request):
    return namespace(request.param, _REF, _NAMES)


MODEL = "test-model"
BLOCK_SIZE = 4
SENTENCE = "the quick brown fox jumps over the lazy dog . "


def sampled_tp(seed: int) -> str:
    return f"00-{seed:032x}-{(seed | 1):016x}-01"


class Fleet:
    def __init__(self, m, indexer, event_pool, base_url):
        self.m = m
        self.indexer = indexer
        self.event_pool = event_pool
        self.base_url = base_url
        self._next_hash = 0x1000

    def publish(self, pod, tokens, parent=None, medium="hbm"):
        n_blocks = len(tokens) // BLOCK_SIZE
        hashes = [self._next_hash + i for i in range(n_blocks)]
        self._next_hash += n_blocks
        m = self.m
        batch = m.EventBatch(
            ts=1.0,
            events=[
                m.BlockStored(
                    block_hashes=hashes,
                    parent_block_hash=parent,
                    token_ids=tokens[: n_blocks * BLOCK_SIZE],
                    block_size=BLOCK_SIZE,
                    medium=medium,
                )
            ],
        )
        self.event_pool.add_task(
            m.Message(
                topic=f"kv@{pod}@{MODEL}",
                payload=batch.encode(),
                pod_identifier=pod,
                model_name=MODEL,
            )
        )
        self.event_pool.drain()
        return hashes

    def tokenize(self, prompt):
        return self.indexer.tokenization_pool.tokenize(prompt, MODEL, None)

    def post(self, path, obj, headers=None):
        request = urllib.request.Request(
            self.base_url + path,
            data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json", **(headers or {})},
            method="POST",
        )
        with urllib.request.urlopen(request, timeout=30) as response:
            return dict(response.headers), json.load(response)

    def get(self, path):
        with urllib.request.urlopen(
            self.base_url + path, timeout=30
        ) as response:
            return json.load(response)


@pytest.fixture()
def fleet(m, tmp_path):
    tokenizer_dir = save_tokenizer_json(str(tmp_path), MODEL)
    indexer = m.Indexer(
        m.IndexerConfig(
            token_processor_config=m.TokenProcessorConfig(
                block_size=BLOCK_SIZE
            ),
            tokenizers_pool_config=m.TokenizationPoolConfig(
                workers=2, model_name=MODEL
            ),
        ),
        tokenizer=m.LocalFastTokenizer(tokenizer_dir),
    )
    indexer.chat_processor.register_tokenizer(
        MODEL, build_transformers_tokenizer()
    )
    indexer.run()
    event_pool = m.Pool(
        indexer.kv_block_index,
        indexer.token_processor,
        m.PoolConfig(concurrency=2),
    )
    event_pool.start()
    server = m.serve(indexer, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    # Rate 0 proves the traceparent/explain forcing paths; restore after.
    previous_rate = m.TRACER.config.sample_rate
    m.TRACER.configure(sample_rate=0.0)
    yield Fleet(m, indexer, event_pool, base)
    m.TRACER.configure(sample_rate=previous_rate)
    server.shutdown()
    server.server_close()
    event_pool.shutdown()
    indexer.shutdown()


class TestTraceparentSurface:
    def test_sampled_traceparent_echoed_and_retrievable(self, fleet):
        trace_id = f"{0xDEADBEEF:032x}"
        header = f"00-{trace_id}-{'ab' * 8}-01"
        headers, scores = fleet.post(
            "/score_completions",
            {"prompt": SENTENCE * 8, "model": MODEL},
            headers={"traceparent": header},
        )
        assert isinstance(scores, dict)
        echoed = headers.get("traceparent")
        assert echoed is not None and echoed.split("-")[1] == trace_id
        assert echoed.split("-")[2] != "ab" * 8  # our span, not theirs

        listing = fleet.get("/debug/traces?kind=recent")
        assert trace_id in [t["trace_id"] for t in listing["traces"]]

        full = fleet.get(f"/debug/traces/{trace_id}")
        assert full["name"] == "http.score_completions"
        assert full["parent_span_id"] == "ab" * 8

    def test_spans_cover_stages_and_sum_to_total(self, fleet, monkeypatch):
        """Acceptance: spans cover tokenization, hashing, index lookup
        and scoring; top-level stage durations sum to the end-to-end
        latency of the indexer call that runs them within 5%.  Best-of-3
        requests: the pin is on the instrumentation, and a single
        scheduler hiccup between stages (full-suite runs share one core)
        must not flake it.

        What is measured: the stages are the indexer's, so the test
        times ``get_pod_scores`` itself and leaves the HTTP handler's
        own work out of the denominator, and it pauses the cyclic
        collector for the request: a generation-0 collection of
        0.3-0.5 ms that lands in the call's few untimed microseconds
        (before the tokenize span or after the score span) is the
        interpreter's pause, not a stage's work, and under load it was
        what took the gap past 5%."""
        calls = []
        score = fleet.indexer.get_pod_scores

        def timed_score(*args, **kwargs):
            start = time.perf_counter()
            try:
                return score(*args, **kwargs)
            finally:
                calls.append((time.perf_counter() - start) * 1e3)

        monkeypatch.setattr(fleet.indexer, "get_pod_scores", timed_score)
        prompt = SENTENCE * 200  # long enough that stages dominate
        best_gap = None
        for attempt in range(3):
            trace_id = f"{0x51051 + attempt:032x}"
            collecting = gc.isenabled()
            gc.disable()
            try:
                fleet.post(
                    "/score_completions",
                    {"prompt": prompt, "model": MODEL},
                    headers={"traceparent": f"00-{trace_id}-{'cd' * 8}-01"},
                )
            finally:
                if collecting:
                    gc.enable()
            full = fleet.get(f"/debug/traces/{trace_id}")
            stages = {
                s["stage"]: s["duration_ms"] for s in full["stages"]
            }
            assert {
                "tokenize",
                "hash_blocks",
                "index_lookup",
                "score",
            } <= set(stages)
            call = calls[-1]
            assert call <= full["duration_ms"]  # the call lies in the trace
            gap = abs(sum(stages.values()) - call) / call
            best_gap = gap if best_gap is None else min(best_gap, gap)
            if best_gap <= 0.05:
                break
        assert len(calls) == attempt + 1
        assert best_gap <= 0.05, best_gap
        # Worker-side sub-spans attached under the tokenize stage.
        sub_spans = {
            s["name"] for s in full["spans"] if s["parent"] == "tokenize"
        }
        assert sub_spans & {
            "tokenize.queue_wait",
            "tokenize.prefix_probe",
            "tokenize.encode",
        }

    def test_unsampled_request_untraced(self, fleet):
        headers, scores = fleet.post(
            "/score_completions",
            {"prompt": SENTENCE * 4, "model": MODEL},
        )
        assert isinstance(scores, dict)
        assert "traceparent" not in {k.lower() for k in headers}

    def test_parallel_traced_requests_no_lost_or_dup_ids(self, fleet):
        """Acceptance: the flight-recorder ring under parallel traced
        HTTP requests — every id retrievable exactly once."""
        n_threads, per_thread = 8, 5
        errors = []

        # Not tests/test_debug_surface.py's ids: both files drive the
        # reference's process-wide TRACER, and on one pytest worker that
        # file's listing would count each shared id twice.
        def worker(worker_index):
            try:
                for i in range(per_thread):
                    seed = 0xC000_0000 + worker_index * 1000 + i
                    fleet.post(
                        "/score_completions",
                        {"prompt": SENTENCE * 4, "model": MODEL},
                        headers={"traceparent": sampled_tp(seed)},
                    )
            except Exception as exc:  # pragma: no cover
                errors.append(exc)

        threads = [
            threading.Thread(target=worker, args=(i,))
            for i in range(n_threads)
        ]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
        assert not errors
        listing = fleet.get("/debug/traces?kind=recent&limit=1000")
        ids = [t["trace_id"] for t in listing["traces"]]
        expected = {
            f"{0xC000_0000 + w * 1000 + i:032x}"
            for w in range(n_threads)
            for i in range(per_thread)
        }
        present = [t for t in ids if t in expected]
        assert len(present) == len(expected)
        assert len(set(present)) == len(expected)


class TestExplain:
    def test_break_index_and_tiers_per_pod(self, fleet):
        """Acceptance: explain names, per pod, the block index where
        the consecutive-prefix chain broke."""
        prompt = SENTENCE * 16
        tokens = fleet.tokenize(prompt)
        n_blocks = len(tokens) // BLOCK_SIZE
        half = n_blocks // 2 * BLOCK_SIZE
        fleet.publish("pod-half", tokens[:half])
        fleet.publish("pod-full", tokens, medium="host")

        _, body = fleet.post(
            "/score_completions?explain=1",
            {"prompt": prompt, "model": MODEL},
        )
        assert body["scores"]["pod-full"] == pytest.approx(0.8 * n_blocks)
        explain = body["explain"]
        assert explain["block_keys"] == n_blocks
        half_detail = explain["pods"]["pod-half"]
        assert half_detail["blocks_matched"] == half // BLOCK_SIZE
        assert half_detail["break_index"] == half // BLOCK_SIZE
        assert half_detail["tiers"] == {"hbm": half // BLOCK_SIZE}
        full_detail = explain["pods"]["pod-full"]
        assert full_detail["break_index"] is None
        assert full_detail["tiers"] == {"host": n_blocks}
        # Stage breakdown rides along with a live trace id.
        assert explain["stages"]
        assert fleet.get(f"/debug/traces/{explain['trace_id']}")

    def test_explain_scores_match_plain_scores(self, fleet):
        prompt = SENTENCE * 8
        fleet.publish("pod-1", fleet.tokenize(prompt))
        _, plain = fleet.post(
            "/score_completions", {"prompt": prompt, "model": MODEL}
        )
        _, explained = fleet.post(
            "/score_completions?explain=1",
            {"prompt": prompt, "model": MODEL},
        )
        assert explained["scores"] == plain

    def test_chat_explain_covers_templating(self, fleet):
        """Acceptance: spans cover templating on the chat path."""
        messages = [
            {"role": "system", "content": "you are a helpful assistant ."},
            {"role": "user", "content": SENTENCE * 4},
        ]
        _, body = fleet.post(
            "/score_chat_completions?explain=1",
            {"model": MODEL, "messages": messages},
        )
        full = fleet.get(f"/debug/traces/{body['explain']['trace_id']}")
        names = {s["name"] for s in full["spans"]}
        assert "tokenize.chat_template" in names


class TestDebugEndpoints:
    def test_healthz_observability_block(self, m, fleet):
        fleet.post(
            "/score_completions",
            {"prompt": SENTENCE * 4, "model": MODEL},
            headers={"traceparent": sampled_tp(0xBEEF)},
        )
        health = fleet.get("/healthz")
        obs = health["observability"]
        assert obs["ring_size"] == m.TRACER.recorder.ring_size
        assert obs["ring_occupancy"] >= 1
        assert obs["traces_sampled"] >= 1
        assert "traces_unsampled" in obs
        assert "slow_threshold_ms" in obs

    def test_debug_traces_kind_filters(self, fleet):
        for kind in ("recent", "slow", "errored"):
            listing = fleet.get(f"/debug/traces?kind={kind}")
            assert listing["kind"] == kind
            assert isinstance(listing["traces"], list)

    def test_debug_traces_rejects_bad_kind(self, fleet):
        with pytest.raises(urllib.error.HTTPError) as excinfo:
            fleet.get("/debug/traces?kind=bogus")
        assert excinfo.value.code == 400

    def test_unknown_trace_id_404(self, fleet):
        with pytest.raises(urllib.error.HTTPError) as excinfo:
            fleet.get(f"/debug/traces/{'9' * 32}")
        assert excinfo.value.code == 404


class TestGrpcTraceparent:
    def test_grpc_metadata_ingest_and_echo(self, m, fleet, tmp_path):
        if m.side == "ref":
            indexer_pb2, grpc_service = ref_indexer_pb2, ref_indexer_service
        else:
            indexer_pb2, grpc_service = port("api.indexer_pb2"), port("api.indexer_service")
        uds = os.path.join(tempfile.mkdtemp(dir=str(tmp_path)), "indexer.sock")
        server = grpc_service.serve(fleet.indexer, f"unix://{uds}")
        try:
            client = grpc_service.new_client(f"unix://{uds}")
            trace_id = f"{0x6677:032x}"
            response, call = client.GetPodScores.with_call(
                indexer_pb2.GetPodScoresRequest(prompt=SENTENCE * 4, model_name=MODEL),
                metadata=(("traceparent", f"00-{trace_id}-{'ef' * 8}-01"),),
                timeout=30,
            )
            echoed = {key: value for key, value in call.initial_metadata()}.get("traceparent")
            assert echoed is not None
            assert echoed.split("-")[1] == trace_id
            full = fleet.get(f"/debug/traces/{trace_id}")
            assert full["name"] == "grpc.get_pod_scores"
            assert full["parent_span_id"] == "ef" * 8
            client.channel.close()
        finally:
            server.stop(grace=None)
