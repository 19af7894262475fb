"""The port's service and observability plane against the JAX package's,
on the CPU, the two packages side by side in one process.

The same seeded inputs go through both packages and what comes out is
compared exactly: capture artifacts and incident bundles are byte-equal
with each package's capture clock pinned; each package's replay accepts
the other's artifact and reproduces its scores and index state; what-if
A/B runs agree digest for digest; the two services answer the same
requests with equal JSON bodies (timing fields aside) and move their
``/metrics`` samples alike, each read from its own exposition; and the
port's env-configured ``main()`` boots in a subprocess on the loopback,
takes KV events over ZMQ and answers ``/healthz`` and a scoring request.
"""

import http.client
import json
import os
import random
import socket
import subprocess
import sys
import time
import urllib.request

import pytest
from prometheus_client.parser import text_string_to_metric_families

from llm_d_kv_cache_manager_tpu.api import http_service as ref_http_service
from llm_d_kv_cache_manager_tpu.kvcache import indexer as ref_indexer
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import index as ref_index
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as ref_token_processor
from llm_d_kv_cache_manager_tpu.kvevents import events as ref_events
from llm_d_kv_cache_manager_tpu.kvevents import pool as ref_pool
from llm_d_kv_cache_manager_tpu.metrics import collector as ref_collector
from llm_d_kv_cache_manager_tpu.obs import capture as ref_capture
from llm_d_kv_cache_manager_tpu.obs import profiler as ref_profiler
from llm_d_kv_cache_manager_tpu.obs import replay as ref_replay
from llm_d_kv_cache_manager_tpu.obs import slo as ref_slo
from llm_d_kv_cache_manager_tpu.obs import trace as ref_trace
from llm_d_kv_cache_manager_tpu.obs import timeline as ref_timeline
from llm_d_kv_cache_manager_tpu.obs import whatif as ref_whatif
from llm_d_kv_cache_manager_tpu.tokenization import tokenizers as ref_tokenizers
from tests.helpers.tiny_tokenizer import save_tokenizer_json
from tests.helpers.torch_port import PACKAGE, namespace, port

SIDES = ("ref", "port")
_REF = {
    "api.http_service": ref_http_service,
    "kvcache.indexer": ref_indexer,
    "kvcache.kvblock.index": ref_index,
    "kvcache.kvblock.token_processor": ref_token_processor,
    "kvevents.events": ref_events,
    "kvevents.pool": ref_pool,
    "metrics.collector": ref_collector,
    "obs.capture": ref_capture,
    "obs.profiler": ref_profiler,
    "obs.replay": ref_replay,
    "obs.slo": ref_slo,
    "obs.timeline": ref_timeline,
    "obs.whatif": ref_whatif,
    "tokenization.tokenizers": ref_tokenizers,
}
_NAMES = {
    "api.http_service": ("serve",),
    "kvcache.indexer": ("Indexer", "IndexerConfig"),
    "kvcache.kvblock.index": ("IndexConfig",),
    "kvcache.kvblock.token_processor": ("TokenProcessorConfig",),
    "kvevents.events": ("BlockRemoved", "BlockStored", "EventBatch"),
    "kvevents.pool": ("Message", "Pool", "PoolConfig"),
    "metrics.collector": ("METRICS",),
    "obs.capture": ("CaptureConfig", "IncidentManager", "InputCaptureRecorder",
                    "encode_capture", "load_artifact"),
    "obs.profiler": ("ProfilerConfig", "SamplingProfiler"),
    "obs.replay": ("load_capture", "replay_capture"),
    "obs.slo": ("SloEngine", "default_fleet_slos"),
    "obs.timeline": ("GaugeTimeline", "register_default_series"),
    "obs.whatif": ("StackConfig", "WhatIfConfig", "gate_headlines", "reference_ab",
                   "reference_capture_path", "run_ab"),
    "tokenization.tokenizers": ("Encoding",),
}
MODULES = {"ref": {"capture": ref_capture}, "port": {"capture": port("obs.capture")}}

MODEL = "cross-model"
BLOCK = 4
PODS = ("pod-0", "pod-1", "pod-2")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mods(side):
    return namespace(side, _REF, _NAMES)


class WordTokenizer:
    """'t<id>' words -> ids, returning the given package's ``Encoding``."""

    def __init__(self, m):
        self._encoding = m.Encoding

    def type(self):
        return "test-word"

    def encode(self, prompt, model_name, add_special_tokens):
        tokens, offsets, pos = [], [], 0
        for word in prompt.split(" "):
            if word.startswith("t"):
                tokens.append(int(word[1:]))
                offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return self._encoding(tokens=tokens, offsets=offsets)


def words(tokens):
    return " ".join(f"t{t}" for t in tokens)


class PinnedClock:
    """Stands in for a capture module's ``time``: every read steps a
    counter, so two packages making the same calls read the same times."""

    gmtime = staticmethod(time.gmtime)
    strftime = staticmethod(time.strftime)

    def __init__(self):
        self._us = 1_767_225_600_000_000

    def time_ns(self):
        self._us += 1_000
        return self._us * 1000

    def time(self):
        return self.time_ns() / 1e9


@pytest.fixture()
def pinned(monkeypatch):
    """Pin both packages' capture clocks (the module attribute, never the
    global ``time`` that other threads of the worker read)."""
    for side in SIDES:
        monkeypatch.setattr(MODULES[side]["capture"], "time", PinnedClock())


class Stack:
    """One package's indexer + event pool (+ capture), fed a seeded
    workload on the caller's thread."""

    def __init__(self, m, capture=None, seed=7, served=False):
        self.m = m
        self.capture = capture
        self.indexer = m.Indexer(
            m.IndexerConfig(
                token_processor_config=m.TokenProcessorConfig(block_size=BLOCK, hash_seed=""),
                kvblock_index_config=m.IndexConfig(enable_metrics=served),
                cache_stats=served,
            ),
            tokenizer=WordTokenizer(m),
            capture_recorder=capture,
        )
        self.indexer.run()
        self.pool = m.Pool(
            self.indexer.kv_block_index,
            self.indexer.token_processor,
            m.PoolConfig(concurrency=2),
            capture=capture,
        )
        self.pool.start()
        self.rng = random.Random(seed)
        self.seqs = {}
        self.scores = []

    def send(self, pod, events):
        m = self.m
        self.seqs[pod] = self.seqs.get(pod, 0) + 1
        self.pool.add_task(m.Message(
            topic=f"kv@{pod}@{MODEL}",
            payload=m.EventBatch(ts=1.0, events=events).encode(),
            pod_identifier=pod,
            model_name=MODEL,
            seq=self.seqs[pod],
        ))

    def stored(self, hashes, tokens, medium="hbm"):
        return self.m.BlockStored(block_hashes=list(hashes), parent_block_hash=None,
                                  token_ids=list(tokens), block_size=BLOCK, medium=medium)

    def drive(self, rounds=6):
        """Conversations grow a few blocks a round; pods store prefixes
        of them (some on the host tier) and blocks of their own, some of
        which they evict; every round scores the conversation and a cold
        prompt.  Only a pod's own blocks are evicted: the pool applies
        different pods' events in any order, and replay compares a state
        that holds only for events that commute across pods."""
        rng, convo = self.rng, []
        for r in range(rounds):
            convo.extend(rng.randrange(1, 5000) for _ in range(BLOCK * 3))
            for p, pod in enumerate(PODS):
                if rng.random() < 0.25:
                    continue
                claimed = rng.randrange(1, len(convo) // BLOCK + 1)
                hashes = [10_000 + r * 500 + p * 100 + b for b in range(claimed)]
                medium = "host" if rng.random() < 0.3 else "hbm"
                self.send(pod, [self.stored(hashes, convo[: claimed * BLOCK], medium)])
                if rng.random() < 0.5:
                    own = 800_000 + p * 1000 + r
                    self.send(pod, [self.stored([own], [20_000 + p * 500 + r * BLOCK + j
                                                        for j in range(BLOCK)])])
                    if rng.random() < 0.5:
                        self.send(pod, [self.m.BlockRemoved(block_hashes=[own])])
            self.pool.drain()
            self.scores.append(self.indexer.get_pod_scores(words(convo), MODEL, None))
            self.scores.append(self.indexer.get_pod_scores(
                words([9000 + r * 10 + j for j in range(BLOCK * 2)]), MODEL, list(PODS)))
        self.pool.drain()
        return convo

    def close(self):
        self.pool.shutdown()
        self.indexer.shutdown()


def recorder(m):
    return m.InputCaptureRecorder(
        m.CaptureConfig(window_s=3600.0, max_bytes=8 << 20),
        meta={"block_size": BLOCK, "hash_seed": "", "model": MODEL},
    )


def captured(side):
    """A seeded workload through one package's stack; its artifact bytes
    and the scores it served."""
    m = mods(side)
    rec = recorder(m)
    stack = Stack(m, capture=rec)
    try:
        stack.drive()
        return rec.dump_bytes(index=stack.indexer.kv_block_index), stack.scores
    finally:
        stack.close()


# ------------------------------------------------------- capture + replay


class TestCaptureAcrossPackages:
    def test_artifacts_are_byte_equal_with_the_clock_pinned(self, pinned):
        ref_blob, ref_scores = captured("ref")
        port_blob, port_scores = captured("port")
        assert port_scores == ref_scores
        assert any(scores for scores in ref_scores)
        assert port_blob == ref_blob
        art = ref_capture.load_artifact(ref_blob)
        assert art["truncated"] == [] and art["state"]

    def test_encode_capture_is_byte_equal(self):
        records = [
            [0, 1, 10, "pod-0", f"kv@pod-0@{MODEL}", MODEL, 1, 0, b"\x01\x02", "admitted"],
            [1, 2, 11, MODEL, [1, 2, 3, 4], None,
             [["pod-0", ref_capture.encode_f64(0.8)]]],
        ]
        blobs = [
            mods(side).encode_capture(
                records, fingerprint="fp", knobs=[["BLOCK_SIZE", "4"]], created_us=7,
                window_s=3, max_bytes=9, truncated=["scores"], meta={"a": "b"},
                state=[[1, 2, [["pod-0", "hbm"]]]],
            )
            for side in SIDES
        ]
        assert blobs[0] == blobs[1]

    def test_incident_bundles_are_byte_equal(self, pinned, tmp_path):
        bundles = {}
        for side in SIDES:
            m = mods(side)
            rec = recorder(m)
            stack = Stack(m, capture=rec)
            try:
                stack.drive(rounds=4)
                manager = m.IncidentManager(
                    str(tmp_path / side), capture=rec, index=stack.indexer.kv_block_index,
                    sources={"note": lambda: {"k": 1}}, min_interval_s=0.0,
                )
                manifest = manager.trigger("cross-check", force=True)
            finally:
                stack.close()
            bundle = tmp_path / side / manifest["id"]
            bundles[side] = (manifest, {p.name: p.read_bytes() for p in bundle.iterdir()})
        (ref_manifest, ref_files), (port_manifest, port_files) = bundles["ref"], bundles["port"]
        assert port_manifest == ref_manifest
        assert sorted(port_files) == ["capture.cbor", "manifest.json", "note.json"]
        assert port_files == ref_files

    @pytest.mark.parametrize("mode", ["single", "cluster"])
    @pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
    def test_each_package_replays_the_others_capture(self, writer, reader, mode):
        blob, scores = captured(writer)
        r = mods(reader)
        art = r.load_capture(blob)
        report = r.replay_capture(art, mode=mode)
        assert report.ok, report.to_dict()
        assert report.scores_compared == len(scores)
        assert report.state_compared


# ------------------------------------------------------------- what-if


class TestWhatIfAcrossPackages:
    def test_run_ab_digests_are_equal(self):
        results = {}
        for side in SIDES:
            m = mods(side)
            capture = m.load_capture(m.reference_capture_path(), allow_mismatch=True)
            results[side] = m.run_ab(
                capture,
                m.StackConfig.parse("shards=1"),
                m.StackConfig.parse("shards=8,depth=2,drain_rate=30"),
                m.WhatIfConfig(speed=8.0),
                register=False,
            )
        for arm in ("a", "b"):
            assert results["port"][arm]["digest"] == results["ref"][arm]["digest"]
        for key in ("hit_rate", "hit_parity", "recorded_parity", "shed", "applied",
                    "final_backlog", "digest_equal"):
            assert results["port"]["delta"][key] == results["ref"]["delta"][key], key

    def test_reference_ab_headlines_equal_the_recorded_baseline(self):
        m = mods("port")
        assert m.reference_capture_path() == ref_whatif.reference_capture_path()
        with open(os.path.join(REPO, "WHATIF_r01.json")) as handle:
            recorded = json.load(handle)["headlines"]
        assert m.gate_headlines(m.reference_ab()) == recorded


# ------------------------------------------------------------- services

# Leaves whose values are times, trace identities or the count of time
# buckets a window spans: compared by presence, not by value.
TIMING_KEYS = {"trace_id", "traceparent", "start_unix", "uptime_s", "frames"}
# /healthz's "observability" block is the tracer's stats.  Each package's
# tracer is a process-wide singleton, shared with every other test of the
# worker, so the block's running counts are compared by presence; its
# keys and its configuration (sample rate, ring size) by value.
TRACER_COUNTS = {"traces_sampled", "traces_unsampled", "ring_occupancy", "slow_retained",
                 "errored_retained", "recorded", "slow_promoted", "errors_recorded"}


def normalized(value, counts=frozenset()):
    if isinstance(value, dict):
        return {
            key: ("<t>" if key in TIMING_KEYS or key in counts
                  or key.endswith(("_ms", "_s", "_unix")) else
                  normalized(item, TRACER_COUNTS if key == "observability" else frozenset()))
            for key, item in value.items()
        }
    if isinstance(value, list):
        return [normalized(item) for item in value]
    return value


class Client:
    """One keep-alive HTTP/1.1 connection to a service."""

    def __init__(self, server):
        self.conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=30)

    def call(self, method, path, body=None, raw=None, headers=None):
        data = raw if raw is not None else (json.dumps(body).encode() if body is not None
                                             else None)
        self.conn.request(method, path, body=data,
                          headers={"Content-Type": "application/json", **(headers or {})})
        response = self.conn.getresponse()
        payload = response.read()
        kind = response.getheader("Content-Type", "")
        return response.status, (json.loads(payload) if "json" in kind else payload)

    def close(self):
        self.conn.close()


def metric_samples(text):
    """``{(sample name, labels): value}`` and ``{family: type}`` of one
    exposition, parsed by ``prometheus_client``'s parser.  The
    ``*_created`` timestamps, which only ``prometheus_client`` writes,
    are times and left out."""
    samples, families = {}, {}
    for family in text_string_to_metric_families(text):
        if family.name.endswith("_created"):
            continue
        families[family.name] = family.type
        for sample in family.samples:
            if not sample.name.endswith("_created"):
                samples[(sample.name, tuple(sorted(sample.labels.items())))] = sample.value
    return samples, families


@pytest.fixture()
def services(monkeypatch):
    # /debug/whatif shows each package's process-wide registry of what-if
    # results, which other tests of the worker may have filled: each
    # service starts from an empty one.
    for whatif in (ref_whatif, port("obs.whatif")):
        monkeypatch.setattr(whatif, "REGISTRY", whatif.WhatIfRegistry())
    # /healthz shows each package's process-wide tracer's sample rate,
    # which other files of the worker may have left changed
    # (tests/test_cluster_trace.py ends at 0.0): each service starts at
    # its package's default.
    for trace in (ref_trace, port("obs.trace")):
        monkeypatch.setattr(trace.TRACER.config, "sample_rate", trace.DEFAULT_SAMPLE_RATE)
    booted = {}
    try:
        for side in SIDES:
            m = mods(side)
            stack = Stack(m, served=True)
            convo = stack.drive(rounds=4)
            server = m.serve(stack.indexer, host="127.0.0.1", port=0)
            booted[side] = (m, stack, server, Client(server), convo)
        yield booted
    finally:
        for m, stack, server, client, _ in booted.values():
            client.close()
            server.shutdown()
            server.server_close()
            stack.close()


def requests_for(convo):
    prompt = words(convo)
    cold = words(range(7000, 7000 + BLOCK * 3))
    sampled = {"traceparent": f"00-{0xabc:032x}-{0x1:016x}-01"}
    return [
        ("POST", "/score_completions", {"prompt": prompt, "model": MODEL}, None),
        ("POST", "/score_completions?explain=1", {"prompt": prompt, "model": MODEL}, None),
        ("POST", "/score_completions", {"prompt": prompt, "model": MODEL,
                                        "pods": ["pod-0", "pod-2"]}, None),
        ("POST", "/score_completions", {"prompt": cold, "model": MODEL}, sampled),
        ("POST", "/score_completions", {"model": MODEL}, None),
        ("POST", "/score_completions", b"{not json", None),
        ("POST", "/no_such_route", {}, None),
        ("GET", "/healthz", None, None),
        ("GET", "/debug/", None, None),
        ("GET", "/debug/cachestats", None, None),
        ("GET", "/debug/traces?kind=bogus", None, None),
        ("GET", f"/debug/traces/{0xabc:032x}", None, None),
        ("GET", "/debug/slo", None, None),
        ("GET", "/debug/incidents", None, None),
        ("GET", "/debug/whatif", None, None),
        ("POST", "/admin/purge_pod", {"pod": "pod-1"}, None),
        ("POST", "/score_completions", {"prompt": prompt, "model": MODEL}, None),
        ("GET", "/nope", None, None),
    ]


class TestServicesAnswerAlike:
    def test_equal_json_bodies_timing_aside(self, services):
        answers = {}
        for side, (m, stack, server, client, convo) in services.items():
            answers[side] = []
            for method, path, body, headers in requests_for(convo):
                raw = body if isinstance(body, bytes) else None
                status, payload = client.call(method, path, None if raw else body, raw, headers)
                answers[side].append((method, path, status, normalized(payload)))
        for ref_answer, port_answer in zip(answers["ref"], answers["port"]):
            assert port_answer == ref_answer
        statuses = [answer[2] for answer in answers["port"]]
        assert statuses.count(200) >= 8 and 400 in statuses and 404 in statuses
        scores = answers["port"][0][3]
        assert scores and max(scores.values()) > 0

    def test_metrics_move_alike(self, services):
        before, after, families = {}, {}, {}
        for side, (m, stack, server, client, convo) in services.items():
            status, text = client.call("GET", "/metrics")
            assert status == 200
            before[side], families[side] = metric_samples(text.decode())
            for method, path, body, headers in requests_for(convo)[:4]:
                client.call(method, path, body, None, headers)
            after[side] = metric_samples(client.call("GET", "/metrics")[1].decode())[0]
        assert families["port"] == families["ref"]

        def moved(side):
            out = {}
            for key, value in after[side].items():
                name = key[0]
                if not name.endswith(("_total", "_count")) or "seconds" in name:
                    continue
                delta = value - before[side].get(key, 0.0)
                if delta:
                    out[key] = delta
            return out

        assert moved("port") == moved("ref")
        lookups = ("kvtpu_kvcache_index_lookup_requests_total", ())
        assert moved("port")[lookups] == 4
        assert moved("port")[("kvtpu_score_requests_total", (("outcome", "ok"),))] == 4


# ---------------------------------------------------------------- main()


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class TestPortMain:
    def test_main_boots_subscribes_and_scores(self, tmp_path):
        """The port's env-configured ``main()`` in its own interpreter:
        the ZMQ subscription on the loopback takes a pod's KV events,
        ``/healthz`` carries the event-plane, SLO, fingerprint, capture
        and incident blocks, and a scoring request finds the pod."""
        model, sentence = "test-model", "the quick brown fox jumps over the lazy dog . "
        tokenizers_dir = save_tokenizer_json(str(tmp_path), model)
        http_port, zmq_port = free_port(), free_port()
        env = dict(
            os.environ,
            PYTHONPATH=REPO,
            MODEL_NAME=model,
            BLOCK_SIZE=str(BLOCK),
            PYTHONHASHSEED="0",
            LOCAL_TOKENIZER_DIR=tokenizers_dir,
            HTTP_PORT=str(http_port),
            ZMQ_ENDPOINT=f"tcp://127.0.0.1:{zmq_port}",
            INCIDENT_DIR=str(tmp_path / "incidents"),
            HF_HUB_OFFLINE="1",
            TRANSFORMERS_OFFLINE="1",
        )
        log = open(tmp_path / "service.log", "wb")
        service = subprocess.Popen(
            [sys.executable, "-m", f"{PACKAGE}.api.http_service"],
            env=env, cwd=str(tmp_path), stdout=log, stderr=subprocess.STDOUT,
        )
        base = f"http://127.0.0.1:{http_port}"
        publisher = None
        try:
            health = None
            deadline = time.monotonic() + 60
            while health is None:
                assert service.poll() is None, (tmp_path / "service.log").read_text()[-3000:]
                assert time.monotonic() < deadline, "the service never answered /healthz"
                try:
                    with urllib.request.urlopen(base + "/healthz", timeout=5) as response:
                        health = json.load(response)
                except OSError:
                    time.sleep(0.2)
            assert health["status"] == "ok"
            for block in ("event_plane", "slo", "fingerprint", "capture", "incidents"):
                assert block in health, block
            assert health["event_plane"]["subscriptions"] == 1

            prompt = sentence * 4
            tokens = port("tokenization.tokenizers").LocalFastTokenizer(tokenizers_dir).encode(
                prompt, model, False).tokens
            n_blocks = len(tokens) // BLOCK
            events = port("kvevents.events")
            batch_events = [events.BlockStored(
                block_hashes=[0x5000 + i for i in range(n_blocks)], parent_block_hash=None,
                token_ids=tokens[: n_blocks * BLOCK], block_size=BLOCK, medium="hbm")]
            publisher = port("kvevents.publisher").Publisher(
                f"tcp://127.0.0.1:{zmq_port}", "pod-main", model, bind=False)
            request = json.dumps({"prompt": prompt, "model": model}).encode()
            scores = {}
            while not scores:
                assert time.monotonic() < deadline, "the pod's events never reached the index"
                publisher.publish(*batch_events)
                time.sleep(0.2)
                post = urllib.request.Request(base + "/score_completions", data=request,
                                              headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(post, timeout=10) as response:
                    scores = json.load(response)
            assert scores == {"pod-main": float(n_blocks)}
        finally:
            if publisher is not None:
                publisher.close()
            service.terminate()
            try:
                service.wait(timeout=30)
            except subprocess.TimeoutExpired:
                service.kill()
                service.wait(timeout=30)
            log.close()


class TestKeepAlive:
    def test_reused_connection_answers_without_a_delayed_ack_stall(self):
        """A reply is two sends (headers, body).  With Nagle's algorithm on
        the service's socket, the body waits for the ACK of the headers,
        which a keep-alive client delays (~40 ms on Linux), so every
        request on a reused connection stalled that long.  The port's
        handler sets ``TCP_NODELAY`` on each connection's socket, read
        back here from the server's side of the connection."""
        m = mods("port")
        stack = Stack(m)
        convo = stack.drive(rounds=2)
        server = m.serve(stack.indexer, host="127.0.0.1", port=0)
        handler, nodelay = server.RequestHandlerClass, []

        class Probe(handler):
            def setup(self):
                super().setup()
                nodelay.append(self.connection.getsockopt(socket.IPPROTO_TCP,
                                                          socket.TCP_NODELAY))

        server.RequestHandlerClass = Probe
        client = Client(server)
        try:
            for _ in range(5):
                status, scores = client.call("POST", "/score_completions",
                                             {"prompt": words(convo), "model": MODEL})
                assert status == 200 and scores
        finally:
            client.close()
            server.shutdown()
            server.server_close()
            stack.close()
        # Five requests on one connection: one handler, its socket's
        # TCP_NODELAY set.
        assert len(nodelay) == 1 and nodelay[0] != 0, nodelay
