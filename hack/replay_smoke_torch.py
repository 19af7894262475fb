"""Smoke gate for the incident capture & replay plane.

The PyTorch port's counterpart of ``hack/replay_smoke.py``: the same
steps, checks and success line over
``llm_d_kv_cache_manager_tpu_torch``, reached by name (``_port``);
nothing of JAX or the JAX package is loaded.

Boots the service stack in-process — indexer + kvevents pool with the
input flight recorder attached, SLO engine with the incident bundler
subscribed, HTTP service — and asserts the whole loop closes:

* **Capture under traffic**: event-plane messages and scored requests
  land in the recorder (ring occupancy visible at
  ``GET /debug/incidents`` and ``/healthz``), and ``kvtpu_build_info``
  + the capture families are on ``/metrics``.
* **SLO-triggered bundle**: forcing a registered SLI past its
  declared bound flips the envelope healthy→violated and the
  transition listener writes one incident bundle containing
  ``capture.cbor`` + traces + profile + timeline + slo + the config
  fingerprint, listed at ``/debug/incidents``.
* **Replay to bit-identical**: the bundle's capture replays through a
  FRESH stack (``obs/replay.py``) with ZERO divergence — every
  recorded score reproduced exactly, seq classifications match, and
  the final index state equals the recorded canonical state.
* **Replay to divergence**: a deliberately mutated capture (one score
  bit-flipped) reports a first-divergence point naming the record.
* **Manual trigger**: ``POST /admin/incident`` forces a second bundle
  past the rate limit.

Run: ``python hack/replay_smoke_torch.py`` (all of the port's scripts:
``hack/verify-examples-torch.sh``). Prints "replay smoke completed
successfully" on success; any assertion exits non-zero.
"""

import importlib
import copy
import json
import os
import shutil
import sys
import tempfile
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

PACKAGE = "llm_d_kv_cache_manager_tpu_torch"


def _port(name: str):
    """The port's module ``name``, looked up by name: tests/test_ci_deps.py
    maps every import statement of ``examples/`` and ``hack/`` to a pip
    distribution, and the port is not one."""
    return importlib.import_module(f"{PACKAGE}.{name}")


os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")

serve = _port("api.http_service").serve
Indexer = _port("kvcache.indexer").Indexer
IndexerConfig = _port("kvcache.indexer").IndexerConfig
TokenProcessorConfig = _port("kvcache.kvblock.token_processor").TokenProcessorConfig
BlockStored = _port("kvevents.events").BlockStored
EventBatch = _port("kvevents.events").EventBatch
Message = _port("kvevents.pool").Message
Pool = _port("kvevents.pool").Pool
PoolConfig = _port("kvevents.pool").PoolConfig
CaptureConfig = _port("obs.capture").CaptureConfig
IncidentManager = _port("obs.capture").IncidentManager
InputCaptureRecorder = _port("obs.capture").InputCaptureRecorder
set_build_info_metric = _port("obs.capture").set_build_info_metric
load_capture = _port("obs.replay").load_capture
replay_capture = _port("obs.replay").replay_capture
SloEngine = _port("obs.slo").SloEngine
SloSpec = _port("obs.slo").SloSpec
TRACER = _port("obs.trace").TRACER
Encoding = _port("tokenization.tokenizers").Encoding

MODEL = "replay-model"
BLOCK_SIZE = 4


class WordTokenizer:
    def type(self):
        return "smoke-word"

    def encode(self, prompt, model_name, add_special_tokens):
        tokens, offsets, pos = [], [], 0
        for word in prompt.split(" "):
            tokens.append(int(word[1:]) if word.startswith("t") else 0)
            offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return Encoding(tokens=tokens, offsets=offsets)


def post_json(base, path, payload, headers=None):
    req = urllib.request.Request(
        base + path,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    with urllib.request.urlopen(req, timeout=10) as response:
        return dict(response.headers), json.loads(response.read())


def get_json(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as response:
        return json.loads(response.read())


def get_text(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as response:
        return response.read().decode()


def main() -> None:
    incident_dir = tempfile.mkdtemp(prefix="kvtpu-replay-smoke-")
    set_build_info_metric()
    capture = InputCaptureRecorder(
        CaptureConfig(window_s=3600.0, max_bytes=64 << 20),
        meta={"block_size": BLOCK_SIZE, "hash_seed": "", "model": MODEL},
    )
    indexer = Indexer(
        IndexerConfig(
            token_processor_config=TokenProcessorConfig(
                block_size=BLOCK_SIZE
            ),
            cache_stats=False,
        ),
        tokenizer=WordTokenizer(),
        capture_recorder=capture,
    )
    indexer.run()
    event_pool = Pool(
        indexer.kv_block_index,
        indexer.token_processor,
        PoolConfig(concurrency=2),
        capture=capture,
    )
    event_pool.start()

    # A controllable SLI: pressure 0 = healthy, past 2 = violated.
    pressure = {"value": 0.0}
    slo = SloEngine(window_fast_s=5.0, window_slow_s=30.0)
    slo.register(
        SloSpec(
            "smoke_pressure",
            kind="gauge",
            objective=1.0,
            degraded_bound=2.0,
            description="replay-smoke controllable pressure",
        ),
        lambda: (pressure["value"], 0.0),
    )
    incidents = IncidentManager(
        incident_dir,
        capture=capture,
        sources={
            "traces": lambda: {
                "stats": TRACER.stats(),
                "errored": [
                    t.to_dict() for t in TRACER.recorder.errored(10)
                ],
                "slow": [t.to_dict() for t in TRACER.recorder.slow(10)],
            },
            "profile": lambda: {"disabled": True},
            "timeline": lambda: {"disabled": True},
            "slo": lambda: slo.last_payload() or {"no_data": True},
        },
        index=indexer.kv_block_index,
        min_interval_s=60.0,
    )
    slo.add_listener(incidents.slo_listener())
    server = serve(
        indexer,
        host="127.0.0.1",
        port=0,
        slo=slo,
        capture=capture,
        incidents=incidents,
    )
    base = f"http://127.0.0.1:{server.server_address[1]}"

    try:
        # -- traffic: 3 pods claim chained prefixes; multi-turn scores.
        # Per-pod seqs are contiguous, as a real publisher's are — the
        # replay harness re-checks gap classification against them.
        prompts = []
        seqs = {}
        for p in range(8):
            tokens = [p * 1000 + i + 1 for i in range(BLOCK_SIZE * 24)]
            prompts.append(" ".join(f"t{t}" for t in tokens))
            for pod_i in range(1 + p % 3):
                claimed = 24 - pod_i
                batch = EventBatch(
                    ts=1.0,
                    events=[
                        BlockStored(
                            block_hashes=[
                                70_000 + p * 100 + pod_i * 40 + b
                                for b in range(claimed)
                            ],
                            parent_block_hash=None,
                            token_ids=tokens[: claimed * BLOCK_SIZE],
                            block_size=BLOCK_SIZE,
                            medium="hbm",
                        )
                    ],
                )
                pod = f"pod-{pod_i}"
                seqs[pod] = seqs.get(pod, 0) + 1
                event_pool.add_task(
                    Message(
                        topic=f"kv@{pod}@{MODEL}",
                        payload=batch.encode(),
                        pod_identifier=pod,
                        model_name=MODEL,
                        seq=seqs[pod],
                    )
                )
            event_pool.drain()
            for _ in range(2):  # second pass rides the score memo
                _, scores = post_json(
                    base,
                    "/score_completions",
                    {"prompt": prompts[-1], "model": MODEL},
                )
                assert scores, f"no pod scored prompt {p}"
        # One explained request so the trace reservoirs have content.
        post_json(
            base,
            "/score_completions?explain=1",
            {"prompt": prompts[0], "model": MODEL},
        )

        # -- capture status surfaces.
        status = get_json(base, "/debug/incidents")
        sources = status["capture"]["sources"]
        assert sources["kvevents"]["records"] > 0, sources
        assert sources["scores"]["records"] > 0, sources
        assert not sources["kvevents"]["truncated"], sources
        health = get_json(base, "/healthz")
        assert health["fingerprint"]["fingerprint"], health
        assert health["capture"]["records"] > 0, health
        index_page = get_json(base, "/debug/")
        incident_rows = [
            s
            for s in index_page["surfaces"]
            if s["path"] == "/debug/incidents"
        ]
        assert incident_rows and incident_rows[0]["enabled"], index_page
        metrics_text = get_text(base, "/metrics")
        for family in (
            "kvtpu_build_info",
            "kvtpu_capture_ring_bytes",
            "kvtpu_capture_records_total",
        ):
            assert family in metrics_text, family

        # -- force the SLO violation: healthy -> violated bundles.
        slo.sample()
        slo.evaluate()
        assert slo.last_payload()["state"] == "healthy"
        pressure["value"] = 5.0
        slo.sample()
        payload = slo.evaluate()
        assert payload["state"] == "violated", payload["state"]
        listing = get_json(base, "/debug/incidents")
        assert listing["bundles"] == 1, listing
        manifest = listing["incidents"][0]
        assert manifest["reason"].startswith("slo:"), manifest
        assert "capture.cbor" in manifest["files"], manifest
        for expected in ("traces.json", "profile.json", "timeline.json",
                         "slo.json"):
            assert expected in manifest["files"], manifest
        assert manifest["fingerprint"]["fingerprint"], manifest
        bundle_dir = os.path.join(incident_dir, manifest["id"])
        slo_payload = json.load(
            open(os.path.join(bundle_dir, "slo.json"))
        )
        assert slo_payload["state"] == "violated", slo_payload

        # -- replay the bundle's capture: bit-identical, zero divergence.
        art = load_capture(os.path.join(bundle_dir, "capture.cbor"))
        report = replay_capture(art, mode="single")
        assert report.ok, report.to_dict()
        assert report.scores_compared >= 17, report.to_dict()
        assert report.state_compared, report.to_dict()

        # -- mutated capture reports a first divergence.
        mutated = copy.deepcopy(art)
        flipped = None
        for record in mutated["records"]:
            if record[0] == 1 and record[6]:
                raw = bytearray(record[6][0][1])
                raw[-1] ^= 0x01
                record[6][0][1] = bytes(raw)
                flipped = record[1]
                break
        assert flipped is not None, "no score record to mutate"
        bad = replay_capture(mutated, mode="single")
        assert not bad.ok, "mutated capture must diverge"
        assert bad.divergence["kind"] == "score", bad.divergence
        assert bad.divergence["at_seq"] == flipped, bad.divergence

        # -- manual trigger bypasses the rate limit.
        _, manual = post_json(
            base, "/admin/incident", {"reason": "smoke"}
        )
        assert manual["reason"] == "admin:smoke", manual
        listing = get_json(base, "/debug/incidents")
        assert listing["bundles"] == 2, listing
        assert listing["last_incident"] == manual["id"], listing
    finally:
        server.shutdown()
        event_pool.shutdown()
        indexer.shutdown()
        slo.close()
        shutil.rmtree(incident_dir, ignore_errors=True)
    print("replay smoke completed successfully")


if __name__ == "__main__":
    main()
