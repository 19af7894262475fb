"""Smoke gate for the replay-driven what-if engine.

The PyTorch port's counterpart of ``hack/whatif_smoke.py``: the same
steps, checks and success line over
``llm_d_kv_cache_manager_tpu_torch``, reached by name (``_port``);
nothing of JAX or the JAX package is loaded.

Closes the loop end to end:

* **Composition**: scales the pinned reference capture
  (``tests/testdata/whatif_reference.cbor``) 4x by pod fan-out into a
  valid artifact the loader accepts, then time-stretches it — the
  synthetic-storm path.
* **A/B canary**: runs the scaled storm through shards=1 vs shards=8
  — the deterministic counters MUST agree exactly (hit parity 1.0,
  equal digests): both arms apply identical writes, so any difference
  is a sharding bug.  A second A/B pits a flow-control-starved arm
  (tiny queue depth, finite drain rate) against a default arm and
  must measure real sheds, differing digests, and a first
  SLO-divergence checkpoint.
* **Service surfaces**: boots the HTTP service in-process, forces an
  incident bundle (``POST /admin/incident``), reads its detail page
  (``GET /debug/incidents/<id>``), replays the bundle through
  ``POST /admin/whatif`` by id, and checks ``GET /debug/whatif`` +
  the ``kvtpu_whatif_*`` metric families.
* **Perf-trend gate**: ``hack/perf_trend.py``'s live what-if rule,
  applied here to the port's own ``reference_ab`` + ``gate_headlines``
  on the pinned capture (that script replays the JAX package): the
  live headlines must pass against the honest ``WHATIF_r01.json``
  (they equal it exactly — the headlines are deterministic) and must
  FAIL against a copy doctored to claim a higher hit rate than the
  code can deliver.

Run: ``python hack/whatif_smoke_torch.py`` (all of the port's scripts:
``hack/verify-examples-torch.sh``). Prints "whatif smoke completed
successfully" on success; any assertion exits non-zero.
"""

import importlib
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
whatif = _port("obs.whatif")
CaptureConfig = _port("obs.capture").CaptureConfig
IncidentManager = _port("obs.capture").IncidentManager
InputCaptureRecorder = _port("obs.capture").InputCaptureRecorder
set_build_info_metric = _port("obs.capture").set_build_info_metric
_ReplayTokenizer = _port("obs.replay")._ReplayTokenizer
load_capture = _port("obs.replay").load_capture
SloEngine = _port("obs.slo").SloEngine
SloSpec = _port("obs.slo").SloSpec
TRACER = _port("obs.trace").TRACER

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REFERENCE = os.path.join(
    REPO, "tests", "testdata", "whatif_reference.cbor"
)
MODEL = "whatif-ref"
BLOCK_SIZE = 4


def post_json(base, path, payload, headers=None):
    req = urllib.request.Request(
        base + path,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    with urllib.request.urlopen(req, timeout=60) as response:
        return json.loads(response.read())


def get_json(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as response:
        return json.loads(response.read())


def get_text(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as response:
        return response.read().decode()


def check_composition(workdir):
    reference = load_capture(REFERENCE, allow_mismatch=True)
    base_events = sum(1 for r in reference["records"] if r[0] == 0)
    base_scores = sum(1 for r in reference["records"] if r[0] == 1)

    storm = whatif.scale_pods(reference, 4)
    assert storm["meta"]["composed"] == "1", storm["meta"]
    assert (
        sum(1 for r in storm["records"] if r[0] == 0) == base_events * 4
    ), "scale:4 must quadruple the event streams"
    assert (
        sum(1 for r in storm["records"] if r[0] == 1) == base_scores
    ), "scale:4 must keep every recorded score"
    stretched = whatif.stretch(storm, 0.5)
    storm_path = os.path.join(workdir, "storm.cbor")
    with open(storm_path, "wb") as handle:
        handle.write(whatif.capture_to_bytes(stretched))
    # Round trip through the standard loader — a composed artifact is
    # a REAL capture, not a private in-memory shape.
    loaded = load_capture(storm_path, allow_mismatch=True)
    assert len(loaded["records"]) == len(stretched["records"])
    print(
        f"whatif-smoke: composed 4x storm ok "
        f"({len(loaded['records'])} records at {storm_path})"
    )
    return loaded


def check_ab(storm):
    cfg = whatif.WhatIfConfig(speed=6.0)
    # Sharding parity: identical deterministic measurements or the
    # index has a shard-dependent bug.  pod_cache is raised so the 12
    # fanned-out pods per key fit without eviction in BOTH arms.
    ab = whatif.run_ab(
        storm,
        whatif.StackConfig.parse("shards=1,pod_cache=16", name="s1"),
        whatif.StackConfig.parse("shards=8,pod_cache=16", name="s8"),
        cfg,
        register=False,
    )
    delta = ab["delta"]
    assert delta["digest_equal"], (
        "shards=1 vs shards=8 diverged deterministically: "
        f"{json.dumps(delta, default=str)[:600]}"
    )
    assert delta["hit_parity"] == 1.0, delta["hit_parity"]
    assert delta["slo"]["first_divergence"] is None
    assert 0.0 < delta["hit_rate"]["a"] <= 1.0
    for key in (
        "hit_rate",
        "shed",
        "applied",
        "latency_p50_ms",
        "latency_p99_ms",
        "wall_scores_per_sec",
    ):
        assert {"a", "b"} <= set(delta[key]), (key, delta[key])
    print(
        "whatif-smoke: shards A/B parity ok "
        f"(hit_rate {delta['hit_rate']['a']:.4f})"
    )

    # Flow-control A/B: a starved arm must measurably shed and push
    # its SLO envelope off the healthy arm's trajectory.
    ab2 = whatif.run_ab(
        storm,
        whatif.StackConfig.parse(
            "depth=4,drain_rate=120,pod_cache=16", name="starved"
        ),
        whatif.StackConfig.parse(
            "drain_rate=120,pod_cache=16", name="roomy"
        ),
        whatif.WhatIfConfig(speed=10.0),
        register=False,
    )
    d2 = ab2["delta"]
    assert d2["shed"]["a"] > 0 and d2["shed"]["b"] == 0, d2["shed"]
    assert not d2["digest_equal"]
    divergence = d2["slo"]["first_divergence"]
    assert divergence is not None, "starved arm never diverged on SLO"
    assert "whatif.event_shed" in divergence["slis"], divergence
    print(
        "whatif-smoke: flow-control A/B ok "
        f"(shed {d2['shed']['a']}, first divergence at virtual "
        f"{divergence['virtual_s']}s)"
    )


def check_service(workdir):
    incident_dir = os.path.join(workdir, "incidents")
    os.makedirs(incident_dir)
    set_build_info_metric()
    capture = InputCaptureRecorder(
        CaptureConfig(window_s=3600.0, max_bytes=32 << 20),
        meta={"block_size": BLOCK_SIZE, "hash_seed": "", "model": MODEL},
    )
    indexer = Indexer(
        IndexerConfig(
            token_processor_config=TokenProcessorConfig(
                block_size=BLOCK_SIZE
            ),
            cache_stats=False,
        ),
        tokenizer=_ReplayTokenizer(),
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
    slo = SloEngine(window_fast_s=5.0, window_slow_s=30.0)
    slo.register(
        SloSpec(
            "smoke_pressure",
            kind="gauge",
            objective=1.0,
            degraded_bound=2.0,
            description="whatif-smoke controllable pressure",
        ),
        lambda: (0.0, 0.0),
    )
    incidents = IncidentManager(
        incident_dir,
        capture=capture,
        sources={
            "traces": lambda: {"stats": TRACER.stats()},
            "slo": lambda: slo.last_payload() or {"no_data": True},
        },
        index=indexer.kv_block_index,
        min_interval_s=60.0,
    )
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
        # Enough traffic that the bundle's capture is worth replaying.
        seqs = {}
        for p in range(6):
            tokens = [p * 1000 + i + 1 for i in range(BLOCK_SIZE * 12)]
            for pod_i in range(1 + p % 3):
                pod = f"pod-{pod_i}"
                seqs[pod] = seqs.get(pod, 0) + 1
                event_pool.add_task(
                    Message(
                        topic=f"kv@{pod}@{MODEL}",
                        payload=EventBatch(
                            ts=1.0,
                            events=[
                                BlockStored(
                                    block_hashes=[
                                        50_000 + p * 100 + pod_i * 40 + b
                                        for b in range(12)
                                    ],
                                    parent_block_hash=None,
                                    token_ids=tokens[: 12 * BLOCK_SIZE],
                                    block_size=BLOCK_SIZE,
                                    medium="hbm",
                                )
                            ],
                        ).encode(),
                        pod_identifier=pod,
                        model_name=MODEL,
                        seq=seqs[pod],
                    )
                )
            event_pool.drain()
            indexer.get_pod_scores(
                " ".join(f"t{t}" for t in tokens), MODEL, None
            )

        surfaces = get_json(base, "/debug/")["surfaces"]
        whatif_row = [
            row for row in surfaces if row["path"] == "/debug/whatif"
        ]
        assert whatif_row and whatif_row[0]["enabled"], surfaces

        manifest = post_json(base, "/admin/incident", {"reason": "smoke"})
        incident_id = manifest["id"]
        detail = get_json(base, f"/debug/incidents/{incident_id}")
        assert detail["id"] == incident_id
        assert detail["manifest"]["reason"] == "admin:smoke"
        inventory = {row["file"]: row["bytes"] for row in detail["inventory"]}
        assert "capture.cbor" in inventory and inventory["capture.cbor"] > 0
        assert "manifest.json" in inventory
        bad = urllib.request.Request(
            base + "/debug/incidents/inc-nope", method="GET"
        )
        try:
            urllib.request.urlopen(bad, timeout=10)
            raise AssertionError("unknown incident id must 404")
        except urllib.error.HTTPError as exc:
            assert exc.code == 404, exc.code
        print(
            f"whatif-smoke: incident detail ok ({incident_id}, "
            f"{len(inventory)} files)"
        )

        verdict = post_json(
            base,
            "/admin/whatif",
            {"bundle": incident_id, "kind": "ab", "speed": 6},
        )
        assert verdict["summary"]["kind"] == "ab"
        assert verdict["summary"]["digest_equal"] is True
        run_verdict = post_json(
            base,
            "/admin/whatif",
            {"bundle": incident_id, "kind": "run", "arm": "mode=cluster"},
        )
        assert run_verdict["summary"]["slo_final"] in (
            "healthy",
            "degraded",
            "violated",
        )
        ring = get_json(base, "/debug/whatif")
        assert ring["results"] >= 2, ring
        assert ring["results_list"][0]["kind"] == "run"
        metrics_text = get_text(base, "/metrics")
        for family in (
            "kvtpu_whatif_runs_total",
            "kvtpu_whatif_events_total",
            "kvtpu_whatif_hit_rate",
        ):
            assert family in metrics_text, f"missing metric {family}"
        print(
            "whatif-smoke: service surfaces ok (/debug/whatif ring "
            f"holds {ring['results']} results)"
        )
    finally:
        server.shutdown()
        event_pool.shutdown()
        indexer.shutdown()


# hack/perf_trend.py's DEFAULT_THRESHOLD: a live headline more than
# this far below the recorded one is a regression.
TREND_THRESHOLD = 0.10


def live_regressions(live, recorded, threshold=TREND_THRESHOLD):
    """hack/perf_trend.py's live what-if check over ``live`` headlines:
    every ``whatif.*`` headline is higher-is-better, and one that fell
    more than ``threshold`` below its recorded value regressed."""
    regressions = []
    for key in sorted(live):
        baseline = recorded.get(key)
        if baseline is None or baseline <= 0:
            continue
        delta = (live[key] - baseline) / baseline
        if delta < -threshold:
            regressions.append(
                f"{key} (live): {live[key]:.4f} vs recorded "
                f"{baseline:.4f} ({delta:+.1%} < -{threshold:.0%})"
            )
    return regressions


def check_perf_trend_gate():
    ab = whatif.reference_ab(REFERENCE)
    live = whatif.gate_headlines(ab)
    with open(os.path.join(REPO, "WHATIF_r01.json")) as handle:
        artifact = json.load(handle)
    honest = live_regressions(live, artifact["headlines"])
    assert not honest, (
        f"perf-trend failed on the honest trajectory: {honest}"
    )

    planted = dict(artifact["headlines"])
    live_hit = planted["whatif.hit_rate"]
    planted["whatif.hit_rate"] = min(1.0, live_hit * 1.5)
    regressions = live_regressions(live, planted)
    assert regressions, (
        "perf-trend must fail on a planted capacity regression"
    )
    assert any("whatif.hit_rate (live)" in r for r in regressions), (
        regressions
    )
    print(
        "whatif-smoke: perf-trend gate ok (honest pass, planted "
        "regression fail)"
    )

    # The recorded baseline IS the live measurement — the headlines
    # are deterministic, so an inequality here means the engine's
    # behavior changed without regenerating the artifacts.
    recorded = artifact["headlines"]
    assert live == recorded, (
        "deterministic headlines drifted from WHATIF_r01.json: "
        f"live {live} vs recorded {recorded} — regenerate the "
        "artifact (see hack/make_reference_capture.py docstring)"
    )
    print("whatif-smoke: recorded baseline matches live bit-for-bit")


def main() -> None:
    assert os.path.isfile(REFERENCE), (
        f"missing {REFERENCE}; run python hack/make_reference_capture.py"
    )
    workdir = tempfile.mkdtemp(prefix="kvtpu-whatif-smoke-")
    try:
        storm = check_composition(workdir)
        check_ab(storm)
        check_service(workdir)
        check_perf_trend_gate()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("whatif smoke completed successfully")


if __name__ == "__main__":
    main()
