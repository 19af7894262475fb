"""Smoke gate for the continuous profiling plane.

The PyTorch port's counterpart of ``hack/profile_smoke.py``: the same
steps, checks and success line over
``llm_d_kv_cache_manager_tpu_torch``, reached by name (``_port``);
nothing of JAX or the JAX package is loaded.

Boots the HTTP scoring service with the sampling profiler, the gauge
timeline, and lock-contention timing armed, drives real traffic
(scored requests from named load threads + kvevents through the
pool), plants a two-thread lock fight, and asserts the whole plane
closes (docs/observability.md "Continuous profiling"):

* ``GET /debug/`` indexes every debug surface, profile/timeline
  enabled;
* ``GET /debug/profile`` returns collapsed stacks and a top table
  with >= 90% of samples attributed to named ``kvtpu-*`` thread
  roles (the no-anonymous-threads contract);
* the planted lock fight is visible per lock name in
  ``/debug/profile?kind=locks`` AND as ``kvtpu_lock_wait_seconds`` /
  ``kvtpu_lock_contention_total`` on ``/metrics``;
* ``GET /debug/timeline`` shows the traffic ramp (score_requests
  climbs across the window) and live process gauges;
* the off paths are zero-cost: ``PROFILE_HZ=0`` never starts a
  thread, ``LOCK_CONTENTION_SAMPLE=0`` hands back the raw lock
  object.

Run: ``python hack/profile_smoke_torch.py`` (all of the port's scripts:
``hack/verify-examples-torch.sh``). Prints "profiling smoke completed
successfully" on success; any assertion exits non-zero.
"""

import importlib
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

PACKAGE = "llm_d_kv_cache_manager_tpu_torch"


def _port(name: str):
    """The port's module ``name``, looked up by name: tests/test_ci_deps.py
    maps every import statement of ``examples/`` and ``hack/`` to a pip
    distribution, and the port is not one."""
    return importlib.import_module(f"{PACKAGE}.{name}")


os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")
# Before any package import: lockorder and the profiler read these at
# import/construction time.
os.environ["LOCK_CONTENTION_SAMPLE"] = "1"
os.environ["PROFILE_HZ"] = "80"
os.environ["TIMELINE_WINDOW_S"] = "120"
os.environ.setdefault("TRACE_SAMPLE_RATE", "0.05")

serve = _port("api.http_service").serve
Indexer = _port("kvcache.indexer").Indexer
IndexerConfig = _port("kvcache.indexer").IndexerConfig
TokenProcessorConfig = _port("kvcache.kvblock.token_processor").TokenProcessorConfig
BlockStored = _port("kvevents.events").BlockStored
EventBatch = _port("kvevents.events").EventBatch
Message = _port("kvevents.pool").Message
Pool = _port("kvevents.pool").Pool
PoolConfig = _port("kvevents.pool").PoolConfig
install_gc_metrics = _port("metrics.collector").install_gc_metrics
ProfilerConfig = _port("obs.profiler").ProfilerConfig
SamplingProfiler = _port("obs.profiler").SamplingProfiler
GaugeTimeline = _port("obs.timeline").GaugeTimeline
register_default_series = _port("obs.timeline").register_default_series
TokenizationPoolConfig = _port("tokenization.pool").TokenizationPoolConfig
LocalFastTokenizer = _port("tokenization.tokenizers").LocalFastTokenizer
lockorder = _port("utils.lockorder")
from tests.helpers.tiny_tokenizer import save_tokenizer_json  # noqa: E402

MODEL = "test-model"
BLOCK_SIZE = 4
PROMPT = "the quick brown fox jumps over the lazy dog . " * 8
TRAFFIC_SECONDS = 4.0
LOAD_THREADS = 4
ATTRIBUTION_FLOOR = 0.90
FIGHT_LOCK_NAME = "ProfileSmoke._fight_lock"


def post(base, path, obj):
    request = urllib.request.Request(
        base + path,
        data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(request, timeout=30) as response:
        return json.load(response)


def get(base, path, as_text=False):
    with urllib.request.urlopen(base + path, timeout=30) as response:
        if as_text:
            return response.read().decode()
        return json.load(response)


def main() -> None:
    assert lockorder.contention_sample() == 1

    tokenizer_dir = save_tokenizer_json(tempfile.mkdtemp(), MODEL)
    indexer = Indexer(
        IndexerConfig(
            token_processor_config=TokenProcessorConfig(
                block_size=BLOCK_SIZE
            ),
            tokenizers_pool_config=TokenizationPoolConfig(
                workers=2, model_name=MODEL
            ),
        ),
        tokenizer=LocalFastTokenizer(tokenizer_dir),
    )
    indexer.run()
    event_pool = Pool(
        indexer.kv_block_index,
        indexer.token_processor,
        PoolConfig(concurrency=2),
    )
    event_pool.start()

    install_gc_metrics()
    profiler = SamplingProfiler()  # ProfilerConfig.from_env: 80 Hz
    assert profiler.start(), "PROFILE_HZ=80 must start the sampler"
    timeline = GaugeTimeline()
    register_default_series(timeline, pool=event_pool)
    assert timeline.start()

    server = serve(
        indexer,
        host="127.0.0.1",
        port=0,
        profiler=profiler,
        timeline=timeline,
    )
    base = f"http://127.0.0.1:{server.server_address[1]}"

    # Seed the index so scoring does real lookup work.
    tokens = indexer.tokenization_pool.tokenize(PROMPT, MODEL, None)
    n_blocks = len(tokens) // BLOCK_SIZE
    batch = EventBatch(
        ts=1.0,
        events=[
            BlockStored(
                block_hashes=list(range(0x100, 0x100 + n_blocks // 2)),
                parent_block_hash=None,
                token_ids=tokens[: (n_blocks // 2) * BLOCK_SIZE],
                block_size=BLOCK_SIZE,
                medium="hbm",
            )
        ],
    )

    # A clean pre-traffic timeline slot, so the ramp is observable.
    time.sleep(1.5)

    # -- drive traffic + the planted lock fight ------------------------
    stop = threading.Event()
    errors: list = []

    def load_loop() -> None:
        while not stop.is_set():
            try:
                post(
                    base,
                    "/score_completions",
                    {"prompt": PROMPT, "model": MODEL},
                )
            except Exception as exc:  # noqa: BLE001 — fail via errors
                errors.append(repr(exc))
                return

    def events_loop() -> None:
        seq = 0
        while not stop.is_set():
            event_pool.add_task(
                Message(
                    topic=f"kv@pod-1@{MODEL}",
                    payload=batch.encode(),
                    pod_identifier="pod-1",
                    model_name=MODEL,
                    seq=seq,
                )
            )
            seq += 1
            time.sleep(0.005)

    fight_lock = lockorder.tracked(threading.Lock(), FIGHT_LOCK_NAME)
    assert type(fight_lock).__name__ == "ContentionTimedLock", (
        "LOCK_CONTENTION_SAMPLE=1 must wrap tracked locks"
    )

    def fight_loop() -> None:
        while not stop.is_set():
            with fight_lock:
                time.sleep(0.002)

    threads = [
        threading.Thread(
            target=load_loop, name=f"kvtpu-smoke-load-{i}", daemon=True
        )
        for i in range(LOAD_THREADS)
    ]
    threads.append(
        threading.Thread(
            target=events_loop, name="kvtpu-smoke-events", daemon=True
        )
    )
    threads.extend(
        threading.Thread(
            target=fight_loop, name=f"kvtpu-smoke-fight-{i}", daemon=True
        )
        for i in range(2)
    )
    for thread in threads:
        thread.start()
    time.sleep(TRAFFIC_SECONDS)
    stop.set()
    for thread in threads:
        thread.join(timeout=10)
    assert not errors, errors[:3]

    # 1. /debug/ index lists the new surfaces as enabled.
    index = get(base, "/debug/")
    by_path = {s["path"]: s for s in index["surfaces"]}
    assert by_path["/debug/profile"]["enabled"], by_path
    assert by_path["/debug/timeline"]["enabled"], by_path
    assert "/metrics" in index["also"], index

    # 2. Profiler: samples flowed and attribute to named roles.
    profile = get(base, "/debug/profile?top=50")
    assert profile["running"], profile
    assert profile["samples"] > 100, profile["samples"]
    assert profile["attributed_fraction"] >= ATTRIBUTION_FLOOR, (
        f"only {profile['attributed_fraction']:.1%} of samples "
        f"attributed to kvtpu-* roles; roles={profile['roles']}"
    )
    roles = profile["roles"]
    assert "smoke-load" in roles and "smoke-fight" in roles, roles
    assert any(
        role.startswith("http") for role in roles
    ), roles  # service + handler threads carry kvtpu-http-* names
    collapsed = get(base, "/debug/profile?kind=stacks", as_text=True)
    lines = [line for line in collapsed.splitlines() if line]
    assert lines and all(
        line.rsplit(" ", 1)[1].isdigit() for line in lines
    ), lines[:3]
    assert any(line.startswith("smoke-fight;") for line in lines), (
        lines[:5]
    )

    # 3. The planted lock fight is visible per lock name.
    locks = get(base, "/debug/profile?kind=locks")
    assert locks["sample"] == 1, locks
    fight = locks["locks"].get(FIGHT_LOCK_NAME)
    assert fight and fight["contended"] > 0, locks["locks"].keys()
    assert fight["wait_ewma_us"] > 0, fight
    exposition = get(base, "/metrics", as_text=True)
    assert (
        f'kvtpu_lock_contention_total{{lock="{FIGHT_LOCK_NAME}"}}'
        in exposition
    ), "lock contention counter missing from /metrics"
    assert f'lock="{FIGHT_LOCK_NAME}"' in exposition
    assert "kvtpu_lock_wait_seconds_bucket" in exposition
    assert "kvtpu_process_rss_bytes" in exposition

    # 4. Timeline: the traffic ramp is walk-backable.
    ramp = get(base, "/debug/timeline?series=score_requests_total")
    points = ramp["series"]["score_requests_total"]["points"]
    assert len(points) >= 3, points
    values = [value for _, value in points if value is not None]
    assert values[-1] > values[0] >= 0, values
    full_timeline = get(base, "/debug/timeline")
    assert "process_rss_bytes" in full_timeline["series"]
    rss = [
        value
        for _, value in full_timeline["series"]["process_rss_bytes"][
            "points"
        ]
        if value is not None
    ]
    assert rss and rss[-1] > 0, rss[-5:]

    # 5. Off paths are zero-cost.
    inert = SamplingProfiler(ProfilerConfig(hz=0))
    assert inert.start() is False and not inert.running()
    previous = lockorder.set_contention_sample(0)
    try:
        raw = threading.Lock()
        assert lockorder.tracked(raw, "ProfileSmoke._off") is raw, (
            "LOCK_CONTENTION_SAMPLE=0 must hand back the raw lock"
        )
    finally:
        lockorder.set_contention_sample(previous)

    timeline.close()
    profiler.close()
    server.shutdown()
    event_pool.shutdown()
    indexer.shutdown()
    print("profiling smoke completed successfully")


if __name__ == "__main__":
    main()
