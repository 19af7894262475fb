"""The PyTorch port stands alone: it never loads JAX or the JAX package,
and its entry points refuse to fall back to the CPU quietly."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from tests.helpers.torch_port import PACKAGE, port

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "llm_d_kv_cache_manager_tpu")


# The port's demos and smokes: each reaches the port by name (``_port``).
PORT_SCRIPTS = tuple(
    [REPO / "examples" / f"{name}_torch.py" for name in (
        "offline_demo", "online_demo", "index_service_demo", "valkey_demo", "vllm_demo")]
    + [REPO / "hack" / f"{name}_torch.py" for name in (
        "verify_observability", "events_smoke", "cluster_smoke", "slo_smoke", "replay_smoke",
        "whatif_smoke", "profile_smoke", "cachestats_smoke", "tiering_smoke",
        "transfer_smoke", "offload_smoke")]
)


def _port_sources():
    return (sorted((REPO / PACKAGE).rglob("*.py")) + [REPO / "chip_smoke.py"]
            + list(PORT_SCRIPTS))


def test_importing_every_port_module_loads_no_jax():
    """In a fresh interpreter, import every module of the port, the chip
    smoke script and the port's demos and smokes; neither JAX nor the
    JAX package may be loaded.  (tests/test_torch_examples.py and
    tests/test_torch_smokes_*.py run each script whole with both
    blocked.)"""
    script = f"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {str(REPO)!r})
import {PACKAGE} as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import runpy
runpy.run_path({str(REPO / "chip_smoke.py")!r}, run_name="chip_smoke_import")
for path in {[str(p) for p in PORT_SCRIPTS]!r}:
    runpy.run_path(path, run_name="port_script_import")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
print(json.dumps({{"modules": names, "loaded": loaded}}))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert f"{PACKAGE}.models.llama" in result["modules"]
    assert f"{PACKAGE}.ops.paged_decode_cuda" in result["modules"]
    for name in ("parallel.mesh", "parallel.sharding", "parallel.process_group",
                 "ops.ring_attention", "ops.ring_flash", "ops.ring_flash_cuda"):
        assert f"{PACKAGE}.{name}" in result["modules"]
    for name in (OFFLOAD_MODULES + READ_PATH_MODULES + WRITE_PATH_MODULES + TIERING_MODULES
                 + PERSISTENCE_MODULES + CLUSTER_MODULES + SERVICE_MODULES + GRPC_MODULES
                 + CONNECTOR_MODULES):
        assert f"{PACKAGE}.{name}" in result["modules"]
    assert result["loaded"] == []


OFFLOAD_MODULES = (
    "native", "native.build", "native.engine", "offload", "offload.file_mapper",
    "offload.manager", "offload.staging", "offload.host_tier", "offload.worker",
    "offload.staging_engine", "offload.spec", "utils.victim",
)
READ_PATH_MODULES = (
    "utils.logging", "utils.lockorder", "utils.lru", "metrics", "metrics.collector", "obs",
    "obs.recorder", "obs.trace", "kvcache.kvblock.index", "kvcache.kvblock.in_memory",
    "kvcache.kvblock.cost_aware", "kvcache.kvblock.instrumented",
    "kvcache.kvblock.token_processor", "kvcache.scorer", "kvcache.indexer", "preprocessing",
    "preprocessing.chat_templating", "tokenization", "tokenization.tokenizers",
    "tokenization.pool", "tokenization.prefixstore", "tokenization.prefixstore.lru_store",
    "tokenization.prefixstore.trie_store", "analytics", "analytics.windows",
    "analytics.ledger",
)
WRITE_PATH_MODULES = (
    "kvevents", "kvevents.msgpack_codec", "kvevents.events", "kvevents.pool",
    "kvevents.resync", "kvevents.zmq_subscriber", "kvevents.publisher", "kvevents.poller",
    "kvevents.subscriber_manager", "kvevents.pod_reconciler", "analytics.auditor",
    "scheduler", "scheduler.precise_scorer", "utils.ttl_cache",
)
TIERING_MODULES = (
    "tiering", "tiering.policy_feed", "tiering.eviction", "tiering.advisor",
    "tiering.demotion", "tiering.staged_target", "tiering.engine", "transfer",
    "transfer.planner", "transfer.directives", "transfer.warmup", "transfer.engine",
)
PERSISTENCE_MODULES = (
    "persistence", "persistence.snapshot", "persistence.journal", "persistence.recovery",
    "kvcache.kvblock.redis_index",
)
CLUSTER_MODULES = (
    "cluster", "cluster.ring", "cluster.replica", "cluster.membership", "cluster.replication",
    "cluster.remote_index", "cluster.ingest", "cluster.harness",
)
SERVICE_MODULES = (
    "obs.profiler", "obs.timeline", "obs.slo", "obs.capture", "obs.replay", "obs.whatif", "api",
    "api.http_service",
)
# The gRPC half of the service and the tokenizer sidecar: they need
# ``grpc`` and ``google.protobuf``.
GRPC_MODULES = (
    "api.indexer_pb2", "api.tokenizer_pb2", "api.grpc_services", "api.indexer_service",
    "tokenization.uds_tokenizer", "services", "services.uds_tokenizer",
)
# The vLLM connector, raceguard and the native builds: none needs gRPC.
CONNECTOR_MODULES = ("offload.vllm_spec", "utils.raceguard", "native.build")
# What the H100's machine lacks (ROADMAP.md, rules of Queue A).
ABSENT_ON_THE_CARD = ("prometheus_client", "xxhash", "tokenizers", "transformers", "msgpack",
                      "zmq")


def test_read_path_scores_without_the_libraries_the_card_lacks():
    """In a fresh interpreter where ``prometheus_client``, ``xxhash``,
    ``tokenizers``, ``transformers``, ``msgpack`` and ``zmq`` cannot be
    imported (as on the H100's machine), every module of the read path
    imports, and the Indexer scores a prompt with a word tokenizer,
    straight and on the fast lane, and exposes its metrics."""
    script = f"""
import importlib, json, sys
for name in {ABSENT_ON_THE_CARD!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(REPO)!r})
for name in {READ_PATH_MODULES + TIERING_MODULES!r}:
    importlib.import_module({PACKAGE!r} + "." + name)
im = importlib.import_module({PACKAGE!r} + ".kvcache.indexer")
index = importlib.import_module({PACKAGE!r} + ".kvcache.kvblock.index")
tp = importlib.import_module({PACKAGE!r} + ".kvcache.kvblock.token_processor")
tokenizers = importlib.import_module({PACKAGE!r} + ".tokenization.tokenizers")
collector = importlib.import_module({PACKAGE!r} + ".metrics.collector")

class Words:
    def type(self):
        return "word"
    def encode(self, prompt, model_name, add_special_tokens):
        words = prompt.split(" ")
        ends = [sum(len(w) + 1 for w in words[:i + 1]) - 1 for i in range(len(words))]
        return tokenizers.Encoding([int(w[1:]) for w in words],
                                   [(e - len(w), e) for w, e in zip(words, ends)])

out = []
for fast in (True, False):
    indexer = im.Indexer(im.IndexerConfig(
        token_processor_config=tp.TokenProcessorConfig(block_size=4),
        kvblock_index_config=index.IndexConfig(enable_metrics=True),
        read_path_fast_lane=fast), tokenizer=Words())
    indexer.run()
    try:
        tokens = list(range(1, 41))
        keys = indexer.token_processor.tokens_to_kv_block_keys(0, tokens, "m")
        indexer.kv_block_index.add(keys, keys, [index.PodEntry("pod-a", "hbm")])
        prompt = " ".join(f"t{{t}}" for t in tokens)
        out.append(indexer.get_pod_scores(prompt, "m", ["pod-a", "pod-b"]))
    finally:
        indexer.shutdown()
text = collector.METRICS.exposition().decode()
blocked = sorted(n for n in {ABSENT_ON_THE_CARD!r} if sys.modules.get(n) is not None)
print(json.dumps({{"scores": out, "blocked_loaded": blocked,
                  "lookups": "kvtpu_kvcache_index_lookup_requests_total 2.0" in text}}))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"scores": [{"pod-a": 10.0, "pod-b": 0.0}] * 2, "blocked_loaded": [],
                      "lookups": True}


def test_write_path_scores_without_the_libraries_the_card_lacks():
    """The write path's twin of the test above: with the same libraries
    blocked, every module of the write path imports, a payload encoded by
    the port's codec goes through ``parse_event_message`` into the pool
    of a ``PrecisePrefixCacheScorer`` (no pod discovery) and the scorer
    scores the stored prompt; a ``Publisher`` and ``ensure_subscriber``,
    which need a socket, raise ``ImportError``."""
    script = f"""
import importlib, json, struct, sys
for name in {ABSENT_ON_THE_CARD!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(REPO)!r})
mod = lambda name: importlib.import_module({PACKAGE!r} + "." + name)
for name in {WRITE_PATH_MODULES!r}:
    mod(name)
im, tp, tokenizers = mod("kvcache.indexer"), mod("kvcache.kvblock.token_processor"), mod(
    "tokenization.tokenizers")
events, zs, sched = mod("kvevents.events"), mod("kvevents.zmq_subscriber"), mod("scheduler")

class Words:
    def type(self):
        return "word"
    def encode(self, prompt, model_name, add_special_tokens):
        words = prompt.split(" ")
        ends = [sum(len(w) + 1 for w in words[:i + 1]) - 1 for i in range(len(words))]
        return tokenizers.Encoding([int(w[1:]) for w in words],
                                   [(e - len(w), e) for w, e in zip(words, ends)])

indexer = im.Indexer(im.IndexerConfig(
    token_processor_config=tp.TokenProcessorConfig(block_size=4)), tokenizer=Words())
scorer = sched.PrecisePrefixCacheScorer(
    sched.PrecisePrefixCacheScorerConfig(discover_pods=False), indexer=indexer)
raised = []
try:
    tokens = list(range(1, 41))
    payload = events.EventBatch(ts=0.0, events=[events.BlockStored(
        block_hashes=[b"h" * 31 + bytes([i]) for i in range(10)], parent_block_hash=None,
        token_ids=tokens, block_size=4, medium="gpu")]).encode()
    message = zs.parse_event_message([b"kv@pod-a@m", struct.pack(">Q", 1), payload],
                                     endpoint="sim", pod_identifier="pod-a",
                                     tracker=zs.TopicSeqTracker())
    scorer.events_pool.add_tasks([message])
    scorer.events_pool.drain()
    pods = [sched.Pod("ns/a", "pod-a"), sched.Pod("ns/b", "pod-b")]
    got = scorer.score(sched.LLMRequest(target_model="m", completions=sched.CompletionsBody(
        prompt=" ".join(f"t{{t}}" for t in tokens))), pods)
    scores = {{pod.address: value for pod, value in got.items()}}
    for make in (lambda: mod("kvevents.publisher").Publisher("tcp://127.0.0.1:0", "p", "m"),
                 lambda: scorer.subscribers.ensure_subscriber("p", "tcp://127.0.0.1:1")):
        try:
            make()
        except ImportError as exc:
            raised.append("pyzmq" in str(exc))
finally:
    scorer.shutdown()
blocked = sorted(n for n in {ABSENT_ON_THE_CARD!r} if sys.modules.get(n) is not None)
print(json.dumps({{"scores": scores, "raised": raised, "blocked_loaded": blocked}}))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"scores": {"pod-a": 1.0, "pod-b": 0.0}, "raised": [True, True],
                      "blocked_loaded": []}


def test_tiering_and_transfer_run_without_the_libraries_the_card_lacks():
    """With the same libraries blocked, every tiering and transfer module
    imports; a ``PolicyEngine`` on an Indexer's ledger learns a scored
    chain, a demotion cycle moves a group hbm -> host through
    ``pool_event_sink`` (the port's codec and event pool) and the score
    follows (1.0 -> 0.8 a block), and a ``TransferEngine`` plans and
    executes a copy to another pod, whose score rises."""
    script = f"""
import importlib, json, sys, time
for name in {ABSENT_ON_THE_CARD!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(REPO)!r})
mod = lambda name: importlib.import_module({PACKAGE!r} + "." + name)
for name in {TIERING_MODULES!r}:
    mod(name)
im, tp, tokenizers = mod("kvcache.indexer"), mod("kvcache.kvblock.token_processor"), mod(
    "tokenization.tokenizers")
events, pool_mod, ledger_mod = mod("kvevents.events"), mod("kvevents.pool"), mod(
    "analytics.ledger")
tiering, transfer = mod("tiering"), mod("transfer")

class Words:
    def type(self):
        return "word"
    def encode(self, prompt, model_name, add_special_tokens):
        words = prompt.split(" ")
        ends = [sum(len(w) + 1 for w in words[:i + 1]) - 1 for i in range(len(words))]
        return tokenizers.Encoding([int(w[1:]) for w in words],
                                   [(e - len(w), e) for w, e in zip(words, ends)])

ledger = ledger_mod.CacheStatsLedger(ledger_mod.LedgerConfig(sample_rate=1.0))
indexer = im.Indexer(im.IndexerConfig(
    token_processor_config=tp.TokenProcessorConfig(block_size=4)), tokenizer=Words(),
    cache_stats_ledger=ledger)
indexer.run()
pool = pool_mod.Pool(indexer.kv_block_index, indexer.token_processor, pool_mod.PoolConfig())
pool.start()
out = []
try:
    tokens = list(range(1, 41))
    prompt = " ".join(f"t{{t}}" for t in tokens)
    hashes = [0x100 + i for i in range(10)]
    tiering.pool_event_sink(pool, "pod-a", "m")([events.BlockStored(
        block_hashes=hashes, parent_block_hash=None, token_ids=tokens, block_size=4,
        medium="hbm")])
    pool.drain()
    engine = tiering.PolicyEngine(ledger=ledger, config=tiering.TieringConfig(refresh_s=0.0))
    indexer.set_policy_engine(engine)
    out.append(indexer.get_pod_scores(prompt, "m", ["pod-a", "pod-b"]))
    state = tiering.PodTierState(10_000, event_sink=tiering.pool_event_sink(pool, "pod-a", "m"),
                                 feed=engine.feed)
    state.register_group(0xF11E, hashes, tokens, 4096, block_size=4, now=time.monotonic() - 60)
    worker = engine.start_demotion(state, tiering.DemotionConfig(
        demote_host_idle_s=0.0, require_prediction=False), start=False)
    moved = worker.run_cycle()
    pool.drain()
    out.append(indexer.get_pod_scores(prompt, "m", ["pod-a", "pod-b"]))
    advisor = tiering.ComputeOrLoadAdvisor(tiering.AdvisorConfig(
        bytes_per_block=1024, block_tokens=4, prefill_tokens_per_s=50.0))
    advisor.observe_load(4096, 0.001)
    plans = transfer.TransferEngine(advisor=advisor, config=transfer.TransferConfig(
        load_threshold=2.0))
    indexer.set_transfer_engine(plans)
    plans.attach_executor(indexer.kv_block_index, pool, "m", start_warmup=False)
    _, directive = indexer.get_pod_scores_planned(prompt, "m", ["pod-a", "pod-b"],
                                                  pod_loads={{"pod-a": 9.0}})
    executed = plans.executor.execute(plans.planner.get(directive["plan_id"]))
    pool.drain()
    out.append(indexer.get_pod_scores(prompt, "m", ["pod-a", "pod-b"]))
    engine.close()
    plans.close()
finally:
    pool.shutdown()
    indexer.shutdown()
blocked = sorted(n for n in {ABSENT_ON_THE_CARD!r} if sys.modules.get(n) is not None)
print(json.dumps({{"scores": out, "moved": moved, "observed":
                  engine.feed.stats()["observed_chains"], "target": directive["target_pod"],
                  "executed": executed, "blocked_loaded": blocked}}))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    host = 0.0
    for _ in range(10):  # the scorer sums the host weight block by block
        host += 0.8
    assert result == {"scores": [{"pod-a": 10.0, "pod-b": 0.0}, {"pod-a": host, "pod-b": 0.0},
                                 {"pod-a": host, "pod-b": 10.0}],
                      "moved": 1, "observed": 4, "target": "pod-b", "executed": True,
                      "blocked_loaded": []}


def test_persistence_and_cluster_run_without_the_libraries_the_card_lacks():
    """With the same libraries blocked, and ``redis`` and ``cbor2`` as
    well, every persistence and cluster module imports; an event pool with
    the port's ``Journal`` tapped in fills an index, a snapshot plus the
    journal recover it into a fresh one, and a 3-replica strict-wire
    ``LocalCluster`` takes the same events and scores as the index does,
    also after one replica is killed."""
    script = f"""
import importlib, json, sys, tempfile
for name in {ABSENT_ON_THE_CARD + ("redis", "cbor2")!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(REPO)!r})
mod = lambda name: importlib.import_module({PACKAGE!r} + "." + name)
for name in {PERSISTENCE_MODULES + CLUSTER_MODULES!r}:
    mod(name)
persistence, cluster, events = mod("persistence"), mod("cluster"), mod("kvevents.events")
pool_mod, in_memory, tp = mod("kvevents.pool"), mod("kvcache.kvblock.in_memory"), mod(
    "kvcache.kvblock.token_processor")
db = tp.ChunkedTokenDatabase(tp.TokenProcessorConfig(block_size=4))
tokens = list(range(1, 41))
keys = db.tokens_to_kv_block_keys(0, tokens, "m")

def feed(index, journal=None):
    pool = pool_mod.Pool(index, db, pool_mod.PoolConfig(concurrency=1), journal=journal)
    pool.start()
    batch = events.EventBatch(ts=0.0, events=[events.BlockStored(
        block_hashes=list(range(100, 110)), parent_block_hash=None, token_ids=tokens,
        block_size=4, medium="gpu")])
    pool.add_task(pool_mod.Message(topic="kv@pod-a@m", payload=batch.encode(),
                                   pod_identifier="pod-a", model_name="m", seq=1))
    pool.drain()
    pool.shutdown()

def found(index):
    return sorted(index.lookup(keys))

with tempfile.TemporaryDirectory() as root:
    config = persistence.PersistenceConfig(directory=root)
    manager = persistence.PersistenceManager(config)
    live = in_memory.InMemoryIndex()
    feed(live, manager.journal)
    manager.snapshot(live)
    manager.close()
    restored = in_memory.InMemoryIndex()
    report = persistence.recover(restored, config)
    local = cluster.LocalCluster(journal_root=root + "/cluster", strict_wire=True)
    try:
        feed(local.remote_index)
        before = found(local.remote_index)
        local.sync_followers()
        local.kill(local.membership.ring().owner(keys[0]), notice=False)
        after = found(local.remote_index)
        ring_version = local.membership.ring().version
    finally:
        local.close()
blocked = sorted(n for n in {ABSENT_ON_THE_CARD + ("redis", "cbor2")!r}
                 if sys.modules.get(n) is not None)
print(json.dumps({{"live": found(live), "restored": found(restored),
                  "status": report.status, "before": before, "after": after,
                  "ring_version": ring_version, "blocked_loaded": blocked}}))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(result["live"]) == 10
    assert result["restored"] == result["before"] == result["after"] == result["live"]
    assert (result["status"], result["ring_version"], result["blocked_loaded"]) == ("warm", 1, [])


def test_service_serves_captures_and_replays_without_the_libraries_the_card_lacks():
    """With the same libraries blocked, every module of the service and its
    observability plane imports; ``serve()`` with an SLO engine, a sampling
    profiler, a gauge timeline, a capture recorder and an incident manager
    scores over HTTP a prompt whose blocks came through the event pool,
    exposes its metrics, writes an incident bundle on ``POST
    /admin/incident``, and the bundle's capture replays clean."""
    script = f"""
import importlib, json, os, sys, tempfile, urllib.request
for name in {ABSENT_ON_THE_CARD!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(REPO)!r})
mod = lambda name: importlib.import_module({PACKAGE!r} + "." + name)
for name in {SERVICE_MODULES!r}:
    mod(name)
im, tp, index, tokenizers = mod("kvcache.indexer"), mod("kvcache.kvblock.token_processor"), mod(
    "kvcache.kvblock.index"), mod("tokenization.tokenizers")
events, pool_mod, obs, service = mod("kvevents.events"), mod("kvevents.pool"), mod("obs"), mod(
    "api.http_service")

class Words:
    def type(self):
        return "word"
    def encode(self, prompt, model_name, add_special_tokens):
        words = prompt.split(" ")
        ends = [sum(len(w) + 1 for w in words[:i + 1]) - 1 for i in range(len(words))]
        return tokenizers.Encoding([int(w[1:]) for w in words],
                                   [(e - len(w), e) for w, e in zip(words, ends)])

capture = obs.InputCaptureRecorder(obs.CaptureConfig(window_s=600.0, max_bytes=1 << 20),
                                   meta={{"block_size": 4, "hash_seed": "", "model": "m"}})
indexer = im.Indexer(im.IndexerConfig(
    token_processor_config=tp.TokenProcessorConfig(block_size=4, hash_seed=""),
    kvblock_index_config=index.IndexConfig(enable_metrics=True)), tokenizer=Words(),
    capture_recorder=capture)
indexer.run()
pool = pool_mod.Pool(indexer.kv_block_index, indexer.token_processor, pool_mod.PoolConfig(),
                     capture=capture)
pool.start()
profiler = obs.SamplingProfiler(obs.ProfilerConfig(hz=50))
profiler.start()
timeline = obs.GaugeTimeline(window_s=60)
obs.register_default_series(timeline, pool=pool)
timeline.start()
slo = obs.default_fleet_slos(window_fast_s=1.0, window_slow_s=2.0, pool=pool)
incidents = obs.IncidentManager(tempfile.mkdtemp(), capture=capture,
                                index=indexer.kv_block_index, min_interval_s=0.0)
server = service.serve(indexer, host="127.0.0.1", port=0, slo=slo, profiler=profiler,
                       timeline=timeline, capture=capture, incidents=incidents)
base = "http://127.0.0.1:%d" % server.server_address[1]

def call(path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    request = urllib.request.Request(base + path, data=data,
                                     headers={{"Content-Type": "application/json"}})
    with urllib.request.urlopen(request, timeout=30) as response:
        raw = response.read()
        return json.loads(raw) if "json" in response.getheader("Content-Type") else raw

try:
    tokens = list(range(1, 41))
    pool.add_task(pool_mod.Message(topic="kv@pod-a@m", payload=events.EventBatch(
        ts=0.0, events=[events.BlockStored(block_hashes=list(range(100, 110)),
                                           parent_block_hash=None, token_ids=tokens,
                                           block_size=4, medium="hbm")]).encode(),
        pod_identifier="pod-a", model_name="m", seq=1))
    pool.drain()
    prompt = " ".join(f"t{{t}}" for t in tokens)
    scores = call("/score_completions", {{"prompt": prompt, "model": "m"}})
    health = call("/healthz")
    metrics = call("/metrics").decode()
    manifest = call("/admin/incident", {{"reason": "isolation"}})
    bundle = os.path.join(incidents.directory, manifest["id"], "capture.cbor")
    report = obs.replay_capture(obs.load_capture(bundle), mode="single")
    surfaces = [call(path) is not None for path in ("/debug/slo", "/debug/profile",
                                                     "/debug/timeline", "/debug/incidents")]
finally:
    server.shutdown()
    server.server_close()
    profiler.close()
    timeline.close()
    pool.shutdown()
    indexer.shutdown()
blocked = sorted(n for n in {ABSENT_ON_THE_CARD!r} if sys.modules.get(n) is not None)
print(json.dumps({{"scores": scores, "blocks": sorted(k for k in ("slo", "capture", "incidents")
                                                     if k in health),
                  "lookups": "kvtpu_kvcache_index_lookup_requests_total 1.0" in metrics,
                  "replay": [report.ok, report.scores_compared, report.state_compared],
                  "surfaces": surfaces, "blocked_loaded": blocked}}))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"scores": {"pod-a": 10.0}, "blocks": ["capture", "incidents", "slo"],
                      "lookups": True, "replay": [True, 1, True], "surfaces": [True] * 4,
                      "blocked_loaded": []}


def test_grpc_modules_import_and_serve_without_jax():
    """With ``jax`` and the JAX package blocked, every module of the gRPC
    half imports; ``api`` itself loads no message module until one is
    asked for; ``from ...api import indexer_pb2`` works; an Indexer with
    ``uds_tokenizer_path`` scores through the port's sidecar what one with
    the word tokenizer scores, and the gRPC service answers the same."""
    script = f"""
import importlib, json, os, sys, tempfile
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(REPO)!r})
mod = lambda name: importlib.import_module({PACKAGE!r} + "." + name)
api = mod("api")
lazy = sorted(n for n in ("indexer_pb2", "tokenizer_pb2") if {PACKAGE!r} + ".api." + n in sys.modules)
for name in {GRPC_MODULES + CONNECTOR_MODULES!r}:
    mod(name)
from {PACKAGE}.api import indexer_pb2
im, tp, tokenizers = mod("kvcache.indexer"), mod("kvcache.kvblock.token_processor"), mod(
    "tokenization.tokenizers")
index_mod, sidecar, service = mod("kvcache.kvblock.index"), mod("services.uds_tokenizer"), mod(
    "api.indexer_service")

class HfWords:
    def __call__(self, text, add_special_tokens=False, return_offsets_mapping=True):
        ids, offsets, pos = [], [], 0
        for word in text.split(" "):
            ids.append(int(word[1:]))
            offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return {{"input_ids": ids, "offset_mapping": offsets}}

class Words:
    def type(self):
        return "word"
    def encode(self, prompt, model_name, add_special_tokens):
        out = HfWords()(prompt)
        return tokenizers.Encoding(out["input_ids"], out["offset_mapping"])

root = tempfile.mkdtemp()
registry = sidecar.TokenizerRegistry()
registry.register("m", HfWords())
tok_server = sidecar.serve(os.path.join(root, "tok.sock"), max_workers=2, registry=registry)
config = lambda **kw: im.IndexerConfig(
    token_processor_config=tp.TokenProcessorConfig(block_size=4), **kw)
words = im.Indexer(config(), tokenizer=Words())
uds = im.Indexer(config(uds_tokenizer_path=os.path.join(root, "tok.sock")),
                 kv_block_index=words.kv_block_index)
for ix in (words, uds):
    ix.run()
tokens = list(range(1, 41))
keys = words.token_processor.tokens_to_kv_block_keys(index_mod.EMPTY_BLOCK_HASH, tokens, "m")
words.kv_block_index.add(keys, keys, [index_mod.PodEntry("pod-a", "hbm")])
prompts = [" ".join(f"t{{t}}" for t in tokens[:n]) for n in (40, 17, 8)]
server = service.serve(words, "unix://" + os.path.join(root, "ix.sock"))
client = service.new_client("unix://" + os.path.join(root, "ix.sock"))
try:
    got = {{"words": [words.get_pod_scores(p, "m") for p in prompts],
           "uds": [uds.get_pod_scores(p, "m") for p in prompts],
           "grpc": [{{s.pod: s.score for s in client.GetPodScores(indexer_pb2.GetPodScoresRequest(
               prompt=p, model_name="m")).scores}} for p in prompts]}}
finally:
    client.channel.close()
    server.stop(grace=None)
    tok_server.stop(grace=None)
    uds.tokenization_pool._tokenizer.backends[0].close()
    for ix in (words, uds):
        ix.shutdown()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}
                and sys.modules[m] is not None)
print(json.dumps({{"lazy": lazy, "got": got, "loaded": loaded}}))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["lazy"] == [] and result["loaded"] == []
    want = [{"pod-a": 10.0}, {"pod-a": 4.0}, {"pod-a": 2.0}]
    assert result["got"] == {"words": want, "uds": want, "grpc": want}


def test_http_service_and_connector_run_without_grpc_or_protobuf():
    """On a machine without ``grpc`` and ``google.protobuf`` (blocked here
    with JAX, the JAX package and what the card's machine lacks):
    ``api.http_service`` imports and serves a score, ``offload.vllm_spec``
    round-trips bf16 blocks of torch tensors through its spec,
    ``utils.raceguard`` loads the port's manifest, ``native.build``
    imports, and ``api.indexer_pb2`` alone fails to import."""
    blocked = FORBIDDEN + ABSENT_ON_THE_CARD + ("grpc", "google.protobuf")
    script = f"""
import importlib, json, os, sys, tempfile, urllib.request
for name in {blocked!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(REPO)!r})
import torch
mod = lambda name: importlib.import_module({PACKAGE!r} + "." + name)
service, vllm_spec, raceguard = mod("api.http_service"), mod("offload.vllm_spec"), mod(
    "utils.raceguard")
mod("native.build")
try:
    mod("api.indexer_pb2")
    pb2_error = None
except ImportError as exc:
    pb2_error = isinstance(exc, ImportError)
im, tp, tokenizers, index_mod = mod("kvcache.indexer"), mod(
    "kvcache.kvblock.token_processor"), mod("tokenization.tokenizers"), mod("kvcache.kvblock.index")

class Words:
    def type(self):
        return "word"
    def encode(self, prompt, model_name, add_special_tokens):
        words = prompt.split(" ")
        ends = [sum(len(w) + 1 for w in words[:i + 1]) - 1 for i in range(len(words))]
        return tokenizers.Encoding([int(w[1:]) for w in words],
                                   [(e - len(w), e) for w, e in zip(words, ends)])

indexer = im.Indexer(im.IndexerConfig(token_processor_config=tp.TokenProcessorConfig(block_size=4)),
                     tokenizer=Words())
indexer.run()
tokens = list(range(1, 41))
keys = indexer.token_processor.tokens_to_kv_block_keys(index_mod.EMPTY_BLOCK_HASH, tokens, "m")
indexer.kv_block_index.add(keys, keys, [index_mod.PodEntry("pod-a", "hbm")])
server = service.serve(indexer, host="127.0.0.1", port=0)
try:
    request = urllib.request.Request(
        "http://127.0.0.1:%d/score_completions" % server.server_address[1],
        data=json.dumps({{"prompt": " ".join(f"t{{t}}" for t in tokens), "model": "m"}}).encode(),
        headers={{"Content-Type": "application/json"}})
    with urllib.request.urlopen(request, timeout=30) as response:
        scores = json.loads(response.read())
finally:
    server.shutdown()
    server.server_close()
    indexer.shutdown()

class Cfg:
    pass
config = Cfg()
config.cache_config, config.model_config, config.parallel_config, config.kv_transfer_config = (
    Cfg(), Cfg(), Cfg(), Cfg())
config.cache_config.block_size, config.cache_config.cache_dtype = 16, "auto"
config.model_config.model, config.model_config.dtype = "m", "bfloat16"
config.parallel_config.rank = 0
config.kv_transfer_config.kv_connector_extra_config = {{
    "shared_storage_path": tempfile.mkdtemp(), "block_size": 32}}

class Backend:
    @staticmethod
    def get_kv_cache_shape(num_blocks, block_size, num_kv_heads, head_size):
        return (num_blocks, 2, block_size, num_kv_heads, head_size)

layers = {{f"l{{i}}": torch.randn(8, 2, 16, 2, 4).to(torch.bfloat16) for i in range(2)}}
original = {{k: v.clone() for k, v in layers.items()}}
spec = vllm_spec.TPUSharedStorageOffloadingSpec(config, None)
(_, _, store), (_, _, load) = spec.get_handlers(layers, {{k: Backend for k in layers}})
ids, hashes = list(range(8)), [1, 2, 3, 4]
store.transfer_async(1, (vllm_spec.GPULoadStoreSpec(ids),
                         vllm_spec.TPUSharedStorageLoadStoreSpec(hashes)))
store.wait({{1}})
for v in layers.values():
    v.zero_()
load.transfer_async(2, (vllm_spec.TPUSharedStorageLoadStoreSpec(hashes),
                        vllm_spec.GPULoadStoreSpec(ids)))
load.wait({{2}})
same = all(torch.equal(layers[k], original[k]) for k in layers)
manifest = len(raceguard.load_manifest()["classes"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "grpc",
    "llm_d_kv_cache_manager_tpu") and sys.modules[m] is not None)
loaded += sorted(m for m in sys.modules if m.startswith("google.protobuf")
                 and sys.modules[m] is not None)
print(json.dumps({{"scores": scores, "same": same, "manifest": manifest, "pb2_error": pb2_error,
                  "lookup": spec.get_manager().lookup(hashes), "loaded": loaded}}))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["scores"] == {"pod-a": 10.0}
    assert result["same"] is True and result["lookup"] == 4
    assert result["manifest"] >= 30 and result["pb2_error"] is True
    assert result["loaded"] == []


def test_obs_exports_the_references_names():
    """The port's ``obs`` exports exactly the reference's ``__all__``, each
    name the port's own object."""
    import importlib

    reference = importlib.import_module("llm_d_kv_cache_manager_tpu.obs")
    ours = port("obs")
    assert list(ours.__all__) == list(reference.__all__)
    for name in ours.__all__:
        value = getattr(ours, name)
        owner = value if isinstance(value, type) or callable(value) and hasattr(
            value, "__module__") else type(value)
        assert owner.__module__.startswith(PACKAGE + "."), name


@pytest.mark.parametrize("package", ["ops", "parallel"])
def test_package_exports_the_references_names(package):
    """The port's ``ops`` and ``parallel`` export exactly the reference's
    ``__all__``, and each name is the port's function or class, not a
    submodule; importing them builds no kernel.  ``parallel`` also
    re-exports ``make_hybrid_mesh``, the port's counterpart of the
    reference's ``parallel/mesh.py`` function."""
    import importlib
    import types

    reference = importlib.import_module(f"llm_d_kv_cache_manager_tpu.{package}")
    ours = port(package)
    assert list(ours.__all__) == list(reference.__all__)
    for name in ours.__all__:
        value = getattr(ours, name)
        assert not isinstance(value, types.ModuleType), name
        assert callable(value) or isinstance(value, str), name
        assert isinstance(value, str) == isinstance(getattr(reference, name), str), name
        if isinstance(value, str):
            assert value == getattr(reference, name)
        else:
            assert value.__module__.startswith(PACKAGE + "."), name
    if package == "parallel":
        ref_mesh = importlib.import_module("llm_d_kv_cache_manager_tpu.parallel.mesh")
        assert callable(ref_mesh.make_hybrid_mesh)
        assert ours.make_hybrid_mesh is port("parallel.mesh").make_hybrid_mesh
        assert ours.make_hybrid_mesh.__module__ == PACKAGE + ".parallel.mesh"
    build = port("ops._build")
    assert not getattr(build, "_LIBS", {}), "importing the ops package built a kernel"


def test_native_engine_builds_from_the_ports_own_sources():
    """The native engine's sources are the port's copy: the build reads
    ``native/src`` inside the port, and every quoted ``#include`` there
    names a file of that directory."""
    build = port("native.build")
    src = REPO / PACKAGE / "native" / "src"
    assert build.SRC_DIR == src and build.BUILD_DIR == REPO / PACKAGE / "build"
    names = set(build.SOURCES + build.HEADERS + (build.STRESS_MAIN,))
    assert names == {p.name for p in src.iterdir()}
    for name in names:
        for line in (src / name).read_text().splitlines():
            if line.startswith("#include \""):
                assert line.split('"')[1] in names, (name, line)


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: str(p.relative_to(REPO))
)
def test_no_source_imports_jax_or_the_jax_package(path):
    """Static check, function bodies included: no import statement of the
    port or of chip_smoke.py names JAX or the JAX package."""
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert bad == []


@pytest.mark.parametrize("path", PORT_SCRIPTS, ids=lambda p: str(p.relative_to(REPO)))
def test_port_script_looks_up_only_the_ports_modules(path):
    """Every ``_port("name")`` of a port script, function bodies
    included, names a module of the port, and ``_port`` looks names up
    in the port's package."""
    tree = ast.parse(path.read_text())
    assigned = {node.targets[0].id: node.value.value for node in tree.body
                if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
                and isinstance(node.targets[0], ast.Name)}
    assert assigned["PACKAGE"] == PACKAGE
    names = [node.args[0].value for node in ast.walk(tree)
             if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "_port"]
    assert names
    for name in names:
        base = REPO / PACKAGE / pathlib.Path(*name.split("."))
        assert base.with_suffix(".py").is_file() or (base / "__init__.py").is_file(), name


def _pool():
    mod = port("models.kv_cache_pool")
    return mod.KVCachePool(mod.KVCachePoolConfig(1, 2, 4, 1, 8))


def _params():
    llama = port("models.llama")
    return llama.init_params(llama.LlamaConfig(n_layers=1), torch.Generator())


def _moe_params():
    moe = port("models.moe")
    return moe.init_params(moe.MoEConfig(n_layers=1, vocab_size=8), torch.Generator())


def _resolve():
    return port("utils.device").resolve_device("cuda")


def _mesh():
    mod = port("parallel.mesh")
    return mod.make_mesh(mod.MeshPlan(dp=1))


def _shard():
    sharding = port("parallel.sharding")
    return sharding.shard(torch.zeros(2), _mesh(), sharding.P(None))


def _hybrid_mesh():
    return port("parallel.mesh").make_hybrid_mesh()


@pytest.mark.parametrize(
    "entry", [_pool, _params, _resolve, _mesh, _moe_params, _shard, _hybrid_mesh],
    ids=["KVCachePool", "init_params", "resolve_device", "make_mesh", "moe.init_params",
         "shard", "make_hybrid_mesh"],
)
def test_entry_point_without_device_raises_without_gpu(entry):
    """Entry points default to CUDA; with no GPU they raise instead of
    carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        entry()


def test_entry_points_run_on_cpu_when_asked():
    mod = port("models.kv_cache_pool")
    pool = mod.KVCachePool(mod.KVCachePoolConfig(1, 2, 4, 1, 8), device="cpu")
    assert pool.kv.device.type == "cpu" and not pool.pinned_host
    with pytest.raises(RuntimeError):
        pool.stage_gather_pinned([0])


def test_moe_init_params_runs_on_cpu_when_asked():
    moe = port("models.moe")
    cfg = moe.MoEConfig(vocab_size=16, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1,
                        d_ff=8, n_experts=2)
    params = moe.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["embed"].device.type == "cpu"
    assert params["layers"]["router"].dtype == torch.float32


def test_build_sources_are_the_kernel_files():
    """Every ``csrc/*.cu`` is named in ``_build.SOURCES``, so a build of
    all sources builds every kernel."""
    build = port("ops._build")
    assert sorted(build.SOURCES) == sorted(p.stem for p in build.CSRC.glob("*.cu"))


def test_shard_runs_on_cpu_when_asked():
    """``make_mesh`` given ``"cpu"`` ranks: shard, a sharded pool and
    unshard run there."""
    mesh_mod, sharding = port("parallel.mesh"), port("parallel.sharding")
    pool_mod = port("models.kv_cache_pool")
    mesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(dp=1, tp=2), ["cpu"] * 2)
    x = sharding.shard(torch.arange(4.0), mesh, sharding.P("tp"))
    assert {t.device.type for _, t in x.distinct()} == {"cpu"}
    assert torch.equal(sharding.unshard(x), torch.arange(4.0))
    pool = pool_mod.KVCachePool(
        pool_mod.KVCachePoolConfig(1, 2, 4, 2, 8),
        sharding=sharding.NamedSharding(mesh, sharding.P(None, None, None, None, "tp")))
    assert pool.sharded and not pool.pinned_host and pool.kv.local_shape == (1, 2, 2, 4, 1, 8)
