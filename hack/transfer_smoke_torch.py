"""Smoke gate for the KV-transfer planning plane.

The PyTorch port's counterpart of ``hack/transfer_smoke.py``: the same
steps, checks and success line over
``llm_d_kv_cache_manager_tpu_torch``, reached by name (``_port``);
nothing of JAX or the JAX package is loaded.

Boots the HTTP scoring service with a TransferEngine attached, then
asserts the whole transfer loop closes over real wire surfaces:

* scored traffic (``plan: true`` + ``pod_loads``) yields a transfer
  directive pricing pod-to-pod movement against recompute, and the
  same request teaches the hot-family catalog;
* executing the planned directive publishes REAL KVEvents through the
  kvevents pool — the target pod's score rises through the ordinary
  index path (0 -> full chain via the live endpoint);
* a cold pod registering for instant-warm scale-out gets the hot
  family bulk-planned and drained by the warm-up worker, visible in
  ``GET /debug/transfer``, in ``kvtpu_transfer_warmup_moves_total``
  on ``/metrics``, AND in the cold pod's actual score;
* ``/healthz`` carries the transfer block.

Run: ``python hack/transfer_smoke_torch.py`` (all of the port's scripts:
``hack/verify-examples-torch.sh``). Prints "transfer smoke completed
successfully" on success; any assertion exits non-zero.
"""

import importlib
import json
import os
import sys
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

PACKAGE = "llm_d_kv_cache_manager_tpu_torch"


def _port(name: str):
    """The port's module ``name``, looked up by name: tests/test_ci_deps.py
    maps every import statement of ``examples/`` and ``hack/`` to a pip
    distribution, and the port is not one."""
    return importlib.import_module(f"{PACKAGE}.{name}")


os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")
# Deterministic smoke: record every request so the ledger ranks the
# family for warm-up, and keep tier detail on all provenance.
os.environ.setdefault("CACHESTATS_SAMPLE_RATE", "1")
os.environ.setdefault("CACHESTATS_TIER_SAMPLE", "1")

serve = _port("api.http_service").serve
Indexer = _port("kvcache.indexer").Indexer
IndexerConfig = _port("kvcache.indexer").IndexerConfig
TokenProcessorConfig = _port("kvcache.kvblock.token_processor").TokenProcessorConfig
BlockStored = _port("kvevents.events").BlockStored
EventBatch = _port("kvevents.events").EventBatch
Message = _port("kvevents.pool").Message
Pool = _port("kvevents.pool").Pool
PoolConfig = _port("kvevents.pool").PoolConfig
AdvisorConfig = _port("tiering.advisor").AdvisorConfig
ComputeOrLoadAdvisor = _port("tiering.advisor").ComputeOrLoadAdvisor
TokenizationPoolConfig = _port("tokenization.pool").TokenizationPoolConfig
Encoding = _port("tokenization.tokenizers").Encoding
TransferConfig = _port("transfer").TransferConfig
TransferEngine = _port("transfer").TransferEngine

MODEL = "test-model"
BLOCK_SIZE = 4


class WordTokenizer:
    """Deterministic whitespace tokenizer: 'tN' -> N."""

    def type(self) -> str:
        return "word"

    def encode(self, prompt, model_name, add_special_tokens=True):
        tokens, offsets, pos = [], [], 0
        for word in prompt.split(" "):
            tokens.append(int(word[1:]))
            offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return Encoding(tokens, offsets)


def post(base, path, obj):
    request = urllib.request.Request(
        base + path,
        data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(request, timeout=30) as response:
        return json.load(response)


def get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as response:
        return json.load(response)


def get_text(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as response:
        return response.read().decode()


def main() -> None:
    indexer = Indexer(
        IndexerConfig(
            token_processor_config=TokenProcessorConfig(
                block_size=BLOCK_SIZE
            ),
            tokenizers_pool_config=TokenizationPoolConfig(
                workers=2, model_name=MODEL
            ),
        ),
        tokenizer=WordTokenizer(),
    )
    assert indexer.cache_stats is not None, "ledger must default on"
    indexer.run()

    # Advisor with both RTT models fed so transfers price cheap
    # against a deliberately slow prefill rate.
    advisor = ComputeOrLoadAdvisor(
        AdvisorConfig(
            bytes_per_block=1024,
            block_tokens=BLOCK_SIZE,
            prefill_tokens_per_s=50.0,
        )
    )
    advisor.observe_load(4096, 0.001)
    advisor.observe_store(4096, 0.0005)

    engine = TransferEngine(
        advisor=advisor,
        config=TransferConfig(load_threshold=2.0, min_blocks=2),
    )
    indexer.set_transfer_engine(engine)
    assert engine.ledger is indexer.cache_stats, "ledger must bind"

    event_pool = Pool(
        indexer.kv_block_index,
        indexer.token_processor,
        PoolConfig(concurrency=2),
    )
    event_pool.start()
    # Directive channel's write side: executed transfers publish real
    # KVEvents through this pool.  The smoke pumps warm-up cycles by
    # hand, so the drain thread stays off.
    engine.attach_executor(
        indexer.kv_block_index, event_pool, MODEL, start_warmup=False
    )

    tokens = list(range(1, 33))  # 8 blocks of 4
    n_blocks = len(tokens) // BLOCK_SIZE
    prompt = " ".join(f"t{t}" for t in tokens)
    engine_hashes = [0x700 + i for i in range(n_blocks)]

    # Seed the chain on pod-1 at hbm through the pool.
    batch = EventBatch(
        ts=1.0,
        events=[
            BlockStored(
                block_hashes=list(engine_hashes),
                parent_block_hash=None,
                token_ids=tokens,
                block_size=BLOCK_SIZE,
                medium="hbm",
            )
        ],
    )
    event_pool.add_task(
        Message(
            topic=f"kv@pod-1@{MODEL}",
            payload=batch.encode(),
            pod_identifier="pod-1",
            model_name=MODEL,
        )
    )
    event_pool.drain()

    server = serve(indexer, host="127.0.0.1", port=0, transfer=engine)
    base = f"http://127.0.0.1:{server.server_address[1]}"

    # 1. Repeat traffic so the ledger develops a reuse rhythm for the
    # family (warm-up ranking feeds off reuse_predictions()).
    for _ in range(4):
        scores = post(
            base, "/score_completions", {"prompt": prompt, "model": MODEL}
        )
    assert scores.get("pod-1") == n_blocks, scores

    # 2. Planned scoring: pod-1 overloaded, pod-2 idle -> directive.
    reply = post(
        base,
        "/score_completions",
        {
            "prompt": prompt,
            "model": MODEL,
            "pods": ["pod-1", "pod-2"],
            "pod_loads": {"pod-1": 9.0, "pod-2": 0.0},
            "plan": True,
        },
    )
    directive = reply["transfer"]
    assert directive["planned"] is True, directive
    assert directive["source_pod"] == "pod-1", directive
    assert directive["target_pod"] == "pod-2", directive
    assert directive["blocks"] == n_blocks, directive

    # The explain surface carries the same directive.
    explained = post(
        base,
        "/score_completions?explain=1",
        {
            "prompt": prompt,
            "model": MODEL,
            "pod_loads": {"pod-1": 9.0, "pod-2": 0.0},
        },
    )
    assert "transfer" in explained["explain"], explained["explain"].keys()

    # 3. Execute the plan: real KVEvents flow, pod-2's score rises
    # through the ordinary index path.
    plan = engine.planner.get(directive["plan_id"])
    assert plan is not None, directive
    assert engine.executor.execute(plan) is True
    event_pool.drain()
    scores = post(
        base, "/score_completions", {"prompt": prompt, "model": MODEL}
    )
    assert scores.get("pod-2") == n_blocks, scores

    # 4. Instant-warm scale-out: cold pod-3 registers, the hot family
    # is bulk-planned and the worker drains the queue.
    queued = engine.register_cold_pod("pod-3")
    assert queued >= 1, "cold pod got no warm-up plans"
    status = get(base, "/debug/transfer")
    assert status["warmup"]["queued"] >= 1, status["warmup"]
    assert status["warmup"]["cold_pods"].get("pod-3", 0) >= 1, status[
        "warmup"
    ]
    while engine.run_warmup_cycle():
        pass
    event_pool.drain()
    scores = post(
        base, "/score_completions", {"prompt": prompt, "model": MODEL}
    )
    assert scores.get("pod-3") == n_blocks, scores

    # 5. The debug surface tells the whole story.
    status = get(base, "/debug/transfer")
    assert status["planner"]["outcomes"].get("planned", 0) >= 1, status[
        "planner"
    ]
    assert status["catalog"]["families"] >= 1, status["catalog"]
    assert status["executor"]["executed"] >= 2, status["executor"]
    assert status["warmup"]["queued"] == 0, status["warmup"]
    assert status["warmup"]["cold_pods"] == {}, status["warmup"]
    assert status["warmup"]["warmed_moves"].get("pod-3", 0) >= 1, status[
        "warmup"
    ]
    assert status["config"]["load_threshold"] == 2.0, status["config"]

    # 6. /metrics exposition.
    text = get_text(base, "/metrics")
    assert (
        'kvtpu_transfer_plans_total{outcome="planned"}' in text
    ), "plan counter missing from exposition"
    assert (
        'kvtpu_transfer_executions_total{outcome="copied"}' in text
    ), "execution counter missing from exposition"
    assert "kvtpu_transfer_bytes_total" in text
    assert "kvtpu_transfer_warmup_moves_total" in text
    assert "kvtpu_transfer_cold_pods 0.0" in text

    # 7. /healthz transfer block + debug index row.
    health = get(base, "/healthz")
    transfer_block = health.get("transfer", {})
    assert transfer_block.get("plans", 0) >= 1, health
    assert transfer_block.get("cold_pods") == 0, transfer_block
    debug_index = get(base, "/debug")
    surfaces = {
        row["path"]: row["enabled"] for row in debug_index["surfaces"]
    }
    assert surfaces["/debug/transfer"] is True, surfaces

    server.shutdown()
    engine.close()
    event_pool.shutdown()
    indexer.shutdown()
    print("transfer smoke completed successfully")


if __name__ == "__main__":
    main()
