"""Smoke gate for the predictive tiering plane.

The PyTorch port's counterpart of ``hack/tiering_smoke.py``: the same
steps, checks and success line over
``llm_d_kv_cache_manager_tpu_torch``, reached by name (``_port``);
nothing of JAX or the JAX package is loaded.

Boots the HTTP scoring service with a tiering PolicyEngine attached,
then asserts the whole policy loop closes:

* scored traffic teaches the PolicyFeed (families mapped, snapshot
  refreshed) — visible in ``GET /debug/tiering``;
* a forced demotion (hbm -> host through the DemotionWorker, events
  riding the REAL kvevents pool) is observed in ``/debug/tiering``,
  in ``kvtpu_tiering_demotions_total`` on ``/metrics``, AND in the
  actual score (1.0/block -> 0.8/block through the live endpoint);
* the compute-or-load advice FLIPS when the RTT estimator is
  inflated: cheap readback -> load/hybrid, catastrophic readback ->
  recompute, and ``?explain=1`` carries the advice;
* ``/healthz`` carries the tiering block.

Run: ``python hack/tiering_smoke_torch.py`` (all of the port's scripts:
``hack/verify-examples-torch.sh``). Prints "tiering smoke completed
successfully" on success; any assertion exits non-zero.
"""

import importlib
import json
import os
import sys
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
# Deterministic smoke: record every request, tier detail on all.
os.environ.setdefault("CACHESTATS_SAMPLE_RATE", "1")
os.environ.setdefault("CACHESTATS_TIER_SAMPLE", "1")
os.environ.setdefault("TIERING_REFRESH_S", "0")

serve = _port("api.http_service").serve
Indexer = _port("kvcache.indexer").Indexer
IndexerConfig = _port("kvcache.indexer").IndexerConfig
TokenProcessorConfig = _port("kvcache.kvblock.token_processor").TokenProcessorConfig
BlockStored = _port("kvevents.events").BlockStored
EventBatch = _port("kvevents.events").EventBatch
Message = _port("kvevents.pool").Message
Pool = _port("kvevents.pool").Pool
PoolConfig = _port("kvevents.pool").PoolConfig
DemotionConfig = _port("tiering").DemotionConfig
PodTierState = _port("tiering").PodTierState
PolicyEngine = _port("tiering").PolicyEngine
pool_event_sink = _port("tiering").pool_event_sink
TokenizationPoolConfig = _port("tokenization.pool").TokenizationPoolConfig
Encoding = _port("tokenization.tokenizers").Encoding

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
    engine = PolicyEngine(ledger=indexer.cache_stats)
    indexer.set_policy_engine(engine)
    event_pool = Pool(
        indexer.kv_block_index,
        indexer.token_processor,
        PoolConfig(concurrency=2),
    )
    event_pool.start()

    tokens = list(range(1, 33))  # 8 blocks of 4
    n_blocks = len(tokens) // BLOCK_SIZE
    prompt = " ".join(f"t{t}" for t in tokens)
    engine_hashes = [0x300 + i for i in range(n_blocks)]

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

    server = serve(indexer, host="127.0.0.1", port=0, tiering=engine)
    base = f"http://127.0.0.1:{server.server_address[1]}"

    # 1. Traffic teaches the feed (repeat the prompt so the family
    # develops a reuse rhythm).
    for _ in range(4):
        scores = post(
            base, "/score_completions", {"prompt": prompt, "model": MODEL}
        )
        time.sleep(0.02)
    assert scores.get("pod-1") == n_blocks, scores

    status = get(base, "/debug/tiering")
    assert status["feed"]["observed_chains"] >= 4, status["feed"]
    assert status["feed"]["keys_mapped"] >= n_blocks, status["feed"]
    assert status["feed"]["refreshes"] >= 1, status["feed"]

    # 2. Forced demotion: the worker moves the (now idle-backdated)
    # group hbm -> host; its events ride the same kvevents pool.
    family = engine.feed.snapshot().family_of(
        indexer.token_processor.tokens_to_kv_block_keys(
            0, tokens, MODEL
        )[-1]
    )
    state = PodTierState(
        capacity_bytes=10_000,
        event_sink=pool_event_sink(event_pool, "pod-1", MODEL),
        feed=engine.feed,
    )
    state.register_group(
        0xFACE,
        engine_hashes=engine_hashes,
        token_ids=tokens,
        nbytes=4096,
        block_size=BLOCK_SIZE,
        family=family,
        now=time.monotonic() - 600,
    )
    worker = engine.start_demotion(
        state,
        DemotionConfig(demote_host_idle_s=0.0, require_prediction=False),
        start=False,
    )
    moves = worker.run_cycle()
    assert moves == 1, f"expected 1 demotion, got {moves}"
    event_pool.drain()

    # Observed in /debug/tiering...
    status = get(base, "/debug/tiering")
    demotion = status["demotion"][0]
    assert demotion["moves"] == 1, demotion
    assert demotion["recent"][0]["transition"] == "hbm_to_host", demotion

    # ...in /metrics...
    text = get_text(base, "/metrics")
    assert (
        'kvtpu_tiering_demotions_total{transition="hbm_to_host"} 1.0'
        in text
    ), "demotion counter missing from exposition"
    assert "kvtpu_tiering_demotion_bytes_total" in text

    # ...and in the actual score: host weighs 0.8 per block.
    scores = post(
        base, "/score_completions", {"prompt": prompt, "model": MODEL}
    )
    assert abs(scores["pod-1"] - 0.8 * n_blocks) < 1e-9, scores

    # 3. Compute-or-load advice flips when the RTT estimator inflates.
    advisor = engine.advisor
    advisor.config.bytes_per_block = 4096
    advisor.observe_prefill(8192, 0.5)
    advisor.observe_load(1 << 20, 0.001)  # cheap readback
    fast = advisor.advise(64)
    assert fast.action in ("load", "hybrid"), fast.to_dict()
    for _ in range(20):
        advisor.observe_load(1 << 20, 30.0)  # catastrophic readback
    slow = advisor.advise(64)
    assert slow.action == "recompute", slow.to_dict()

    # The explain surface carries the advice.
    explained = post(
        base,
        "/score_completions?explain=1",
        {"prompt": prompt, "model": MODEL},
    )
    advice = explained["explain"].get("tiering")
    assert advice is not None, explained["explain"].keys()
    assert advice["pod"] == "pod-1", advice
    assert advice["action"] == "recompute", advice

    text = get_text(base, "/metrics")
    assert 'kvtpu_tiering_advice_total{action="recompute"}' in text

    # 4. /healthz tiering block.
    health = get(base, "/healthz")
    tiering_block = health.get("tiering", {})
    assert "advice_counts" in tiering_block, health
    assert tiering_block["demotion_workers"] == 1, tiering_block

    server.shutdown()
    engine.close()
    event_pool.shutdown()
    indexer.shutdown()
    print("tiering smoke completed successfully")


if __name__ == "__main__":
    main()
