"""Smoke gate for the cache-efficiency analytics plane.

The PyTorch port's counterpart of ``hack/cachestats_smoke.py``: the same
steps, checks and success line over
``llm_d_kv_cache_manager_tpu_torch``, reached by name (``_port``);
nothing of JAX or the JAX package is loaded.

Boots the HTTP scoring service with the hit-attribution ledger and an
index-truth auditor wired to a controllable inventory source, then
asserts the whole analytics loop closes:

* scored traffic lands in the ledger: ``GET /debug/cachestats`` shows
  the right request count, a sane hit/partial split, a tracked prefix
  family, and live window frames;
* the family drill-down (``?family=<id>``) resolves;
* a planted divergence (the inventory "forgets" 10% of a pod's
  blocks) is detected by one auditor cycle: the report says divergent
  with the right ratio, the audit log carries it, and
  ``kvtpu_index_divergence_ratio`` lands on ``/metrics``;
* ``/healthz`` carries the analytics block (ledger summary + audit
  status);
* the analytics metric families are present in the exposition.

Run: ``python hack/cachestats_smoke_torch.py`` (all of the port's
scripts: ``hack/verify-examples-torch.sh``). Prints "cachestats smoke
completed successfully" on success; any assertion exits non-zero.
"""

import importlib
import json
import os
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
# Deterministic smoke: record every request, tier detail on all.
os.environ.setdefault("CACHESTATS_SAMPLE_RATE", "1")
os.environ.setdefault("CACHESTATS_TIER_SAMPLE", "1")

AuditorConfig = _port("analytics").AuditorConfig
IndexAuditor = _port("analytics").IndexAuditor
serve = _port("api.http_service").serve
Indexer = _port("kvcache.indexer").Indexer
IndexerConfig = _port("kvcache.indexer").IndexerConfig
TokenProcessorConfig = _port("kvcache.kvblock.token_processor").TokenProcessorConfig
BlockStored = _port("kvevents.events").BlockStored
EventBatch = _port("kvevents.events").EventBatch
Message = _port("kvevents.pool").Message
Pool = _port("kvevents.pool").Pool
PoolConfig = _port("kvevents.pool").PoolConfig
CallableInventorySource = _port("kvevents.resync").CallableInventorySource
InventoryBlock = _port("kvevents.resync").InventoryBlock
PodInventory = _port("kvevents.resync").PodInventory
TokenizationPoolConfig = _port("tokenization.pool").TokenizationPoolConfig
LocalFastTokenizer = _port("tokenization.tokenizers").LocalFastTokenizer
from tests.helpers.tiny_tokenizer import save_tokenizer_json  # noqa: E402

MODEL = "test-model"
BLOCK_SIZE = 4
PROMPT = "the quick brown fox jumps over the lazy dog . " * 8
COLD = "completely different words never stored anywhere at all . " * 8


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
    assert indexer.cache_stats is not None, "ledger must default on"
    indexer.run()
    event_pool = Pool(
        indexer.kv_block_index,
        indexer.token_processor,
        PoolConfig(concurrency=2),
    )
    event_pool.start()

    # Store the warm prompt's full chain on pod-1; remember the truth
    # for the inventory source.
    tokens = indexer.tokenization_pool.tokenize(PROMPT, MODEL, None)
    n_blocks = len(tokens) // BLOCK_SIZE
    engine_hashes = list(range(0x200, 0x200 + n_blocks))
    batch = EventBatch(
        ts=1.0,
        events=[
            BlockStored(
                block_hashes=list(engine_hashes),
                parent_block_hash=None,
                token_ids=tokens[: n_blocks * BLOCK_SIZE],
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

    inventory_blocks = {
        "pod-1": [
            InventoryBlock(
                block_hashes=list(engine_hashes),
                token_ids=tokens[: n_blocks * BLOCK_SIZE],
                block_size=BLOCK_SIZE,
                medium="hbm",
            )
        ]
    }

    def fetch(pod):
        blocks = inventory_blocks.get(pod)
        if blocks is None:
            return None
        return PodInventory(
            pod_identifier=pod, model_name=MODEL, blocks=blocks
        )

    auditor = IndexAuditor(
        indexer.kv_block_index,
        indexer.token_processor,
        CallableInventorySource(fetch),
        AuditorConfig(interval_s=0.0),
    )
    server = serve(indexer, host="127.0.0.1", port=0, auditor=auditor)
    base = f"http://127.0.0.1:{server.server_address[1]}"

    # 1. Scored traffic: warm hits + a cold miss.
    warm_scores = post(
        base, "/score_completions", {"prompt": PROMPT, "model": MODEL}
    )
    assert warm_scores.get("pod-1") == n_blocks, warm_scores
    for _ in range(3):
        post(base, "/score_completions", {"prompt": PROMPT, "model": MODEL})
    cold_scores = post(
        base, "/score_completions", {"prompt": COLD, "model": MODEL}
    )
    assert cold_scores == {}, cold_scores

    # 2. /debug/cachestats: totals, windows, families.
    stats = get(base, "/debug/cachestats")
    totals = stats["totals"]
    assert totals["recorded"] == 5, totals
    assert totals["hits"] == 4, totals
    assert totals["misses"] == 1, totals
    assert totals["tiers"].get("hbm", 0) > 0, totals
    assert stats["windows"]["1m"]["requests"] == 5, stats["windows"]
    assert stats["families_tracked"] >= 2, stats
    top = stats["top_families"]
    assert top and top[0]["requests"] == 4, top
    assert top[0]["ewma_interarrival_s"] is not None, top

    # 3. Family drill-down.
    family = get(base, f"/debug/cachestats?family={top[0]['family']}")
    assert family["requests"] == 4, family

    # 4. Clean audit first: index and inventory agree.
    reports = auditor.run_cycle()
    assert len(reports) == 1 and reports[0].outcome == "clean", [
        r.to_dict() for r in reports
    ]

    # 5. Plant a divergence: the pod "forgets" 10% of its blocks, so
    # the index's claims become phantoms; one cycle must detect it.
    keep = n_blocks - max(1, n_blocks // 10)
    victim = inventory_blocks["pod-1"][0]
    victim.block_hashes = victim.block_hashes[:keep]
    victim.token_ids = victim.token_ids[: keep * BLOCK_SIZE]
    planted_ratio = (n_blocks - keep) / n_blocks
    reports = auditor.run_cycle()
    report = reports[0]
    assert report.outcome == "divergent", report.to_dict()
    assert abs(report.divergence_ratio - planted_ratio) < 1e-6, (
        report.to_dict(),
        planted_ratio,
    )
    assert report.phantom == n_blocks - keep, report.to_dict()

    stats = get(base, "/debug/cachestats")
    assert stats["audit"]["divergent_pods"].get("pod-1"), stats["audit"]
    assert stats["audit_log"], "audit log empty"
    assert stats["audit_divergent"][0]["pod"] == "pod-1", stats

    # 6. /healthz analytics block.
    health = get(base, "/healthz")
    analytics = health.get("analytics", {})
    assert analytics.get("cachestats", {}).get("recorded") == 5, analytics
    assert analytics.get("audit", {}).get("audits") == 2, analytics

    # 7. Metric families on /metrics.
    text = get_text(base, "/metrics")
    assert 'kvtpu_cachestats_requests_total{outcome="hit"} 4.0' in text
    assert 'kvtpu_index_divergence_ratio{pod="pod-1"}' in text
    assert "kvtpu_cachestats_reuse_distance_count" in text
    assert 'kvtpu_index_audits_total{outcome="divergent"} 1.0' in text

    server.shutdown()
    event_pool.shutdown()
    indexer.shutdown()
    print("cachestats smoke completed successfully")


if __name__ == "__main__":
    main()
