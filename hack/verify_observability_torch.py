"""Smoke gate for the tracing debug surface.

The PyTorch port's counterpart of ``hack/verify_observability.py``: the
same steps, checks and success line over
``llm_d_kv_cache_manager_tpu_torch``, reached by name (``_port``);
nothing of JAX or the JAX package is loaded.

Boots the HTTP scoring service against a tiny local tokenizer, makes a
scored request carrying a W3C ``traceparent`` header, and asserts the
whole observability loop closes:

* the response echoes a traceparent with the caller's trace id;
* ``GET /debug/traces`` lists the trace and ``GET /debug/traces/<id>``
  returns its spans (tokenize/hash_blocks/index_lookup/score);
* ``?explain=1`` returns the per-stage breakdown and per-pod score
  provenance (break index, tiers);
* ``/healthz`` carries the observability block.

Run: ``python hack/verify_observability_torch.py`` (all of the port's
scripts: ``hack/verify-examples-torch.sh``). Prints "observability smoke
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
# Before any package import: the tracer reads these at import time.
os.environ.setdefault("TRACE_SAMPLE_RATE", "1")
os.environ.setdefault("TRACE_RING_SIZE", "64")

serve = _port("api.http_service").serve
Indexer = _port("kvcache.indexer").Indexer
IndexerConfig = _port("kvcache.indexer").IndexerConfig
TokenProcessorConfig = _port("kvcache.kvblock.token_processor").TokenProcessorConfig
BlockStored = _port("kvevents.events").BlockStored
EventBatch = _port("kvevents.events").EventBatch
Message = _port("kvevents.pool").Message
Pool = _port("kvevents.pool").Pool
PoolConfig = _port("kvevents.pool").PoolConfig
TokenizationPoolConfig = _port("tokenization.pool").TokenizationPoolConfig
LocalFastTokenizer = _port("tokenization.tokenizers").LocalFastTokenizer
from tests.helpers.tiny_tokenizer import save_tokenizer_json  # noqa: E402

MODEL = "test-model"
BLOCK_SIZE = 4
PROMPT = "the quick brown fox jumps over the lazy dog . " * 8
TRACE_ID = "c1c1c1c1c1c1c1c1c1c1c1c1c1c1c1c1"
TRACEPARENT = f"00-{TRACE_ID}-b2b2b2b2b2b2b2b2-01"


def post(base, path, obj, headers=None):
    request = urllib.request.Request(
        base + path,
        data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    with urllib.request.urlopen(request, timeout=30) as response:
        return dict(response.headers), json.load(response)


def get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as response:
        return json.load(response)


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
    indexer.run()
    event_pool = Pool(
        indexer.kv_block_index,
        indexer.token_processor,
        PoolConfig(concurrency=2),
    )
    event_pool.start()
    server = serve(indexer, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"

    # Store half the prompt's blocks so explain has a chain break.
    tokens = indexer.tokenization_pool.tokenize(PROMPT, MODEL, None)
    n_blocks = len(tokens) // BLOCK_SIZE
    half_blocks = n_blocks // 2
    batch = EventBatch(
        ts=1.0,
        events=[
            BlockStored(
                block_hashes=list(range(0x100, 0x100 + half_blocks)),
                parent_block_hash=None,
                token_ids=tokens[: half_blocks * BLOCK_SIZE],
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

    # 1. Scored request with a traceparent header: echo + retrieval.
    headers, scores = post(
        base,
        "/score_completions",
        {"prompt": PROMPT, "model": MODEL},
        headers={"traceparent": TRACEPARENT},
    )
    assert scores.get("pod-1") == half_blocks, scores
    echoed = headers.get("traceparent")
    assert echoed and echoed.split("-")[1] == TRACE_ID, headers

    listing = get(base, "/debug/traces?kind=recent")
    listed_ids = [t["trace_id"] for t in listing["traces"]]
    assert TRACE_ID in listed_ids, listed_ids

    full = get(base, f"/debug/traces/{TRACE_ID}")
    stage_names = {s["stage"] for s in full["stages"]}
    assert {
        "tokenize", "hash_blocks", "index_lookup", "score"
    } <= stage_names, stage_names

    # 2. explain=1: stage breakdown + per-pod chain-break provenance.
    _, body = post(
        base,
        "/score_completions?explain=1",
        {"prompt": PROMPT, "model": MODEL},
    )
    detail = body["explain"]["pods"]["pod-1"]
    assert detail["break_index"] == half_blocks, detail
    assert detail["tiers"] == {"hbm": half_blocks}, detail
    assert body["explain"]["stages"], body["explain"]

    # 3. /healthz observability block.
    health = get(base, "/healthz")
    obs = health.get("observability", {})
    assert obs.get("traces_sampled", 0) >= 2, obs
    assert obs.get("ring_occupancy", 0) >= 2, obs

    server.shutdown()
    event_pool.shutdown()
    indexer.shutdown()
    print("observability smoke completed successfully")


if __name__ == "__main__":
    main()
