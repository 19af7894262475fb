"""Online demo: HTTP scoring service fed by live ZMQ events.

The PyTorch port's counterpart of ``examples/online_demo.py``: the same
steps, checks and success line over
``llm_d_kv_cache_manager_tpu_torch``, reached by name (``_port``);
nothing of JAX or the JAX package is loaded.

Counterpart of the reference's online example
(examples/kv_events/online/main.go:273-385): boots the HTTP service
(api/http_service.py) plus the event-subscription stack, publishes
BlockStored events from a simulated pod, and queries
``/score_completions`` and ``/metrics`` over real HTTP.

    python examples/online_demo_torch.py
"""

import importlib
import json
import os
import sys
import tempfile
import time
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

PACKAGE = "llm_d_kv_cache_manager_tpu_torch"


def _port(name: str):
    """The port's module ``name``, looked up by name: tests/test_ci_deps.py
    maps every import statement of ``examples/`` and ``hack/`` to a pip
    distribution, and the port is not one."""
    return importlib.import_module(f"{PACKAGE}.{name}")


serve = _port("api.http_service").serve
Indexer = _port("kvcache.indexer").Indexer
IndexerConfig = _port("kvcache.indexer").IndexerConfig
IndexConfig = _port("kvcache.kvblock.index").IndexConfig
TokenProcessorConfig = _port("kvcache.kvblock.token_processor").TokenProcessorConfig
BlockStored = _port("kvevents.events").BlockStored
Pool = _port("kvevents.pool").Pool
PoolConfig = _port("kvevents.pool").PoolConfig
Publisher = _port("kvevents.publisher").Publisher
SubscriberManager = _port("kvevents.subscriber_manager").SubscriberManager
TokenizationPoolConfig = _port("tokenization.pool").TokenizationPoolConfig
LocalFastTokenizer = _port("tokenization.tokenizers").LocalFastTokenizer
from tests.helpers.tiny_tokenizer import save_tokenizer_json

MODEL = "test-model"
POD = "vllm-pod-0"
BLOCK_SIZE = 4
ENDPOINT = "tcp://127.0.0.1:5558"
PROMPT = "the quick brown fox jumps over the lazy dog"


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
            kvblock_index_config=IndexConfig(enable_metrics=True),
        ),
        tokenizer=LocalFastTokenizer(tokenizer_dir),
    )
    indexer.run()
    pool = Pool(
        indexer.kv_block_index,
        indexer.token_processor,
        PoolConfig(concurrency=2),
    )
    pool.start()
    manager = SubscriberManager(sink=pool.add_task)
    manager.ensure_subscriber(POD, ENDPOINT)
    publisher = Publisher(
        ENDPOINT, pod_identifier=POD, model_name=MODEL, bind=True
    )
    server = serve(indexer, host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    time.sleep(1.0)  # ZMQ slow-joiner

    tokens = indexer.tokenization_pool.tokenize(PROMPT, MODEL, None)
    publisher.publish(
        *[
            BlockStored(
                block_hashes=[0x3000 + i],
                parent_block_hash=0x3000 + i - 1 if i else None,
                token_ids=tokens[i * BLOCK_SIZE:(i + 1) * BLOCK_SIZE],
                block_size=BLOCK_SIZE,
                lora_id=None,
                medium="hbm",
            )
            for i in range(len(tokens) // BLOCK_SIZE)
        ]
    )

    deadline = time.time() + 10
    scores = {}
    while time.time() < deadline and not scores.get(POD):
        request = urllib.request.Request(
            base + "/score_completions",
            data=json.dumps({"prompt": PROMPT, "model": MODEL}).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(request, timeout=10) as response:
            scores = json.load(response)
        time.sleep(0.2)
    print(f"scores over HTTP: {scores}")
    assert scores.get(POD, 0) > 0

    with urllib.request.urlopen(base + "/metrics", timeout=10) as response:
        lines = [
            line
            for line in response.read().decode().splitlines()
            if line.startswith("kvtpu_kvcache_index_lookup")
        ]
    print("metrics excerpt:")
    for line in lines[:4]:
        print(f"  {line}")

    publisher.close()
    server.shutdown()
    manager.shutdown()
    pool.shutdown()
    indexer.shutdown()
    print("online demo completed successfully")


if __name__ == "__main__":
    main()
