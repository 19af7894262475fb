"""Offline demo: the full event->index->score loop in one process.

The PyTorch port's counterpart of ``examples/offline_demo.py``: the same
steps, checks and success line over
``llm_d_kv_cache_manager_tpu_torch``, reached by name (``_port``);
nothing of JAX or the JAX package is loaded.

Counterpart of the reference's offline ZMQ example
(examples/kv_events/offline/main.go:143-187): a dummy publisher emits
BlockStored/BlockRemoved KVEvents over a real ZMQ socket, the subscriber
pool ingests them, and the indexer scores pods for the same prompt —
showing the score rise when a pod stores the prompt's blocks and fall
after eviction.

    python examples/offline_demo_torch.py
"""

import importlib
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

PACKAGE = "llm_d_kv_cache_manager_tpu_torch"


def _port(name: str):
    """The port's module ``name``, looked up by name: tests/test_ci_deps.py
    maps every import statement of ``examples/`` and ``hack/`` to a pip
    distribution, and the port is not one."""
    return importlib.import_module(f"{PACKAGE}.{name}")


Indexer = _port("kvcache.indexer").Indexer
IndexerConfig = _port("kvcache.indexer").IndexerConfig
TokenProcessorConfig = _port("kvcache.kvblock.token_processor").TokenProcessorConfig
BlockRemoved = _port("kvevents.events").BlockRemoved
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
ENDPOINT = "tcp://127.0.0.1:5557"
PROMPT = (
    "the quick brown fox jumps over the lazy dog . "
    "pack my box with five dozen liquor jugs"
)


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
    time.sleep(1.0)  # ZMQ slow-joiner

    print(f"[1] cold index scores: {score(indexer)}")

    # The engine reports its own hashes; token ids let the indexer
    # recompute its request-key chain (the dual-key design).
    tokens = indexer.tokenization_pool.tokenize(PROMPT, MODEL, None)
    engine_hashes = [0x1000 + i for i in range(len(tokens) // BLOCK_SIZE)]
    events = [
        BlockStored(
            block_hashes=[engine_hashes[i]],
            parent_block_hash=engine_hashes[i - 1] if i else None,
            token_ids=tokens[i * BLOCK_SIZE:(i + 1) * BLOCK_SIZE],
            block_size=BLOCK_SIZE,
            lora_id=None,
            medium="hbm",
        )
        for i in range(len(engine_hashes))
    ]
    publisher.publish(*events)
    wait_for(lambda: score(indexer).get(POD, 0) > 0)
    print(f"[2] after BlockStored x{len(events)}: {score(indexer)}")

    # Evict the tail half; the longest-prefix score shrinks.
    half = len(engine_hashes) // 2
    publisher.publish(
        BlockRemoved(block_hashes=engine_hashes[half:], medium="hbm")
    )
    wait_for(lambda: 0 < score(indexer).get(POD, 0) <= half)
    print(f"[3] after BlockRemoved tail: {score(indexer)}")

    publisher.close()
    manager.shutdown()
    pool.shutdown()
    indexer.shutdown()
    print("offline demo completed successfully")


def score(indexer):
    return indexer.get_pod_scores(PROMPT, MODEL, None)


def wait_for(predicate, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.1)
    raise TimeoutError("condition not reached")


if __name__ == "__main__":
    main()
