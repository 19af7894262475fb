"""gRPC index-service demo (reference: examples/kv_cache_index_service).

The PyTorch port's counterpart of ``examples/index_service_demo.py``:
the same steps, checks and success line over
``llm_d_kv_cache_manager_tpu_torch``, reached by name (``_port``);
nothing of JAX or the JAX package is loaded.

Boots the scoring service on a Unix-domain socket, seeds the index the
way a live fleet would (via KVEvents through the pool), and queries it
with the generated client stub.

    python examples/index_service_demo_torch.py
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


indexer_pb2 = _port("api.indexer_pb2")
new_client = _port("api.indexer_service").new_client
serve = _port("api.indexer_service").serve
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
from tests.helpers.tiny_tokenizer import save_tokenizer_json

MODEL = "test-model"
BLOCK_SIZE = 4
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

    # Simulate two pods: pod-a stores the whole prompt, pod-b one block.
    tokens = indexer.tokenization_pool.tokenize(PROMPT, MODEL, None)
    n_blocks = len(tokens) // BLOCK_SIZE
    for pod, blocks in (("pod-a", n_blocks), ("pod-b", 1)):
        events = [
            BlockStored(
                block_hashes=[0x2000 + i],
                parent_block_hash=0x2000 + i - 1 if i else None,
                token_ids=tokens[i * BLOCK_SIZE:(i + 1) * BLOCK_SIZE],
                block_size=BLOCK_SIZE,
                lora_id=None,
                medium="hbm",
            )
            for i in range(blocks)
        ]
        batch = EventBatch(ts=time.time(), events=events)
        pool.add_task(
            Message(
                topic=f"kv@{pod}@{MODEL}",
                payload=batch.encode(),
                pod_identifier=pod,
                model_name=MODEL,
                seq=1,
            )
        )
    pool.drain()

    uds = os.path.join(tempfile.mkdtemp(), "indexer.sock")
    server = serve(indexer, f"unix://{uds}")
    client = new_client(f"unix://{uds}")
    response = client.GetPodScores(
        indexer_pb2.GetPodScoresRequest(prompt=PROMPT, model_name=MODEL)
    )
    for entry in response.scores:
        print(f"  {entry.pod}: {entry.score}")
    assert response.scores[0].pod == "pod-a"

    server.stop(grace=None)
    pool.shutdown()
    indexer.shutdown()
    print("index service demo completed successfully")


if __name__ == "__main__":
    main()
