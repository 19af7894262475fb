"""Shared-index demo: two indexer replicas over one Valkey/Redis store.

The PyTorch port's counterpart of ``examples/valkey_demo.py``: the same
steps, checks and success line over
``llm_d_kv_cache_manager_tpu_torch``, reached by name (``_port``);
nothing of JAX or the JAX package is loaded.

Counterpart of the reference's valkey demo (examples/): replica A
ingests the fleet's events; replica B — a different process in
production — serves scoring queries against the same distributed index.
An in-process RESP server stands in for Valkey (tests/helpers/miniresp,
the miniredis pattern), so the demo runs hermetically; point
``address`` at a real ``valkey://`` endpoint in a cluster.

    python examples/valkey_demo_torch.py
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
IndexConfig = _port("kvcache.kvblock.index").IndexConfig
RedisIndexConfig = _port("kvcache.kvblock.index").RedisIndexConfig
TokenProcessorConfig = _port("kvcache.kvblock.token_processor").TokenProcessorConfig
BlockStored = _port("kvevents.events").BlockStored
EventBatch = _port("kvevents.events").EventBatch
Message = _port("kvevents.pool").Message
Pool = _port("kvevents.pool").Pool
PoolConfig = _port("kvevents.pool").PoolConfig
TokenizationPoolConfig = _port("tokenization.pool").TokenizationPoolConfig
LocalFastTokenizer = _port("tokenization.tokenizers").LocalFastTokenizer
from tests.helpers.miniresp import MiniRespServer
from tests.helpers.tiny_tokenizer import save_tokenizer_json

MODEL = "test-model"
BLOCK_SIZE = 4
PROMPT = "the quick brown fox jumps over the lazy dog"


def make_indexer(tokenizer_dir: str, address: str) -> Indexer:
    indexer = Indexer(
        IndexerConfig(
            token_processor_config=TokenProcessorConfig(
                block_size=BLOCK_SIZE
            ),
            kvblock_index_config=IndexConfig(
                redis_config=RedisIndexConfig(
                    address=address, flavor="valkey"
                ),
            ),
            tokenizers_pool_config=TokenizationPoolConfig(
                workers=1, model_name=MODEL
            ),
        ),
        tokenizer=LocalFastTokenizer(tokenizer_dir),
    )
    indexer.run()
    return indexer


def main() -> None:
    valkey = MiniRespServer()
    tokenizer_dir = save_tokenizer_json(tempfile.mkdtemp(), MODEL)

    writer = make_indexer(tokenizer_dir, valkey.address)  # event ingester
    reader = make_indexer(tokenizer_dir, valkey.address)  # scoring replica

    pool = Pool(
        writer.kv_block_index,
        writer.token_processor,
        PoolConfig(concurrency=2),
    )
    pool.start()

    tokens = writer.tokenization_pool.tokenize(PROMPT, MODEL, None)
    events = [
        BlockStored(
            block_hashes=[0x6000 + i],
            parent_block_hash=0x6000 + i - 1 if i else None,
            token_ids=tokens[i * BLOCK_SIZE:(i + 1) * BLOCK_SIZE],
            block_size=BLOCK_SIZE,
            lora_id=None,
            medium="hbm",
        )
        for i in range(len(tokens) // BLOCK_SIZE)
    ]
    batch = EventBatch(ts=time.time(), events=events)
    pool.add_task(
        Message(
            topic=f"kv@pod-a@{MODEL}",
            payload=batch.encode(),
            pod_identifier="pod-a",
            model_name=MODEL,
            seq=1,
        )
    )
    pool.drain()

    # The *other* replica sees the same index state over the wire.
    scores = reader.get_pod_scores(PROMPT, MODEL, None)
    print(f"replica-B scores (events ingested by replica-A): {scores}")
    assert scores.get("pod-a", 0) > 0

    pool.shutdown()
    writer.shutdown()
    reader.shutdown()
    valkey.close()
    print("valkey demo completed successfully")


if __name__ == "__main__":
    main()
