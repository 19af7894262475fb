"""Live-engine demo: index KV events from a real vLLM process.

The PyTorch port's counterpart of ``examples/vllm_demo.py``: the same
steps, checks and success line over
``llm_d_kv_cache_manager_tpu_torch``, reached by name (``_port``);
nothing of JAX or the JAX package is loaded.

Counterpart of the reference's real-engine demo
(examples/kv_events/vllm/vllm_kv_cache_demo.py): boot vLLM with KV
events enabled, subscribe the indexer to its ZMQ stream, run prompts,
and watch pod scores reflect the engine's actual prefix cache.

Requires a vLLM install (vLLM for CUDA on a GPU host); in environments
without it this prints the integration recipe, with the port's offload
spec as the connector, and exits cleanly so
hack/verify-examples-torch.sh can include it unconditionally.

Fleet invariants (docs/configuration.md):
- engine `--block-size` must equal the indexer's block_size
- engine PYTHONHASHSEED must equal the indexer's hash_seed
- `prefix_caching_hash_algo="sha256_cbor"` interops via the
  engineKey->requestKey map (last-8-bytes big-endian rule)
"""

import importlib
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

PACKAGE = "llm_d_kv_cache_manager_tpu_torch"


def _port(name: str):
    """The port's module ``name``, looked up by name: tests/test_ci_deps.py
    maps every import statement of ``examples/`` and ``hack/`` to a pip
    distribution, and the port is not one."""
    return importlib.import_module(f"{PACKAGE}.{name}")


MODEL = os.environ.get("MODEL_NAME", "meta-llama/Llama-3.1-8B-Instruct")
BLOCK_SIZE = int(os.environ.get("BLOCK_SIZE", "16"))
ZMQ_ENDPOINT = os.environ.get("ZMQ_ENDPOINT", "tcp://localhost:5557")
POD = os.environ.get("POD_IDENTIFIER", "localhost")

SHARED_STORAGE = os.environ.get("SHARED_STORAGE_PATH", "/mnt/kv-cache")

RECIPE = f"""\
vLLM not installed — to run this demo on a serving host:

  PYTHONHASHSEED=42 vllm serve {MODEL} \\
    --block-size {BLOCK_SIZE} \\
    --kv-events-config '{{
        "enable_kv_cache_events": true,
        "publisher": "zmq",
        "endpoint": "{ZMQ_ENDPOINT.replace("localhost", "*")}",
        "topic": "kv@{POD}@{MODEL}"
      }}' \\
    --kv-transfer-config '{{
        "kv_connector": "OffloadingConnector",
        "kv_role": "kv_both",
        "kv_connector_extra_config": {{
          "spec_name": "TPUSharedStorageOffloadingSpec",
          "spec_module_path":
            "llm_d_kv_cache_manager_tpu_torch.offload.vllm_spec",
          "shared_storage_path": "{SHARED_STORAGE}",
          "block_size": {BLOCK_SIZE * 4},
          "threads_per_chip": 8,
          "max_staging_memory_gb": 16
        }}
      }}' \\
    --prefix-caching-hash-algo sha256_cbor

then:  python examples/vllm_demo_torch.py

vllm demo completed successfully (recipe mode)\
"""


def main() -> None:
    try:
        import vllm  # noqa: F401
    except ImportError:
        print(RECIPE)
        return

    Indexer = _port("kvcache.indexer").Indexer
    IndexerConfig = _port("kvcache.indexer").IndexerConfig
    TokenProcessorConfig = _port("kvcache.kvblock.token_processor").TokenProcessorConfig
    Pool = _port("kvevents.pool").Pool
    PoolConfig = _port("kvevents.pool").PoolConfig
    SubscriberManager = _port("kvevents.subscriber_manager").SubscriberManager
    TokenizationPoolConfig = _port("tokenization.pool").TokenizationPoolConfig

    indexer = Indexer(
        IndexerConfig(
            token_processor_config=TokenProcessorConfig(
                block_size=BLOCK_SIZE,
                hash_seed=os.environ.get("PYTHONHASHSEED", ""),
            ),
            tokenizers_pool_config=TokenizationPoolConfig(
                model_name=MODEL
            ),
        )
    )
    indexer.run()
    pool = Pool(
        indexer.kv_block_index,
        indexer.token_processor,
        PoolConfig(concurrency=2),
    )
    pool.start()
    manager = SubscriberManager(sink=pool.add_task)
    manager.ensure_subscriber(POD, ZMQ_ENDPOINT)

    from vllm import LLM, SamplingParams

    # Wire the port's shared-storage offload connector (offload/vllm_spec.py)
    # so evicted blocks page to shared storage and can be re-served.
    kv_transfer_config = {
        "kv_connector": "OffloadingConnector",
        "kv_role": "kv_both",
        "kv_connector_extra_config": {
            "spec_name": "TPUSharedStorageOffloadingSpec",
            "spec_module_path": (
                "llm_d_kv_cache_manager_tpu_torch.offload.vllm_spec"
            ),
            "shared_storage_path": SHARED_STORAGE,
            "block_size": BLOCK_SIZE * 4,
            "threads_per_chip": 8,
            "max_staging_memory_gb": 16,
        },
    }
    llm = LLM(
        model=MODEL,
        enable_prefix_caching=True,
        block_size=BLOCK_SIZE,
        kv_transfer_config=kv_transfer_config,
    )
    shared = "You are a helpful assistant. " * 200
    prompts = [shared + q for q in ("What is CUDA?", "What is a GPU?")]
    llm.generate(prompts, SamplingParams(max_tokens=8))
    time.sleep(2.0)  # let events drain

    for prompt in prompts:
        scores = indexer.get_pod_scores(prompt, MODEL, None)
        print(f"scores for {prompt[-24:]!r}: {scores}")
        assert scores.get(POD, 0) > 0, "engine events not indexed"

    manager.shutdown()
    pool.shutdown()
    indexer.shutdown()
    print("vllm demo completed successfully")


if __name__ == "__main__":
    main()
