"""Smoke gate for the host-offload staging engine.

The PyTorch port's counterpart of ``hack/offload_smoke.py``: the same
steps, checks and success line over
``llm_d_kv_cache_manager_tpu_torch``, reached by name (``_port``);
nothing of JAX or the JAX package is loaded.

End-to-end over the REAL data plane (docs/host-offload.md):

* **store -> evict -> load round trip** through the per-chip staging
  lanes: pool blocks staged to shared-storage files (atomic layout),
  the pool overwritten (eviction stand-in), then paged back through
  the staged load pipeline — bytes bit-identical;
* **demotion moves bytes**: a DemotionWorker cycle over the
  StagedDemotionTarget pages the group hbm -> host (readable from the
  HostTierCache) and then host -> shared_storage (readable from the
  file), with the medium-tagged events riding the real kvevents pool
  so the index tier AND the live score follow each rung
  (1.0 -> 0.8 -> 0.5 per block);
* **measured RTT feeds the advisor**: `/debug/tiering` shows read- and
  write-side estimator observations from the real transfers (not
  simulated), and the writeback gauge is on `/metrics`.

On a CUDA pool the staging engine must take the pinned path
(``staging.uses_pinned``): it raises rather than fall back to plain
host copies, and the smoke asserts the path is on.

``--device`` picks the pool's device: ``cuda`` by default, as every
entry point of the port; without a card that raises unless ``--device
cpu`` is given.  ``--geometry tiny`` is the reference's pool (2 layers,
64 blocks of 8 tokens, 2 KV heads, head_dim 16, bf16); ``--geometry
llama3_8b`` is ``LlamaConfig.llama3_8b()``'s KV geometry (32 layers,
8 KV heads, head_dim 128, blocks of 16 tokens, bf16: 2 MiB a block,
128 MiB for the 64-block pool).  ``main`` returns the store and load
walls of the round trip; ``chip_smoke.py`` phase 7d runs it in-process
on the card at ``llama3_8b``.

Run: ``python hack/offload_smoke_torch.py --device cpu`` (all of the
port's scripts: ``hack/verify-examples-torch.sh``).  Prints "offload
smoke completed successfully" on success; any assertion exits
non-zero.
"""

import argparse
import contextlib
import importlib
import json
import os
import shutil
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


os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")
os.environ.setdefault("CACHESTATS_SAMPLE_RATE", "1")
os.environ.setdefault("TIERING_REFRESH_S", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

serve = _port("api.http_service").serve
Indexer = _port("kvcache.indexer").Indexer
IndexerConfig = _port("kvcache.indexer").IndexerConfig
TokenProcessorConfig = _port("kvcache.kvblock.token_processor").TokenProcessorConfig
BlockStored = _port("kvevents.events").BlockStored
EventBatch = _port("kvevents.events").EventBatch
Message = _port("kvevents.pool").Message
Pool = _port("kvevents.pool").Pool
PoolConfig = _port("kvevents.pool").PoolConfig
KVCachePool = _port("models.kv_cache_pool").KVCachePool
KVCachePoolConfig = _port("models.kv_cache_pool").KVCachePoolConfig
JobStatus = _port("native.engine").JobStatus
HostTierCache = _port("offload.host_tier").HostTierCache
TPUOffloadConnector = _port("offload.spec").TPUOffloadConnector
TPUOffloadSpec = _port("offload.spec").TPUOffloadSpec
group_blocks_per_file = _port("offload.worker").group_blocks_per_file
DemotionConfig = _port("tiering").DemotionConfig
PolicyEngine = _port("tiering").PolicyEngine
StagedDemotionTarget = _port("tiering").StagedDemotionTarget
pool_event_sink = _port("tiering").pool_event_sink
TokenizationPoolConfig = _port("tokenization.pool").TokenizationPoolConfig
Encoding = _port("tokenization.tokenizers").Encoding
LlamaConfig = _port("models.llama").LlamaConfig
resolve_device = _port("utils.device").resolve_device
LOG = _port("utils.logging").get_logger("hack.offload_smoke")

MODEL = "test-model"
BLOCK_SIZE = 4  # indexer-side tokens per block
# Tokens a pool block holds at --geometry llama3_8b: the block of the
# port's serving path (chip_smoke.py's pools).
LLAMA_BLOCK_TOKENS = 16


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


def geometry(name: str):
    """The pool's config for ``--geometry``."""
    if name == "tiny":
        return KVCachePoolConfig(
            num_layers=2,
            num_blocks=64,
            block_size=8,
            num_kv_heads=2,
            head_dim=16,
            dtype="bfloat16",
        )
    if name == "llama3_8b":
        cfg = LlamaConfig.llama3_8b()
        return KVCachePoolConfig(
            num_layers=cfg.n_layers,
            num_blocks=64,
            block_size=LLAMA_BLOCK_TOKENS,
            num_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.d_model // cfg.n_heads,
            dtype="bfloat16",
        )
    raise ValueError(f"unknown geometry {name!r}")


def random_block(rng, shape):
    """Standard normals as bf16 (truncated from float32) in the host
    layout of the port's bf16 gathers: ``uint16`` bit patterns."""
    values = rng.standard_normal(shape, dtype=np.float32)
    return (values.view(np.uint32) >> 16).astype(np.uint16)


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument(
        "--geometry", choices=("tiny", "llama3_8b"), default="tiny"
    )
    return parser.parse_args(argv)


def main(argv=None, after_load=None) -> dict:
    """The smoke; returns the round trip's walls and the score ladder.
    ``after_load(pool)`` runs between the load and the comparison
    (tests plant a fault there)."""
    args = parse_args(argv)
    device = resolve_device(args.device)  # no card: raises here
    pool_config = geometry(args.geometry)
    storage_root = tempfile.mkdtemp(prefix="kvtpu-offload-smoke-")
    # Everything the smoke starts is shut, last first, even when an
    # assertion fails: its threads would keep the process alive.
    with contextlib.ExitStack() as cleanup:
        cleanup.callback(shutil.rmtree, storage_root, ignore_errors=True)
        return _smoke(
            device, args.geometry, pool_config, storage_root,
            cleanup.callback, after_load,
        )


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _smoke(  # noqa: PLR0915 — one linear smoke story
    device, geometry_name, pool_config, storage_root, on_exit, after_load
) -> dict:
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
    indexer.run()
    on_exit(indexer.shutdown)
    engine = PolicyEngine(ledger=indexer.cache_stats)
    indexer.set_policy_engine(engine)
    event_pool = Pool(
        indexer.kv_block_index,
        indexer.token_processor,
        PoolConfig(concurrency=2),
    )
    event_pool.start()
    on_exit(event_pool.shutdown)

    # --- the real data plane: pool + staged connector + policy feeds ---
    pool = KVCachePool(pool_config, device=device)
    spec = TPUOffloadSpec(
        shared_storage_path=storage_root,
        model_name=MODEL,
        device_block_size=pool_config.block_size,
        offloaded_block_size=2 * pool_config.block_size,
        threads_per_chip=2,
        host_cache_bytes=0,
        staging_lanes=2,
    )
    connector = TPUOffloadConnector(spec, pool, policy_engine=engine)
    on_exit(connector.close)
    on_exit(engine.close)
    assert connector.staging is not None, "staging knob did not engage"
    if device.type == "cuda":
        assert connector.staging.uses_pinned, (
            "a CUDA pool must stage through pinned host memory"
        )

    # 1. store -> evict -> load round trip through the staging engine.
    rng = np.random.default_rng(7)
    block_ids = [3, 4, 7, 9]
    block_shape = (
        pool_config.num_layers,
        2,
        pool_config.block_size,
        pool_config.num_kv_heads,
        pool_config.head_dim,
    )
    originals = {}
    for block_id in block_ids:
        data = random_block(rng, block_shape)
        pool.write_block(block_id, data)
        originals[block_id] = data
    file_hashes = [0xA1, 0xA2]
    groups = group_blocks_per_file(file_hashes, block_ids, 2)
    _sync(device)
    t0 = time.perf_counter()
    connector.store_handler.transfer_async(1, groups)
    assert connector.store_handler.wait(1) == JobStatus.SUCCEEDED
    store_s = time.perf_counter() - t0
    for file_hash in file_hashes:
        path = connector.file_mapper.get_file_name(file_hash)
        assert os.path.exists(path), f"missing block file {path}"

    zero = np.zeros_like(next(iter(originals.values())))
    for block_id in block_ids:  # "evict": the pool forgets the bytes
        pool.write_block(block_id, zero)
    _sync(device)
    t0 = time.perf_counter()
    connector.load_handler.transfer_async(
        2, group_blocks_per_file(file_hashes, block_ids, 2)
    )
    assert connector.load_handler.wait(2) == JobStatus.SUCCEEDED
    _sync(device)
    load_s = time.perf_counter() - t0
    if after_load is not None:
        after_load(pool)
    restored = pool.gather_to_host(block_ids)
    for i, block_id in enumerate(block_ids):
        np.testing.assert_array_equal(restored[:, i], originals[block_id])
    print("store -> evict -> load round trip: bytes bit-identical")
    round_trip_bytes = len(block_ids) * pool.block_nbytes
    LOG.info(
        "offload smoke (%s, %s): %d bytes stored in %.6f s (%.3f GB/s), "
        "loaded in %.6f s (%.3f GB/s)",
        device, geometry_name, round_trip_bytes,
        store_s, round_trip_bytes / store_s / 1e9,
        load_s, round_trip_bytes / load_s / 1e9,
    )

    # Both estimator directions observed REAL transfers.
    advisor_stats = engine.advisor.stats()
    assert advisor_stats["rtt"]["observations"] >= 1, advisor_stats
    assert advisor_stats["rtt_store"]["observations"] >= 1, advisor_stats

    # 2. the index side: seed a chain on pod-1 at hbm, teach the feed.
    tokens = list(range(1, 33))  # 8 blocks of 4
    n_blocks = len(tokens) // BLOCK_SIZE
    prompt = " ".join(f"t{t}" for t in tokens)
    engine_hashes = [0x300 + i for i in range(n_blocks)]
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
    on_exit(server.server_close)
    on_exit(server.shutdown)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    scores = post(
        base, "/score_completions", {"prompt": prompt, "model": MODEL}
    )
    assert scores.get("pod-1") == n_blocks, scores
    ladder = [scores["pod-1"] / n_blocks]

    # 3. demotion cycles MOVE BYTES, and index tier + score follow.
    demo_ids = [11, 12]
    for block_id in demo_ids:
        pool.write_block(
            block_id, random_block(rng, zero.shape)
        )
    expected_group = pool.gather_block_major(demo_ids)
    host_cache = HostTierCache(
        max(1 << 22, 2 * len(demo_ids) * pool.block_nbytes)
    )
    group_key = 0xFACE
    target = StagedDemotionTarget(
        capacity_bytes=64 * pool.block_nbytes,
        pool=pool,
        file_mapper=connector.file_mapper,
        host_cache=host_cache,
        event_sink=pool_event_sink(event_pool, "pod-1", MODEL),
        feed=engine.feed,
        store_rtt_observer=engine.advisor.observe_store,
    )
    target.register_pool_group(
        group_key,
        block_ids=demo_ids,
        engine_hashes=engine_hashes,
        token_ids=tokens,
        block_size=BLOCK_SIZE,
        now=time.monotonic() - 600,
    )
    worker = engine.start_demotion(
        target,
        DemotionConfig(
            demote_host_idle_s=0.0,
            demote_storage_idle_s=0.0,
            require_prediction=False,
        ),
        start=False,
    )

    # Rung 1: hbm -> host — bytes readable from the host tier.
    assert worker.run_cycle() == 1, "expected the hbm->host move"
    cached = host_cache.get(group_key)
    assert cached is not None, "demotion advertised host without bytes"
    np.testing.assert_array_equal(cached, expected_group)
    event_pool.drain()
    scores = post(
        base, "/score_completions", {"prompt": prompt, "model": MODEL}
    )
    assert abs(scores["pod-1"] - 0.8 * n_blocks) < 1e-9, scores
    ladder.append(scores["pod-1"] / n_blocks)
    print("demotion hbm -> host: bytes in host tier, score 1.0 -> 0.8")

    # Rung 2: host -> shared_storage — bytes readable from the file.
    assert worker.run_cycle() == 1, "expected the host->storage move"
    path = connector.file_mapper.get_file_name(group_key)
    with open(path, "rb") as handle:
        on_disk = np.frombuffer(
            handle.read(), dtype=expected_group.dtype
        ).reshape(expected_group.shape)
    np.testing.assert_array_equal(on_disk, expected_group)
    assert host_cache.get(group_key) is None, "host entry must retire"
    event_pool.drain()
    scores = post(
        base, "/score_completions", {"prompt": prompt, "model": MODEL}
    )
    assert abs(scores["pod-1"] - 0.5 * n_blocks) < 1e-9, scores
    ladder.append(scores["pod-1"] / n_blocks)
    print(
        "demotion host -> shared_storage: bytes on disk, score 0.8 -> 0.5"
    )

    # 4. measured RTT visible in /debug/tiering; gauge on /metrics.
    status = get(base, "/debug/tiering")
    advisor_block = status["advisor"]
    assert advisor_block["rtt"]["observations"] >= 1, advisor_block
    assert advisor_block["rtt"]["per_byte_s"] is not None, advisor_block
    assert advisor_block["rtt_store"]["observations"] >= 2, advisor_block
    demotion_block = status["demotion"][0]
    assert demotion_block["moves"] == 2, demotion_block

    text = get_text(base, "/metrics")
    assert "kvtpu_tiering_writeback_rtt_seconds" in text
    assert "kvtpu_offload_staging_lane_waits_total" in text
    assert 'kvtpu_offload_bytes_total{direction="store"}' in text
    assert 'kvtpu_tiering_demotions_total{transition="host_to_storage"}' in text

    print("offload smoke completed successfully")
    return {
        "device": str(device),
        "geometry": geometry_name,
        "block_nbytes": pool.block_nbytes,
        "round_trip_bytes": round_trip_bytes,
        "round_trip": "bit-identical",
        "store_s": store_s,
        "load_s": load_s,
        "uses_pinned": connector.staging.uses_pinned,
        "score_ladder": ladder,
    }


if __name__ == "__main__":
    main()
