"""Smoke gate for the replicated index service (cluster/).

The PyTorch port's counterpart of ``hack/cluster_smoke.py``: the same
steps, checks and success line over
``llm_d_kv_cache_manager_tpu_torch``, reached by name (``_port``);
nothing of JAX or the JAX package is loaded.

Boots THREE in-process replicas + a router HTTP scoring service whose
indexer runs against the cluster's ``RemoteIndex`` (journal-fed
replication followers syncing standby slices), then asserts the fleet
story end to end:

* scored traffic flows through the clustered read path (admissions via
  the REAL kvevents pool route to slice owners; scores arrive over the
  live HTTP endpoint);
* one replica is KILLED mid-traffic: scoring keeps answering without a
  single error, the heartbeat removes the replica from the ring
  (failover counter, ring version bump — visible in
  ``GET /debug/cluster`` and ``kvtpu_cluster_*`` on ``/metrics``);
* the failed-over slice is WARM: post-kill scores equal pre-kill
  scores (the follower inherited the slice), inside the pinned
  degradation envelope;
* ``POST /replica`` serves the wire surface (probed directly).

Run: ``python hack/cluster_smoke_torch.py`` (all of the port's scripts:
``hack/verify-examples-torch.sh``). Prints "cluster smoke completed
successfully" on success; any assertion exits non-zero.
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

serve = _port("api.http_service").serve
LocalCluster = _port("cluster").LocalCluster
encode_request = _port("cluster.replica").encode_request
Indexer = _port("kvcache.indexer").Indexer
IndexerConfig = _port("kvcache.indexer").IndexerConfig
TokenProcessorConfig = _port("kvcache.kvblock.token_processor").TokenProcessorConfig
BlockStored = _port("kvevents.events").BlockStored
EventBatch = _port("kvevents.events").EventBatch
Message = _port("kvevents.pool").Message
Pool = _port("kvevents.pool").Pool
PoolConfig = _port("kvevents.pool").PoolConfig
Encoding = _port("tokenization.tokenizers").Encoding

MODEL = "smoke-model"
BLOCK_SIZE = 4
# Warm-failover envelope (docs/replication.md): every pre-kill-scored
# prompt must score identically post-kill; the envelope bounds how many
# may degrade before the gate fails (followers sync continuously, so
# the expected count is zero).
DEGRADED_PROMPT_BUDGET = 0


class WordTokenizer:
    """Deterministic: 't<id>' words -> ids (no network, no HF)."""

    def type(self) -> str:
        return "smoke-word"

    def encode(self, prompt, model_name, add_special_tokens):
        tokens, offsets, pos = [], [], 0
        for word in prompt.split(" "):
            tokens.append(int(word[1:]) if word.startswith("t") else 0)
            offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return Encoding(tokens=tokens, offsets=offsets)


def post_json(base: str, path: str, payload: dict) -> dict:
    req = urllib.request.Request(
        base + path,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=10) as response:
        return json.loads(response.read())


def get_json(base: str, path: str) -> dict:
    with urllib.request.urlopen(base + path, timeout=10) as response:
        return json.loads(response.read())


def get_text(base: str, path: str) -> str:
    with urllib.request.urlopen(base + path, timeout=10) as response:
        return response.read().decode()


def stored_message(pod: str, seq: int, engine_key: int, tokens, parent):
    batch = EventBatch(
        ts=float(seq),
        events=[
            BlockStored(
                block_hashes=[engine_key],
                parent_block_hash=parent,
                token_ids=list(tokens),
                block_size=BLOCK_SIZE,
            )
        ],
    )
    return Message(
        topic=f"kv@{pod}@{MODEL}",
        payload=batch.encode(),
        pod_identifier=pod,
        model_name=MODEL,
        seq=seq,
    )


def main() -> None:
    with tempfile.TemporaryDirectory() as journal_root:
        cluster = LocalCluster(
            journal_root=journal_root,
            heartbeat_interval_s=0.2,
            follower_poll_s=0.05,
        )
        cluster.start()  # heartbeat + replication followers

        indexer = Indexer(
            IndexerConfig(
                token_processor_config=TokenProcessorConfig(
                    block_size=BLOCK_SIZE
                ),
                cache_stats=False,
            ),
            tokenizer=WordTokenizer(),
            kv_block_index=cluster.remote_index,
        )
        indexer.run()
        event_pool = Pool(
            cluster.remote_index,
            indexer.token_processor,
            PoolConfig(concurrency=2),
        )
        event_pool.start()
        server = serve(
            indexer,
            host="127.0.0.1",
            port=0,
            replica=None,
            cluster_status=cluster.status,
        )
        base = f"http://127.0.0.1:{server.server_address[1]}"

        # 1. Traffic: 3 pods each claim chained prefixes of 12 prompts
        # through the real event plane -> slice owners.
        prompts = []
        for p in range(12):
            tokens = [p * 100 + i + 1 for i in range(BLOCK_SIZE * 4)]
            prompts.append(" ".join(f"t{t}" for t in tokens))
            for pod_i in range(1 + p % 3):
                pod = f"pod-{pod_i}"
                parent = None
                for block in range(4 - pod_i):
                    engine_key = 10_000 + p * 100 + pod_i * 10 + block
                    chunk = tokens[
                        block * BLOCK_SIZE: (block + 1) * BLOCK_SIZE
                    ]
                    event_pool.add_task(
                        stored_message(
                            pod, p * 10 + block, engine_key, chunk, parent
                        )
                    )
                    parent = engine_key
        event_pool.drain()

        pre_kill = {}
        for prompt in prompts:
            scores = post_json(
                base, "/score_completions", {"prompt": prompt, "model": MODEL}
            )
            pre_kill[prompt] = scores
        assert any(pre_kill.values()), "no prompt scored before the kill"

        # 2. Probe the replica wire surface directly (the method table
        # the HTTP replica endpoint serves).
        transport = cluster.transports["replica-0"]
        assert transport.call("ping", []) == "replica-0"
        encode_request("ping", [])  # codec importable + callable

        # 3. Let the followers drain, then kill a replica MID-TRAFFIC.
        assert cluster.sync_followers() >= 0
        ring = cluster.membership.ring()
        sample_key = indexer.token_processor.tokens_to_kv_block_keys(
            0, [1, 2, 3, 4], MODEL
        )[0]
        victim = ring.owner(sample_key)
        cluster.kill(victim, notice=False)  # the heartbeat must notice

        degraded = 0
        deaths_noticed = False
        for round_i in range(50):
            for prompt in prompts:
                scores = post_json(
                    base,
                    "/score_completions",
                    {"prompt": prompt, "model": MODEL},
                )
                assert isinstance(scores, dict)  # scores keep flowing
            cluster.heartbeat.beat_once()
            if not cluster.membership.is_alive(victim):
                deaths_noticed = True
                break
        assert deaths_noticed, "heartbeat never removed the dead replica"

        # 4. Warm takeover: every pre-kill score reproduced exactly.
        for prompt, want in pre_kill.items():
            got = post_json(
                base, "/score_completions", {"prompt": prompt, "model": MODEL}
            )
            if got != want:
                degraded += 1
        assert degraded <= DEGRADED_PROMPT_BUDGET, (
            f"{degraded} prompts degraded after failover "
            f"(budget {DEGRADED_PROMPT_BUDGET})"
        )

        # 5. Debug + metrics surfaces.
        status = get_json(base, "/debug/cluster")
        membership = status["membership"]
        assert victim not in membership["alive"], membership
        assert membership["failovers"] >= 1, membership
        assert membership["ring_version"] >= 1, membership
        assert status["replication"], status

        metrics_text = get_text(base, "/metrics")
        assert "kvtpu_cluster_failovers_total" in metrics_text
        assert "kvtpu_cluster_ring_version" in metrics_text
        assert "kvtpu_cluster_replication_applied_total" in metrics_text

        server.shutdown()
        event_pool.shutdown()
        indexer.shutdown()
        cluster.close()
    print("cluster smoke completed successfully")


if __name__ == "__main__":
    main()
