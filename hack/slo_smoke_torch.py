"""Smoke gate for the fleet observability plane.

The PyTorch port's counterpart of ``hack/slo_smoke.py``: the same steps,
checks and success line over ``llm_d_kv_cache_manager_tpu_torch``,
reached by name (``_port``); nothing of JAX or the JAX package is
loaded.

Boots THREE in-process replicas (strict-wire codec, so every RPC pays
the real CBOR round trip) behind a router HTTP service with the SLO
engine attached, then asserts the two fleet-observability loops close:

* **Cross-replica trace stitching**: a scored request carrying a W3C
  ``traceparent`` resolves at ``GET /debug/traces/<id>`` as ONE trace
  whose ``cluster.rpc`` spans cover every owner RPC, with replica-side
  ``replica.lookup`` sub-spans piggybacked off the wire, and top-level
  stage durations summing to the end-to-end latency (±5%);
  ``?explain=1`` carries the per-replica ``cluster_rpcs`` rollup.
* **Degradation envelopes**: ``GET /debug/slo`` reports ``healthy``
  under steady traffic; a replica killed mid-traffic flips the
  ``replicas_dead`` / ``failovers`` SLIs to ``degraded`` (never
  ``violated`` — the published envelope stays inside its declared
  bounds, checked by ``envelope_violations``), with the failure's
  kind/last-error context visible in ``/debug/cluster`` and the
  ``kvtpu_slo_*`` / ``kvtpu_cluster_rpc_*`` families on ``/metrics``.

Run: ``python hack/slo_smoke_torch.py`` (all of the port's scripts:
``hack/verify-examples-torch.sh``). Prints "slo smoke completed
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

serve = _port("api.http_service").serve
LocalCluster = _port("cluster").LocalCluster
Indexer = _port("kvcache.indexer").Indexer
IndexerConfig = _port("kvcache.indexer").IndexerConfig
TokenProcessorConfig = _port("kvcache.kvblock.token_processor").TokenProcessorConfig
BlockStored = _port("kvevents.events").BlockStored
EventBatch = _port("kvevents.events").EventBatch
Message = _port("kvevents.pool").Message
Pool = _port("kvevents.pool").Pool
PoolConfig = _port("kvevents.pool").PoolConfig
default_fleet_slos = _port("obs.slo").default_fleet_slos
envelope_violations = _port("obs.slo").envelope_violations
Encoding = _port("tokenization.tokenizers").Encoding

MODEL = "slo-model"
BLOCK_SIZE = 4
TRACE_ID = "d3d3d3d3d3d3d3d3d3d3d3d3d3d3d3d3"
TRACEPARENT = f"00-{TRACE_ID}-e4e4e4e4e4e4e4e4-01"


class WordTokenizer:
    def type(self):
        return "smoke-word"

    def encode(self, prompt, model_name, add_special_tokens):
        tokens, offsets, pos = [], [], 0
        for word in prompt.split(" "):
            tokens.append(int(word[1:]) if word.startswith("t") else 0)
            offsets.append((pos, pos + len(word)))
            pos += len(word) + 1
        return Encoding(tokens=tokens, offsets=offsets)


def post_json(base, path, payload, headers=None):
    req = urllib.request.Request(
        base + path,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    with urllib.request.urlopen(req, timeout=10) as response:
        return dict(response.headers), json.loads(response.read())


def get_json(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as response:
        return json.loads(response.read())


def get_text(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as response:
        return response.read().decode()


def main() -> None:
    cluster = LocalCluster(strict_wire=True, heartbeat_interval_s=0.2)
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
    # Tight windows so a smoke-scale run exercises real window math.
    slo = default_fleet_slos(
        window_fast_s=5.0,
        window_slow_s=30.0,
        score_latency_s=2.0,
        membership=cluster.membership,
        pool=event_pool,
    )
    server = serve(
        indexer,
        host="127.0.0.1",
        port=0,
        cluster_status=cluster.status,
        slo=slo,
    )
    base = f"http://127.0.0.1:{server.server_address[1]}"

    # Traffic: 3 pods claim chained prefixes of 8 prompts through the
    # real event plane, keys landing on every replica slice.  Prompts
    # are 32 blocks long so the per-request fixed bookkeeping is small
    # next to the staged work (the ±5% stage-sum pin below).
    blocks_per_prompt = 32
    prompts = []
    for p in range(8):
        tokens = [
            p * 1000 + i + 1
            for i in range(BLOCK_SIZE * blocks_per_prompt)
        ]
        prompts.append(" ".join(f"t{t}" for t in tokens))
        for pod_i in range(1 + p % 3):
            claimed = blocks_per_prompt - pod_i
            batch = EventBatch(
                ts=1.0,
                events=[
                    BlockStored(
                        block_hashes=[
                            40_000 + p * 100 + pod_i * 40 + b
                            for b in range(claimed)
                        ],
                        parent_block_hash=None,
                        token_ids=tokens[: claimed * BLOCK_SIZE],
                        block_size=BLOCK_SIZE,
                        medium="hbm",
                    )
                ],
            )
            event_pool.add_task(
                Message(
                    topic=f"kv@pod-{pod_i}@{MODEL}",
                    payload=batch.encode(),
                    pod_identifier=f"pod-{pod_i}",
                    model_name=MODEL,
                    seq=p,
                )
            )
    event_pool.drain()

    # 1. Stitched cross-replica trace, retrievable by id.
    headers, scores = post_json(
        base,
        "/score_completions",
        {"prompt": prompts[0], "model": MODEL},
        headers={"traceparent": TRACEPARENT},
    )
    assert scores, f"no pod scored: {scores}"
    assert headers.get("traceparent", "").split("-")[1] == TRACE_ID

    full = get_json(base, f"/debug/traces/{TRACE_ID}")
    spans = full["spans"]
    rpc_spans = [
        s
        for s in spans
        if s["name"] == "cluster.rpc"
        and s["attributes"].get("method") == "lookup"
    ]
    assert rpc_spans, [s["name"] for s in spans]
    owners = {s["attributes"]["replica"] for s in rpc_spans}
    assert len(owners) >= 2, f"expected a multi-owner fan-out: {owners}"
    server_spans = [s for s in spans if s["name"] == "replica.lookup"]
    assert server_spans, "replica-side spans must ride the reply"
    assert {s["attributes"]["replica"] for s in server_spans} <= set(
        cluster.replicas
    )
    assert all(s["parent"] == "cluster.rpc" for s in server_spans)

    # Stage sums consistent with end-to-end latency (±5%): top-level
    # stages are the request's sequential breakdown; stitched children
    # must not perturb it.  Best-of-3 traced requests — a single
    # scheduler hiccup between stages must not flake the gate.
    def stage_gap(view) -> float:
        stage_sum = sum(s["duration_ms"] for s in view["stages"])
        return abs(stage_sum - view["duration_ms"]) / view["duration_ms"]

    gaps = [stage_gap(full)]
    attempt = 0
    while min(gaps) > 0.05 and attempt < 2:
        attempt += 1
        retry_id = TRACE_ID[:-1] + str(attempt)
        post_json(
            base,
            "/score_completions",
            {"prompt": prompts[0], "model": MODEL},
            headers={
                "traceparent": f"00-{retry_id}-e4e4e4e4e4e4e4e4-01"
            },
        )
        gaps.append(stage_gap(get_json(base, f"/debug/traces/{retry_id}")))
    assert min(gaps) <= 0.05, (gaps, full["stages"])

    # explain=1 carries the per-owner rollup.
    _, body = post_json(
        base,
        "/score_completions?explain=1",
        {"prompt": prompts[0], "model": MODEL},
    )
    rollup = body["explain"].get("cluster_rpcs")
    assert rollup, body["explain"].keys()
    assert sum(v["rpcs"] for v in rollup.values()) >= len(rpc_spans)

    # 2. Healthy envelope under steady traffic.
    for _ in range(3):
        for prompt in prompts:
            post_json(
                base,
                "/score_completions",
                {"prompt": prompt, "model": MODEL},
            )
        slo.sample()
        time.sleep(0.05)
    payload = get_json(base, "/debug/slo")
    assert payload["state"] == "healthy", payload
    assert envelope_violations(payload) == [], payload
    health = get_json(base, "/healthz")
    assert health["slo"]["state"] == "healthy", health["slo"]

    # 3. Chaos: kill a replica mid-traffic -> the staleness SLIs burn
    # into DEGRADED (bounded), asserted via the published envelope
    # rather than ad-hoc numeric pins.
    victim = sorted(cluster.replicas)[0]
    cluster.kill(victim)
    for prompt in prompts:  # scores keep flowing over the survivors
        post_json(
            base, "/score_completions", {"prompt": prompt, "model": MODEL}
        )
    slo.sample()
    payload = get_json(base, "/debug/slo")
    assert payload["state"] == "degraded", payload["state"]
    assert payload["slis"]["replicas_dead"]["state"] == "degraded"
    assert payload["slis"]["failovers"]["state"] == "degraded"
    assert envelope_violations(payload) == [], envelope_violations(
        payload
    )
    health = get_json(base, "/healthz")
    assert "replicas_dead" in health["slo"].get("degraded", []), health

    # 4. Attribution surfaces: per-replica rpc panel + last-error
    # context + the new metric families.
    status = get_json(base, "/debug/cluster")
    assert status["rpc"]["replicas"], status["rpc"]
    assert status["rpc"]["critical_path"]["owner_rpcs"] >= 1
    assert victim in status["membership"]["last_errors"], status[
        "membership"
    ]["last_errors"]
    metrics_text = get_text(base, "/metrics")
    for family in (
        "kvtpu_slo_state",
        "kvtpu_slo_burn_rate",
        "kvtpu_cluster_rpc_latency_seconds",
        "kvtpu_score_latency_seconds",
    ):
        assert family in metrics_text, family

    server.shutdown()
    event_pool.shutdown()
    indexer.shutdown()
    cluster.close()
    print("slo smoke completed successfully")


if __name__ == "__main__":
    main()
