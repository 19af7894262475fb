#!/usr/bin/env python3
"""Where a traced scoring request's time lies outside its four stages.

``tests/test_torch_debug_surface.py::TestTraceparentSurface::
test_spans_cover_stages_and_sum_to_total`` holds the sum of the
``tokenize``, ``hash_blocks``, ``index_lookup`` and ``score`` stages to
within 5% of the request.  This probe serves the same fleet as that
test (the tiny tokenizer, two tokenizer workers, an event pool) on one
package, sends ``--requests`` traced requests of fresh prompts (the
test's sentence, 200 times, its words shuffled from a seed), and for
each splits the time outside the stages into the handler's head and
tail (trace start to the indexer call, the call's end to the trace's)
and the indexer's (the call's start to the ``tokenize`` span, the
``score`` span's end to the call's end).  It records every cyclic
collection that ran inside the call (``gc.callbacks``), and with
``--pause-gc`` pauses the collector for each request as the test does.

Run as ``python -m hack.stage_gap_probe_torch --side port --requests
400`` (``--side ref`` for the JAX package's service).  Load the machine
beside it (for example six busy processes) to see what a parallel test
run sees.  Prints one JSON object: the requests whose stage sum misses
the trace total, and the indexer call, by more than 5%, the largest
gaps, and each head and tail part's median and maximum in ms.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import random
import tempfile
import time
import urllib.request

from tests.helpers.tiny_tokenizer import build_transformers_tokenizer, save_tokenizer_json

MODEL = "test-model"
SENTENCE = "the quick brown fox jumps over the lazy dog . "
STAGES = ("tokenize", "hash_blocks", "index_lookup", "score")
PACKAGES = {"ref": "llm_d_kv_cache_manager_tpu", "port": "llm_d_kv_cache_manager_tpu_torch"}


def _module(side: str, name: str):
    return importlib.import_module(f"{PACKAGES[side]}.{name}")


def _post(url: str, obj: dict, trace_id: str) -> None:
    request = urllib.request.Request(
        url, data=json.dumps(obj).encode(), method="POST",
        headers={"Content-Type": "application/json",
                 "traceparent": f"00-{trace_id}-{'cd' * 8}-01"})
    with urllib.request.urlopen(request, timeout=30) as response:
        response.read()


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=30) as response:
        return json.load(response)


def probe(side: str, requests: int, pause_gc: bool, seed: int) -> dict:
    ix = _module(side, "kvcache.indexer")
    tp = _module(side, "kvcache.kvblock.token_processor")
    tok_pool = _module(side, "tokenization.pool")
    tokenizers = _module(side, "tokenization.tokenizers")
    ev_pool = _module(side, "kvevents.pool")
    trace = _module(side, "obs.trace")
    http = _module(side, "api.http_service")
    with tempfile.TemporaryDirectory() as tmp:
        indexer = ix.Indexer(
            ix.IndexerConfig(
                token_processor_config=tp.TokenProcessorConfig(block_size=4),
                tokenizers_pool_config=tok_pool.TokenizationPoolConfig(workers=2,
                                                                       model_name=MODEL)),
            tokenizer=tokenizers.LocalFastTokenizer(save_tokenizer_json(tmp, MODEL)))
        indexer.chat_processor.register_tokenizer(MODEL, build_transformers_tokenizer())
        indexer.run()
        events = ev_pool.Pool(indexer.kv_block_index, indexer.token_processor,
                              ev_pool.PoolConfig(concurrency=2))
        events.start()
        server = http.serve(indexer, host="127.0.0.1", port=0)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        trace.TRACER.configure(sample_rate=0.0)
        score, mark, collections = indexer.get_pod_scores, {}, []

        def timed_score(*args, **kwargs):
            mark["trace_start"] = trace.current_trace().start
            mark["t0"] = time.perf_counter()
            try:
                return score(*args, **kwargs)
            finally:
                mark["t1"] = time.perf_counter()

        def on_gc(phase, info):
            collections.append((phase, time.perf_counter(), info.get("generation")))

        indexer.get_pod_scores = timed_score
        gc.callbacks.append(on_gc)
        rows = []
        try:
            words = SENTENCE.split() * 200
            for i in range(requests):
                random.Random(seed + i).shuffle(words)
                trace_id = f"{0x9000 + i:032x}"
                collections.clear()
                collecting = gc.isenabled()
                if pause_gc:
                    gc.disable()
                try:
                    _post(base + "/score_completions",
                          {"prompt": " ".join(words) + " ", "model": MODEL}, trace_id)
                finally:
                    if collecting:
                        gc.enable()
                full = _get(f"{base}/debug/traces/{trace_id}")
                spans = sorted((s for s in full["spans"]
                                if s["name"] in STAGES and s["parent"] is None),
                               key=lambda s: s["start_ms"])
                stage_sum = sum(s["duration_ms"] for s in full["stages"])
                total = full["duration_ms"]
                enter = (mark["t0"] - mark["trace_start"]) * 1e3
                call = (mark["t1"] - mark["t0"]) * 1e3
                last_end = spans[-1]["start_ms"] + spans[-1]["duration_ms"]
                starts = [t for p, t, _ in collections if p == "start" and mark["t0"] <= t]
                stops = [t for p, t, _ in collections if p == "stop" and mark["t0"] <= t]
                rows.append({
                    "gap_of_total": abs(stage_sum - total) / total,
                    "gap_of_call": abs(stage_sum - call) / call,
                    "handler_head_ms": enter, "handler_tail_ms": total - enter - call,
                    "indexer_head_ms": spans[0]["start_ms"] - enter,
                    "indexer_tail_ms": enter + call - last_end,
                    "gc_in_call_ms": sum((b - a) * 1e3 for a, b in zip(starts, stops)
                                         if b <= mark["t1"]),
                })
        finally:
            gc.callbacks.remove(on_gc)
            server.shutdown()
            server.server_close()
            events.shutdown()
            indexer.shutdown()

    def spread(key):
        values = sorted(r[key] for r in rows)
        return {"median": values[len(values) // 2], "max": values[-1]}

    over = [r for r in rows if r["gap_of_total"] > 0.05]
    return {
        "side": side, "requests": requests, "pause_gc": pause_gc,
        "over_5pct_of_trace": len(over),
        "over_5pct_of_call": sum(r["gap_of_call"] > 0.05 for r in rows),
        "over_5pct_of_trace_with_gc_in_call": sum(r["gc_in_call_ms"] > 0 for r in over),
        "worst_gap_of_trace": max(r["gap_of_total"] for r in rows),
        "worst_gap_of_call": max(r["gap_of_call"] for r in rows),
        **{key: spread(key) for key in ("handler_head_ms", "indexer_head_ms",
                                        "indexer_tail_ms", "handler_tail_ms")},
        "over": over[:8],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--side", choices=sorted(PACKAGES), default="port")
    parser.add_argument("--requests", type=int, default=150)
    parser.add_argument("--pause-gc", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    print(json.dumps(probe(args.side, args.requests, args.pause_gc, args.seed), indent=1))


if __name__ == "__main__":
    main()
