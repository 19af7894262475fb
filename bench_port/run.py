"""Run one cell of the port's benchmark once, on the CUDA device.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``.  Makes
the traffic and the weights from ``--seed``, sets up the port's serving
stack (``serve.Server``), warms every shape the cell uses, serves the
window, judges what it served against the plain reference
(``check.py``), and prints one JSON line last on standard output.
``--trace 1`` profiles a slice of the window and reports the per-layer
metrics instead of the end-to-end ones.  Refuses to run without a CUDA
device.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from the interpreter's first import

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_port import check, roofline, serve, spec, trace  # noqa: E402
from bench_port.reference import router as ref_router  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "llm_d_kv_cache_manager_tpu"}
GIB = 1 << 30
MARGIN_BYTES = 3 * GIB  # left free beside the pool, the graphs and the activations
DRAIN_S = 90.0  # longest wait for the window's requests after it closes
TRACE_S = 4.0  # the traced slice: the window's last seconds
SETTLED_CALLS = 32  # prompts scored again once every frame is applied


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Run:
    """One served window and what the checks and metrics need of it."""

    cell: spec.Cell
    seed: int
    seconds: float
    setup_s: float
    win: serve.Window
    calls: List[serve.Call]
    slice_calls: List[serve.Call]
    router_calls: List[Any]
    router_scores: List[Dict[str, float]]
    frames: Dict[str, List[Any]]
    dropped: float
    lost: int
    memory_peak: int
    trace: Dict = field(default_factory=dict)
    params: Any = None  # the seeded weights, which the reference reads too


def plan_for(cell: spec.Cell, seed: int, seconds: float):
    mix = cell.traffic
    return spec.traffic_kind(mix["kind"]).generate(mix, seed, seconds,
                                                   cell.config["vocab_size"])


def activation_reserve(lm, params, plan, device) -> int:
    """Bytes a prefill of the plan's longest prompt takes beyond what is
    allocated, measured on a pool of its own; runs a continuation too, so
    that every kernel is built and cuBLAS has seen both paths.  The
    caching allocator keeps what they used, so that the window's prefills
    find it there and do not ask the device again."""
    reqs = plan.setup + plan.window + [r for q in plan.streams for r in q]
    longest = max(len(r.prompt) for r in reqs)
    bs = lm.block_size
    pool = lm.pool(longest // bs + 1, device)
    table = torch.arange(1, longest // bs + 1, dtype=torch.int32)[None]
    tokens = torch.randint(1, lm.vocab_size, (1, longest))
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    lm.prefill_paged(params, tokens, pool.kv, table)
    suffix = min(512, longest - bs)
    lm.prefill_continue(params, tokens[:, longest - suffix:], pool.kv, table, longest - suffix)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del pool
    gc.collect()
    return int(peak * 1.1) + (256 << 20)


def pool_blocks(lm, params, plan, mix, device: torch.device) -> int:
    """The pool's blocks: on the card, what is left after the weights, the
    decode graphs, a measured activation reserve and a margin (at most
    the mix's ``pool_tokens`` where it names one); on the CPU,
    ``pool_tokens``."""
    cap = 1 + int(mix["pool_tokens"]) // lm.block_size if "pool_tokens" in mix else None
    if device.type != "cuda":
        return cap
    reserve = activation_reserve(lm, params, plan, device)
    free = torch.cuda.mem_get_info(device)[0]
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    spare = (free - max(0, reserve - cached) - lm.graph_bytes(mix["decode_buckets"])
             - MARGIN_BYTES)
    say(f"memory: {free / GIB:.2f} GiB free after the weights, activation reserve "
        f"{reserve / GIB:.2f} GiB")
    blocks = int(spare // lm.block_bytes)
    return blocks if cap is None else min(blocks, cap)


def warm_profiler(device: torch.device) -> None:
    """Start and stop the profiler once at set-up, so that the window's
    slice does not pay for its first start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


def allocator_counts(device: torch.device) -> Dict[str, int]:
    """The caching allocator's device allocations and out-of-memory
    retries so far."""
    if device.type != "cuda":
        return {"num_device_alloc": 0, "num_alloc_retries": 0}
    stats = torch.cuda.memory_stats(device)
    return {k: int(stats.get(k, 0)) for k in ("num_device_alloc", "num_alloc_retries")}


def settled_scores(server: serve.Server, last: int = SETTLED_CALLS):
    """Once the window has closed: wait for the event pool, count the
    frames it never applied, and score the last requests' prompts again,
    now that every published frame should be in the index."""
    server.events.drain()
    names = [p.name for p in server.pods]
    published = {n: server.publishers[n].seq for n in names}
    unapplied = sum(published[n] - server.tap.applied(n) for n in names)
    calls, scores = [], []
    for lv in server.lives[-last:]:
        scores.append(dict(server.indexer.get_pod_scores(lv.text, server.model, names)))
        calls.append((lv.text, {n: (published[n], published[n]) for n in names}))
    return calls, scores, unapplied


def serve_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
               device: torch.device) -> Run:
    """Set up, serve the window and drain it; the program's state is
    freed before this returns."""
    mix = cell.traffic
    cuda = device.type == "cuda"
    plan = plan_for(cell, seed, seconds)
    params = cell.family.weights(cell.config, seed, device)
    lm = cell.family.model(cell.config, mix)
    blocks = pool_blocks(lm, params, plan, mix, device)
    need = plan.pods * math.ceil(plan.max_context / lm.block_size) + 1
    if blocks < need:
        raise RuntimeError(f"a pool of {blocks} blocks cannot hold this cell ({need} needed)")
    server = serve.Server(lm, mix, params, plan, blocks, device, cell.config["model_id"],
                          timed_calls=traced)
    try:
        server.capture()
        carried = server.serve_setup(plan.setup)
        dropped0 = server.dropped()
        gc.collect()
        gc.freeze()  # set-up's objects out of the collector's way, as servers do after start-up
        setup_s = time.perf_counter() - T_START
        say(f"set-up {setup_s:.2f} s: pool {blocks} blocks of {lm.block_size} tokens, "
            f"{plan.pods} pods, {len(plan.setup)} set-up requests")
        slice_ = None
        if traced:
            warm_profiler(device)
            length = min(TRACE_S, seconds / 2)
            slice_ = (seconds - length, seconds)
        before = allocator_counts(device)
        win = serve.run_window(server, plan, carried, seconds, DRAIN_S, slice_)
        after = allocator_counts(device)
        say("allocator in the window: " + ", ".join(
            f"{k} {after[k] - before[k]}" for k in sorted(after)))
        memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        end = win.t0 + seconds
        calls = [c for c in server.calls if win.t0 <= c.t0 < end]
        fills = [c for c in calls if c.kind == "prefill"]
        say(f"window work: {len(fills)} prefills, {sum(1 for c in fills if not c.prefix)} whole, "
            f"{sum(c.new for c in fills)} tokens computed, "
            f"{sum(1 for c in calls if c.kind == 'decode')} decode steps")
        slice_calls = ([c for c in server.calls
                        if win.profiled[0] <= c.t0 and c.t1 <= win.profiled[1]]
                       if win.profiled else [])
        summary = trace.reduce(win.prof) if win.prof is not None else {}
        win.prof = None
        final_calls, final_scores, unapplied = settled_scores(server)
        run = Run(
            cell=cell, seed=seed, seconds=seconds, setup_s=setup_s,
            win=win, calls=calls, slice_calls=slice_calls,
            router_calls=[(lv.text, lv.bracket) for lv in server.lives] + final_calls,
            router_scores=[lv.scores for lv in server.lives] + final_scores,
            frames={name: pub.log for name, pub in server.publishers.items()},
            dropped=server.dropped() - dropped0, lost=server.frames_lost + unapplied,
            memory_peak=memory_peak, trace=summary)
        for lv in server.lives:
            lv.pod = None  # the pods' tables go with the server
    finally:
        gc.unfreeze()
        server.close()
    del server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    run.params = params
    return run


def end_to_end(run: Run) -> Dict[str, float]:
    """Every end-to-end number this run can give, by metric name."""
    win = run.win
    t0, t1 = win.t0, win.t0 + run.seconds
    out = {"setup_s": run.setup_s}
    everyone = win.carried + win.lives
    tokens = sum(1 for lv in everyone for t in lv.times if t0 <= t < t1)
    out["output_tokens_per_s"] = tokens / run.seconds
    if run.cell.traffic["kind"] == "open":
        ttft = [(lv.times[0] - lv.due) * 1e3 for lv in win.lives if lv.times]
        itl = [(b - a) * 1e3 for lv in win.lives for a, b in zip(lv.times, lv.times[1:])]
        # Each request's mean gap between tokens (time per output token).
        tpot = [(lv.times[-1] - lv.times[0]) * 1e3 / (len(lv.times) - 1)
                for lv in win.lives if len(lv.times) > 1]
        if ttft:
            out["ttft_p50_ms"] = float(np.percentile(ttft, 50))
            out["ttft_p95_ms"] = float(np.percentile(ttft, 95))
        if tpot:
            out["tpot_p95_ms"] = float(np.percentile(tpot, 95))
    else:
        itl = [(b - a) * 1e3 for lv in everyone for a, b in zip(lv.times, lv.times[1:])
               if a >= t0 and b < t1]
    if itl:
        out["itl_p95_ms"] = float(np.percentile(itl, 95))
    return out


def record(run: Run) -> Dict[str, Any]:
    """What the per-layer readers (``metrics/<name>.py``) read."""
    name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    return {
        "lives": run.win.lives, "calls": run.calls, "slice_calls": run.slice_calls,
        "trace": run.trace, "stages": run.win.stages,
        "shape": run.cell.family.shape(run.cell.config),
        "block_size": int(run.cell.traffic["multiple"]),
        "peaks": roofline.peaks_for(name) if name != "cpu" else roofline.PEAKS["H100 SXM"],
    }


def judged(run: Run) -> List[Any]:
    """The requests whose served tokens are judged: the open loop's that
    finished, or every request that served tokens in a closed loop."""
    if run.cell.traffic["kind"] == "open":
        return [lv for lv in run.win.lives if lv.done]
    return [lv for lv in run.win.carried + run.win.lives if lv.tokens]


def busiest_rows(run: Run) -> List[int]:
    """The requests of the window's decode step with the most rows, each
    in its own slot of the batch."""
    steps = [c for c in run.calls if c.kind == "decode"]
    return list(max(steps, key=lambda c: len(c.rows)).rows) if steps else []


def checks(run: Run, device: torch.device) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit, in the order printed."""
    limits = run.cell.traffic["check"]
    t0 = time.perf_counter()
    want = ref_router.expected_scores(run.router_calls, run.frames, int(run.cell.traffic["multiple"]))
    bad, first = ref_router.mismatches(run.router_scores, want)
    if first:
        say(f"router: first mismatch {first}")
    picked = check.sample(judged(run), run.seed, int(limits["tokens"]),
                          int(limits["max_requests"]), busiest_rows(run))
    gap = check.served_gap(run.cell.family, run.params, run.cell.config, picked, device)
    unfinished = sum(1 for lv in run.win.lives if not lv.done) if run.cell.traffic["kind"] == "open" else 0
    say(f"judged {gap['tokens']} served tokens of {gap['requests']} requests and "
        f"{len(run.router_scores)} router calls in {time.perf_counter() - t0:.1f} s")
    return {
        "served_logit_gap": {"value": gap["gap"], "limit": float(limits["served_logit_gap"])},
        "router_score_mismatches": {"value": bad, "limit": 0},
        "events_dropped": {"value": run.dropped + run.lost, "limit": 0},
        "requests_unfinished": {"value": unfinished, "limit": 0},
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(Path("BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"{cell.name} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)  # the host's work is the loop's; no intra-op pool beside it
    traced = bool(args.trace)
    run = serve_cell(cell, args.seed, args.seconds, traced, device)
    values = end_to_end(run)
    metrics: Dict[str, Dict[str, Any]] = {}
    if traced:
        rec = record(run)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        say(f"refusing to report: JAX or the JAX package is loaded: {found}")
        return 3
    compared = checks(run, device)
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    attempted = len(run.win.lives) if cell.traffic["kind"] == "open" else len(judged(run))
    failed = compared["requests_unfinished"]["value"] + int(compared["events_dropped"]["value"])
    win = run.win
    say(f"window {run.seconds:.0f} s: {attempted} requests, drained {win.drained_s:.2f} s, "
        f"admission late p95 {np.percentile(win.late_s, 95) * 1e3 if win.late_s else 0:.2f} ms; "
        + ", ".join(f"{k} {v:.4f}" for k, v in values.items()))
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                   "memory_peak_bytes": int(run.memory_peak)}
    result: Dict[str, Any] = {"correct": correct, "attempted": attempted, "failed": failed,
                              "metrics": metrics, "device": device_info}
    if traced and run.trace:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = trace.breakdown(run.trace)
    result["checks"] = compared
    for name, c in compared.items():
        say(f"check {name}: {c['value']} (limit {c['limit']})")
    if forbidden_modules():
        say(f"refusing to report: JAX or the JAX package is loaded: {forbidden_modules()}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
