#!/usr/bin/env python3
"""Time the captured decode step (``llama.make_decode_step``) replayed
from an ordinary ``torch.cuda.CUDAGraph`` against the same step on a
graph made with ``keep_graph=True``, which ``chip_smoke.py`` swaps in to
count the graph's decode kernel nodes.  Llama-3-8B, 32 layers, random
bf16 weights, batch 2 over 8448-token contexts (a 530-block table), 8
steps a turn on the host's clock, in turns (plain, keep, keep, plain)
four times over, so that what keeping the graph costs a replay, if
anything, shows beside the host's own spread.

Usage, from the repository root, on a machine with the GPU:
    python3 hack/decode_graph_ab.py
"""

from __future__ import annotations

import pathlib
import runpy
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
STEPS = 8


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_graph_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="decode_graph_ab")
    port = smoke["port"]
    llama, pool_mod = port("models.llama"), port("models.kv_cache_pool")
    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    pool = pool_mod.KVCachePool(
        pool_mod.KVCachePoolConfig(cfg.n_layers, 1060, cfg.block_size, cfg.n_kv_heads,
                                   cfg.head_dim, cfg.dtype), device="cuda")
    pool.kv.normal_()
    table = torch.arange(1060, dtype=torch.int32).reshape(2, 530)
    tokens = torch.tensor([5, 7], device="cuda")
    ctx0 = torch.full((2,), 8448, dtype=torch.int32, device="cuda")
    steps = {}
    for name in ("plain", "keep"):
        steps[name] = llama.make_decode_step(params, pool.kv, cfg, 2, table.shape[1])
        if name == "keep":
            steps[name].graph = torch.cuda.CUDAGraph(keep_graph=True)
        steps[name](tokens, table, ctx0 + 1)  # capture
    torch.cuda.synchronize()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    nodes = smoke["captured_kernel_nodes"](steps["keep"].graph, ("paged_decode_bf16_kernel",))
    print(f"decode kernel nodes in the kept graph: {nodes}", flush=True)
    times = {"plain": [], "keep": []}
    for _ in range(4):
        for name in ("plain", "keep", "keep", "plain"):
            toks, ctx = tokens, ctx0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEPS):
                ctx = ctx + 1
                toks = steps[name](toks, table, ctx).clone().argmax(-1)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3 / STEPS)
    for name, ms in times.items():
        print(f"{name}: ms/step over {STEPS} steps, each turn: "
              + " ".join(f"{t:.3f}" for t in ms), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
