#!/usr/bin/env python3
"""Time the port's bf16 prefill and ring-partial kernels, built from
several source trees, against each other on one GPU, in turns.

Each argument is NAME=DIR, DIR a copy of
``llm_d_kv_cache_manager_tpu_torch/csrc/`` with a change in it (the C
interface of ``flash_prefill.cu`` and ``ring_partial.cu`` must stay the
checkout's); the checkout's own ``csrc/`` runs as ``tree``.  Every
version is built first, with its ``-Xptxas -v`` registers and spills
printed.  Then, for each serving shape of ``chip_smoke.py`` (prefill at
8448², the 256-token continuation, the ring partial at 2048² for
offsets 0, None and -1), the versions run in the order given, ``tree``
twice, then in reverse, three times over; each run is
``chip_smoke.timed_ms`` (20 launches replayed from a CUDA graph).  The
median and least time of each version are printed, beside SDPA's.

Usage, from the repository root, on a machine with the GPU:
    python3 hack/attention_kernel_ab.py old=/path/to/csrc-copy
"""

from __future__ import annotations

import pathlib
import runpy
import statistics
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="attention_kernel_ab")
    port, timed_ms = smoke["port"], smoke["timed_ms"]
    build = port("ops._build")
    fc, rc = port("ops.flash_cuda"), port("ops.ring_flash_cuda")
    versions = [arg.split("=", 1) for arg in argv] + [("tree", str(build.CSRC))]
    sources = ("flash_prefill", "ring_partial")
    libs = {}
    for tag, path in versions:
        build.CSRC = pathlib.Path(path).resolve()
        build._LIBS.clear()
        for src, log in build.build_all(sources).items():
            for kernel, line in smoke["ptxas_lines"](log):
                if "bf16" in kernel:
                    print(f"{tag} {src}: {kernel}: {line}", flush=True)
        libs[tag] = {name: build.library(name) for name in sources}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    g = torch.Generator(device="cuda").manual_seed(0)

    def qkv(Tq, Tk):
        return [torch.randn(1, T, h, 128, generator=g, device="cuda").to(torch.bfloat16)
                for T, h in ((Tq, 32), (Tk, 8), (Tk, 8))]

    def sdpa(x, **kw):
        q, k, v = (t.transpose(1, 2) for t in x)
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, **kw)

    full, hit, ring = qkv(8448, 8448), qkv(256, 8448), qkv(2048, 2048)
    shapes = {
        "prefill 8448^2": (lambda: fc.flash_gqa_attention_cuda(*full), sdpa(full, is_causal=True)),
        "prefill 256 over 8448": (lambda: fc.flash_gqa_attention_cuda(*hit, q_offset=8192), None),
        "ring 2048^2 offset 0": (lambda: rc.flash_partial_cuda(*ring, causal_offset=0),
                                 sdpa(ring, is_causal=True)),
        "ring 2048^2 offset None": (lambda: rc.flash_partial_cuda(*ring, causal_offset=None),
                                    sdpa(ring)),
        "ring 2048^2 offset -1": (lambda: rc.flash_partial_cuda(*ring, causal_offset=-1), None),
    }
    tags = [tag for tag, _ in versions[:-1]]
    order = (tags + ["tree", "tree"] + tags[::-1]) * 3
    for name, (kernel, library) in shapes.items():
        times = {}
        for tag in order:
            build._LIBS.update(libs[tag])
            times.setdefault(tag, []).append(timed_ms(torch, kernel, 20))
        line = "; ".join(f"{tag} median {statistics.median(ms):.4f} min {min(ms):.4f}"
                         for tag, ms in times.items())
        if library is not None:
            line += f"; sdpa {timed_ms(torch, library, 20):.4f}"
        print(f"{name}: {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
