#!/usr/bin/env python3
"""Time the port's attention kernels, built from several source trees or
with several settings, against each other on one GPU, in turns.

Prefill and ring partial (skipped by ``--only decode``):

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

Paged decode (skipped by ``--only attention``): the checkout's
``paged_decode.cu`` (``tree``: 8 warps of 2 stages, ``cp.async``, tensor
cores); the design options measured and not taken, built from
``hack/kernel_variants/paged_decode_options.cu``, the same kernel with
its options still in it: other ring settings (``-DDECODE_WARPS``,
``-DDECODE_STAGES``: warps a CTA and shared-memory stages a warp; with
neither it is ``tree`` again, as ``w8s2`` shows), the rings filled by
TMA (``-DDECODE_TMA``), bf16 on its CUDA-core engine
(``-DDECODE_BF16_SIMT``); and the design it replaced, kept as
``hack/kernel_variants/paged_decode_warp_chunks.cu`` (a warp per chunk
of blocks reading global memory, a second kernel merging the partials),
whose two kernels are also timed apart from a profiler window.  Device
ms at the three decode shapes of ``chip_smoke.py``, in turns, each run
``chip_smoke.timed_ms`` (20 launches replayed from a CUDA graph), with
each version's output held against the plain version first; a fourth
shape of one block a sequence times what a call costs before its first
byte.

Usage, from the repository root, on a machine with the GPU:
    python3 hack/attention_kernel_ab.py [--only decode|attention] [old=/path/to/csrc-copy]
"""

from __future__ import annotations

import pathlib
import runpy
import statistics
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


# (tag, extra nvcc flags) of the decode kernel's variants, each a build
# of hack/kernel_variants/paged_decode_options.cu.
DECODE_VARIANTS = (
    ("w8s2", ()),
    ("w2s4", ("-DDECODE_WARPS=2", "-DDECODE_STAGES=4")),
    ("w4s2", ("-DDECODE_WARPS=4", "-DDECODE_STAGES=2")),
    ("w4s4", ("-DDECODE_WARPS=4", "-DDECODE_STAGES=4")),
    ("w6s2", ("-DDECODE_WARPS=6", "-DDECODE_STAGES=2")),
    ("w8s3", ("-DDECODE_WARPS=8", "-DDECODE_STAGES=3")),
    ("w10s2", ("-DDECODE_WARPS=10", "-DDECODE_STAGES=2")),
    ("w12s2", ("-DDECODE_WARPS=12", "-DDECODE_STAGES=2")),
    ("cuda-cores", ("-DDECODE_BF16_SIMT",)),
    ("tma", ("-DDECODE_TMA",)),
    ("tma-w8s3", ("-DDECODE_TMA", "-DDECODE_STAGES=3")),
    ("tma-w4s4", ("-DDECODE_TMA", "-DDECODE_WARPS=4", "-DDECODE_STAGES=4")),
    ("tma-w12s2", ("-DDECODE_TMA", "-DDECODE_WARPS=12")),
)
KERNEL_VARIANTS = REPO / "hack" / "kernel_variants"


def old_decode(torch, lib, q, kv, table, ctx):
    """The replaced design's wrapper: chunks over the table's width for
    about 16 warps an SM, a partial pass and a merge pass."""
    import ctypes

    B, H, D = q.shape
    num_blocks, _, block_size, Hkv, _ = kv.shape
    max_blocks = table.shape[1]
    want = -(-132 * 16 // (B * Hkv))
    chunks = max(1, min(max_blocks, want))
    per_chunk = -(-max_blocks // chunks)
    chunks = -(-max_blocks // per_chunk)
    out = torch.empty_like(q)
    part_acc = torch.empty((B, H, chunks, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, H, chunks, 2), dtype=torch.float32, device=q.device)
    fn = lib.paged_decode
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), kv.data_ptr(), table.data_ptr(), ctx.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), out.data_ptr(), B, H, Hkv, D, block_size, num_blocks, max_blocks,
            per_chunk, chunks, 1, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old paged_decode: CUDA error {rc}")
    return out


def decode_section(torch, smoke) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    port, timed_ms = smoke["port"], smoke["timed_ms"]
    build, pc = port("ops._build"), port("ops.paged_decode_cuda")
    base_flags, csrc = build.NVCC_FLAGS, build.CSRC
    # One nvcc per build, all started together (a library's name carries
    # a hash of its flags): the checkout's kernel, then the variants,
    # which include the checkout's attention_tiles.cuh.
    builds = [("tree", "paged_decode", csrc, ())] + [
        (tag, "paged_decode_options", KERNEL_VARIANTS, ("-I", str(csrc)) + flags)
        for tag, flags in DECODE_VARIANTS]
    started = []
    for tag, source, folder, flags in builds:
        build.CSRC, build.NVCC_FLAGS = folder, base_flags + flags
        started.append(build._start(source))
    libs = {}
    for (tag, source, folder, flags), job in zip(builds, started):
        build.CSRC, build.NVCC_FLAGS = folder, base_flags + flags
        log = build._finish(source, *job)
        for kernel, line in smoke["ptxas_lines"](log):
            # The checkout's serving kernel (blocks of 16 or more
            # tokens) and the variants' one.
            if kernel in ("paged_decode_bf16_kernel<128,8,0>", "paged_decode_bf16_kernel<128,8>"):
                print(f"{tag} {' '.join(flags[2:])}: {kernel}: {line}", flush=True)
        build._LIBS.clear()
        libs[tag] = build.library(source)
    build.NVCC_FLAGS, build.CSRC = base_flags, KERNEL_VARIANTS
    log = build.build_all(["paged_decode_warp_chunks"])["paged_decode_warp_chunks"]
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "bfloat16Li128ELi16ELi8E" in ln:
            print("old: decode_partial_kernel<bf16,128,16,8>:", " ".join(
                x.strip() for x in lines[i + 1:i + 4]), flush=True)
    old_lib = build.library("paged_decode_warp_chunks")
    build.CSRC = csrc
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    def use(tag):
        build._LIBS["paged_decode"] = libs[tag]
        pc.RESIDENT_CTAS.clear()  # each build has its own occupancy

    ragged16 = [8448 - 523 * i for i in range(15)] + [1]
    # The last shape reads next to nothing: what a call costs before its
    # first byte (the launch, the memset node, a pipeline fill, the merge).
    shapes = {"B=2 ctx 8456": (529, [8456, 8456]), "B=4 ragged": (528, [8448, 1, 5000, 8447]),
              "B=16 ragged": (528, ragged16), "B=2 ctx 16 (fixed cost)": (529, [16, 16])}
    g = torch.Generator(device="cuda").manual_seed(0)
    tags = [tag for tag, _ in DECODE_VARIANTS]
    order = (["old"] + tags + ["tree", "tree"] + tags[::-1] + ["old"]) * 2
    for name, (max_blocks, ctx) in shapes.items():
        B = len(ctx)
        kv = torch.randn(B * max_blocks, 2, 16, 8, 128, generator=g, device="cuda").bfloat16()
        q = torch.randn(B, 32, 128, generator=g, device="cuda").bfloat16()
        table = torch.randperm(B * max_blocks, generator=torch.Generator().manual_seed(0))
        table = table.reshape(B, max_blocks).to(torch.int32).cuda()
        ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
        ref = pc.paged_decode_attention_plain(q, kv, table, ctx_t)
        calls = {"old": lambda: old_decode(torch, old_lib, q, kv, table, ctx_t)}
        for tag in ["tree"] + tags:
            calls[tag] = lambda: pc.paged_decode_attention_cuda(q, kv, table, ctx_t)
        times = {}
        for tag in order:
            if tag != "old":
                use(tag)
            if tag not in times:
                smoke["check_close"](f"{name} {tag}", calls[tag](), ref,
                                     *smoke["LIMITS"]["decode", "bfloat16"])
            times.setdefault(tag, []).append(timed_ms(torch, calls[tag], 20))
        print(f"decode {name}: " + "; ".join(
            f"{tag} median {statistics.median(ms):.4f} min {min(ms):.4f}"
            for tag, ms in times.items()), flush=True)
        # The replaced design's two kernels apart, from the profiler.
        calls["old"]()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                calls["old"]()
            torch.cuda.synchronize()
        apart = {key: sum(e.self_device_time_total for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA and key in e.key) / 20 / 1e3
                 for key in ("decode_partial_kernel", "decode_merge_kernel")}
        print(f"decode {name}: old design's kernels apart, ms: {apart}", flush=True)
    use("tree")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    only = None
    if argv[:1] == ["--only"]:
        only, argv = argv[1], argv[2:]
    sys.path.insert(0, str(REPO))
    smoke = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="attention_kernel_ab")
    if only != "attention":
        decode_section(torch, smoke)
    if only == "decode":
        return 0
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
