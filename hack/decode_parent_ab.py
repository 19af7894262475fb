#!/usr/bin/env python3
"""Time the checkout's decode kernel against an earlier one, in turns,
on one GPU.

The earlier kernel is a ``paged_decode.cu`` with the C interface the
port had before pool blocks of other than 16 tokens (``paged_decode``
without ``nsub``, ``paged_decode_ctas_per_sm(D, G, dtype)``), such as
the file in an unpacked ``git archive`` of an older commit; it is
called through ctypes directly.  Each further argument NAME=PATH is a
``paged_decode.cu`` with the checkout's interface (a copy of
``csrc/`` with a change in it), called through the checkout's wrapper.
All are built at once with ``ops/_build.py``'s flags, their bf16
``<128,...>`` kernels' registers printed.  At chip_smoke's decode
shapes (H 32, Hkv 8, D 128, blocks of 16: B = 2, 4 ragged, 1, 16
ragged) each is first held to the plain version, then timed with
``chip_smoke.timed_ms`` (20 launches replayed from a CUDA graph) in
the order given and reversed, AB_ROUNDS times (default 3); the median
and least time of each are printed.

Usage, from the repository root, on a machine with the GPU:
    AB_ROUNDS=5 python3 hack/decode_parent_ab.py OLD/paged_decode.cu [name=path.cu ...]
"""
import ctypes
import os
import pathlib
import runpy
import statistics
import subprocess
import sys

sys.path.insert(0, ".")
import torch  # noqa: E402

g = runpy.run_path("chip_smoke.py", run_name="decode_parent_ab")
port = g["port"]
build = port("ops._build")
pc = port("ops.paged_decode_cuda")
out_dir = pathlib.Path("llm_d_kv_cache_manager_tpu_torch/build/decode_ab")
out_dir.mkdir(parents=True, exist_ok=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
variants = {"parent": sys.argv[1],
            "tree": "llm_d_kv_cache_manager_tpu_torch/csrc/paged_decode.cu"}
for arg in sys.argv[2:]:
    name, path = arg.split("=")
    variants[name] = path
procs = {}
for name, src in variants.items():
    so = out_dir / f"lib{name}.so"
    procs[name] = (so, subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), src],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True))
libs = {}
for name, (so, proc) in procs.items():
    log, _ = proc.communicate()
    if proc.returncode:
        print(log)
        raise SystemExit(f"{name} failed to build")
    for kernel, line in g["ptxas_lines"](log):
        if "bf16" in kernel and ("128,8" in kernel or "128,4" in kernel):
            print(f"  {name}: {kernel}: {line}", flush=True)
    lib = ctypes.CDLL(str(so))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    libs[name] = lib


def parent_call(lib, q, kv, table, ctx):
    """A call of the earlier kernel through its own C interface."""
    B, H, D = q.shape
    nb, _, bs, Hkv, _ = kv.shape
    lib.paged_decode.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.paged_decode_ctas_per_sm.argtypes = [ctypes.c_int] * 3
    lib.paged_decode_scratch_bytes.argtypes = [ctypes.c_int] * 5
    lib.paged_decode_scratch_bytes.restype = ctypes.c_long
    res = lib.paged_decode_ctas_per_sm(D, H // Hkv, 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = pc.split_plan(B, Hkv, table.shape[1], sms, res)
    scratch = torch.empty(lib.paged_decode_scratch_bytes(B, Hkv, H // Hkv, D, ctas),
                          dtype=torch.uint8, device="cuda")
    out = torch.empty_like(q)

    def call():
        rc = lib.paged_decode(q.data_ptr(), kv.data_ptr(), table.data_ptr(), ctx.data_ptr(),
                              scratch.data_ptr(), out.data_ptr(), B, H, Hkv, D, bs, nb,
                              table.shape[1], ctas, 1, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out
    return call


def new_call(lib, q, kv, table, ctx):
    """A call of a kernel with the checkout's interface, through the
    checkout's wrapper with ``lib`` as its library."""
    def call():
        build._LIBS["paged_decode"] = lib
        return pc.paged_decode_attention_cuda(q, kv, table, ctx)
    return call


SHAPES = {"B2 ctx8456": (2, 529, [8456, 8456]), "B4 ragged": (4, 528, [8448, 1, 5000, 8447]),
          "B1 ctx8452": (1, 529, [8452]),
          "B16 ragged": (16, 528, [8448 - 523 * i for i in range(15)] + [1])}
gen = torch.Generator(device="cuda").manual_seed(0)
for shape, (B, mb, ctxs) in SHAPES.items():
    kv = torch.randn(B * mb + 7, 2, 16, 8, 128, generator=gen, device="cuda").to(torch.bfloat16)
    q = torch.randn(B, 32, 128, generator=gen, device="cuda").to(torch.bfloat16)
    table = torch.randperm(B * mb + 7, generator=torch.Generator().manual_seed(0))[:B * mb]
    table = table.reshape(B, mb).to(torch.int32).cuda()
    ctx = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
    ref = pc.paged_decode_attention_plain(q, kv, table, ctx)
    calls = {}
    for name, lib in libs.items():
        pc.RESIDENT_CTAS.clear()
        calls[name] = (parent_call if name == "parent" else new_call)(lib, q, kv, table, ctx)
        got = calls[name]()
        torch.cuda.synchronize()
        err = g["err_over_limit"](got, ref, *g["LIMITS"]["decode", "bfloat16"])
        print(f"  {shape} {name}: err/limit {err[1]:.3f}", flush=True)
    times = {n: [] for n in calls}
    order = list(calls)
    for _ in range(int(os.environ.get("AB_ROUNDS", "3"))):
        for name in order + order[::-1]:
            if name != "parent":
                build._LIBS["paged_decode"] = libs[name]
                pc.RESIDENT_CTAS.clear()
            times[name].append(g["timed_ms"](torch, calls[name], 20))
    print(f"{shape}: " + "  ".join(f"{n} {statistics.median(t):.4f} (min {min(t):.4f})"
                                    for n, t in times.items()), flush=True)
