"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, under
``build/`` inside this package (listed in ``.gitignore``), and loaded
with ``ctypes``.  The library's file name carries a hash of its source
and flags, so an edited source is rebuilt and a stale library is never
loaded.  :func:`build_all` starts one ``nvcc`` per source, all at once,
and waits for them together; the first library asked for builds every
source of :data:`SOURCES` that is not built yet that way, so that a
fresh checkout waits for the slowest ``nvcc`` once, not for each in turn.

Nothing is built or loaded at import: the CPU tests import every
module of the port on machines without ``nvcc``.  A failed build
raises; no caller carries on without its kernel.

The kernels are forward-only, as the reference's Pallas kernels are (it
gives none of them a VJP and trains through its dense einsum): a
wrapper calls :func:`refuse_grad` before it launches, so a call that
autograd would record raises instead of returning an output with no
gradient.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

from llm_d_kv_cache_manager_tpu_torch.metrics.collector import count_build
from llm_d_kv_cache_manager_tpu_torch.obs.trace import profiler_range

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
# Every kernel source: csrc/<name>.cu, each its own library.
SOURCES = ("flash_prefill", "paged_decode", "ring_partial", "layer_fused", "moe_experts")
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

# Loaded libraries, one per source for the life of the process (a
# loaded shared object cannot be unloaded safely anyway).
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    digest.update(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    target = _target(name)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    return target, tmp, proc


def _finish(name: str, target: Path, tmp: Path, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent build sees all or none
    (target.with_suffix(".log")).write_text(log)
    return log


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc``
    per source, all started together.  Returns ``{name: nvcc output}``
    (register and shared-memory use from ``-Xptxas -v``)."""
    logs: Dict[str, str] = {}
    started: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    try:
        for name in names:
            target = _target(name)
            if target.exists():
                log = target.with_suffix(".log")
                logs[name] = log.read_text() if log.exists() else ""
                continue
            started.append((name, *_start(name)))
    finally:
        # Wait for every started compiler even when a later start
        # raised, so no nvcc outlives this call.
        errors = []
        for name, target, tmp, proc in started:
            try:
                logs[name] = _finish(name, target, tmp, proc)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built on first use with
    every other source of :data:`SOURCES` not built yet (an ``ops.build``
    profiler range, counted in
    ``kvtpu_kernel_builds_total{what="library"}``)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            t0 = time.perf_counter()
            with profiler_range("ops.build", {"source": name}):
                build_all(SOURCES if name in SOURCES else [name])
                lib = ctypes.CDLL(str(_target(name)))
            count_build("library", time.perf_counter() - t0)
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, what: str, rc: int) -> None:
    """Raise when a C entry returned a CUDA error (``cudaGetLastError``
    after its launches): a refused launch never runs, and a later
    synchronize would not report it."""
    if rc != 0:
        message = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({message})")


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record a kernel call: grad mode is on
    and an input requires grad.  A kernel writes its output through a
    raw pointer, so that output would carry no ``grad_fn`` and the
    inputs would get no gradient, without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel is forward-only and an input requires grad; "
            "call it under torch.no_grad(), or differentiate through the "
            "dense op (forward(..., use_flash=False), as loss_fn does)"
        )
