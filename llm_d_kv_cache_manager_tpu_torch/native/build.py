"""Build the port's native I/O engine with g++ (no CUDA, no external deps).

Usage: ``python -m llm_d_kv_cache_manager_tpu_torch.native.build``.

The port keeps its own copy of the engine's sources (``src/``) and
builds them at first use into the port's ``build/`` folder, beside the
CUDA kernels (listed in ``.gitignore``), never next to the JAX
package's library.  The file name
carries a hash of the sources and flags, so an edited source is rebuilt
and a stale library is never loaded.  Concurrent builds (test
workers, processes of one machine) take a file lock and write a
temporary file that is renamed into place, so none ever loads a torn
library.  A failed build raises: no caller carries on without the
engine.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "src"
BUILD_DIR = _HERE.parent / "build"
SOURCES = ("hashing.cpp", "numa.cpp", "thread_pool.cpp", "file_io.cpp", "engine.cpp")
HEADERS = ("kvtpu_native.hpp", "debug_utils.hpp")
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall", "-Wextra")


def _compiler() -> str:
    compiler = shutil.which("g++") or shutil.which("c++")
    if compiler is None:
        raise RuntimeError(
            "no C++ compiler (g++ or c++) on PATH: the native engine cannot be built")
    return compiler


def lib_path() -> Path:
    """Where the library for the current sources lives."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for name in HEADERS + SOURCES:
        digest.update(name.encode())
        digest.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libkvtpu_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises ``RuntimeError`` when there is no compiler or it fails."""
    target = lib_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if target.exists():  # another build finished while we waited
            return target
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_compiler(), *FLAGS, "-o", tmp, *(str(SRC_DIR / s) for s in SOURCES)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, target)
        except subprocess.CalledProcessError as exc:
            raise RuntimeError(f"native build failed:\n{exc.stderr}") from exc
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return target


if __name__ == "__main__":
    try:
        print(f"built {build()}")
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        sys.exit(1)
