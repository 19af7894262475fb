"""Build the port's native I/O engine with g++ (no CUDA, no external deps).

Usage: ``python -m llm_d_kv_cache_manager_tpu_torch.native.build``
(``--force`` recompiles a library that is up to date); with
``--stress`` or ``--stress-tsan`` it builds and runs the stress harness
(``src/stress_main.cpp``), plain or under ThreadSanitizer.

The port keeps its own copy of the engine's sources (``src/``) and
builds them at first use into the port's ``build/`` folder, beside the
CUDA kernels (listed in ``.gitignore``), never next to the JAX
package's library.  The file name
carries a hash of the sources and flags, so an edited source is rebuilt
and a stale library is never loaded.  Concurrent builds (test
workers, processes of one machine) take a file lock and write a
temporary file that is renamed into place, so none ever loads a torn
library.  A failed build raises: no caller carries on without the
engine.  ``build_stress`` compiles the harness the same way, over the
port's own header and engine sources.
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
STRESS_MAIN = "stress_main.cpp"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall", "-Wextra")
STRESS_FLAGS = ("-std=c++17", "-pthread", "-Wall", "-Wextra", "-O2")
TSAN_FLAGS = ("-std=c++17", "-pthread", "-Wall", "-Wextra", "-fsanitize=thread", "-O1", "-g")


def _compiler() -> str:
    compiler = shutil.which("g++") or shutil.which("c++")
    if compiler is None:
        raise RuntimeError(
            "no C++ compiler (g++ or c++) on PATH: the native engine cannot be built")
    return compiler


def _target(stem: str, suffix: str, flags, sources) -> Path:
    """``BUILD_DIR/<stem>-<hash of flags and sources><suffix>``."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for name in HEADERS + tuple(sources):
        digest.update(name.encode())
        digest.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}{suffix}"


def lib_path() -> Path:
    """Where the library for the current sources lives."""
    return _target("libkvtpu_native", ".so", FLAGS, SOURCES)


def needs_build() -> bool:
    """True when the library for the current sources is not built yet."""
    return not lib_path().exists()


def _compile(target: Path, flags, sources, what: str, force: bool = False) -> Path:
    """Compile ``sources`` into ``target`` unless it exists (``force``:
    even then), under the build lock, through a temporary file renamed
    into place."""
    if target.exists() and not force:
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if target.exists() and not force:  # another build finished while we waited
            return target
        fd, tmp = tempfile.mkstemp(suffix=target.suffix + ".tmp", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_compiler(), *flags, "-o", tmp, *(str(SRC_DIR / s) for s in sources)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.chmod(tmp, 0o755)
            os.replace(tmp, target)
        except subprocess.CalledProcessError as exc:
            raise RuntimeError(f"{what} build failed:\n{exc.stderr}") from exc
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return target


def build(force: bool = False) -> Path:
    """Compile the library unless it is built already (``force``: even
    then); returns its path.  Raises ``RuntimeError`` when there is no
    compiler or it fails."""
    return _compile(lib_path(), FLAGS, SOURCES, "native", force=force)


def build_stress(tsan: bool = False) -> Path:
    """Compile the stress harness (``src/stress_main.cpp`` over the
    engine's sources), with ThreadSanitizer when ``tsan``; returns the
    binary's path.  Raises ``RuntimeError`` when there is no compiler or
    it fails (a toolchain without libtsan fails the ``tsan`` build)."""
    flags = TSAN_FLAGS if tsan else STRESS_FLAGS
    sources = SOURCES + (STRESS_MAIN,)
    return _compile(_target("stress_tsan" if tsan else "stress", "", flags, sources), flags,
                    sources, "stress")


def _run_stress(tsan: bool) -> int:
    binary = build_stress(tsan=tsan)
    print(f"built {binary}; running", flush=True)
    with tempfile.TemporaryDirectory(prefix="kvtpu-stress-") as scratch:
        env = dict(os.environ, TSAN_OPTIONS="halt_on_error=1", KVTPU_STRESS_DIR=scratch)
        return subprocess.run([str(binary)], env=env).returncode


if __name__ == "__main__":
    try:
        if "--stress" in sys.argv or "--stress-tsan" in sys.argv:
            sys.exit(_run_stress("--stress-tsan" in sys.argv))
        print(f"built {build(force='--force' in sys.argv)}")
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        sys.exit(1)
