"""The port's native I/O engine on the CPU: ports of ``TestOffloadEngine``
(``tests/test_native.py``) for the native and the explicit Python engine,
the same jobs giving the same bytes as the JAX package's engine, and a
loader that raises on a failed build instead of handing back the Python
engine."""

import ctypes
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from llm_d_kv_cache_manager_tpu.native.engine import (
    JobStatus as JaxJobStatus,
    OffloadEngine as JaxOffloadEngine,
)
from tests.helpers.torch_port import PACKAGE, port

REPO = pathlib.Path(__file__).resolve().parent.parent

native = port("native")
build_mod = port("native.build")
engine_mod = port("native.engine")
JobStatus = engine_mod.JobStatus


@pytest.fixture(params=["native", "python"])
def engine(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setenv("KVTPU_DISABLE_NATIVE", "1")
    else:
        monkeypatch.delenv("KVTPU_DISABLE_NATIVE", raising=False)
    eng = engine_mod.OffloadEngine(n_threads=2)
    assert eng.is_native == (request.param == "native")
    yield eng
    eng.close()


class TestOffloadEngine:
    def test_store_load_roundtrip(self, engine, tmp_path):
        rng = np.random.default_rng(3)
        blocks = [rng.integers(0, 255, size=(2, 16, 8), dtype=np.uint8) for _ in range(5)]
        paths = [str(tmp_path / f"{i:02x}" / f"block_{i}.bin") for i in range(5)]
        engine.store(1, paths, blocks, skip_existing=True)
        assert engine.wait(1) == JobStatus.SUCCEEDED
        assert all(os.path.exists(p) for p in paths)
        out = [np.zeros_like(b) for b in blocks]
        engine.load(2, paths, out)
        assert engine.wait(2) == JobStatus.SUCCEEDED
        for original, loaded in zip(blocks, out):
            np.testing.assert_array_equal(original, loaded)

    def test_get_finished_harvests_once(self, engine, tmp_path):
        engine.store(10, [str(tmp_path / "a.bin")], [np.arange(64, dtype=np.uint8)])
        assert engine.wait(10) == JobStatus.SUCCEEDED
        assert engine.get_finished() == []

    def test_get_finished_polling(self, engine, tmp_path):
        engine.store(20, [str(tmp_path / "b.bin")], [np.arange(128, dtype=np.uint8)])
        deadline = time.monotonic() + 10
        finished = []
        while time.monotonic() < deadline and not finished:
            finished = engine.get_finished()
            time.sleep(0.01)
        assert finished == [(20, JobStatus.SUCCEEDED)]

    def test_load_missing_file_fails(self, engine, tmp_path):
        engine.load(30, [str(tmp_path / "missing.bin")], [np.zeros(64, dtype=np.uint8)])
        assert engine.wait(30) == JobStatus.FAILED

    def test_load_size_mismatch_fails(self, engine, tmp_path):
        path = tmp_path / "short.bin"
        path.write_bytes(b"x" * 10)
        engine.load(31, [str(path)], [np.zeros(64, dtype=np.uint8)])
        assert engine.wait(31) == JobStatus.FAILED

    def test_skip_existing_dedupe(self, engine, tmp_path):
        path = str(tmp_path / "dedupe.bin")
        first = np.full(32, 1, dtype=np.uint8)
        engine.store(40, [path], [first])
        assert engine.wait(40) == JobStatus.SUCCEEDED
        engine.store(41, [path], [np.full(32, 2, dtype=np.uint8)], skip_existing=True)
        assert engine.wait(41) == JobStatus.SUCCEEDED
        with open(path, "rb") as handle:
            assert handle.read() == first.tobytes()

    def test_overwrite_when_not_skipping(self, engine, tmp_path):
        path = str(tmp_path / "clobber.bin")
        second = np.full(32, 2, dtype=np.uint8)
        engine.store(50, [path], [np.full(32, 1, dtype=np.uint8)])
        assert engine.wait(50) == JobStatus.SUCCEEDED
        engine.store(51, [path], [second], skip_existing=False)
        assert engine.wait(51) == JobStatus.SUCCEEDED
        with open(path, "rb") as handle:
            assert handle.read() == second.tobytes()

    def test_partial_head_load_from_larger_file(self, engine, tmp_path):
        path = tmp_path / "group.bin"
        full = np.arange(64, dtype=np.uint8)
        path.write_bytes(full.tobytes())
        head = np.zeros(32, dtype=np.uint8)
        engine.load(80, [str(path)], [head])
        assert engine.wait(80) == JobStatus.SUCCEEDED
        np.testing.assert_array_equal(head, full[:32])

    def test_partial_store_upgraded_by_full_store(self, engine, tmp_path):
        path = str(tmp_path / "upgrade.bin")
        partial = np.full(16, 1, dtype=np.uint8)
        full = np.full(32, 2, dtype=np.uint8)
        for job_id, buffer in ((81, partial), (82, full), (83, partial)):
            engine.store(job_id, [path], [buffer], skip_existing=True)
            assert engine.wait(job_id) == JobStatus.SUCCEEDED
            with open(path, "rb") as handle:  # a partial never clobbers a full file
                assert handle.read() == (partial if job_id == 81 else full).tobytes()

    def test_closed_engine_raises(self, engine, tmp_path):
        engine.close()
        with pytest.raises(RuntimeError, match="closed"):
            engine.store(90, [str(tmp_path / "x.bin")], [np.zeros(8, dtype=np.uint8)])
        with pytest.raises(RuntimeError, match="closed"):
            engine.get_finished()
        engine.close()  # idempotent

    def test_wait_unknown_job(self, engine):
        assert engine.wait(999) == JobStatus.UNKNOWN

    def test_empty_job(self, engine):
        engine.store(60, [], [])
        assert engine.wait(60) in (JobStatus.SUCCEEDED, JobStatus.UNKNOWN)

    def test_in_flight_id_is_refused(self, engine, tmp_path):
        engine.load(61, [str(tmp_path / "missing.bin")], [np.zeros(8, dtype=np.uint8)])
        with pytest.raises(ValueError, match="still in flight"):
            engine.store(61, [str(tmp_path / "y.bin")], [np.zeros(8, dtype=np.uint8)])
        assert engine.wait(61) == JobStatus.FAILED

    def test_load_buffers_must_be_writeable_and_contiguous(self, engine, tmp_path):
        with pytest.raises(ValueError, match="contiguous"):
            engine.load(62, [str(tmp_path / "z.bin")], [np.zeros((4, 4), np.uint8)[:, ::2]])

    def test_large_fanout(self, engine, tmp_path):
        blocks = [np.full(1024, i % 256, dtype=np.uint8) for i in range(64)]
        paths = [str(tmp_path / f"fan_{i}.bin") for i in range(64)]
        engine.store(70, paths, blocks)
        assert engine.wait(70) == JobStatus.SUCCEEDED
        out = [np.zeros(1024, dtype=np.uint8) for _ in range(64)]
        engine.load(71, paths, out)
        assert engine.wait(71) == JobStatus.SUCCEEDED
        for i in range(64):
            np.testing.assert_array_equal(out[i], blocks[i])


def test_numa_node_does_not_crash(monkeypatch):
    monkeypatch.delenv("KVTPU_DISABLE_NATIVE", raising=False)
    engine_mod.OffloadEngine(n_threads=1, numa_node=0).close()


@pytest.mark.parametrize("skip_existing", [True, False])
def test_same_jobs_same_bytes_as_the_jax_engine(tmp_path, monkeypatch, skip_existing):
    """The port's native engine and the JAX package's write identical
    trees for the same jobs, and read each other's files."""
    monkeypatch.delenv("KVTPU_DISABLE_NATIVE", raising=False)
    rng = np.random.default_rng(11)
    buffers = [rng.integers(0, 2**16, size=(3, 2, 8, 4), dtype=np.uint16) for _ in range(6)]
    rel = [os.path.join(f"{i:03x}", f"{i:02x}", f"{i:016x}.bin") for i in range(6)]
    ours, theirs = engine_mod.OffloadEngine(2), JaxOffloadEngine(2)
    assert ours.is_native and theirs.is_native
    for eng, root in ((ours, "port"), (theirs, "jax")):
        eng.store(1, [str(tmp_path / root / r) for r in rel], buffers, skip_existing)
    assert ours.wait(1) == JobStatus.SUCCEEDED and theirs.wait(1) == JaxJobStatus.SUCCEEDED
    for r, buffer in zip(rel, buffers):
        port_bytes = (tmp_path / "port" / r).read_bytes()
        assert port_bytes == (tmp_path / "jax" / r).read_bytes() == buffer.tobytes()
    out = [np.zeros_like(b) for b in buffers]
    ours.load(2, [str(tmp_path / "jax" / r) for r in rel], out)
    assert ours.wait(2) == JobStatus.SUCCEEDED
    for got, want in zip(out, buffers):
        np.testing.assert_array_equal(got, want)
    ours.close()
    theirs.close()


def test_library_is_the_ports_own_build():
    lib = native.get_library()
    assert isinstance(lib, ctypes.CDLL)
    path = build_mod.lib_path()
    assert path.parent == build_mod.BUILD_DIR and path.exists()
    assert "llm_d_kv_cache_manager_tpu_torch" in str(path)
    handle = lib.kvtpu_engine_create(1, -1)
    assert handle
    lib.kvtpu_engine_destroy(handle)


@pytest.fixture
def scratch_build(tmp_path, monkeypatch):
    """Point the build at a copy of the sources and a fresh build dir,
    and forget any loaded library."""
    src = tmp_path / "src"
    src.mkdir()
    for name in build_mod.SOURCES + build_mod.HEADERS:
        (src / name).write_bytes((build_mod.SRC_DIR / name).read_bytes())
    monkeypatch.setattr(build_mod, "SRC_DIR", src)
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("KVTPU_DISABLE_NATIVE", raising=False)
    return src


def test_failed_build_raises_instead_of_the_python_engine(scratch_build):
    for name in build_mod.SOURCES:  # empty units compile at once
        (scratch_build / name).write_text("")
    (scratch_build / "engine.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="native build failed"):
        native.get_library()
    with pytest.raises(RuntimeError, match="native build failed"):
        engine_mod.OffloadEngine(n_threads=1)
    assert not list((scratch_build.parent / "build").glob("*.so*")), "a failed build left a file"


def test_missing_compiler_raises(scratch_build, monkeypatch):
    monkeypatch.setattr(build_mod.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.get_library()


def test_concurrent_builds_compile_once(scratch_build):
    """Builds racing on an empty build dir all get the one library
    (file lock + temp file renamed into place)."""
    (scratch_build / "hashing.cpp").write_text(
        (scratch_build / "hashing.cpp").read_text() + "\n// rebuilt\n")
    results, errors = [], []

    def run():
        try:
            results.append(build_mod.build())
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=run, name=f"build-{i}") for i in range(3)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(results)) == 1 and results[0].exists()
    built = sorted(p.name for p in (scratch_build.parent / "build").iterdir())
    assert built == sorted([results[0].name, "native.lock"])
    ctypes.CDLL(str(results[0])).kvtpu_engine_create  # loads


def test_forced_build_recompiles_an_up_to_date_library(scratch_build):
    """``build()`` leaves a built library alone; ``build(force=True)``
    compiles it again and renames the new file into place."""
    for name in build_mod.SOURCES:  # empty units compile at once
        (scratch_build / name).write_text("")
    lib = build_mod.build()
    first = os.stat(lib)
    assert build_mod.build() == lib and os.stat(lib).st_ino == first.st_ino
    assert build_mod.build(force=True) == lib
    assert os.stat(lib).st_ino != first.st_ino


def test_build_command_force_flag_rebuilds():
    """``python -m llm_d_kv_cache_manager_tpu_torch.native.build`` keeps
    an up-to-date library; with ``--force`` it builds a new one."""
    lib = build_mod.build()

    def command(*flags):
        out = subprocess.run(
            [sys.executable, "-m", f"{PACKAGE}.native.build", *flags], cwd=str(REPO),
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == f"built {lib}"
        return os.stat(lib).st_ino

    before = os.stat(lib).st_ino
    assert command() == before
    assert command("--force") != before
