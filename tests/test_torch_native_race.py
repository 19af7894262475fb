"""The port's native-engine race detection: ``native/src/stress_main.cpp``
built by the port's ``native.build.build_stress`` over the port's own
header and engine sources (which differ from the JAX package's), run
plain and under ThreadSanitizer with ``halt_on_error=1``, as
``tests/test_native_race.py`` runs the reference's.  The binaries land
in the port's git-ignored ``build/`` folder, named by a hash of their
sources and flags."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from tests.helpers.torch_port import PACKAGE, port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no C++ compiler",
)


def _run(binary, tmp_path):
    env = dict(os.environ, TSAN_OPTIONS="halt_on_error=1", KVTPU_STRESS_DIR=str(tmp_path))
    return subprocess.run([str(binary)], env=env, capture_output=True, text=True, timeout=300)


def test_stress_plain(tmp_path):
    build = port("native.build")
    binary = build.build_stress(tsan=False)
    assert binary.parent == build.BUILD_DIR == build.SRC_DIR.parent.parent / "build"
    result = _run(binary, tmp_path)
    assert result.returncode == 0, result.stderr
    assert "stress ok: 804 jobs, 0 failures" in result.stdout


def test_stress_under_tsan(tmp_path):
    try:
        binary = port("native.build").build_stress(tsan=True)
    except RuntimeError as exc:  # toolchain without libtsan
        pytest.skip(f"tsan unavailable: {exc}")
    result = _run(binary, tmp_path)
    assert result.returncode == 0, f"ThreadSanitizer found a race:\n{result.stderr[-4000:]}"
    assert "stress ok: 804 jobs, 0 failures" in result.stdout


def test_stress_compiles_against_the_ports_header():
    """The harness's includes resolve inside the port's ``native/src``,
    and a changed engine source names another binary (so a stale one is
    never run)."""
    build = port("native.build")
    src = build.SRC_DIR
    assert src == pathlib.Path(REPO, PACKAGE, "native", "src")
    includes = [line.split('"')[1] for line in (src / build.STRESS_MAIN).read_text().splitlines()
                if line.startswith('#include "')]
    assert includes == ["kvtpu_native.hpp"]
    plain = build._target("stress", "", build.STRESS_FLAGS, build.SOURCES + (build.STRESS_MAIN,))
    tsan = build._target("stress_tsan", "", build.TSAN_FLAGS,
                         build.SOURCES + (build.STRESS_MAIN,))
    assert plain != tsan and plain.parent == tsan.parent == build.BUILD_DIR


def test_cli_runs_the_harness():
    """``python -m ...native.build --stress`` builds and runs it."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    result = subprocess.run(
        [sys.executable, "-m", f"{PACKAGE}.native.build", "--stress"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    assert "stress ok" in result.stdout
