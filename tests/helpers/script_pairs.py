"""Run a reference script and its PyTorch port's counterpart, and hold
their outputs to each other.

Each port script (``examples/*_torch.py``, ``hack/*_torch.py``) tells
the story of the reference script it ports.  :func:`run_pair` runs the
two in subprocesses on the CPU (``JAX_PLATFORMS=cpu``); the port's runs
with ``jax``, ``jaxlib`` and the JAX package blocked in ``sys.modules``,
so any import of them fails the script.  Both must exit 0 and print the
success line, and their result lines must be equal once :func:`masked`
has taken out what differs from run to run.

The mask, and nothing else:

* logging records (a ``YYYY-MM-DD HH:MM:SS,mmm LEVEL`` line and the
  traceback lines under it) are dropped from both streams;
* so are gRPC's C-core log records, which its absl logger writes to
  stderr on its own schedule (a ``GOAWAY`` after the success line, on
  either side, in some runs): the ``WARNING: All log messages before
  absl::InitializeLog() ...`` preamble and ``[IWEF]NNNN hh:mm:ss.uuuuuu
  <thread> file:line] ...`` lines;
* temp paths become ``<tmp>``;
* incident ids (``inc-YYYYMMDD-HHMMSS-NNNN``) become ``inc-<id>``;
* ``*_created`` metric samples (creation timestamps, which only
  ``prometheus_client`` writes) are dropped;
* measured rates (``N msgs/s``) become ``<rate> msgs/s``.

Scores, hit rates, shed counts, record counts, virtual-time divergence
points and score ladders are left as printed.
"""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys
import tempfile
from dataclasses import dataclass
from typing import List, Sequence

REPO = pathlib.Path(__file__).resolve().parents[2]
REFERENCE_PACKAGE = "llm_d_kv_cache_manager_tpu"
PORT_PACKAGE = "llm_d_kv_cache_manager_tpu_torch"
BLOCKED = ("jax", "jaxlib", REFERENCE_PACKAGE)

# Runs the script at argv[1] as __main__ with JAX and the JAX package
# made unimportable.
_GUARD = (
    "import runpy, sys\n"
    f"for name in {BLOCKED!r}:\n"
    "    sys.modules[name] = None\n"
    "path = sys.argv[1]\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(path, run_name='__main__')\n"
)

_RECORD = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} [A-Z]+ ")
_TRACEBACK_TAIL = re.compile(r"^(\s|Traceback |[\w.]+(Error|Exception|Exit)\b)")
_TEMP = re.compile(
    "(?:" + "|".join(sorted({re.escape(tempfile.gettempdir()), "/tmp"}, key=len,
                            reverse=True)) + r")/[^\s)'\",]*"
)
_INCIDENT = re.compile(r"\binc-\d{8}-\d{6}-\d{4}\b")
_CREATED = re.compile(r"^\s*kvtpu_\w+_created(\{[^}]*\})? ")
_ABSL_PREAMBLE = re.compile(r"^WARNING: All log messages before absl::InitializeLog\(\)")
_ABSL_RECORD = re.compile(r"^[IWEF]\d{4} \d\d:\d\d:\d+\.\d+ +\d+ [\w./-]+:\d+\] ")
_RATE = re.compile(r"\b\d+(\.\d+)? msgs/s\b")


@dataclass
class Run:
    script: str
    returncode: int
    stdout: str
    stderr: str

    def lines(self) -> List[str]:
        """Result lines: stdout's, then stderr's, each masked."""
        return masked(self.stdout) + masked(self.stderr)

    def report(self) -> str:
        return (f"{self.script} exited {self.returncode}\n--- stdout\n{self.stdout[-4000:]}"
                f"\n--- stderr\n{self.stderr[-4000:]}")


def masked(text: str) -> List[str]:
    """``text``'s lines with the module docstring's mask applied."""
    out, in_record = [], False
    for line in text.splitlines():
        if _RECORD.match(line):
            in_record = True
            continue
        if in_record and (not line or _TRACEBACK_TAIL.match(line)):
            continue
        in_record = False
        if _CREATED.match(line) or _ABSL_PREAMBLE.match(line) or _ABSL_RECORD.match(line):
            continue
        line = _TEMP.sub("<tmp>", line)
        line = _INCIDENT.sub("inc-<id>", line)
        line = _RATE.sub("<rate> msgs/s", line)
        out.append(line)
    return out


def _env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # One intra-op thread, as tests/helpers/torch_port.py gives each test
    # worker: the suite's other workers share the cores.
    env["OMP_NUM_THREADS"] = "1"
    # The suite's own XLA flags (8 host devices) are not the scripts'.
    env.pop("XLA_FLAGS", None)
    env.pop("PYTHONPATH", None)
    return env


def run_script(script: str, args: Sequence[str] = (), port: bool = False,
               timeout: float = 180.0) -> Run:
    """Run ``script`` (a path relative to the repo) in a subprocess."""
    path = str(REPO / script)
    cmd = ([sys.executable, "-c", _GUARD, path] if port else [sys.executable, path])
    out = subprocess.run(cmd + list(args), cwd=str(REPO), env=_env(), capture_output=True,
                         text=True, timeout=timeout)
    return Run(script, out.returncode, out.stdout, out.stderr)


def port_of(script: str) -> str:
    """``examples/offline_demo.py`` -> ``examples/offline_demo_torch.py``."""
    return script[: -len(".py")] + "_torch.py"


def run_pair(script: str, success: str, port_args: Sequence[str] = (),
             timeout: float = 180.0, reference_attempts: int = 1):
    """Run the reference ``script`` and then its port; both must exit 0
    with a line containing ``success``.  Returns both runs' result
    lines.  ``reference_attempts`` > 1 repeats a reference script with a
    known race of its own until it passes; the port's runs once."""
    for _ in range(reference_attempts):
        ref = run_script(script, timeout=timeout)
        if ref.returncode == 0:
            break
    assert ref.returncode == 0, ref.report()
    ours = run_script(port_of(script), port_args, port=True, timeout=timeout)
    assert ours.returncode == 0, ours.report()
    ref_lines, port_lines = ref.lines(), ours.lines()
    assert any(success in ln for ln in ref_lines), ref.report()
    assert any(success in ln for ln in port_lines), ours.report()
    return ref_lines, port_lines


def with_port_names(lines: Sequence[str], script: str) -> List[str]:
    """The reference's lines with its own names, the package's and the
    script's, replaced by the port's (a recipe printed by a script names
    both)."""
    name = pathlib.Path(script).name
    return [
        ln.replace(f"{REFERENCE_PACKAGE}.", f"{PORT_PACKAGE}.").replace(name, port_of(name))
        for ln in lines
    ]
