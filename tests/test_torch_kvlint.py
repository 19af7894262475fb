"""The port passes the reference's static-analysis gate.

``python -m hack.kvlint llm_d_kv_cache_manager_tpu_torch`` runs the same
rules over the port's sources that ``tests/test_kvlint.py`` runs over the
reference's (lock guards, check-then-act, GIL-dependent writes, env knobs
and their docs): it must exit 0 with nothing on stdout, as
``TestCLIContract::test_clean_tree_exits_zero`` asks of the reference."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The whole run takes about 10 s on one core.
LIMIT_S = 240


def test_the_ports_tree_exits_zero():
    proc = subprocess.run([sys.executable, "-m", "hack.kvlint", "llm_d_kv_cache_manager_tpu_torch"],
                          cwd=REPO, capture_output=True, text=True, timeout=LIMIT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout == ""
