"""The port's service smokes (``hack/*_torch.py``: the tracing debug
surface, the cluster, the SLO plane, incident capture and replay)
against the reference's, on the CPU: both exit 0 with their success
lines and print equal result lines (``tests/helpers/script_pairs.py``
states the mask)."""

import pytest

from tests.helpers.script_pairs import run_pair

SMOKES = {
    "hack/verify_observability.py": "observability smoke completed successfully",
    "hack/cluster_smoke.py": "cluster smoke completed successfully",
    "hack/slo_smoke.py": "slo smoke completed successfully",
    "hack/replay_smoke.py": "replay smoke completed successfully",
}


@pytest.mark.parametrize("script", list(SMOKES))
def test_smoke_prints_what_the_reference_prints(script):
    ref, ours = run_pair(script, SMOKES[script])
    assert ours == ref
