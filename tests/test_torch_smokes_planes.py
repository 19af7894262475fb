"""The port's what-if and profiling smokes against the reference's, on
the CPU: both exit 0 with their success lines and print equal result
lines (``tests/helpers/script_pairs.py`` states the mask)."""

from tests.helpers.script_pairs import run_pair


def test_whatif_smoke_prints_the_references_counts():
    """Record counts, the A/B hit rate, the flow-control sheds and the
    first divergence in virtual time, the incident's files, the ring's
    results and both gates' verdicts, line for line."""
    ref, ours = run_pair("hack/whatif_smoke.py", "whatif smoke completed successfully")
    assert ours == ref
    assert any("hit_rate 0.7526" in ln for ln in ours)
    assert any("shed 244, first divergence at virtual 2.910074s" in ln for ln in ours)


def test_profile_smoke_prints_what_the_reference_prints():
    ref, ours = run_pair("hack/profile_smoke.py", "profiling smoke completed successfully")
    assert ours == ref
