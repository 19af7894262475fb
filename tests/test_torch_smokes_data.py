"""The port's data-plane smokes (the event plane, cache analytics,
tiering, transfer, host offload) against the reference's, on the CPU:
both exit 0 with their success lines and print equal result lines
(``tests/helpers/script_pairs.py`` states the mask)."""

import pytest

from tests.helpers.script_pairs import run_pair, run_script

SMOKES = {
    "hack/events_smoke.py": "events smoke ok: 64 pods",
    "hack/cachestats_smoke.py": "cachestats smoke completed successfully",
    "hack/tiering_smoke.py": "tiering smoke completed successfully",
    "hack/transfer_smoke.py": "transfer smoke completed successfully",
}
OFFLOAD_LADDER = [
    "store -> evict -> load round trip: bytes bit-identical",
    "demotion hbm -> host: bytes in host tier, score 1.0 -> 0.8",
    "demotion host -> shared_storage: bytes on disk, score 0.8 -> 0.5",
    "offload smoke completed successfully",
]


# hack/events_smoke.py's wait for its forced gap's resync can end before
# the poller has seen that gap, when resyncs of pods the flood gapped have
# already cleared every suspect; its checks then fail (ROADMAP.md Queue C,
# not port faults).  The port's copy waits for that gap.  The reference's
# run is repeated until it passes; the port's runs once.
REFERENCE_ATTEMPTS = {"hack/events_smoke.py": 5}


@pytest.mark.parametrize("script", list(SMOKES))
def test_smoke_prints_what_the_reference_prints(script):
    ref, ours = run_pair(script, SMOKES[script],
                         reference_attempts=REFERENCE_ATTEMPTS.get(script, 1))
    assert ours == ref


@pytest.mark.parametrize("geometry", ["tiny", "llama3_8b"])
def test_offload_smoke_prints_the_references_ladder(geometry):
    """The round trip bit-identical and the score ladder 1.0 -> 0.8 ->
    0.5 a block, on a CPU pool at the reference's geometry and at
    Llama-3-8B's KV geometry."""
    ref, ours = run_pair("hack/offload_smoke.py", "offload smoke completed successfully",
                         port_args=["--device", "cpu", "--geometry", geometry])
    assert ref == OFFLOAD_LADDER
    assert ours == ref


def test_offload_smoke_wants_a_card_unless_told_cpu():
    """``--device`` defaults to ``cuda``; without a card the smoke raises
    before it starts anything, and prints no step."""
    run = run_script("hack/offload_smoke_torch.py", port=True, timeout=120)
    assert run.returncode != 0
    assert "torch.cuda.is_available() is False" in run.stderr
    assert run.stdout == ""
