"""The port's five demos (``examples/*_torch.py``) against the
reference's, on the CPU: both exit 0 with their success lines and print
equal result lines (``tests/helpers/script_pairs.py`` states the mask)."""

import pytest

from tests.helpers.script_pairs import masked, run_pair, with_port_names

SUCCESS = "completed successfully"


@pytest.mark.parametrize("demo", ["offline_demo", "index_service_demo", "valkey_demo"])
def test_demo_prints_the_references_scores(demo):
    """Scores after each step (the offline demo's ``{}``, 4.0 and 2.0;
    the gRPC service's pod scores; replica B's over the shared store)."""
    ref, ours = run_pair(f"examples/{demo}.py", SUCCESS)
    assert ours == ref


def test_online_demo_prints_the_references_scores_and_metrics():
    """Equal scores over HTTP; the metrics excerpt is the first four
    ``kvtpu_kvcache_index_lookup*`` samples, and two of the reference's
    four are ``_created`` timestamps the mask drops, so the port's four
    begin with the reference's other two."""
    ref, ours = run_pair("examples/online_demo.py", SUCCESS)
    cut = ref.index("metrics excerpt:") + 1
    assert ours[:cut] == ref[:cut]
    ref_excerpt, port_excerpt = ref[cut:-1], ours[cut:-1]
    assert [ln.split()[0] for ln in ref_excerpt] == [
        "kvtpu_kvcache_index_lookup_requests_total", "kvtpu_kvcache_index_lookup_hits_total"]
    assert len(port_excerpt) == 4
    assert port_excerpt[:len(ref_excerpt)] == ref_excerpt
    assert ours[-1] == ref[-1]


def test_vllm_demo_prints_the_recipe_with_the_ports_names():
    """Without vLLM both print the serving recipe; the port's names its
    own offload spec module and its own script."""
    ref, ours = run_pair("examples/vllm_demo.py", SUCCESS)
    assert any("llm_d_kv_cache_manager_tpu_torch.offload.vllm_spec" in ln for ln in ours)
    assert ours == with_port_names(ref, "examples/vllm_demo.py")


def test_the_mask_drops_grpc_core_log_records():
    """gRPC's C core logs through absl on its own schedule: a GOAWAY
    record after the success line, in some runs of either script.  The
    mask drops its preamble and its records, and leaves a result line
    that merely looks alike."""
    stderr = (
        "WARNING: All log messages before absl::InitializeLog() is called are written to "
        "STDERR\n"
        "I0000 00:00:1760759558.123456   48213 chttp2_transport.cc:1182] ipv6:%5B::1%5D:50051: "
        "Got goaway [2] err=UNAVAILABLE:GOAWAY received\n"
        "E1018 04:12:33.000123 77 server.cc:12] shutting down\n"
        "I0000 pod scores: {'pod-a': 2.0}\n"
    )
    assert masked(stderr) == ["I0000 pod scores: {'pod-a': 2.0}"]
    assert masked(f"{SUCCESS}\n" + stderr) == [SUCCESS, "I0000 pod scores: {'pod-a': 2.0}"]
