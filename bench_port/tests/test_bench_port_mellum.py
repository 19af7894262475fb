"""The ``mellum`` family: its costs against numbers worked by hand at the
published widths, its reference loading nothing of the port, its
configuration file holding the catalog's keys, and a tiny Mellum cell
served on the CPU through the port's CPU paths and judged correct."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench_port import roofline, spec
from bench_port import run as bench_run
from bench_port.tests.test_bench_port_serving import CPU, correct, tiny_cell

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
PEAKS = roofline.PEAKS["H100 SXM"]
CONFIG = json.loads((HERE / "configs" / "mellum2-12b-a2.5b.json").read_text())
FAMILY = spec.family_of(CONFIG)

# Per layer: q and o (2304 x 4096 each), k and v (2304 x 512 each), the
# router (2304 x 64) and 8 experts of gate, up and down (3 x 2304 x 896).
PER_LAYER = 2 * 2304 * 4096 + 2 * 2304 * 512 + 2304 * 64 + 8 * 3 * 2304 * 896
PER_TOKEN = 2 * PER_LAYER * 28
HEAD = 2 * 2304 * 98304
QK_PV = 4 * 32 * 128  # attention FLOPs a (query, key) pair, all heads


def test_the_configuration_holds_the_published_widths():
    assert CONFIG["reduced"] == [] and CONFIG["family"] == "mellum"
    assert CONFIG["layer_types"].count("sliding_attention") == 21
    assert CONFIG["layer_types"][3::4] == ["full_attention"] * 7
    assert (CONFIG["hidden_size"], CONFIG["head_dim"], CONFIG["num_experts"],
            CONFIG["num_experts_per_tok"], CONFIG["moe_intermediate_size"]) == (
        2304, 128, 64, 8, 896)
    assert CONFIG["tie_word_embeddings"] is False
    assert len(CONFIG["assumed"]) == len(CONFIG["assumed_why"])


def test_costs_against_hand_worked_numbers():
    s = FAMILY.shape(CONFIG)
    assert (s.windowed, s.full, s.window) == (21, 7, 1024)
    assert s.matmul_flops_per_token == PER_TOKEN == 3_971_874_816
    assert s.head_flops == HEAD
    # Decode over rows of 100 and 5000 tokens: the full layers see every
    # key, the windowed ones min(ctx, 1024).
    want = 2 * (PER_TOKEN + HEAD) + QK_PV * (5100 * 7 + (100 + 1024) * 21)
    assert s.decode_flops([100, 5000]) == want == 9_821_356_032
    # A prefill of 3 tokens after 1022: positions 1023..1025 see 1023,
    # 1024 and 1024 keys in a windowed layer, 1023..1025 in a full one.
    assert FAMILY.window_pairs(3, 1022, 1024) == 1023 + 1024 + 1024
    assert s.prefill_flops(1022, 3) == (3 * PER_TOKEN + QK_PV * (3072 * 7 + 3071 * 21) + HEAD)
    # The decode bound: bytes of K and V (plus q and out) over 3.35 TB/s,
    # by kind.
    full = (2 * 5100 * 4 * 128 + 2 * 2 * 32 * 128) * 2
    windowed = (2 * 1124 * 4 * 128 + 2 * 2 * 32 * 128) * 2
    assert s.decode_attention_bound_s([100, 5000], None, PEAKS) == pytest.approx(
        (7 * full + 21 * windowed) / 3.35e12, rel=1e-12)
    # The expert kernel at a decode step of 24 rows: 192 routed rows and
    # 62 distinct experts' weights (12.4 MB each), bytes-bound.
    assert s.expert_bound_s(192, 62, PEAKS) == pytest.approx(62 * 3 * 2304 * 896 * 2 / 3.35e12)
    assert s.expected_experts(24) == pytest.approx(64 * (1 - (7 / 8) ** 24))


def test_a_prefill_bound_keeps_the_windowed_layers_keys():
    s = FAMILY.shape(CONFIG)
    full = roofline.prefill_attention(1, 8192, 8192, 32, 4, 128, 0).bound_s(PEAKS)
    windowed = max(QK_PV * FAMILY.window_pairs(8192, 0, 1024) / 989e12,
                   (2 * 8192 * 32 + 2 * 8192 * 4) * 128 * 2 / 3.35e12)
    assert s.prefill_attention_bound_s(0, 8192, PEAKS) == pytest.approx(7 * full + 21 * windowed)


def test_the_reference_alone_loads_nothing_of_the_port():
    probe = ("import sys, bench_port.reference.mellum; "
             "print(sorted({m.split('.')[0] for m in sys.modules} & "
             "{'llm_d_kv_cache_manager_tpu_torch', 'llm_d_kv_cache_manager_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


TINY = {
    "model_id": "tiny-mellum", "family": "mellum", "hidden_size": 64, "intermediate_size": 96,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
    "num_hidden_layers": 8, "layer_types": (["sliding_attention"] * 3 + ["full_attention"]) * 2,
    "sliding_window": 16, "num_experts": 16, "num_experts_per_tok": 4,
    "moe_intermediate_size": 32, "norm_topk_prob": True, "rms_norm_eps": 1e-6,
    "vocab_size": 512, "torch_dtype": "bfloat16",
    "rope_parameters": {
        "full_attention": {"rope_type": "yarn", "rope_theta": 500000, "factor": 4,
                           "original_max_position_embeddings": 32, "beta_fast": 32,
                           "beta_slow": 1, "attention_factor": 1.1386294361119891},
        "sliding_attention": {"rope_type": "default", "rope_theta": 500000}},
}


def test_a_tiny_mellum_cell_serves_correctly_on_the_cpu():
    """The closed loop's cell with a tiny Mellum block: every decode step
    past the window, bf16 through the port's CPU paths, judged against
    the float32 reference at the tiny cell's limit."""
    base = tiny_cell("closed")
    cell = dataclasses.replace(base, config=TINY, family=spec.family_of(TINY))
    run = bench_run.serve_cell(cell, 2**31 + 5, 0.75, False, CPU)
    compared = bench_run.checks(run, CPU)
    assert correct(compared), compared
    assert max(len(lv.req.prompt) + len(lv.tokens) for lv in run.win.carried) > 16
    rec = bench_run.record(run)
    assert rec["shape"].counters is None  # the CPU path keeps no device counters
    for name in ("expert_mlp_roofline.tokens", "expert_ms.tokens", "paged_decode_roofline.tokens"):
        assert spec.metric_reader(name).read(rec) is None  # no trace on the CPU
    assert not torch.equal(run.params["head"], run.params["embed"])  # untied


@pytest.mark.parametrize("prefill_in_slice", [False, True])
def test_the_expert_readers_count_the_decode_products_alone(prefill_in_slice):
    """A slice's grouped expert products over its decode steps, the same
    whether a prefill's route, grouping and combine fell in it or not;
    the roofline at the counters' mean rows and experts a call."""
    shape = FAMILY.shape(CONFIG)
    kernels = {"void moe_rows_kernel<__nv_bfloat16, true>(...)": 0.30,
               "void moe_rows_kernel<__nv_bfloat16, false>(...)": 0.15,
               "void moe_route_kernel<__nv_bfloat16>(...)": 0.02}
    if prefill_in_slice:
        kernels.update({"void moe_route_kernel<__nv_bfloat16>(...)": 0.05,
                        "void moe_combine_kernel<__nv_bfloat16>(...)": 0.01,
                        "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT": 0.4})
    steps = [SimpleNamespace(kind="decode", contexts=(16384,) * 24) for _ in range(20)]
    calls = steps + ([SimpleNamespace(kind="prefill")] if prefill_in_slice else [])
    shape = dataclasses.replace(shape, counters={"routed_rows": 192 * 28, "calls": 28,
                                                 "distinct_experts": 62 * 28,
                                                 "dropped_rows": 0})
    rec = {"slice_calls": calls, "trace": {"kernels": kernels}, "shape": shape,
           "peaks": PEAKS}
    assert spec.metric_reader("expert_ms.tokens").read(rec) == pytest.approx(1e3 * 0.45 / 20)
    bound = 20 * 28 * shape.expert_bound_s(192, 62, PEAKS)
    assert spec.metric_reader("expert_mlp_roofline.tokens").read(rec) == pytest.approx(
        100 * bound / 0.45)
