"""The bounds of the port's kernel table, rebuilt from shapes alone, and
the model-FLOP count both ``mfu`` metrics share (the llama family's)."""

import pytest

from bench_port import roofline, spec

PEAKS = roofline.PEAKS["H100 SXM"]


def test_causal_pairs_closed_form_matches_the_sum():
    for tq, tk, off in [(1, 1, 0), (7, 7, 0), (5, 12, 7), (8, 8, 3), (16, 40, 24), (3, 2, 0)]:
        want = sum(min(off + i + 1, tk) for i in range(tq))
        assert roofline.causal_pairs(tq, tk, off) == want


def test_prefill_bound_of_the_table():
    # Kernel table: full prefill, Tq = Tk = 8448, H 32, Hkv 8, D 128: 0.591 ms (ops).
    cost = roofline.prefill_attention(1, 8448, 8448, 32, 8, 128, 0)
    assert cost.flops / PEAKS["bf16_flops"] > cost.bytes / PEAKS["hbm_bytes"]
    assert round(cost.bound_s(PEAKS) * 1e3, 3) == 0.591


def test_decode_bound_of_the_table():
    # B = 2, ctx 8456, H 32, Hkv 8, D 128: 0.0207 ms (bytes).
    cost = roofline.paged_decode([8456, 8456], 32, 8, 128)
    assert cost.bytes / PEAKS["hbm_bytes"] > cost.flops / PEAKS["bf16_flops"]
    assert round(cost.bound_s(PEAKS) * 1e3, 4) == 0.0207


def test_ring_partial_bound_of_the_table():
    # Tq = Tk = 2048, H 32, Hkv 8, D 128, causal offset 0: 0.0348 ms (ops).
    cost = roofline.ring_partial(1, 2048, 2048, 32, 8, 128, 0)
    assert round(cost.bound_s(PEAKS) * 1e3, 4) == 0.0348
    assert roofline.visible_pairs(2048, 2048, 0) == roofline.causal_pairs(2048, 2048, 0)


def test_continuation_counts_only_the_new_rows():
    whole = roofline.prefill_attention(1, 8448, 8448, 32, 8, 128, 0)
    cont = roofline.prefill_attention(1, 256, 8448, 32, 8, 128, 8192)
    assert cont.flops == 4 * 128 * 32 * sum(8192 + i + 1 for i in range(256))
    assert cont.flops < whole.flops


MISTRAL = spec.family("llama").Shape(d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                                     head_dim=128, d_ff=14336, vocab=32768)


def test_model_flops():
    # 2 x the layer weights a token multiplies through: 6.98 B of 7.25 B parameters.
    assert MISTRAL.matmul_flops_per_token == pytest.approx(2 * 32 * 218103808)
    one = MISTRAL.prefill_flops(0, 1)
    assert one == MISTRAL.matmul_flops_per_token + MISTRAL.attention_flops(1) + MISTRAL.head_flops
    # A continuation costs its rows' matmuls and their attention over the prefix.
    cont = MISTRAL.prefill_flops(100, 16)
    assert cont == pytest.approx(16 * MISTRAL.matmul_flops_per_token
                                 + MISTRAL.attention_flops(sum(101 + i for i in range(16)))
                                 + MISTRAL.head_flops)
    step = MISTRAL.decode_flops((10, 20))
    assert step == pytest.approx(2 * (MISTRAL.matmul_flops_per_token + MISTRAL.head_flops)
                                 + MISTRAL.attention_flops(30))


def test_peaks_by_card_name():
    assert roofline.peaks_for("NVIDIA H100 80GB HBM3") is roofline.PEAKS["H100 SXM"]
    with pytest.raises(ValueError):
        roofline.peaks_for("NVIDIA A100-SXM4-80GB")
