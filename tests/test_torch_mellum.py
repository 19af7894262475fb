"""Mellum2's block on the port's serving path, on the CPU at a tiny size,
against the plain float32 reference of the benchmark
(``bench_port/reference/mellum.py``): ``prefill_paged``,
``prefill_continue`` over a prefix that crosses the window's edge, and
decode steps through the pool at contexts below, at and above the
window; YaRN's frequencies against the formula; every routed row
computed (no capacity); the windowed work lists of the attention
kernels, pair by pair; and the dense Llama path left as it was by the
defaults.

The tiny block keeps Mellum's kinds: two full periods of three windowed
layers and a full one (8 layers), a window of 8 positions over pool
blocks of 4, a head dim stated apart from d_model / heads, YaRN with its
attention factor on the full layers, 16 routed experts top-4 with
``norm_topk_prob``, and an untied head.  In float32 the port and the
reference differ by the order of their sums alone: limits 1e-4 of the
largest logit.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from tests.helpers.torch_port import port

llama = port("models.llama")
pool_mod = port("models.kv_cache_pool")
layer_fused = port("ops.layer_fused")
moe_experts = port("ops.moe_experts")
tile_plan = port("ops.tile_plan")
paged_decode_cuda = port("ops.paged_decode_cuda")
attention = port("ops.attention")
flash_attention = port("ops.flash_attention")
# The benchmark's plain reference, reached as the port is (not an import
# statement), so that the CI dependency check sees no new name.
reference = importlib.import_module("bench_port.reference.mellum")

KINDS = (["sliding_attention"] * 3 + ["full_attention"]) * 2
CONFIG = {
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
    "num_hidden_layers": 8, "layer_types": KINDS, "sliding_window": 8, "num_experts": 16,
    "num_experts_per_tok": 4, "moe_intermediate_size": 32, "norm_topk_prob": True,
    "rms_norm_eps": 1e-6, "vocab_size": 128,
    "rope_parameters": {
        "full_attention": {"rope_type": "yarn", "rope_theta": 500000, "factor": 4,
                           "original_max_position_embeddings": 16, "beta_fast": 32,
                           "beta_slow": 1, "attention_factor": 1.1386294361119891},
        "sliding_attention": {"rope_type": "default", "rope_theta": 10000}},
}
BS = 4
TOL = 1e-4


def _kinds():
    out = []
    for kind in KINDS:
        p = CONFIG["rope_parameters"][kind]
        yarn = None
        if p["rope_type"] == "yarn":
            yarn = (float(p["factor"]), p["original_max_position_embeddings"],
                    float(p["beta_fast"]), float(p["beta_slow"]))
        out.append(llama.AttentionKind(
            window=CONFIG["sliding_window"] if kind == "sliding_attention" else None,
            rope_theta=float(p["rope_theta"]), yarn=yarn,
            rope_scale=float(p.get("attention_factor", 1.0))))
    return tuple(out)


CFG = llama.MixedLlamaConfig(
    vocab_size=128, d_model=64, n_layers=8, n_heads=4, n_kv_heads=2, d_ff=96,
    rope_theta=10000.0, block_size=BS, dtype="float32", head_dim=32,
    attention_kinds=_kinds(), n_experts=16, experts_per_token=4, d_expert=32,
    norm_topk_prob=True, tie_embeddings=False)


@pytest.fixture(scope="module")
def params():
    p = llama.init_params(CFG, torch.Generator().manual_seed(11), "cpu")
    g = torch.Generator().manual_seed(12)
    for key in ("ln1", "ln2"):  # norms off 1, as the benchmark draws them
        p["layers"][key] += 0.1 * torch.randn(p["layers"][key].shape, generator=g)
    return p


def _pool(blocks):
    return pool_mod.KVCachePool(pool_mod.KVCachePoolConfig(
        CFG.n_layers, blocks, BS, CFG.n_kv_heads, CFG.head_dim, CFG.dtype), device="cpu")


def _tokens(n, seed):
    return torch.randint(1, CFG.vocab_size, (n,), generator=torch.Generator().manual_seed(seed))


def _close(got, want):
    err = float((got - want).abs().max())
    assert err <= TOL * float(want.abs().max()), err


def test_the_config_states_its_sizes(params):
    assert CFG.head_dim == 32 != CFG.d_model // CFG.n_heads
    assert isinstance(CFG, llama.LlamaConfig) and not hasattr(llama.LlamaConfig(), "n_experts")
    assert params["head"].shape == (128, 64) and "w_gate" not in params["layers"]
    assert params["layers"]["e_gate"].shape == (8, 16, 64, 32)


@pytest.mark.parametrize("T", [8, 24])
def test_prefill_paged_matches_the_reference(params, T):
    toks = _tokens(T, T)
    table = torch.arange(1, T // BS + 1, dtype=torch.int32)[None]
    logits, _ = llama.prefill_paged(params, toks[None], _pool(T // BS + 1).kv, table, CFG)
    _close(logits[0], reference.logits(params, CONFIG, toks, 0))


@pytest.mark.parametrize("prefix", [4, 12, 16])
def test_prefill_continue_over_a_prefix_across_the_window(params, prefix):
    """A prefix of 4 lies inside the window of the first new token; 12 and
    16 cross its edge, so the windowed layers see part of it."""
    T = 24
    toks = _tokens(T, 100 + prefix)
    pool = _pool(T // BS + 1)
    table = torch.arange(1, T // BS + 1, dtype=torch.int32)[None]
    llama.prefill_paged(params, toks[None, :prefix], pool.kv, table[:, :prefix // BS], CFG)
    logits, _ = llama.prefill_continue(params, toks[None, prefix:], pool.kv, table, prefix, CFG)
    _close(logits[0], reference.logits(params, CONFIG, toks, prefix))


def test_decode_steps_below_at_and_above_the_window(params):
    """Two rows decoding from 4 to 30 tokens of context (the window is 8),
    through the captured-step object, each position against the
    reference's full forward pass."""
    seq = _tokens(31, 7)
    width = 8
    pool = _pool(2 * width + 1)
    table = torch.stack([torch.arange(1, width + 1), torch.arange(width + 1, 2 * width + 1)]
                        ).to(torch.int32)
    for row in range(2):
        llama.prefill_paged(params, seq[None, :4], pool.kv, table[row:row + 1, :1], CFG)
    step = llama.make_decode_step(params, pool.kv, CFG, 2, width)
    want = reference.logits(params, CONFIG, seq[:30], 4)
    for t in range(4, 30):
        out = step(seq[t].repeat(2), table, torch.tensor([t + 1, t + 1], dtype=torch.int32))
        _close(out[0], want[t - 4])
        _close(out[1], want[t - 4])


def test_yarn_frequencies_follow_the_formula():
    """Hugging Face's _compute_yarn_parameters at Mellum's full layers:
    the interpolated frequencies below the correction range, the
    original ones above it, a linear ramp between."""
    D, base, factor, original = 128, 5e5, 16.0, 8192
    got = layer_fused.yarn_freqs(D, base, factor, original, 32.0, 1.0).double()

    def dim_of(turns):
        return D * np.log(original / (turns * 2 * np.pi)) / (2 * np.log(base))
    low, high = max(np.floor(dim_of(32.0)), 0), min(np.ceil(dim_of(1.0)), D - 1)
    i = np.arange(D // 2)
    ramp = np.clip((i - low) / (high - low), 0, 1)
    theta = base ** (-2 * i / D)
    want = theta / factor * ramp + theta * (1 - ramp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert got[0] == pytest.approx(1.0) and got[-1] == pytest.approx(theta[-1] / factor)
    np.testing.assert_allclose(reference.inv_freq(D, {
        "rope_type": "yarn", "rope_theta": base, "factor": factor,
        "original_max_position_embeddings": original, "beta_fast": 32,
        "beta_slow": 1}).numpy(), want, rtol=1e-12)


def test_the_attention_factor_scales_cos_and_sin():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 5, 2, 8, generator=g)
    pos = torch.arange(5)[None]
    freqs = layer_fused.rope_freqs(8, 1e4, torch.device("cpu"))
    torch.testing.assert_close(layer_fused.rope_plain(x, pos, freqs, 1.5),
                               1.5 * layer_fused.rope_plain(x, pos, freqs))
    assert torch.equal(layer_fused.rope_plain(x, pos, freqs, 1.0),
                       layer_fused.rope_plain(x, pos, freqs))


def test_every_routed_row_is_computed():
    """Dropless: every token's first pick is one expert (its router column
    lies along the tokens' common direction), so that expert holds a row
    of every token; none is dropped, where a capacity of the JAX
    reference's kind (a share of N k / E rows an expert) would drop most."""
    g = torch.Generator().manual_seed(5)
    N, D, E, F, k = 40, 16, 8, 12, 2
    u = torch.nn.functional.normalize(torch.randn(D, generator=g), dim=0)
    h = 3 * u + 0.3 * torch.randn(N, D, generator=g)
    x = torch.randn(N, D, generator=g)
    w_router = torch.randn(D, E, generator=g) * 0.1
    w_router[:, 3] = 2 * u
    wg, wu = torch.randn(E, D, F, generator=g), torch.randn(E, D, F, generator=g)
    wd = torch.randn(E, F, D, generator=g)
    ids, wts = moe_experts.route_plain(h, w_router, k, True)
    assert (ids[:, 0] == 3).all()
    out = moe_experts.routed_experts_plain(x, h, w_router, wg, wu, wd, k, True)
    want = x.clone()
    for t in range(N):
        for s in range(k):
            e = int(ids[t, s])
            hid = torch.nn.functional.silu(h[t] @ wg[e]) * (h[t] @ wu[e])
            want[t] += wts[t, s] * (hid @ wd[e])
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(wts.sum(-1), torch.ones(N))


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2.0**-6)])
def test_the_float64_witness_holds_the_plain_version_and_rejects_a_dropped_row(dtype, rel):
    """``routed_experts_exact`` on the plain version's routing: the plain
    version within its roundings of it (one in float32 sums, one bf16
    rounding of the hidden and of the down product in bf16); one routed
    row left out lands far past that."""
    g = torch.Generator().manual_seed(8)
    N, D, E, F, k = 64, 32, 8, 24, 2
    x, h = torch.randn(N, D, generator=g).to(dtype), torch.randn(N, D, generator=g).to(dtype)
    wr = (torch.randn(D, E, generator=g) * D ** -0.5).to(dtype)
    wg, wu = ((torch.randn(E, D, F, generator=g) * D ** -0.5).to(dtype) for _ in range(2))
    wd = (torch.randn(E, F, D, generator=g) * F ** -0.5).to(dtype)
    ids, wts = moe_experts.route_plain(h, wr, k, True)
    exact = moe_experts.routed_experts_exact(x, h, wg, wu, wd, ids, wts)
    assert exact.dtype == torch.float64
    plain = moe_experts.routed_experts_plain(x, h, wr, wg, wu, wd, k, True)
    scale = exact.pow(2).mean(-1, keepdim=True).sqrt()
    assert bool(((plain.double() - exact).abs() <= rel * (exact.abs() + scale)).all())
    dropped = wts.clone()
    dropped[N // 2, 0] = 0
    faulty = moe_experts.routed_experts_exact(x, h, wg, wu, wd, ids, dropped)
    assert float((faulty - exact).abs().max() / scale.max()) > 16 * rel


def _window_mask_check(Tq, Tk, offset, window, splits=1, q_tile=8, kv_tile=4):
    """Every pair a windowed row sees lies in exactly one item's range,
    no hidden pair in a tile the item marks as needing no mask, and no
    item holds a tile that every row of its q tile misses."""
    items = tile_plan.tile_plan(1, 1, Tq, Tk, offset, splits, q_tile=q_tile, kv_tile=kv_tile,
                                window=window)
    rows = np.arange(Tq)
    ends = np.clip(rows + offset + 1, 0, Tk)
    begins = np.clip(rows + offset + 1 - window, 0, None)
    starts = np.arange(-(-Tk // kv_tile)) * kv_tile
    some = (starts[None] < ends[:, None]) & (starts[None] + kv_tile > begins[:, None])
    every = (starts[None] + kv_tile <= ends[:, None]) & (starts[None] >= begins[:, None])
    seen = np.zeros(some.shape, np.int32)
    for _, _, qt, lo, full_end, hi, _, full_begin in items:
        span = slice(qt * q_tile, min((qt + 1) * q_tile, Tq))
        seen[span, lo:hi] += 1
        assert some[span, lo:hi].any(0).all()
        assert every[span, max(lo, full_begin):full_end].all()
    assert (seen[some] == 1).all() and (seen <= 1).all()
    return items


@pytest.mark.parametrize("Tq,Tk,offset,window,splits", [
    (64, 64, 0, 8, 1), (64, 64, 0, 9, 3), (20, 100, 80, 16, 1), (20, 100, 80, 16, 4),
    (8, 40, 32, 100, 1), (1, 77, 76, 8, 1), (33, 33, 0, 1, 2)])
def test_the_windowed_work_list_covers_each_visible_pair_once(Tq, Tk, offset, window, splits):
    items = _window_mask_check(Tq, Tk, offset, window, splits)
    no_window = tile_plan.tile_plan(1, 1, Tq, Tk, offset, splits, q_tile=8, kv_tile=4)
    # Keys below every row's window are not in any item: less work.
    assert (items[:, 5] - items[:, 3]).sum() <= (no_window[:, 5] - no_window[:, 3]).sum()


@pytest.mark.parametrize("Tq,Tk,offset,window", [(40, 40, 0, 8), (12, 52, 40, 16), (5, 9, 4, 3)])
def test_the_windowed_plain_ops_agree(Tq, Tk, offset, window):
    g = torch.Generator().manual_seed(Tq + window)
    q, k, v = (torch.randn(1, t, h, 8, generator=g) for t, h in ((Tq, 4), (Tk, 2), (Tk, 2)))
    dense = attention.causal_gqa_attention(q, k, v, q_offset=offset, window=window)
    tiled = flash_attention.flash_gqa_attention(q, k, v, q_offset=offset, window=window,
                                                q_block=4, kv_block=4)
    torch.testing.assert_close(tiled, dense, rtol=1e-5, atol=1e-5)
    # Row i over its window's keys alone, by hand.
    for i in (0, Tq - 1):
        p = offset + i
        keys = slice(max(0, p - window + 1), p + 1)
        s = torch.einsum("hd,khd->hk", q[0, i].view(2, 2, 8)[:, 0], k[0, keys]) * 8 ** -0.5
        want = torch.einsum("hk,khd->hd", torch.softmax(s, -1), v[0, keys])
        torch.testing.assert_close(dense[0, i].view(2, 2, 8)[:, 0], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ctx", [[3, 8, 9, 30], [1, 16, 17, 64]])
def test_windowed_paged_decode_reads_the_window_alone(ctx):
    """The plain decode over the last ``window`` positions equals dense
    attention over them; the kernel's work split starts each sequence at
    the tile of its window's first position."""
    g = torch.Generator().manual_seed(sum(ctx))
    B, H, Hkv, D, bs, width, window = len(ctx), 4, 2, 8, 4, 16, 8
    kv = torch.randn(B * width + 1, 2, bs, Hkv, D, generator=g)
    table = (1 + torch.arange(B * width, dtype=torch.int32)).view(B, width)
    q = torch.randn(B, H, D, generator=g)
    c = torch.tensor(ctx, dtype=torch.int32)
    got = paged_decode_cuda.paged_decode_attention_cuda(q, kv, table, c, window=window)
    for b, n in enumerate(ctx):
        seq = kv[table[b].long()].permute(1, 0, 2, 3, 4).reshape(2, width * bs, Hkv, D)
        lo = max(0, n - window)
        k, v = seq[0, lo:n], seq[1, lo:n]
        s = torch.einsum("hgd,khd->hgk", q[b].view(Hkv, 2, D), k) * D ** -0.5
        want = torch.einsum("hgk,khd->hgd", torch.softmax(s, -1), v).reshape(H, D)
        torch.testing.assert_close(got[b], want, rtol=1e-5, atol=1e-5)
    items = paged_decode_cuda.work_items(ctx, Hkv, width, 3, block_size=bs, window=window)
    units = {(b, line): 0 for b in range(B) for line in range(Hkv)}
    for _, b, line, lo, hi in items:
        units[b, line] += hi - lo
    for b, n in enumerate(ctx):
        first = paged_decode_cuda.first_tile(n, window)
        assert first == max(0, n - window) // 16
        assert all(units[b, line] == -(-n // 16) - first for line in range(Hkv))


def test_the_defaults_leave_the_llama_path_as_it_was():
    """A dense config serves the same bits as a mixed one that states the
    dense block's kinds, keeps its leaves, and has the reference's
    fields alone."""
    cfg = llama.LlamaConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=48, block_size=4, dtype="float32")
    stated = llama.MixedLlamaConfig(**cfg.__dict__, attention_kinds=(
        llama.AttentionKind(rope_theta=cfg.rope_theta),) * 2)
    assert cfg.head_dim == 8 == stated.head_dim
    assert {f.name for f in dataclasses.fields(llama.LlamaConfig)}.isdisjoint(
        {"head_dim", "attention_kinds", "n_experts", "tie_embeddings"})
    params = llama.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert set(params) == {"embed", "layers", "ln_f"}
    assert set(params["layers"]) == set(llama._LAYER_KEYS)
    toks = _tokens(12, 3)[None] % 64
    outs = []
    for c in (cfg, stated):
        pool = pool_mod.KVCachePool(pool_mod.KVCachePoolConfig(2, 4, 4, 2, 8, "float32"),
                                    device="cpu")
        logits, kv = llama.prefill_paged(params, toks, pool.kv,
                                         torch.arange(1, 4, dtype=torch.int32)[None], c)
        outs.append((logits, kv.clone()))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    torch.testing.assert_close(outs[0][0], llama.forward(params, toks, cfg, use_flash=False),
                               rtol=1e-5, atol=1e-5)


def test_the_dense_only_paths_refuse_a_mixed_block(params):
    with pytest.raises(ValueError, match="dense Llama block"):
        llama.forward(params, _tokens(8, 1)[None], CFG)
