"""The kernels that serve Mellum2's block on a CUDA card, against their
plain versions there: the prefill and decode attention kernels with a
sliding window, the routed-expert MLP (grouped, by products above
``GROUPED_MAX_ROWS`` routed rows, and grouped again under graph capture
at any size), and the RoPE kernel with YaRN frequencies and a cos/sin
scale.

Marked ``cuda``: each test skips without a card (decided in the ``card``
fixture, never at import).  On the card:
``python -m pytest --noconftest -q -m cuda tests/test_torch_mellum_cuda.py``.
Imports nothing of JAX.

Limits: attention as chip_smoke's LIMITS (prefill 2^-6 |ref| + 2^-6
rms(row); decode 2^-6 |ref| + 2^-10 rms(row); float32 2^-14 both); the
experts 2^-6 |ref| + 2^-9 rms(row) in bf16, 1e-5 in float32, against the
plain version and, beside it, against the float64 value of the same
routing (``routed_experts_exact``): within it, or no more than 1.25
times as far past it as the plain version, which rounds the same hidden
elements once from float32 sums of another order; RoPE bit for bit.
"""

import importlib

import pytest
import torch


def port(name):
    # Not tests.helpers: a machine with a card may have another package
    # named ``tests`` on its path.
    return importlib.import_module("llm_d_kv_cache_manager_tpu_torch." + name)


fc = port("ops.flash_cuda")
pc = port("ops.paged_decode_cuda")
lf = port("ops.layer_fused")
moe = port("ops.moe_experts")

pytestmark = pytest.mark.cuda

LIMITS = {("prefill", torch.bfloat16): (2.0**-6, 2.0**-6),
          ("decode", torch.bfloat16): (2.0**-6, 2.0**-10),
          ("moe", torch.bfloat16): (2.0**-6, 2.0**-9),
          ("prefill", torch.float32): (2.0**-14, 2.0**-14),
          ("decode", torch.float32): (2.0**-14, 2.0**-14),
          ("moe", torch.float32): (1e-5, 1e-5)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels of csrc/ run only there")
    return torch.device("cuda")


def _worst(got, ref, what):
    """The largest |got - ref| over its element's limit."""
    rel, floor = LIMITS[what]
    ref = ref.double()
    limit = rel * ref.abs() + floor * ref.pow(2).mean(-1, keepdim=True).sqrt()
    return float(((got.double() - ref).abs() / limit).max())


def _within(got, ref, what):
    assert _worst(got, ref, what) <= 1.0, float((got.float() - ref.float()).abs().max())


def _experts_case(card, dtype, N, D=256, E=16, F=96, k=4):
    g = torch.Generator(device=card).manual_seed(N)

    def rnd(*shape, scale):
        return (scale * torch.randn(*shape, generator=g, device=card)).to(dtype)
    return (rnd(N, D, scale=1.0), rnd(N, D, scale=1.0), rnd(D, E, scale=D ** -0.5),
            rnd(E, D, F, scale=D ** -0.5), rnd(E, D, F, scale=D ** -0.5),
            rnd(E, F, D, scale=F ** -0.5), k)


def _experts_held(got, args, dtype):
    """``got`` within the limit of the plain version, and against the
    float64 value of the kernels' own routing within the limit or no
    farther past it than 1.25 times the plain version."""
    x, h, wr, wg, wu, wd, k = args
    ids, wts = moe.moe_route_cuda(h, wr, k, True)
    exact = moe.routed_experts_exact(x, h, wg, wu, wd, ids, wts)
    plain = moe.routed_experts_plain(x, h, wr, wg, wu, wd, k, True)
    _within(got, plain, ("moe", dtype))
    worst = _worst(got, exact, ("moe", dtype))
    assert worst <= max(1.0, 1.25 * _worst(plain, exact, ("moe", dtype))), worst


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Tq,Tk,off,window", [
    (1024, 1024, 0, 128), (300, 300, 0, 100), (64, 2112, 2048, 1024), (256, 4096, 3840, 1024),
    (129, 129, 0, 1), (17, 500, 483, 2000)])
def test_windowed_prefill_kernel_matches_plain(card, dtype, Tq, Tk, off, window):
    g = torch.Generator(device=card).manual_seed(Tq + window)
    q = torch.randn(1, Tq, 8, 128, generator=g, device=card).to(dtype)
    k, v = (torch.randn(1, Tk, 2, 128, generator=g, device=card).to(dtype) for _ in range(2))
    got = fc.flash_gqa_attention_cuda(q, k, v, q_offset=off, window=window)
    _within(got, fc.flash_gqa_attention_plain(q, k, v, q_offset=off, window=window),
            ("prefill", dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("ctx", [[1, 15, 16, 17, 300], [1024, 1025, 1040, 3000, 77]])
def test_windowed_decode_kernel_matches_plain(card, dtype, bs, ctx):
    g = torch.Generator(device=card).manual_seed(bs + len(ctx) + ctx[-1])
    B, width, window = len(ctx), -(-3000 // bs), 1024
    kv = torch.randn(B * width + 1, 2, bs, 4, 128, generator=g, device=card).to(dtype)
    table = (1 + torch.arange(B * width, device=card, dtype=torch.int32)).view(B, width)
    q = torch.randn(B, 32, 128, generator=g, device=card).to(dtype)
    c = torch.tensor(ctx, dtype=torch.int32, device=card)
    got = pc.paged_decode_attention_cuda(q, kv, table, c, window=window)
    _within(got, pc.paged_decode_attention_plain(q, kv, table, c, window=window),
            ("decode", dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N", [1, 3, 24, 200, 300, 1000])
def test_routed_experts_kernels_match_plain(card, dtype, N):
    """Up to 256 tokens (1024 routed rows at top 4) the grouped kernels;
    300 and 1000 tokens (1200 and 4000 rows) the per-expert products."""
    args = _experts_case(card, dtype, N)
    x, h, wr, wg, wu, wd, k = args
    counts = torch.zeros(4, dtype=torch.int64, device=card)
    launches = moe.moe_experts_cuda.launches
    got = moe.routed_experts_fused(x, h, wr, wg, wu, wd, k, True, counts)
    assert moe.moe_experts_cuda.launches - launches == (N * k <= moe.GROUPED_MAX_ROWS)
    ids, _ = moe.moe_route_cuda(h, wr, k, True)
    want_ids, _ = moe.route_plain(h, wr, k, True)
    assert torch.equal(ids.sort(-1).values, want_ids.sort(-1).values)
    _experts_held(got, args, dtype)
    routed, distinct, dropped, calls = counts.tolist()
    assert (routed, dropped, calls) == (N * k, 0, 1)
    assert distinct == len(torch.unique(ids))


def test_routed_experts_under_capture_take_the_grouped_kernels_at_any_size(card):
    """1200 routed rows captured in a CUDA graph: the products path would
    wait on the host for the offsets, which capture cannot; the grouped
    kernels run instead, and the replay holds to the same witness."""
    args = _experts_case(card, torch.bfloat16, 300)
    x, h, wr, wg, wu, wd, k = args
    out = moe.routed_experts_fused(*args[:6], k, True)  # builds, outside the capture
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    graph = torch.cuda.CUDAGraph()
    launches = moe.moe_experts_cuda.launches
    with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
        out = moe.routed_experts_fused(*args[:6], k, True)
    torch.cuda.current_stream(card).wait_stream(side)
    assert moe.moe_experts_cuda.launches - launches == 1
    graph.replay()
    torch.cuda.synchronize(card)
    _experts_held(out, args, torch.bfloat16)


def test_rope_kernel_with_yarn_and_a_scale_is_plain_bit_for_bit(card):
    g = torch.Generator(device=card).manual_seed(9)
    T, H, Hkv, D = 300, 32, 4, 128
    q, k, v = (torch.randn(1, T, n, D, generator=g, device=card).to(torch.bfloat16)
               for n in (H, Hkv, Hkv))
    pools = [torch.zeros(T // 16 + 2, 2, 16, Hkv, D, dtype=torch.bfloat16, device=card)
             for _ in range(2)]
    slots = (16 + torch.arange(T, device=card))[None]
    pos = (9000 + torch.arange(T, device=card))[None]
    freqs = lf.yarn_freqs(D, 5e5, 16.0, 8192, 32.0, 1.0).to(card)
    got = lf.rope_kv_fused(q, k, v, pos, freqs, pools[0], slots, scale=1.2772588722239782)
    want = lf.rope_kv_plain(q, k, v, pos, freqs, pools[1], slots, scale=1.2772588722239782)
    assert torch.equal(got, want) and torch.equal(pools[0], pools[1])
