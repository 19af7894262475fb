"""The port's attention ops, and both kernel modules' plain versions,
against the JAX reference's ops and Pallas kernels (interpret mode).

Inputs come from a numpy seed and go to both packages.  Tolerance at
float32: atol = rtol = 1e-5 (sums in another order, nothing else)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.ops.attention import causal_gqa_attention as jax_dense
from llm_d_kv_cache_manager_tpu.ops.flash_attention import flash_gqa_attention as jax_flash
from llm_d_kv_cache_manager_tpu.ops.flash_pallas import flash_gqa_attention_pallas
from llm_d_kv_cache_manager_tpu.ops.paged_attention import paged_attention as jax_paged
from llm_d_kv_cache_manager_tpu.ops.paged_decode_pallas import (
    paged_decode_attention_pallas,
)
from tests.helpers.torch_port import port

attention = port("ops.attention")
flash_attention = port("ops.flash_attention")
paged_attention = port("ops.paged_attention")
flash_cuda = port("ops.flash_cuda")
paged_decode_cuda = port("ops.paged_decode_cuda")

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, B, Tq, Tk, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((B, Tq, H, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D))
    )


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "B,Tq,Tk,H,Hkv,D,q_offset,kv_len",
    [
        (2, 24, 24, 4, 2, 8, 0, None),
        (2, 8, 40, 4, 4, 8, 32, None),  # continuation
        (3, 12, 16, 6, 2, 4, 0, [16, 9, 3]),  # padded keys
        (1, 13, 19, 2, 1, 8, 6, None),  # odd lengths
    ],
)
def test_dense_matches_reference(B, Tq, Tk, H, Hkv, D, q_offset, kv_len):
    q, k, v = _qkv(0, B, Tq, Tk, H, Hkv, D)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = jax_dense(*_j(q, k, v), q_offset=q_offset,
                     kv_len=None if kl is None else jnp.asarray(kl))
    got = attention.causal_gqa_attention(
        *_t(q, k, v), q_offset=q_offset,
        kv_len=None if kl is None else torch.from_numpy(kl))
    _close(got, want)


@pytest.mark.parametrize(
    "B,Tq,Tk,H,Hkv,D,q_offset,kv_len,q_block,kv_block",
    [
        (2, 24, 24, 4, 2, 8, 0, None, 8, 8),
        (2, 24, 24, 4, 2, 8, 0, None, 16, 4),
        (2, 24, 24, 4, 2, 8, 0, None, 64, 64),
        (2, 8, 40, 4, 4, 8, 32, None, 4, 8),  # q_offset
        (3, 12, 16, 6, 2, 4, 0, [16, 9, 3], 4, 4),  # kv_len
        (1, 13, 19, 2, 1, 8, 0, None, 8, 8),  # non-divisible lengths
        (1, 13, 40, 2, 1, 8, 27, [30], 8, 16),  # all of them at once
    ],
)
def test_tiled_matches_reference(B, Tq, Tk, H, Hkv, D, q_offset, kv_len, q_block, kv_block):
    q, k, v = _qkv(1, B, Tq, Tk, H, Hkv, D)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    kw = dict(q_offset=q_offset, q_block=q_block, kv_block=kv_block)
    want = jax_flash(*_j(q, k, v), kv_len=None if kl is None else jnp.asarray(kl), **kw)
    got = flash_attention.flash_gqa_attention(
        *_t(q, k, v), kv_len=None if kl is None else torch.from_numpy(kl), **kw)
    _close(got, want)
    # ...and the tiled op equals the port's own dense op.
    dense = attention.causal_gqa_attention(
        *_t(q, k, v), q_offset=q_offset,
        kv_len=None if kl is None else torch.from_numpy(kl))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)


@pytest.mark.parametrize(
    "B,Tq,Tk,H,Hkv,D,q_offset,q_block",
    [
        (1, 64, 64, 4, 2, 32, 0, 256),  # square causal, GQA
        (2, 32, 160, 8, 4, 32, 128, 256),  # continuation
        (1, 40, 40, 2, 2, 64, 0, 32),  # padded rows (40 -> 64)
        (1, 16, 112, 4, 2, 32, 96, 8),  # Tk not a kv_chunk multiple
    ],
)
def test_prefill_plain_matches_pallas_kernel(B, Tq, Tk, H, Hkv, D, q_offset, q_block):
    """The prefill wrapper on CPU tensors (its plain version) against
    the TPU kernel run in interpret mode."""
    q, k, v = _qkv(2, B, Tq, Tk, H, Hkv, D)
    want = flash_gqa_attention_pallas(
        *_j(q, k, v), q_offset=q_offset, q_block=q_block, kv_chunk=64, interpret=True)
    got = flash_cuda.flash_gqa_attention_cuda(*_t(q, k, v), q_offset=q_offset)
    assert bool(torch.isfinite(got).all())
    _close(got, want)


def test_prefill_plain_keeps_bf16():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(3, 1, 16, 16, 2, 1, 8))
    out = flash_cuda.flash_gqa_attention_cuda(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


@pytest.mark.parametrize(
    "bad",
    [
        lambda q, k, v: (q[..., :4], k, v),  # head dim mismatch
        lambda q, k, v: (q[:, :, :3], k, v),  # H not a multiple of Hkv
        lambda q, k, v: (q, k, v[:, :5]),  # k/v disagree
        lambda q, k, v: (q.double(), k, v),  # mixed dtypes
    ],
)
def test_prefill_wrapper_rejects_bad_inputs(bad):
    q, k, v = _t(*_qkv(4, 1, 8, 8, 4, 2, 8))
    with pytest.raises(ValueError):
        flash_cuda.flash_gqa_attention_cuda(*bad(q, k, v))


@pytest.mark.parametrize(
    "ctas,kv_tiles,sms,splits",
    [(4224, 132, 132, 1), (128, 132, 132, 1), (8, 3, 132, 3), (2, 1, 132, 1), (66, 2, 132, 2)],
)
def test_prefill_split_plan_covers_the_keys(ctas, kv_tiles, sms, splits):
    """Work lists that fill the SMs stay unsplit; a small one is split
    so every key tile falls in exactly one split."""
    got, per_split = flash_cuda.split_plan(ctas, kv_tiles, sms)
    assert got == splits
    assert (got - 1) * per_split < kv_tiles <= got * per_split


def _paged_case(seed, B, H, Hkv, D, num_blocks, bs, max_blocks, ctx):
    """Unique shuffled pool blocks per sequence; pad slots hold block 0."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kv = rng.standard_normal((num_blocks, 2, bs, Hkv, D)).astype(np.float32)
    ids = rng.permutation(np.arange(1, num_blocks))
    table = np.zeros((B, max_blocks), np.int32)
    used = 0
    for b in range(B):
        n = -(-ctx[b] // bs)
        table[b, :n] = ids[used : used + n]
        used += n
    return q, kv, table, np.asarray(ctx, np.int32)


PAGED_CASES = [
    (1, 8, 4, 64, 8, [64]),  # exact block multiple
    (2, 8, 2, 64, 8, [61, 33]),  # ragged contexts
    (3, 4, 4, 128, 8, [16, 7, 128]),  # MHA, tiny and full contexts
    (2, 8, 4, 64, 7, [97, 1]),  # context of one token
]


@pytest.mark.parametrize("B,H,Hkv,D,max_blocks,ctx", PAGED_CASES)
def test_paged_attention_matches_reference(B, H, Hkv, D, max_blocks, ctx):
    q, kv, table, ctx_arr = _paged_case(5, B, H, Hkv, D, 64, 16, max_blocks, ctx)
    want = jax_paged(*_j(q, kv, table, ctx_arr))
    got = paged_attention.paged_attention(*_t(q, kv, table, ctx_arr))
    _close(got, want)


@pytest.mark.parametrize("B,H,Hkv,D,max_blocks,ctx", PAGED_CASES)
def test_decode_plain_matches_pallas_kernel(B, H, Hkv, D, max_blocks, ctx):
    """The decode wrapper on CPU tensors (its plain version) against the
    TPU kernel run in interpret mode."""
    q, kv, table, ctx_arr = _paged_case(6, B, H, Hkv, D, 64, 16, max_blocks, ctx)
    want = paged_decode_attention_pallas(*_j(q, kv, table, ctx_arr), interpret=True)
    got = paged_decode_cuda.paged_decode_attention_cuda(*_t(q, kv, table, ctx_arr))
    _close(got, want)


def test_decode_wrapper_rejects_bad_inputs():
    q, kv, table, ctx = _t(*_paged_case(7, 2, 8, 4, 64, 16, 16, 4, [20, 5]))
    with pytest.raises(ValueError):
        paged_decode_cuda.paged_decode_attention_cuda(q, kv, table[:1], ctx)
    with pytest.raises(ValueError):
        paged_decode_cuda.paged_decode_attention_cuda(q[:, :6], kv, table, ctx)
    with pytest.raises(ValueError):
        paged_decode_cuda.paged_decode_attention_cuda(q, kv, table, ctx[:1])


def _covered(items):
    """{(sequence, KV head, block): CTA} of a list of pieces; fails on a
    block that two pieces hold."""
    seen = {}
    for cta, b, kvh, first, end in items:
        assert first < end
        for j in range(first, end):
            assert (b, kvh, j) not in seen
            seen[b, kvh, j] = cta
    return seen


@pytest.mark.parametrize(
    "batch,kv_heads,max_blocks,sms",
    [(4, 8, 528, 132), (16, 8, 528, 132), (2, 8, 529, 132), (1, 1, 1, 132), (64, 8, 3, 132)],
)
def test_decode_split_plan_covers_the_table(batch, kv_heads, max_blocks, sms):
    """The grid is one wave of CTAs, or one CTA a block where the table
    has fewer; with every context as long as the table, every table
    column of every (sequence, KV head) falls in exactly one piece, and
    the runs differ by at most one rounding of the split."""
    for resident in (1, 3):
        ctas = paged_decode_cuda.split_plan(batch, kv_heads, max_blocks, sms, resident)
        assert ctas == min(sms * resident, batch * kv_heads * max_blocks)
        items = paged_decode_cuda.work_items([max_blocks * 16] * batch, kv_heads, max_blocks, ctas)
        seen = _covered(items)
        assert len(seen) == batch * kv_heads * max_blocks
        per = -(-len(seen) // ctas)
        load = [0] * ctas
        for cta in seen.values():
            load[cta] += 1
        assert max(load) == per and all(cta < ctas for cta in seen.values())


@pytest.mark.parametrize("seed", range(8))
def test_decode_work_items_cover_every_live_block(seed):
    """Random batches, lengths (0 and past the table included), table
    widths and grids: every block below ceil(ctx / 16) is in exactly one
    piece, no piece reaches past the live blocks or the table, a CTA's
    pieces are one contiguous run, and at most two of them (its first
    and its last) are not a whole (sequence, KV head)."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(40):
        batch = int(rng.integers(1, 9))
        kv_heads = int(rng.choice([1, 2, 4, 8]))
        max_blocks = int(rng.integers(1, 70))
        ctas = int(rng.integers(1, 3 * 132))
        ctx = [int(n) for n in rng.integers(0, max_blocks * 16 + 40, batch)]
        ctx[int(rng.integers(batch))] = int(rng.choice([0, 1, 16, 17, max_blocks * 16]))
        live = [min(-(-n // 16), max_blocks) for n in ctx]
        items = paged_decode_cuda.work_items(ctx, kv_heads, max_blocks, ctas)
        seen = _covered(items)
        assert set(seen) == {(b, h, j) for b in range(batch) for h in range(kv_heads)
                             for j in range(live[b])}
        per = -(-len(seen) // ctas) if seen else 0
        by_cta = {}
        for cta, b, kvh, first, end in items:
            assert 0 <= cta < ctas and end <= live[b] <= max_blocks
            by_cta.setdefault(cta, []).append((b, kvh, first, end))
        for cta, pieces in by_cta.items():
            assert sum(end - first for _, _, first, end in pieces) <= per
            partial = [i for i, (b, _, first, end) in enumerate(pieces)
                       if (first, end) != (0, live[b])]
            assert set(partial) <= {0, len(pieces) - 1}
            # Inside a run a piece starts where the one before it ended:
            # a later piece starts its pair, an earlier one ends its own.
            assert all(first == 0 for _, _, first, _ in pieces[1:])
            assert all(end == live[b] for b, _, _, end in pieces[:-1])
