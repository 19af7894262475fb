"""The kernels' shapes beyond Llama-3-8B's, on the CPU: every head dim
that is a multiple of 16 from 32 to 256, any group H / Hkv (1 to 16 for
decode) and pool blocks of 8 to 128 tokens, as the reference's Pallas
kernels take them.

The three wrappers' plain versions (what a CPU tensor runs) against the
Pallas kernels in interpret mode at those shapes; the decode kernel's
host mirror of its work split (``work_items``, ``split_plan``,
``head_split``) at every block size; the wrappers'
shape guard against the stated set; and the Llama serving path (prefill,
continuation, decode steps) against the reference at blocks of 8 and 64,
head dims 32 and 96, a group of 3.

Inputs come from a numpy seed and go to both packages.  Tolerances:
float32 ops atol = rtol = 1e-5 (sums in another order, nothing else);
model logits 2e-4, the reference suite's own; pools 1e-4, where that
suite holds 1e-5 at a model width of 64: here the width is 192 to 576,
and its float32 projections, summed in another order, differ by up to
1.2e-5 (two elements of 294,912 at width 576)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from llm_d_kv_cache_manager_tpu.ops import ring_flash_pallas as jax_partial
from llm_d_kv_cache_manager_tpu.ops.flash_pallas import flash_gqa_attention_pallas
from llm_d_kv_cache_manager_tpu.ops.paged_decode_pallas import (
    paged_decode_attention_pallas,
)
from tests.helpers.torch_port import port

flash_cuda = port("ops.flash_cuda")
ring_flash_cuda = port("ops.ring_flash_cuda")
paged_decode_cuda = port("ops.paged_decode_cuda")
tile_plan = port("ops.tile_plan")
llama = port("models.llama")

TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=2e-4, atol=2e-4)
POOL = dict(rtol=1e-4, atol=1e-4)
SET = tuple(range(32, 257, 16))


def _qkv(seed, B, Tq, Tk, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, Tq, H, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D)))


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# ------------------------------------------------------------------ prefill


@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,D,q_offset", [
    (1, 24, 24, 6, 2, 32, 0),
    (1, 16, 40, 10, 2, 48, 24),  # group 5, continuation
    (2, 16, 16, 3, 1, 80, 0),  # group 3
    (1, 12, 28, 16, 1, 96, 16),  # group 16
    (1, 16, 16, 5, 5, 112, 0),
    (1, 8, 24, 4, 2, 144, 16),
    (1, 16, 16, 2, 1, 256, 0),
])
def test_prefill_plain_matches_pallas_at_every_width(B, Tq, Tk, H, Hkv, D, q_offset):
    """The prefill wrapper on CPU tensors against the TPU kernel, which
    tiles by the whole head dim, in interpret mode."""
    q, k, v = _qkv(D + H, B, Tq, Tk, H, Hkv, D)
    want = flash_gqa_attention_pallas(*_j(q, k, v), q_offset=q_offset, q_block=8, kv_chunk=16,
                                      interpret=True)
    got = flash_cuda.flash_gqa_attention_cuda(*_t(q, k, v), q_offset=q_offset)
    _close(got, want)


# ------------------------------------------------------------------ partial


@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,D,off", [
    (1, 16, 16, 6, 2, 32, 0),
    (1, 12, 20, 9, 3, 80, None),  # group 3
    (1, 16, 16, 16, 1, 144, -1),  # group 16
    (1, 8, 24, 4, 2, 256, 0),
])
def test_partial_plain_matches_pallas_at_every_width(B, Tq, Tk, H, Hkv, D, off):
    """acc, m and l of the partial wrapper on CPU tensors against the TPU
    kernel in interpret mode."""
    q, k, v = _qkv(D + Tk, B, Tq, Tk, H, Hkv, D)
    want = jax_partial.flash_partial(*_j(q, k, v), causal_offset=off, q_block=8, kv_chunk=8,
                                     interpret=True)
    got = ring_flash_cuda.flash_partial_cuda(*_t(q, k, v), causal_offset=off)
    for g, w in zip(got, want):
        _close(g, w)


# ------------------------------------------------------------------- decode


def _paged_case(seed, B, H, Hkv, D, bs, max_blocks, ctx):
    """Unique shuffled pool blocks per sequence; pad slots hold block 0."""
    rng = np.random.default_rng(seed)
    num_blocks = B * max_blocks + 1
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kv = rng.standard_normal((num_blocks, 2, bs, Hkv, D)).astype(np.float32)
    ids = rng.permutation(np.arange(1, num_blocks))
    table = np.zeros((B, max_blocks), np.int32)
    used = 0
    for b in range(B):
        n = -(-ctx[b] // bs)
        table[b, :n] = ids[used: used + n]
        used += n
    return q, kv, table, np.asarray(ctx, np.int32)


@pytest.mark.parametrize("B,H,Hkv,D,bs,max_blocks,ctx", [
    (2, 6, 2, 32, 8, 12, [90, 17]),  # group 3, blocks of 8
    (2, 5, 1, 96, 16, 6, [80, 33]),  # group 5
    (1, 16, 1, 48, 32, 4, [100]),  # group 16
    (2, 8, 8, 256, 64, 2, [128, 63]),  # ends on and inside a block
    (1, 14, 2, 112, 128, 1, [127]),  # group 7
])
def test_decode_plain_matches_pallas_at_every_shape(B, H, Hkv, D, bs, max_blocks, ctx):
    """The decode wrapper on CPU tensors against the TPU kernel, which
    reads block_size and the group from the shapes, in interpret mode."""
    q, kv, table, ctx_arr = _paged_case(D + bs, B, H, Hkv, D, bs, max_blocks, ctx)
    want = paged_decode_attention_pallas(*_j(q, kv, table, ctx_arr), interpret=True,
                                         blocks_per_step=2)
    got = paged_decode_cuda.paged_decode_attention_cuda(*_t(q, kv, table, ctx_arr))
    _close(got, want)


def _tokens_of(items, context_len, max_blocks, bs):
    """{(sequence, line, token): CTA} of a list of pieces, each token
    of each of a piece's 16-token tiles below the sequence's readable
    context; fails on a token that two pieces hold."""
    seen = {}
    for cta, b, line, first, end in items:
        assert first < end
        ctx = min(context_len[b], max_blocks * bs)
        for j in range(first, end):
            for tok in range(16 * j, min(16 * j + 16, ctx)):
                assert (b, line, tok) not in seen
                seen[b, line, tok] = cta
    return seen


def _tile_blocks(tile, context_len, block_size):
    """The table columns (pool blocks) key tile ``tile`` of a sequence
    reads in csrc/paged_decode.cu (``ids`` in ``piece``): one, or two
    at block size 8 when its second half holds a live token."""
    first = tile * 16
    blocks = [first // block_size]
    if block_size < 16 and first + 8 < context_len:
        blocks.append((first + 8) // block_size)
    return blocks


@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("seed", range(3))
def test_decode_work_items_cover_every_live_token_once(bs, seed):
    """At every block size: the pieces cover each live token of each
    (sequence, line) exactly once (lengths 0, past the table, mid-block
    and on a block's last token included), a CTA's run is at most
    ``per`` tiles, and the table columns a tile reads (``_tile_blocks``,
    the kernel's ``ids``) are all below ceil(context / block_size) and
    cover every one."""
    rng = np.random.default_rng(300 + seed)
    for _ in range(25):
        batch = int(rng.integers(1, 7))
        lines = int(rng.choice([1, 2, 4, 8, 16]))
        max_blocks = int(rng.integers(1, 40))
        ctas = int(rng.integers(1, 2 * 132))
        cap = max_blocks * bs
        ctx = [int(n) for n in rng.integers(0, cap + 40, batch)]
        ctx[int(rng.integers(batch))] = int(rng.choice([0, 1, bs - 1, bs, bs + 1, cap]))
        items = paged_decode_cuda.work_items(ctx, lines, max_blocks, ctas, block_size=bs)
        seen = _tokens_of(items, ctx, max_blocks, bs)
        assert set(seen) == {(b, h, t) for b in range(batch) for h in range(lines)
                             for t in range(min(ctx[b], cap))}
        tiles = [-(-min(n, cap) // 16) if n > 0 else 0 for n in ctx]
        per = -(-sum(tiles) * lines // ctas) if sum(tiles) else 0
        for cta in range(ctas):
            assert sum(e - f for c, _, _, f, e in items if c == cta) <= per
        for b, n in enumerate(ctx):
            live = -(-min(n, cap) // bs) if n > 0 else 0
            read = [blk for j in range(tiles[b])
                    for blk in _tile_blocks(j, min(n, cap), bs)]
            assert sorted(set(read)) == list(range(live))
            assert len(read) == len(set(read)) or bs > 16  # a block of 32+ holds 2+ tiles


@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128])
def test_decode_split_plan_is_one_wave_or_one_cta_a_tile(bs):
    for batch, lines, max_blocks in ((4, 8, 1056 * 8 // bs), (1, 1, 1), (64, 8, 3), (2, 16, 7)):
        for resident in (1, 2):
            ctas = paged_decode_cuda.split_plan(batch, lines, max_blocks, 132, resident,
                                                block_size=bs)
            tiles = paged_decode_cuda.max_tiles(max_blocks, bs)
            assert tiles == -(-max_blocks * bs // 16)
            assert ctas == max(1, min(132 * resident, batch * lines * tiles))
    # At block size 16 a tile is a block: the split is the one it was.
    assert paged_decode_cuda.work_items([40, 17], 2, 4, 3) == paged_decode_cuda.work_items(
        [40, 17], 2, 4, 3, block_size=16)


@pytest.mark.parametrize("D", SET)
def test_head_split_cuts_float32_groups_into_equal_lines(D):
    most = 1024 // tile_plan.compiled_width(D)
    for group in range(1, 17):
        assert paged_decode_cuda.head_split(group, D, torch.bfloat16) == (group, 1)
        heads, lines = paged_decode_cuda.head_split(group, D, torch.float32)
        assert heads * lines == group and heads <= most
        assert heads == max(d for d in range(1, min(group, most) + 1) if group % d == 0)


# -------------------------------------------------------------- shape guard


def test_the_shape_guard_takes_exactly_the_stated_set():
    """Every head dim from 0 to 300: the set is the multiples of 16 from
    32 to 256, the message names it; decode also every block size from 0
    to 256 and every group from 0 to 20."""
    assert flash_cuda.HEAD_DIMS == ring_flash_cuda.HEAD_DIMS == paged_decode_cuda.HEAD_DIMS == SET
    for d in range(301):
        if d in SET:
            tile_plan.check_head_dim("kernel", d)
        else:
            with pytest.raises(ValueError, match="a multiple of 16 from 32 to 256"):
                tile_plan.check_head_dim("kernel", d)
    ok = 0
    for d in (16, 32, 80, 256, 272):
        for bs in range(257):
            for group in range(21):
                try:
                    paged_decode_cuda.check_shape(d, bs, group)
                except ValueError as exc:
                    assert "block_size in (8, 16, 32, 64, 128)" in str(exc)
                    assert (d not in SET or bs not in (8, 16, 32, 64, 128)
                            or not 1 <= group <= 16)
                else:
                    ok += 1
                    assert d in SET and bs in (8, 16, 32, 64, 128) and 1 <= group <= 16
    assert ok == 3 * 5 * 16


@pytest.mark.parametrize("D", SET)
def test_compiled_widths_and_key_tiles(D):
    width = tile_plan.compiled_width(D)
    assert width in (64, 128, 192, 256) and D <= width < D + 64
    assert tile_plan.key_tile(D) == (128 if width <= 128 else 64)


def test_every_wrapper_computes_every_head_dim_on_the_cpu():
    """The plain versions, which CPU tensors run, take the whole set as
    the reference's kernels do (each against the dense formula)."""
    for D in SET:
        q, k, v = _t(*_qkv(D, 1, 5, 9, 4, 2, D))
        out = flash_cuda.flash_gqa_attention_cuda(q, k, v, q_offset=4)
        acc, m, l = ring_flash_cuda.flash_partial_cuda(q, k, v, causal_offset=4)
        torch.testing.assert_close(acc / l[..., None], out, **TOL)


# --------------------------------------------------------- the serving path


@pytest.mark.parametrize("block_size,head_dim", [(8, 32), (64, 96), (8, 96), (64, 32)])
def test_serving_path_matches_reference(block_size, head_dim):
    """prefill_paged, prefill_continue over its prefix and three decode
    steps, port against the reference, at a group of 3 (6 heads over 2
    KV heads), float32, two layers."""
    jcfg = jax_llama.LlamaConfig(vocab_size=128, d_model=6 * head_dim, n_layers=2, n_heads=6,
                                 n_kv_heads=2, d_ff=128, block_size=block_size,
                                 dtype="float32")
    tcfg = llama.LlamaConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(llama.LlamaConfig)})
    jparams = jax_llama.init_params(jax.random.PRNGKey(block_size + head_dim), jcfg)
    tparams = llama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                      device="cpu")
    B, P, S = 2, block_size, block_size  # prefix and suffix of one block each
    tokens = np.random.default_rng(head_dim).integers(0, 128, (B, P + S)).astype(np.int32)
    n = 3  # blocks a sequence: prefix, suffix, decode
    table = np.arange(B * n, dtype=np.int32).reshape(B, n)[:, ::-1].copy()
    shape = (2, B * n, 2, block_size, 2, head_dim)
    jpool, tpool = jnp.zeros(shape, jnp.float32), torch.zeros(shape)
    want, jpool = jax_llama.prefill_paged(jparams, jnp.asarray(tokens[:, :P]), jpool,
                                          jnp.asarray(table[:, :1]), jcfg)
    got, _ = llama.prefill_paged(tparams, *_t(tokens[:, :P]), tpool, *_t(table[:, :1]), tcfg)
    _close(got, want, LOGITS)
    want, jpool = jax_llama.prefill_continue(jparams, jnp.asarray(tokens[:, P:]), jpool,
                                             jnp.asarray(table[:, :2]), P, jcfg)
    got, _ = llama.prefill_continue(tparams, *_t(tokens[:, P:]), tpool, *_t(table[:, :2]), P,
                                    tcfg)
    _close(got, want, LOGITS)
    _close(tpool, jpool, POOL)
    nxt = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
    for step in range(3):
        ctx = np.full((B,), P + S + 1 + step, np.int32)
        want, jpool = jax_llama.decode_step(jparams, jnp.asarray(nxt), jpool, jnp.asarray(table),
                                            jnp.asarray(ctx), jcfg)
        got, _ = llama.decode_step(tparams, *_t(nxt), tpool, *_t(table, ctx), tcfg)
        _close(got, want, LOGITS)
        _close(tpool, jpool, POOL)
        nxt = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
