"""The port's Llama serving path against the JAX reference, on the
reference suite's tiny float32 config (tests/test_llama_model.py).

Weights are the reference's ``init_params`` carried across by
``params_from_numpy``; tokens come from a numpy seed.  Logits must agree
within rtol = atol = 2e-4 (the reference suite's own tolerance) and pool
contents within 1e-5.  The port writes its pool in place, so each run
starts from its own zeroed pool."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from tests.helpers.torch_port import port

llama = port("models.llama")

JAX_CFG = jax_llama.LlamaConfig(
    vocab_size=128,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    block_size=4,
    dtype="float32",
)
LOGITS = dict(rtol=2e-4, atol=2e-4)
POOL = dict(rtol=1e-5, atol=1e-5)
# Key length at which CPU prefill switches from dense to the tiled op:
# the default keeps every test shape dense, 8 sends them through tiles.
MIN_LENS = [1024, 8]


def _cfgs(min_len=1024):
    jcfg = dataclasses.replace(JAX_CFG, flash_attention_min_len=min_len)
    shared = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(llama.LlamaConfig)}
    return jcfg, llama.LlamaConfig(**shared)


@pytest.fixture(scope="module")
def jax_params():
    return jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    return llama.params_from_numpy(tree, _cfgs()[1], device="cpu")


def _tokens(seed, B, T):
    return np.random.default_rng(seed).integers(0, JAX_CFG.vocab_size, (B, T)).astype(np.int32)


def _pools(num_blocks):
    c = JAX_CFG
    shape = (c.n_layers, num_blocks, 2, c.block_size, c.n_kv_heads, c.head_dim)
    return jnp.zeros(shape, jnp.float32), torch.zeros(shape)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("min_len", MIN_LENS)
def test_forward_matches_reference(jax_params, torch_params, min_len):
    jcfg, tcfg = _cfgs(min_len)
    tokens = _tokens(1, 2, 12)
    want = jax_llama.forward(jax_params, jnp.asarray(tokens), jcfg)
    got = llama.forward(torch_params, _t(tokens), tcfg)
    _close(got, want, LOGITS)


@pytest.mark.parametrize("min_len", MIN_LENS)
def test_prefill_paged_matches_reference(jax_params, torch_params, min_len):
    jcfg, tcfg = _cfgs(min_len)
    B, T = 2, 8
    tokens = _tokens(2, B, T)
    table = np.random.default_rng(3).permutation(16)[: B * 2].reshape(B, 2).astype(np.int32)
    jpool, tpool = _pools(16)
    want, jpool = jax_llama.prefill_paged(jax_params, jnp.asarray(tokens), jpool,
                                          jnp.asarray(table), jcfg)
    got, out_pool = llama.prefill_paged(torch_params, _t(tokens), tpool, _t(table), tcfg)
    assert out_pool is tpool  # written in place
    _close(got, want, LOGITS)
    _close(tpool, jpool, POOL)
    assert float(tpool.abs().sum()) > 0


@pytest.mark.parametrize("min_len", MIN_LENS)
def test_prefill_continue_matches_reference(jax_params, torch_params, min_len):
    jcfg, tcfg = _cfgs(min_len)
    B, T, P = 2, 12, 8
    tokens = _tokens(4, B, T)
    table = np.arange(B * 3, dtype=np.int32).reshape(B, 3)[:, ::-1].copy()
    jpool, tpool = _pools(16)
    _, jpool = jax_llama.prefill_paged(jax_params, jnp.asarray(tokens[:, :P]), jpool,
                                       jnp.asarray(table[:, :2]), jcfg)
    llama.prefill_paged(torch_params, _t(tokens[:, :P]), tpool, _t(table[:, :2]), tcfg)
    want, jpool = jax_llama.prefill_continue(jax_params, jnp.asarray(tokens[:, P:]), jpool,
                                             jnp.asarray(table), P, jcfg)
    got, _ = llama.prefill_continue(torch_params, _t(tokens[:, P:]), tpool, _t(table), P, tcfg)
    _close(got, want, LOGITS)
    _close(tpool, jpool, POOL)


@pytest.mark.parametrize("min_len", MIN_LENS)
def test_prefill_chunked_matches_reference(jax_params, torch_params, min_len):
    jcfg, tcfg = _cfgs(min_len)
    B, T, C = 2, 32, 8
    tokens = _tokens(5, B, T)
    nb = T // JAX_CFG.block_size
    table = np.arange(B * nb, dtype=np.int32).reshape(B, nb)
    for seq_len in (None, np.asarray([T - C - 3, T - 1], np.int32)):
        jpool, tpool = _pools(B * nb)
        want, jpool = jax_llama.prefill_chunked(
            jax_params, jnp.asarray(tokens), jpool, jnp.asarray(table), jcfg,
            chunk_tokens=C, seq_len=None if seq_len is None else jnp.asarray(seq_len))
        got, _ = llama.prefill_chunked(
            torch_params, _t(tokens), tpool, _t(table), tcfg,
            chunk_tokens=C, seq_len=None if seq_len is None else _t(seq_len))
        _close(got, want, LOGITS)
        _close(tpool, jpool, POOL)


def test_decode_steps_match_reference(jax_params, torch_params):
    jcfg, tcfg = _cfgs()
    B, T, max_blocks = 2, 8, 4
    tokens = _tokens(6, B, T)
    table = np.random.default_rng(7).permutation(32)[: B * max_blocks]
    table = table.reshape(B, max_blocks).astype(np.int32)
    jpool, tpool = _pools(32)
    jlog, jpool = jax_llama.prefill_paged(jax_params, jnp.asarray(tokens), jpool,
                                          jnp.asarray(table[:, :2]), jcfg)
    tlog, _ = llama.prefill_paged(torch_params, _t(tokens), tpool, _t(table[:, :2]), tcfg)
    nxt = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)
    for step in range(3):
        ctx = np.full((B,), T + 1 + step, np.int32)
        jlog, jpool = jax_llama.decode_step(jax_params, jnp.asarray(nxt), jpool,
                                            jnp.asarray(table), jnp.asarray(ctx), jcfg)
        tlog, _ = llama.decode_step(torch_params, _t(nxt), tpool, _t(table), _t(ctx), tcfg)
        _close(tlog, jlog, LOGITS)
        _close(tpool, jpool, POOL)
        nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)


def _decode_setup(jax_params, torch_params, B, max_blocks, eager_steps):
    """Both packages after a prefill of 8 tokens and ``eager_steps``
    eager decode steps: (jax pool, torch pool, table, next tokens)."""
    jcfg, tcfg = _cfgs()
    T = 8
    tokens = _tokens(10 + B, B, T)
    table = np.random.default_rng(11).permutation(32)[: B * max_blocks]
    table = table.reshape(B, max_blocks).astype(np.int32)
    jpool, tpool = _pools(32)
    jlog, jpool = jax_llama.prefill_paged(jax_params, jnp.asarray(tokens), jpool,
                                          jnp.asarray(table[:, :2]), jcfg)
    llama.prefill_paged(torch_params, _t(tokens), tpool, _t(table[:, :2]), tcfg)
    nxt = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)
    for step in range(eager_steps):
        ctx = np.full((B,), T + 1 + step, np.int32)
        jlog, jpool = jax_llama.decode_step(jax_params, jnp.asarray(nxt), jpool,
                                            jnp.asarray(table), jnp.asarray(ctx), jcfg)
        llama.decode_step(torch_params, _t(nxt), tpool, _t(table), _t(ctx), tcfg)
        nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    return jpool, tpool, table, nxt, T + eager_steps


@pytest.mark.parametrize("B,capacity", [(2, 4), (2, 6), (1, 4)],
                         ids=["table-at-capacity", "narrower-table", "second-batch-size"])
def test_captured_decode_step_matches_reference_and_eager(jax_params, torch_params, B, capacity):
    """The captured-step callable over 4 steps that cross a block
    boundary (positions 10..13, blocks of 4), against the reference's
    jitted, pool-donating decode step at the tolerance of
    ``test_decode_steps_match_reference``, and against the port's eager
    ``decode_step`` exactly, pool bytes included.  On CPU tensors the
    callable runs the eager step on its static buffers."""
    jcfg, tcfg = _cfgs()
    jpool, tpool, table, nxt, done = _decode_setup(jax_params, torch_params, B, 4, 2)
    jstep = jax.jit(
        lambda p, t, kv, bt, cl: jax_llama.decode_step(p, t, kv, bt, cl, jcfg),
        donate_argnums=(2,))
    step = llama.make_decode_step(torch_params, tpool, tcfg, B, capacity)
    epool = tpool.clone()
    for i in range(4):
        ctx = np.full((B,), done + 1 + i, np.int32)
        jlog, jpool = jstep(jax_params, jnp.asarray(nxt), jpool, jnp.asarray(table),
                            jnp.asarray(ctx))
        elog, _ = llama.decode_step(torch_params, _t(nxt), epool, _t(table), _t(ctx), tcfg)
        tlog = step(_t(nxt), _t(table), _t(ctx))
        assert tlog.shape == (B, JAX_CFG.vocab_size)
        assert torch.equal(tlog, elog) and torch.equal(tpool, epool)
        _close(tlog, jlog, LOGITS)
        _close(tpool, jpool, POOL)
        nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    assert step.replays == 0 and step.graph is None  # nothing to capture on the CPU
    assert (done + 1) // 4 != (done + 4) // 4  # the steps crossed a block boundary


def test_captured_decode_step_is_made_for_one_shape(torch_params):
    """Another batch size or a wider table raises instead of running
    eagerly behind the caller's back; a second step serves it."""
    _, tcfg = _cfgs()
    pool = _pools(32)[1]
    step = llama.make_decode_step(torch_params, pool, tcfg, 2, 4)
    ctx = torch.full((2,), 3, dtype=torch.int32)
    table = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    step(torch.tensor([1, 2]), table, ctx)
    with pytest.raises(ValueError, match="batch 2"):
        step(torch.tensor([1, 2, 3]), torch.zeros((3, 4), dtype=torch.int32),
             torch.full((3,), 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="4 blocks wide"):
        step(torch.tensor([1, 2]), torch.zeros((2, 5), dtype=torch.int32), ctx)
    with pytest.raises(ValueError):
        llama.make_decode_step(torch_params, pool, tcfg, 0, 4)
    other = llama.make_decode_step(torch_params, pool, tcfg, 3, 4)
    logits = other(torch.tensor([1, 2, 3]), torch.arange(12, dtype=torch.int32).reshape(3, 4),
                   torch.full((3,), 3, dtype=torch.int32))
    assert logits.shape == (3, JAX_CFG.vocab_size)


@pytest.mark.parametrize("min_len", MIN_LENS)
def test_prefix_hit_contract_in_port(torch_params, min_len):
    """Prefill of a prefix, then continuation of the suffix, gives the
    suffix logits of one full prefill, and decode continues off the
    continued pool as off a dense pass (the port alone)."""
    _, cfg = _cfgs(min_len)
    B, T, P = 2, 16, 8
    tokens = _t(_tokens(8, B, T))
    table = torch.arange(B * 5, dtype=torch.int32).reshape(B, 5)
    pool = _pools(16)[1]
    llama.prefill_paged(torch_params, tokens[:, :P], pool, table[:, :2], cfg)
    cont, _ = llama.prefill_continue(torch_params, tokens[:, P:], pool, table[:, :4], P, cfg)
    full, _ = llama.prefill_paged(torch_params, tokens, _pools(16)[1], table[:, :4], cfg)
    np.testing.assert_allclose(cont.numpy(), full[:, P:].numpy(), **LOGITS)
    nxt = cont[:, -1].argmax(-1)
    dec, _ = llama.decode_step(torch_params, nxt, pool, table,
                               torch.full((B,), T + 1, dtype=torch.int32), cfg)
    dense = llama.forward(torch_params, torch.cat([tokens, nxt[:, None]], 1), cfg)[:, -1]
    np.testing.assert_allclose(dec.numpy(), dense.numpy(), **LOGITS)


def test_params_from_numpy_carries_bf16_bits():
    jcfg = dataclasses.replace(JAX_CFG, dtype="bfloat16")
    tree = jax.tree_util.tree_map(
        np.asarray, jax_llama.init_params(jax.random.PRNGKey(1), jcfg))
    _, tcfg = _cfgs()
    tcfg.dtype = "bfloat16"
    params = llama.params_from_numpy(tree, tcfg, device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    for got, want in [(params["embed"], tree["embed"]), (params["ln_f"], tree["ln_f"])] + [
        (params["layers"][k], tree["layers"][k]) for k in tree["layers"]
    ]:
        assert got.view(torch.uint16).numpy().tobytes() == want.view(np.uint16).tobytes()


def test_params_from_numpy_rejects_wrong_shapes(jax_params):
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    _, tcfg = _cfgs()
    tcfg.n_heads = 8  # head_dim 8: wq no longer fits
    with pytest.raises(ValueError, match="layers.wq"):
        llama.params_from_numpy(tree, tcfg, device="cpu")


def test_init_params_layout_on_cpu():
    _, cfg = _cfgs()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jax_shapes = jax.tree_util.tree_map(
        lambda x: tuple(x.shape), jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG))
    assert tuple(params["embed"].shape) == jax_shapes["embed"]
    for key, shape in jax_shapes["layers"].items():
        assert tuple(params["layers"][key].shape) == shape
    logits = llama.forward(params, _t(_tokens(9, 1, 8)), cfg)
    assert logits.shape == (1, 8, cfg.vocab_size) and bool(torch.isfinite(logits).all())


class TestCpuFallback:
    """The reference's decode keys (``decode_attention``,
    ``decode_blocks_per_step``, ``decode_mxu_native``) construct on the
    port with the reference's defaults, as ``StagingConfig(use_pinned=...)``
    does (tests/test_staging_engine.py::TestCpuFallback).  They pick a
    route and size a Pallas grid step in the reference; the port's decode
    is one kernel (here its plain version) whatever they say."""

    NAMES = ("decode_attention", "decode_blocks_per_step", "decode_mxu_native")

    def test_defaults_are_the_references(self):
        for name in self.NAMES:
            assert getattr(llama.LlamaConfig(), name) == getattr(jax_llama.LlamaConfig(), name)

    @pytest.mark.parametrize("route", ["auto", "pallas", "gather"])
    def test_decode_is_the_same_whatever_the_keys_say(self, jax_params, torch_params, route):
        jcfg, tcfg = _cfgs()
        keyed = dataclasses.replace(tcfg, decode_attention=route, decode_blocks_per_step=2,
                                    decode_mxu_native=True)
        B, T, max_blocks = 2, 8, 4
        tokens = _tokens(21, B, T)
        table = np.arange(B * max_blocks, dtype=np.int32).reshape(B, max_blocks)
        jpool, _ = _pools(32)
        jlog, jpool = jax_llama.prefill_paged(jax_params, jnp.asarray(tokens), jpool,
                                              jnp.asarray(table[:, :2]), jcfg)
        nxt = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)
        ctx = np.full((B,), T + 1, np.int32)
        jlog, _ = jax_llama.decode_step(jax_params, jnp.asarray(nxt), jpool, jnp.asarray(table),
                                        jnp.asarray(ctx), jcfg)
        logits = []
        for cfg in (tcfg, keyed):
            _, tpool = _pools(32)
            llama.prefill_paged(torch_params, _t(tokens), tpool, _t(table[:, :2]), cfg)
            logits.append(llama.decode_step(torch_params, _t(nxt), tpool, _t(table), _t(ctx),
                                            cfg)[0])
        assert torch.equal(logits[0], logits[1])
        _close(logits[1], jlog, LOGITS)
