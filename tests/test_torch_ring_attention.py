"""The port's ring attention against the JAX reference, on the CPU.

- the partial kernel's plain version (``ops/ring_flash.py``, reached
  through the wrapper on CPU tensors) vs the Pallas ``flash_partial``
  in interpret mode;
- ``merge_partials``, ``neutral_partial``, ``normalize_partial``,
  ``stripe`` and ``unstripe`` vs the reference's;
- ``ring_attention`` on ``[cpu] * R`` meshes vs the reference's on the
  suite's eight virtual host devices, both layouts, both bodies;
- ``forward(sp_mesh=...)`` vs the reference's, on the reference suite's
  tiny float32 config.

Inputs come from a numpy seed and go to both packages.  Tolerances are
the reference suite's own: 1e-5 for float32 attention (sums in another
order), 0.05 for bf16 inputs against a float32 dense reference, 5e-4
for logits after two layers (tests/test_llama_model.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from llm_d_kv_cache_manager_tpu.ops.ring_attention import (
    ring_attention as jax_ring_attention,
    ring_attention_sharded as jax_ring_sharded,
    stripe as jax_stripe,
    unstripe as jax_unstripe,
)
from llm_d_kv_cache_manager_tpu.ops import ring_flash_pallas as jax_partial
from llm_d_kv_cache_manager_tpu.ops.attention import causal_gqa_attention as jax_dense
from llm_d_kv_cache_manager_tpu.parallel import mesh as jax_mesh
from tests.helpers.torch_port import port

ring = port("ops.ring_attention")
ring_flash = port("ops.ring_flash")
ring_flash_cuda = port("ops.ring_flash_cuda")
mesh = port("parallel.mesh")
llama = port("models.llama")

TOL = dict(rtol=1e-5, atol=1e-5)
NEG_INF32 = np.float32(-1e30)


def _qkv(seed, B, Tq, Tk, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((B, Tq, H, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D))
    )


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# ------------------------------------------------------------- partial


PARTIAL_CASES = [
    # B, Tq, Tk, H, Hkv, D, causal_offset
    (1, 37, 37, 4, 2, 16, 0),
    (1, 37, 37, 4, 2, 16, -1),
    (2, 70, 45, 4, 2, 16, None),
    (1, 100, 77, 4, 2, 8, 0),  # Tk < Tq: the last rows see every key
    (2, 13, 100, 4, 2, 8, -1),  # Tk > Tq: keys past the band stay masked
    (1, 77, 77, 4, 4, 16, -1),
    (1, 5, 9, 4, 2, 8, -7),  # rows 0..6 see nothing
]


@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,D,off", PARTIAL_CASES)
def test_partial_plain_matches_pallas_kernel(B, Tq, Tk, H, Hkv, D, off):
    """The partial wrapper on CPU tensors (its plain version) against the
    TPU kernel in interpret mode: acc, m and l, and exact (0, -1e30, 0)
    on every row that sees no key."""
    q, k, v = _qkv(10, B, Tq, Tk, H, Hkv, D)
    want = jax_partial.flash_partial(*_j(q, k, v), causal_offset=off, interpret=True)
    got = ring_flash_cuda.flash_partial_cuda(*_t(q, k, v), causal_offset=off)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)
    acc, m, l = (x.numpy() for x in got)
    if off is not None:
        empty = np.arange(Tq) + off < 0
        assert (m[:, empty] == NEG_INF32).all() and (l[:, empty] == 0).all()
        assert (acc[:, empty] == 0).all()
        assert (m[:, ~empty] > -1e3).all() and (l[:, ~empty] > 0).all()


def test_partial_plain_is_the_wrapper_on_cpu():
    q, k, v = _t(*_qkv(11, 1, 20, 30, 4, 2, 8))
    for off in (None, 0, -1):
        want = ring_flash.flash_partial_plain(q, k, v, causal_offset=off)
        got = ring_flash_cuda.flash_partial_cuda(q, k, v, causal_offset=off)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_partial_plain_takes_bf16():
    q, k, v = (x.to(torch.bfloat16) for x in _t(*_qkv(12, 1, 16, 16, 2, 1, 8)))
    acc, m, l = ring_flash_cuda.flash_partial_cuda(q, k, v, causal_offset=0)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    want = jax_partial.flash_partial(
        *_j(*(x.float().numpy() for x in (q, k, v))), causal_offset=0, interpret=True)
    _close(acc, want[0])


@pytest.mark.parametrize(
    "bad",
    [
        lambda q, k, v: (q[..., :4], k, v),  # head dim mismatch
        lambda q, k, v: (q[:, :, :3], k, v),  # H not a multiple of Hkv
        lambda q, k, v: (q, k, v[:, :5]),  # k/v disagree
        lambda q, k, v: (q.double(), k, v),  # mixed dtypes
    ],
)
def test_partial_wrapper_rejects_bad_inputs(bad):
    q, k, v = _t(*_qkv(13, 1, 8, 8, 4, 2, 8))
    with pytest.raises(ValueError):
        ring_flash_cuda.flash_partial_cuda(*bad(q, k, v))


def test_partial_wrapper_rejects_offsets_past_int32():
    q, k, v = _t(*_qkv(13, 1, 8, 8, 4, 2, 8))
    with pytest.raises(ValueError, match="int32"):
        ring_flash_cuda.flash_partial_cuda(q, k, v, causal_offset=2**31)


# ------------------------------------------------------ merge helpers


def _partial_arrays(seed, shape, D, masked_every=3):
    """A partial with some rows fully masked (acc 0, m NEG_INF, l 0)."""
    rng = np.random.default_rng(seed)
    acc = rng.standard_normal(shape + (D,)).astype(np.float32)
    m = rng.standard_normal(shape).astype(np.float32) * 3
    l = rng.uniform(0.5, 4.0, shape).astype(np.float32)
    dead = np.zeros(shape, bool)
    dead.reshape(-1)[::masked_every] = True
    acc[dead] = 0
    m[dead] = NEG_INF32
    l[dead] = 0
    return acc, m, l


@pytest.mark.parametrize("masked_a,masked_b", [(3, 2), (2, 3), (1, 5), (7, 1)])
def test_merge_partials_matches_reference(masked_a, masked_b):
    shape, D = (2, 9, 4), 8
    a = _partial_arrays(20, shape, D, masked_a)
    b = _partial_arrays(21, shape, D, masked_b)
    want = jax_partial.merge_partials(_j(*a), _j(*b))
    got = ring_flash.merge_partials(_t(*a), _t(*b))
    for g, w in zip(got, want):
        _close(g, w)


def test_neutral_partial_matches_reference():
    q = np.random.default_rng(22).standard_normal((2, 5, 4, 8)).astype(np.float32)
    want = jax_partial.neutral_partial(jnp.asarray(q))
    got = ring_flash.neutral_partial(torch.from_numpy(q))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # ...and it is the identity of the merge.
    part = _partial_arrays(23, (2, 5, 4), 8)
    merged = ring_flash.merge_partials(got, _t(*part))
    for g, w in zip(merged, part):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_partial_matches_reference(dtype):
    acc, _, l = _partial_arrays(24, (2, 6, 4), 8)
    want = jax_partial.normalize_partial(*_j(acc, l), jnp.dtype(dtype))
    got = ring_flash.normalize_partial(*_t(acc, l), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(got, np.asarray(want, np.float32))
    assert bool(torch.isfinite(got).all())


def test_split_partials_merge_to_one_pass():
    """Splitting K/V in two and merging the partials equals one pass
    (the flash-decoding identity the ring steps rely on)."""
    q, k, v = _t(*_qkv(25, 1, 32, 32, 4, 2, 16))
    part = ring_flash.flash_partial_plain
    state = ring_flash.neutral_partial(q)
    for sl in (slice(0, 16), slice(16, 32)):
        state = ring_flash.merge_partials(state, part(q, k[:, sl], v[:, sl], causal_offset=None))
    full = part(q, k, v, causal_offset=None)
    np.testing.assert_allclose(
        ring_flash.normalize_partial(state[0], state[2], q.dtype).numpy(),
        ring_flash.normalize_partial(full[0], full[2], q.dtype).numpy(), **TOL)


# ------------------------------------------------------------- stripe


@pytest.mark.parametrize("ring_size", [2, 4, 8])
def test_stripe_unstripe_match_reference(ring_size):
    x = np.arange(2 * 24 * 3).reshape(2, 24, 3)
    jx = jnp.asarray(x)
    s = ring.stripe(torch.from_numpy(x), ring_size)
    np.testing.assert_array_equal(s.numpy(), np.asarray(jax_stripe(jx, ring_size)))
    u = ring.unstripe(s, ring_size)
    np.testing.assert_array_equal(u.numpy(), np.asarray(jax_unstripe(
        jax_stripe(jx, ring_size), ring_size)))
    np.testing.assert_array_equal(u.numpy(), x)


def test_stripe_rejects_indivisible_sequence():
    with pytest.raises(ValueError, match="not divisible"):
        ring.stripe(torch.zeros(1, 10), 4)


# --------------------------------------------------------------- ring


RING_CASES = [
    # dp, sp, B, T, H, Hkv, D
    (2, 4, 2, 16, 4, 2, 8),
    (1, 8, 1, 64, 8, 4, 16),
]


def _meshes(dp, sp):
    plan = dict(dp=dp, sp=sp)
    return (
        jax_mesh.make_mesh(jax_mesh.MeshPlan(**plan), jax.devices()[: dp * sp]),
        mesh.make_mesh(mesh.MeshPlan(**plan), ["cpu"] * (dp * sp)),
    )


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("striped", [False, True], ids=["contiguous", "striped"])
@pytest.mark.parametrize("dp,sp,B,T,H,Hkv,D", RING_CASES)
def test_ring_attention_matches_reference(dp, sp, B, T, H, Hkv, D, striped, impl):
    q, k, v = _qkv(30 + sp, B, T, T, H, Hkv, D)
    jmesh, tmesh = _meshes(dp, sp)
    want = jax_ring_attention(
        *_j(q, k, v), jmesh, striped=striped, impl=impl, interpret=impl == "flash")
    got = ring.ring_attention(*_t(q, k, v), tmesh, striped=striped, impl=impl)
    _close(got, want)
    # ...and the ring equals dense causal attention.
    _close(got, jax_dense(*_j(q, k, v)))


def test_ring_auto_on_cpu_is_einsum(monkeypatch):
    """Off CUDA, "auto" runs the einsum body, as the reference's "auto"
    does off the TPU: the partial is never called."""
    q, k, v = _t(*_qkv(32, 1, 16, 16, 4, 2, 8))
    tmesh = mesh.make_mesh(mesh.MeshPlan(dp=1, sp=4), ["cpu"] * 4)
    before = ring_flash_cuda.flash_partial_cuda.launches
    calls = []
    real = ring_flash_cuda.flash_partial_plain

    def spy(*args, **kwargs):
        calls.append(kwargs.get("causal_offset"))
        return real(*args, **kwargs)

    monkeypatch.setattr(ring_flash_cuda, "flash_partial_plain", spy)
    auto = ring.ring_attention(q, k, v, tmesh, impl="auto")
    assert calls == []
    flash = ring.ring_attention(q, k, v, tmesh, impl="flash")
    # Contiguous flash: 10 of the 16 (rank, step) pairs see keys.
    assert sorted(calls, key=str) == sorted([None] * 6 + [0] * 4, key=str)
    assert ring_flash_cuda.flash_partial_cuda.launches == before  # CPU: no launch
    np.testing.assert_allclose(auto.numpy(), flash.numpy(), **TOL)


def test_ring_attention_bf16_serving_dtype():
    """bf16 inputs: the ring agrees with a float32 dense reference within
    the reference suite's bf16 tolerance, and with the reference's bf16
    ring."""
    q, k, v = _qkv(33, 2, 32, 32, 4, 4, 16)
    jmesh, tmesh = _meshes(2, 4)
    dense = jax_dense(*_j(q, k, v))
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    want = jax_ring_attention(*jb, jmesh)
    for impl in ("einsum", "flash"):
        got = ring.ring_attention(*tb, tmesh, impl=impl)
        assert got.dtype == torch.bfloat16
        _close(got, dense, dict(rtol=0.05, atol=0.05))
        _close(got, np.asarray(want, np.float32), dict(rtol=0.05, atol=0.05))


def test_ring_rejects_tp_mesh():
    """A tp mesh no longer raises: the ring with heads cut over tp
    (``head_axis="tp"``, as ``ring_for_mesh`` gates it) equals the
    reference's on the same tp x sp mesh and dense attention; without
    ``head_axis`` the tp ranks are replicas and the ring runs once.
    The name is the one it had when it checked the raise that tp
    meshes gave before they were supported."""
    tmesh = mesh.make_mesh(mesh.MeshPlan(dp=1, tp=2, sp=2), ["cpu"] * 4)
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshPlan(dp=1, tp=2, sp=2), jax.devices()[:4])
    q, k, v = _qkv(34, 1, 8, 8, 4, 2, 8)
    want = jax_ring_sharded(jmesh, head_axis="tp")(*_j(q, k, v))
    for run in (ring.ring_attention_sharded(tmesh, head_axis="tp"), ring.ring_for_mesh(tmesh)):
        _close(run(*_t(q, k, v)), want)
    _close(ring.ring_attention(*_t(q, k, v), tmesh), jax_dense(*_j(q, k, v)))
    with pytest.raises(ValueError, match="no axis"):
        ring.ring_attention_sharded(tmesh, head_axis="heads")


def test_ring_rejects_unknown_impl():
    tmesh = mesh.make_mesh(mesh.MeshPlan(dp=1, sp=2), ["cpu"] * 2)
    with pytest.raises(ValueError, match="unknown ring impl"):
        ring.ring_attention_sharded(tmesh, impl="pallas")


# ------------------------------------------------------------ forward


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
LOGITS = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def models():
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG)
    shared = {f.name: getattr(JAX_CFG, f.name) for f in dataclasses.fields(llama.LlamaConfig)}
    tcfg = llama.LlamaConfig(**shared)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, llama.params_from_numpy(tree, tcfg, device="cpu"), tcfg


def _tokens(seed, B, T):
    return np.random.default_rng(seed).integers(0, JAX_CFG.vocab_size, (B, T)).astype(np.int32)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("striped", [False, True], ids=["contiguous", "striped"])
@pytest.mark.parametrize("dp,sp,B,T", [(2, 4, 2, 32), (1, 8, 1, 32)])
def test_forward_sp_mesh_matches_reference(models, dp, sp, B, T, striped, impl):
    jparams, tparams, tcfg = models
    tokens = _tokens(40 + sp, B, T)
    jmesh, tmesh = _meshes(dp, sp)
    want = jax_llama.forward(
        jparams, jnp.asarray(tokens), JAX_CFG, sp_mesh=jmesh, ring_striped=striped,
        ring_impl=impl, ring_interpret=impl == "flash")
    got = llama.forward(tparams, torch.from_numpy(tokens), tcfg, sp_mesh=tmesh,
                        ring_striped=striped, ring_impl=impl)
    assert got.shape == (B, T, JAX_CFG.vocab_size)
    _close(got, want, LOGITS)
    # ...and the ring forward equals the port's own dense forward.
    dense = llama.forward(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **LOGITS)


def test_forward_sp_mesh_rejects_custom_positions(models):
    _, tparams, tcfg = models
    tmesh = mesh.make_mesh(mesh.MeshPlan(dp=1, sp=4), ["cpu"] * 4)
    tokens = torch.from_numpy(_tokens(45, 1, 8))
    with pytest.raises(ValueError, match="default positions"):
        llama.forward(tparams, tokens, tcfg, positions=torch.arange(8)[None], sp_mesh=tmesh)


def test_forward_sp_mesh_rejects_tp_mesh(models):
    """A tp x sp ``sp_mesh`` no longer raises: unsharded params run the
    ring with heads cut over tp and give the reference's logits over
    the same mesh.
    The name is the one it had when it checked the raise that tp
    meshes gave before they were supported."""
    jparams, tparams, tcfg = models
    tokens = _tokens(46, 1, 8)
    tmesh = mesh.make_mesh(mesh.MeshPlan(dp=1, tp=2, sp=2), ["cpu"] * 4)
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshPlan(dp=1, tp=2, sp=2), jax.devices()[:4])
    want = jax_llama.forward(jparams, jnp.asarray(tokens), JAX_CFG, sp_mesh=jmesh)
    got = llama.forward(tparams, torch.from_numpy(tokens), tcfg, sp_mesh=tmesh)
    _close(got, want, LOGITS)
