"""The port's MoE family against the JAX reference, on the config of
tests/test_moe_model.py (vocab 512, d 64, 2 layers, 4/2 heads, d_ff 128,
4 experts, top 2).

Every equivalence runs at float32: in bf16 the last ulp of attention is
amplified through the expert MLP by design (the reference pins float32
for the same reason).  Routing is exact: ``dispatch`` must equal the
reference's bit for bit, ``combine`` and the aux loss within 1e-6.
Logits within rtol = atol = 2e-4 (the reference suite's own tolerance),
the loss within rtol 1e-5, leaves after AdamW steps within atol 1e-6 /
rtol 1e-4, except, as in tests/test_torch_training.py, elements whose
gradient lies within that tolerance of zero (under one in a thousand a
step), which Adam's normalized step may move by up to 2 * lr a step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import moe as jax_moe
from llm_d_kv_cache_manager_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from llm_d_kv_cache_manager_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tests.helpers.torch_port import port

moe = port("models.moe")
llama = port("models.llama")
mesh = port("parallel.mesh")

JAX_CFG = jax_moe.MoEConfig(
    vocab_size=512,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    n_experts=4,
    top_k=2,
    dtype="float32",
)
LOGITS = dict(rtol=2e-4, atol=2e-4)
LOSS = dict(rtol=1e-5)
LEAF = dict(atol=1e-6, rtol=1e-4)
AUX = dict(rtol=0, atol=1e-6)


def _cfg(jcfg):
    return moe.MoEConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


CFG = _cfg(JAX_CFG)


@pytest.fixture(scope="module")
def jax_params():
    return jax_moe.init_params(jax.random.PRNGKey(0), JAX_CFG)


def _torch_params(jax_params, cfg=CFG):
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    return moe.params_from_numpy(tree, cfg, device="cpu")


def _tokens(seed, B=2, T=32):
    return np.random.default_rng(seed).integers(0, JAX_CFG.vocab_size, (B, T)).astype(np.int32)


def _named(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_named(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def test_config_matches_reference():
    assert dataclasses.asdict(moe.MoEConfig()) == dataclasses.asdict(jax_moe.MoEConfig())
    cfg = moe.MoEConfig()
    assert cfg.head_dim == 128
    for tokens in (1, 7, 64, 2048, 8192):
        assert cfg.capacity(tokens) == jax_moe.MoEConfig().capacity(tokens)


ROUTE_CASES = {
    "default": {},
    "tight, top 1": dict(top_k=1, capacity_factor=0.25),
    "tight, top 2": dict(capacity_factor=0.5),
    "top 3 of 8": dict(n_experts=8, top_k=3, capacity_factor=0.75),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_matches_reference(case):
    """The reference's TestRouting inputs (32 tokens, a standard normal
    router), and capacities tight enough to drop tokens."""
    jcfg = dataclasses.replace(JAX_CFG, **ROUTE_CASES[case])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, jcfg.d_model)).astype(np.float32)
    router = rng.standard_normal((jcfg.d_model, jcfg.n_experts)).astype(np.float32)
    jd, jc, jaux = jax_moe._route(jnp.asarray(x), jnp.asarray(router), jcfg)
    d, c, aux = moe._route(torch.from_numpy(x), torch.from_numpy(router), _cfg(jcfg))
    assert d.dtype == c.dtype == torch.float32
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **AUX)
    np.testing.assert_allclose(float(aux), float(jaux), **AUX)
    C = jcfg.capacity(32)
    assert d.shape == (32, jcfg.n_experts, C)
    assert float(d.sum(0).max()) <= 1.0  # no slot double-booked
    if case != "default":
        assert float(d.sum()) < 32 * jcfg.top_k  # tokens really dropped


def test_route_ties_go_to_the_first_expert():
    """Equal router logits: every round picks the lowest free expert, on
    both sides."""
    cfg = dataclasses.replace(JAX_CFG, capacity_factor=4.0)
    x = np.ones((6, cfg.d_model), np.float32)
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    jd, _, _ = jax_moe._route(jnp.asarray(x), jnp.asarray(router), cfg)
    d, c, _ = moe._route(torch.from_numpy(x), torch.from_numpy(router), _cfg(cfg))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert d.sum((0, 2)).tolist() == [6.0, 6.0, 0.0, 0.0]
    np.testing.assert_allclose(c.sum((1, 2)).numpy(), 1.0, rtol=1e-6)


def test_params_from_numpy_is_bit_exact():
    """bf16 leaves by their uint16 bits, the float32 router by value."""
    jcfg = dataclasses.replace(JAX_CFG, dtype="bfloat16")
    jparams = jax_moe.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = _torch_params(jparams, _cfg(jcfg))
    want = _named(jax.tree_util.tree_map(np.asarray, jparams))
    got = _named(tparams)
    assert got.keys() == want.keys()
    for name, array in want.items():
        tensor = got[name]
        if name == "layers.router":
            assert tensor.dtype == torch.float32
            np.testing.assert_array_equal(tensor.numpy(), array)
        else:
            assert tensor.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(tensor.view(torch.uint16).numpy(),
                                          array.view(np.uint16), err_msg=name)


def test_params_from_numpy_rejects_wrong_shapes(jax_params):
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    with pytest.raises(ValueError, match="layers.w_gate"):
        moe.params_from_numpy(tree, dataclasses.replace(CFG, d_ff=64), device="cpu")


def test_init_params_layout_on_cpu():
    """The default config's widths, at one layer and a short vocabulary."""
    cfg = dataclasses.replace(moe.MoEConfig(), n_layers=1, vocab_size=100)
    params = moe.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    layers = params["layers"]
    assert params["embed"].shape == (100, 1024) and params["embed"].dtype == torch.bfloat16
    assert layers["wq"].shape == (1, 1024, 8, 128) and layers["wk"].shape == (1, 1024, 4, 128)
    assert layers["router"].shape == (1, 1024, 8) and layers["router"].dtype == torch.float32
    assert layers["w_gate"].shape == (1, 8, 1024, 2816)
    assert layers["w_down"].shape == (1, 8, 2816, 1024)
    assert bool((layers["ln1"] == 1).all()) and bool((params["ln_f"] == 1).all())
    std = float(layers["router"].std())
    assert abs(std - 1024**-0.5) < 0.05 * 1024**-0.5


@pytest.mark.parametrize("use_flash", [True, False])
def test_forward_matches_reference(jax_params, use_flash):
    tokens = _tokens(1)
    want, want_aux = jax_moe.forward(jax_params, jnp.asarray(tokens), JAX_CFG,
                                     use_flash=use_flash)
    got, aux = moe.forward(_torch_params(jax_params), torch.from_numpy(tokens), CFG,
                           use_flash=use_flash)
    assert got.shape == (2, 32, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    np.testing.assert_allclose(float(aux), float(want_aux), **AUX)


def test_forward_tiled_attention_matches_reference(jax_params):
    """Keys at or past ``flash_attention_min_len``: the tiled op on the
    CPU, the reference's scan op off the TPU."""
    jcfg = dataclasses.replace(JAX_CFG, flash_attention_min_len=8)
    tokens = _tokens(2)
    want, _ = jax_moe.forward(jax_params, jnp.asarray(tokens), jcfg)
    got, _ = moe.forward(_torch_params(jax_params), torch.from_numpy(tokens), _cfg(jcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("sp", [2, 4])
def test_forward_ring_matches_dense(jax_params, sp, impl):
    """The reference's test_forward_ring_matches_dense: the contiguous
    ring over an sp mesh equals the dense forward (and the reference's
    ring forward over the same mesh)."""
    tokens = _tokens(3)
    params = _torch_params(jax_params)
    dense, dense_aux = moe.forward(params, torch.from_numpy(tokens), CFG, use_flash=False)
    tmesh = mesh.make_mesh(mesh.MeshPlan(dp=1, sp=sp), ["cpu"] * sp)
    got, aux = moe.forward(params, torch.from_numpy(tokens), CFG, sp_mesh=tmesh,
                           ring_impl=impl)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **LOGITS)
    np.testing.assert_allclose(float(aux), float(dense_aux), rtol=1e-5)
    jmesh = jax_make_mesh(JaxMeshPlan(dp=1, sp=sp), devices=jax.devices()[:sp])
    want, _ = jax_moe.forward(jax_params, jnp.asarray(tokens), JAX_CFG, sp_mesh=jmesh,
                              ring_impl=impl, ring_interpret=impl == "flash")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_forward_ring_rejects_tp_mesh(jax_params):
    """A tp x sp ``sp_mesh`` no longer raises: the ring runs with heads
    cut over tp and the logits equal the reference's over that mesh.
    The name is the one it had when it checked the raise that tp
    meshes gave before they were supported."""
    tokens = _tokens(4)
    tmesh = mesh.make_mesh(mesh.MeshPlan(dp=1, tp=2, sp=2), ["cpu"] * 4)
    jmesh = jax_make_mesh(JaxMeshPlan(dp=1, tp=2, sp=2), devices=jax.devices()[:4])
    got, aux = moe.forward(_torch_params(jax_params), torch.from_numpy(tokens), CFG,
                           sp_mesh=tmesh)
    want, want_aux = jax_moe.forward(jax_params, jnp.asarray(tokens), JAX_CFG, sp_mesh=jmesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_single_expert_equals_dense_mlp():
    """The reference's test: top_k = n_experts = 1 with ample capacity
    reduces the routed layer to the plain gated MLP."""
    cfg = moe.MoEConfig(d_model=32, d_ff=64, n_experts=1, top_k=1, capacity_factor=2.0)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 8, 32)).astype(np.float32))
    lp = {
        "router": torch.zeros((32, 1)),
        "w_gate": torch.from_numpy(rng.standard_normal((1, 32, 64)).astype(np.float32) * 0.1),
        "w_up": torch.from_numpy(rng.standard_normal((1, 32, 64)).astype(np.float32) * 0.1),
        "w_down": torch.from_numpy(rng.standard_normal((1, 64, 32)).astype(np.float32) * 0.1),
    }
    out, aux = moe._moe_mlp(x, lp, cfg)
    dense = llama._mlp(x, {k: lp[k][0] for k in ("w_gate", "w_up", "w_down")})
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=1e-4, atol=1e-4)
    assert float(aux) == 1.0


def test_loss_and_gradients_match_reference(jax_params):
    tokens = _tokens(5)
    want, want_grads = jax.value_and_grad(jax_moe.loss_fn)(jax_params, jnp.asarray(tokens),
                                                            JAX_CFG)
    params = _torch_params(jax_params)
    for leaf in llama.param_leaves(params):
        leaf.requires_grad_()
    loss = moe.loss_fn(params, torch.from_numpy(tokens), CFG)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **LOSS)
    want_grads = _named(want_grads)
    for name, leaf in _named(params).items():
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want_grads[name]),
                                   err_msg=name, **LEAF)
    assert float(params["layers"]["router"].grad.abs().max()) > 0


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_reference(jax_params, steps):
    optimizer = jax_moe.make_optimizer()
    jparams, opt_state = jax_params, optimizer.init(jax_params)
    params = _torch_params(jax_params)
    topt = moe.make_optimizer(params)
    near_zero = {name: np.zeros(leaf.shape, bool) for name, leaf in _named(params).items()}
    for step in range(steps):
        tokens = _tokens(10 + step)
        jparams, opt_state, want = jax_moe.train_step(
            jparams, opt_state, jnp.asarray(tokens), JAX_CFG, optimizer)
        got = moe.train_step(params, topt, torch.from_numpy(tokens), CFG)
        np.testing.assert_allclose(float(got), float(want), err_msg=f"step {step}", **LOSS)
        for name, leaf in _named(params).items():
            near_zero[name] |= np.abs(leaf.grad.numpy()) <= LEAF["atol"]
    assert sum(int(m.sum()) for m in near_zero.values()) * 1000 < steps * sum(
        m.size for m in near_zero.values())
    want = _named(jparams)
    for name, leaf in _named(params).items():
        g, w, free = leaf.detach().numpy(), np.asarray(want[name]), near_zero[name]
        np.testing.assert_allclose(g[~free], w[~free], err_msg=name, **LEAF)
        assert np.abs(g[free] - w[free]).max(initial=0.0) <= 2 * 3e-4 * steps, name


def test_train_steps_lower_the_loss():
    params = moe.init_params(dataclasses.replace(CFG, dtype="bfloat16"),
                             torch.Generator().manual_seed(0), device="cpu")
    opt = moe.make_optimizer(params, lr=1e-3)
    tokens = torch.from_numpy(_tokens(20))
    losses = [float(moe.train_step(params, opt, tokens, CFG)) for _ in range(5)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
