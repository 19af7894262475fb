"""The port's Llama training step against the JAX reference, on the
config of tests/test_checkpoint.py at float32 (vocab 256, d 64, 2
layers, 4/2 heads, d_ff 128).

Weights are the reference's ``init_params`` carried across by
``params_from_numpy``; tokens come from a numpy seed.  The loss must
agree within rtol 1e-5.  Gradients and updated leaves are float32 sums
taken in another order on each side: gradients within atol 1e-6 / rtol
1e-4 of the reference's, leaves after AdamW steps within atol 1e-6 /
rtol 1e-4 (AdamW's decoupled update and optax's adamw chain agree in
exact arithmetic; their roundings differ).  One exception, which Adam
makes: an element whose gradient lies within the gradient tolerance of
zero takes a step of lr * g / (|g| + eps), whose size and sign the
rounding of g decides, so such elements (counted: under one in a thousand a step) may
differ by up to 2 * lr a step.  Also the grad guard of the
kernel wrappers: on the CPU they differentiate through their plain
versions, and on any other device they refuse autograd before the
launch."""

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
    vocab_size=256,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    dtype="float32",
)
CFG = llama.LlamaConfig(
    **{f.name: getattr(JAX_CFG, f.name) for f in dataclasses.fields(llama.LlamaConfig)}
)
LOSS = dict(rtol=1e-5)
LEAF = dict(atol=1e-6, rtol=1e-4)


@pytest.fixture(scope="module")
def jax_params():
    return jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG)


def _torch_params(jax_params):
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    return llama.params_from_numpy(tree, CFG, device="cpu")


def _tokens(seed, B=2, T=32):
    return np.random.default_rng(seed).integers(0, JAX_CFG.vocab_size, (B, T)).astype(np.int32)


def _named(tree, prefix=""):
    """{"layers.wq": leaf, ...} of a params tree (JAX or torch)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_named(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def _assert_tree_close(got, want, tol=LEAF, free=None, free_atol=0.0):
    """Every leaf within ``tol``; where ``free`` (a {name: bool array})
    marks an element, within ``free_atol`` instead."""
    got, want = _named(got), _named(want)
    assert got.keys() == want.keys()
    for name in want:
        g, w = got[name].detach().numpy(), np.asarray(want[name])
        mask = np.zeros(w.shape, bool) if free is None else free[name]
        np.testing.assert_allclose(g[~mask], w[~mask], err_msg=name, **tol)
        assert np.abs(g[mask] - w[mask]).max(initial=0.0) <= free_atol, name


def test_next_token_nll_matches_reference():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 9, 40)).astype(np.float32)
    tokens = rng.integers(0, 40, (3, 9)).astype(np.int32)
    want = jax_llama.next_token_nll(jnp.asarray(logits), jnp.asarray(tokens))
    got = llama.next_token_nll(torch.from_numpy(logits), torch.from_numpy(tokens))
    np.testing.assert_allclose(float(got), float(want), **LOSS)


def test_next_token_nll_ignores_the_last_position():
    """Shift-and-mask: the last position has no target and its logits
    do not move the loss; the sliced form gives the same value."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((2, 7, 11)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 11, (2, 7)))
    base = llama.next_token_nll(logits, tokens)
    moved = logits.clone()
    moved[:, -1] += 100.0
    assert float(llama.next_token_nll(moved, tokens)) == float(base)
    sliced = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, 11), tokens[:, 1:].reshape(-1))
    np.testing.assert_allclose(float(base), float(sliced), rtol=1e-6)


def test_loss_and_every_gradient_match_reference(jax_params):
    tokens = _tokens(3)
    want_loss, want_grads = jax.value_and_grad(jax_llama.loss_fn)(
        jax_params, jnp.asarray(tokens), JAX_CFG)
    params = _torch_params(jax_params)
    for leaf in llama.param_leaves(params):
        leaf.requires_grad_()
    loss = llama.loss_fn(params, torch.from_numpy(tokens), CFG)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **LOSS)
    grads = {name: leaf.grad for name, leaf in _named(params).items()}
    _assert_tree_close(grads, _named(want_grads))
    assert all(float(g.abs().max()) > 0 for g in grads.values())


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_optax_adamw(jax_params, steps):
    """Consecutive steps on fresh tokens: loss before each update and
    every leaf after the last one, against ``optax.adamw`` (steps past
    the first cover Adam's bias correction)."""
    optimizer = jax_llama.make_optimizer()
    jparams, opt_state = jax_params, optimizer.init(jax_params)
    params = _torch_params(jax_params)
    topt = llama.make_optimizer(params)
    near_zero = {name: np.zeros(leaf.shape, bool) for name, leaf in _named(params).items()}
    for step in range(steps):
        tokens = _tokens(10 + step)
        jparams, opt_state, want = jax_llama.train_step(
            jparams, opt_state, jnp.asarray(tokens), JAX_CFG, optimizer)
        got = llama.train_step(params, topt, torch.from_numpy(tokens), CFG)
        np.testing.assert_allclose(float(got), float(want), err_msg=f"step {step}", **LOSS)
        for name, leaf in _named(params).items():
            near_zero[name] |= np.abs(leaf.grad.numpy()) <= LEAF["atol"]
    # A handful: under one element in a thousand a step.
    assert sum(int(m.sum()) for m in near_zero.values()) * 1000 < steps * sum(
        m.size for m in near_zero.values())
    _assert_tree_close(params, jparams, free=near_zero, free_atol=2 * 3e-4 * steps)


def test_make_optimizer_is_the_references_adamw():
    params = llama.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    opt = llama.make_optimizer(params)
    (group,) = opt.param_groups
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        3e-4, (0.9, 0.95), 1e-8, 0.1)
    leaves = list(llama.param_leaves(params))
    assert len(group["params"]) == len(leaves) == 11
    assert all(a is b and a.requires_grad for a, b in zip(group["params"], leaves))
    assert llama.make_optimizer(params, lr=1e-3).param_groups[0]["lr"] == 1e-3


def test_train_step_runs_and_improves():
    """The reference's test_train_step_runs_and_improves: five steps on
    one batch lower the loss."""
    params = llama.init_params(
        dataclasses.replace(CFG, dtype="bfloat16"), torch.Generator().manual_seed(0),
        device="cpu")
    opt = llama.make_optimizer(params, lr=1e-3)
    tokens = torch.from_numpy(_tokens(20))
    losses = [float(llama.train_step(params, opt, tokens, CFG)) for _ in range(5)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_use_flash_false_forces_the_dense_op(monkeypatch):
    """``use_flash=False`` takes the dense op even past
    ``flash_attention_min_len``; the default takes the tiled op there."""
    calls = []
    attention = port("ops.attention")
    real = attention.causal_gqa_attention

    def dense(*args, **kwargs):
        calls.append("dense")
        return real(*args, **kwargs)

    def tiled(*args, **kwargs):
        raise AssertionError("the tiled op ran")

    monkeypatch.setattr(llama, "causal_gqa_attention", dense)
    cfg = dataclasses.replace(CFG, flash_attention_min_len=8)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(_tokens(21, 1, 16))
    want = llama.forward(params, tokens, cfg)  # tiled op: 16 keys >= 8
    assert calls == []
    monkeypatch.setattr(llama, "flash_gqa_attention", tiled)
    got = llama.forward(params, tokens, cfg, use_flash=False)
    assert calls == ["dense"] * cfg.n_layers
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_loss_fn_differentiates_through_the_dense_op(monkeypatch):
    """The training loss never reaches a kernel wrapper."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran in the loss")

    monkeypatch.setattr(llama, "flash_gqa_attention_cuda", refuse)
    monkeypatch.setattr(llama, "flash_gqa_attention", refuse)
    params = llama.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    llama.make_optimizer(params)
    loss = llama.loss_fn(params, torch.from_numpy(_tokens(22, 1, 2048 // 64)), CFG)
    loss.backward()
    for key in ("wq", "wk", "wv", "ln1"):
        grad = params["layers"][key].grad
        assert grad is not None and bool(grad.isfinite().all())
        assert all(float(g.abs().max()) > 0 for g in grad)  # every layer


# ---------------------------------------------------------- the grad guard


def _qkv(device, requires_grad):
    g = torch.Generator().manual_seed(5)
    q = torch.randn(1, 8, 4, 64, generator=g)
    k = torch.randn(1, 8, 2, 64, generator=g)
    v = torch.randn(1, 8, 2, 64, generator=g)
    return [x.to(device).requires_grad_(requires_grad) for x in (q, k, v)]


def _decode_inputs(device, requires_grad):
    g = torch.Generator().manual_seed(6)
    q = torch.randn(2, 4, 64, generator=g).to(device).requires_grad_(requires_grad)
    kv = torch.randn(4, 2, 16, 2, 64, generator=g).to(device)
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=device)
    ctx = torch.tensor([20, 7], dtype=torch.int32, device=device)
    return q, kv, table, ctx


WRAPPERS = {
    "flash_gqa_attention_cuda": lambda dev, rg: port("ops.flash_cuda").flash_gqa_attention_cuda(
        *_qkv(dev, rg)),
    "flash_partial_cuda": lambda dev, rg: port("ops.ring_flash_cuda").flash_partial_cuda(
        *_qkv(dev, rg))[0],
    "paged_decode_attention_cuda": lambda dev, rg: port(
        "ops.paged_decode_cuda").paged_decode_attention_cuda(*_decode_inputs(dev, rg)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_refuse_autograd_off_the_cpu(name):
    """Off the CPU the guard comes first, before any device check or
    launch: a (meta) input that requires grad raises RuntimeError, the
    same input without grad reaches the device check."""
    with pytest.raises(RuntimeError, match=f"{name}: the kernel is forward-only"):
        WRAPPERS[name]("meta", True)
    with pytest.raises(ValueError, match="unsupported device"):
        WRAPPERS[name]("meta", False)
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported device"):
        WRAPPERS[name]("meta", True)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_differentiate_on_the_cpu(name):
    """On the CPU a wrapper is its plain version, which autograd
    records."""
    out = WRAPPERS[name]("cpu", True)
    assert out.grad_fn is not None
    out.float().sum().backward()


def test_refuse_grad_decides_on_grad_mode_and_requires_grad():
    build = port("ops._build")
    plain, tracked = torch.ones(2), torch.ones(2, requires_grad=True)
    build.refuse_grad("k", plain, plain)
    with pytest.raises(RuntimeError, match="k: the kernel is forward-only"):
        build.refuse_grad("k", plain, tracked)
    with torch.no_grad():
        build.refuse_grad("k", plain, tracked)
