"""The port's checkpoints (``models/checkpoint.py``, over
``torch.distributed.checkpoint``) on the config of
tests/test_checkpoint.py: params (bf16 and float32) and AdamW state come
back bit for bit, into ``abstract_like`` targets too, and training
resumed from a checkpoint gives the uninterrupted run's loss exactly
(the reference's test_resume_training_continues).  Also the port's
resumed loss against the reference's resumed run, at float32, within
the loss tolerance of tests/test_torch_training.py."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import checkpoint as jax_checkpoint
from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from tests.helpers.torch_port import port

checkpoint = port("models.checkpoint")
llama = port("models.llama")
moe = port("models.moe")

CFG = llama.LlamaConfig(
    vocab_size=256,
    d_model=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
)


def _tokens(seed, B=2, T=32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, CFG.vocab_size, (B, T)).astype(np.int32))


def _trained(dtype, steps=1):
    """Params and an AdamW optimizer after ``steps`` train steps."""
    cfg = dataclasses.replace(CFG, dtype=dtype)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = llama.make_optimizer(params)
    for step in range(steps):
        llama.train_step(params, opt, _tokens(step), cfg)
    return params, opt


def _assert_equal(got, want, where="state"):
    """Same structure, tensors bit-equal in dtype and bytes, other
    leaves equal (tuples stay tuples)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for key in want:
            _assert_equal(got[key], want[key], f"{where}.{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype, where
        assert got.shape == want.shape, where
        assert torch.equal(got.detach().cpu().view(torch.uint8) if got.dim() else got.cpu(),
                           want.detach().cpu().view(torch.uint8) if want.dim() else want), where
    else:
        assert type(got) is type(want) and got == want, where


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_round_trip_is_bit_exact(tmp_path, dtype):
    params, opt = _trained(dtype, steps=2)
    state = {"params": params, "opt": opt.state_dict()}
    path = checkpoint.save_checkpoint(str(tmp_path / "ckpt"), state)
    assert path == str(tmp_path / "ckpt")
    target = checkpoint.abstract_like(state)
    # Python values in the target are overwritten with the saved ones.
    target["opt"]["param_groups"][0].update(lr=1.0, betas=(0.1, 0.2), weight_decay=0.0)
    restored = checkpoint.restore_checkpoint(path, target)
    assert restored is target
    _assert_equal(restored, state)
    steps = {float(s["step"]) for s in restored["opt"]["state"].values()}
    assert steps == {2.0}
    assert restored["opt"]["state"][0]["exp_avg"].dtype == getattr(torch, dtype)


def test_restore_without_a_target(tmp_path):
    """CPU tensors in their saved dtypes, lists as lists; dict keys come
    back as strings (an optimizer's int-keyed state needs a target)."""
    params, opt = _trained("bfloat16")
    state = {"params": params, "opt": opt.state_dict()}
    path = checkpoint.save_checkpoint(str(tmp_path / "ckpt"), state)
    restored = checkpoint.restore_checkpoint(path)
    _assert_equal(restored["params"], params)
    _assert_equal(restored["opt"]["param_groups"], state["opt"]["param_groups"])
    _assert_equal(restored["opt"]["state"],
                  {str(k): v for k, v in state["opt"]["state"].items()})


def test_abstract_like_builds_empty_targets():
    params, opt = _trained("bfloat16")
    state = {"params": params, "opt": opt.state_dict()}
    target = checkpoint.abstract_like(state, device="meta")
    embed = target["params"]["embed"]
    assert embed.device.type == "meta" and embed.dtype == torch.bfloat16
    assert embed.shape == params["embed"].shape and not embed.requires_grad
    assert target["opt"]["state"][3]["step"].device.type == "meta"
    assert target["opt"]["param_groups"] == state["opt"]["param_groups"]
    assert target["opt"]["param_groups"] is not state["opt"]["param_groups"]
    own = checkpoint.abstract_like(state)
    assert own["params"]["embed"].device.type == "cpu"
    assert own["opt"]["state"][0]["step"].shape == ()


def test_save_and_restore_keep_the_single_process_warning_quiet(tmp_path):
    params, _ = _trained("float32")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        path = checkpoint.save_checkpoint(str(tmp_path / "ckpt"), {"params": params})
        checkpoint.restore_checkpoint(path, checkpoint.abstract_like({"params": params}))
        checkpoint.restore_checkpoint(path)
    assert [str(w.message) for w in seen] == []


def test_save_overwrites_an_existing_checkpoint(tmp_path):
    first, _ = _trained("float32", steps=1)
    second, _ = _trained("float32", steps=2)
    path = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(path, {"params": first})
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        checkpoint.save_checkpoint(path, {"params": second})
    assert [str(w.message) for w in seen] == []
    _assert_equal(checkpoint.restore_checkpoint(path)["params"], second)


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_resume_training_continues(tmp_path, family):
    """The reference's test: the loss after save and restore equals an
    uninterrupted run's bit for bit, and so does every leaf after it."""
    if family == "llama":
        cfg, model = CFG, llama
    else:
        cfg = moe.MoEConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=128, n_experts=4)
        model = moe
    params = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = model.make_optimizer(params)
    tokens = _tokens(1)
    model.train_step(params, opt, tokens, cfg)
    state = {"params": params, "opt": opt.state_dict()}
    path = checkpoint.save_checkpoint(str(tmp_path / "ckpt"), state)
    target = checkpoint.abstract_like(state)
    loss_straight = model.train_step(params, opt, tokens, cfg)

    restored = checkpoint.restore_checkpoint(path, target)
    resumed = restored["params"]
    ropt = model.make_optimizer(resumed)
    ropt.load_state_dict(restored["opt"])
    loss_resumed = model.train_step(resumed, ropt, tokens, cfg)
    assert float(loss_straight) == float(loss_resumed)
    _assert_equal(resumed, params)


def test_resumed_loss_matches_the_references_resume(tmp_path):
    """Both sides save after one step, restore, and take the next step
    at float32: the losses agree within rtol 1e-5."""
    jcfg = jax_llama.LlamaConfig(**{**dataclasses.asdict(CFG), "dtype": "float32"})
    tcfg = dataclasses.replace(CFG, dtype="float32")
    tokens = _tokens(2)
    optimizer = jax_llama.make_optimizer()
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), jcfg)
    opt_state = optimizer.init(jparams)
    params = llama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                     device="cpu")
    topt = llama.make_optimizer(params)
    jparams, opt_state, _ = jax_llama.train_step(jparams, opt_state, jnp.asarray(tokens.numpy()),
                                                 jcfg, optimizer)
    llama.train_step(params, topt, tokens, tcfg)
    jstate = {"params": jparams, "opt": opt_state}
    jpath = jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), jstate)
    jstate = jax_checkpoint.restore_checkpoint(jpath, jax_checkpoint.abstract_like(jstate))
    _, _, want = jax_llama.train_step(jstate["params"], jstate["opt"],
                                      jnp.asarray(tokens.numpy()), jcfg, optimizer)
    state = {"params": params, "opt": topt.state_dict()}
    path = checkpoint.save_checkpoint(str(tmp_path / "port"), state)
    restored = checkpoint.restore_checkpoint(path, checkpoint.abstract_like(state))
    ropt = llama.make_optimizer(restored["params"])
    ropt.load_state_dict(restored["opt"])
    got = llama.train_step(restored["params"], ropt, tokens, tcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("side", ["ref", "port"])
def test_force_false_refuses_an_existing_checkpoint_force_true_overwrites(tmp_path, side):
    """Both packages: ``save_checkpoint(..., force=False)`` over an
    existing checkpoint raises ``ValueError: Destination <path> already
    exists.`` and leaves it as it was; ``force=True`` (the default)
    writes the new state over it."""
    if side == "ref":
        save, restore, make = (jax_checkpoint.save_checkpoint, jax_checkpoint.restore_checkpoint,
                               lambda v: jnp.asarray(v, jnp.float32))
    else:
        save, restore, make = (checkpoint.save_checkpoint, checkpoint.restore_checkpoint,
                               lambda v: torch.tensor(v, dtype=torch.float32))
    path = str(tmp_path / "ckpt")
    save(path, {"w": make([1.0, 2.0])})
    with pytest.raises(ValueError, match=r"^Destination .*ckpt already exists\.$") as refused:
        save(path, {"w": make([3.0, 4.0])}, force=False)
    assert str(refused.value) == f"Destination {path} already exists."
    np.testing.assert_array_equal(np.asarray(restore(path)["w"]), [1.0, 2.0])
    save(path, {"w": make([5.0, 6.0])}, force=True)
    np.testing.assert_array_equal(np.asarray(restore(path)["w"]), [5.0, 6.0])
