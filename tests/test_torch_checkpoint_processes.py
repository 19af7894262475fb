"""Checkpoints of a state sharded across processes, on the CPU.

Two spawned processes in a gloo group (``tests/helpers/torch_dist.py``,
``checkpoint_across``) take one float32 ``train_step`` of the Llama on
dcn tp 2 and save the state: the params, AdamW's state laid out as the
params (``checkpoint.optimizer_state_tree``) and bf16 params of the same
weights, each process writing only its own slices.  Then:

- the state as the processes held it, assembled here, saved by this one
  process, and both checkpoints restored here without a target (plain
  CPU tensors): every leaf bit-equal, bf16 and float32;
- the checkpoint restored here onto pp 2 x tp 2 of one process: every
  local bit-equal to its slice of the saved state;
- restored in the group onto the same layout and onto dcn pp 2: every
  local bit-equal to its slice of the saved state; each process's read
  plan asks for exactly the bytes of its own slices (one copy of each)
  and its plain tensors, and the processes' writes add up to the
  state's bytes, each slice written once;
- one step resumed from each restore in the group (params and optimizer
  state) gives the uninterrupted second step's loss within ``LOSS``
  (``tests/test_torch_training.py``'s)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from tests.helpers import torch_dist
from tests.helpers.torch_port import port

checkpoint = port("models.checkpoint")
llama = port("models.llama")
mesh = port("parallel.mesh")
sharding = port("parallel.sharding")

LOSS = dict(rtol=1e-5)
GROUP_S = 150.0
LAYOUTS = {"same": dict(dp=1, tp=2), "pp": dict(dp=1, pp=2)}
JAX_CFG = jax_llama.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                                d_ff=128, block_size=4, dtype="float32")


def _cfg():
    return llama.LlamaConfig(**{f.name: getattr(JAX_CFG, f.name)
                                for f in dataclasses.fields(llama.LlamaConfig)})


def _torch(array, dtype):
    tensor = torch.from_numpy(array)
    return tensor.view(torch.bfloat16) if dtype == torch.bfloat16 else tensor


@pytest.fixture(scope="module")
def across(tmp_path_factory):
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG))
    rng = np.random.default_rng(100)
    tokens = [rng.integers(0, JAX_CFG.vocab_size, (2, 16)).astype(np.int32) for _ in range(2)]
    folder = str(tmp_path_factory.mktemp("ckpt") / "tp")
    results = torch_dist.run_group(torch_dist.checkpoint_across, 2, tree,
                                   torch_dist.cfg_fields(_cfg()), tokens, folder, LAYOUTS,
                                   timeout=GROUP_S)
    return folder, results


def _layout():
    """The saved state's leaves: {name: (shape, dtype, spec or None)}."""
    cfg = _cfg()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    specs = dict(torch_dist._named(llama.param_pspecs(cfg)))
    out = {}
    for prefix, dtype in (("params", torch.float32), ("opt.exp_avg", torch.float32),
                          ("opt.exp_avg_sq", torch.float32), ("bf16", torch.bfloat16)):
        for name, leaf in torch_dist._named(params):
            out[f"{prefix}.{name}"] = (tuple(leaf.shape), dtype, specs[name])
    out["opt.step"] = ((), torch.float32, None)
    return out


def _global(results) -> dict:
    """The saved state as one process's tensors: each leaf assembled from
    the slices the processes held, every copy of a slice checked equal
    on the way."""
    tp_mesh = mesh.make_mesh(mesh.MeshPlan(dp=1, tp=2), ["cpu"] * 2)
    out = {}
    for name, (shape, dtype, spec) in _layout().items():
        if spec is None:
            values = [_torch(r["saved"][name], dtype) for r in results]
            assert all(torch.equal(v, values[0]) for v in values), name
            out[name] = values[0]
            continue
        like = sharding.zeros(shape, dtype, tp_mesh, spec)
        full = torch.empty(shape, dtype=dtype)
        seen = {}
        for r in results:
            for coord, array in r["saved"][name].items():
                index = like.shard_index(coord)
                value = _torch(array, dtype)
                if index in seen:
                    assert torch.equal(value, seen[index]), (name, coord)
                seen[index] = value
                full[like.slices(index)] = value
        assert len(seen) == len({like.shard_index(c) for c, _ in like.distinct()}), name
        out[name] = full
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, value in flat.items():
        node = out
        *parents, last = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = value
    return out


def _bits(tensor):
    tensor = tensor.detach()
    return tensor.view(torch.int16) if tensor.dtype == torch.bfloat16 else tensor


def test_restored_on_one_process_equals_a_single_process_save(across, tmp_path):
    """Both checkpoints, restored without a target, are the same tensors
    bit for bit, in their dtypes (bf16 and float32)."""
    folder, results = across
    state = _global(results)
    single = checkpoint.save_checkpoint(str(tmp_path / "single"), _nest(state))
    got = dict(torch_dist._named(checkpoint.restore_checkpoint(folder)))
    want = dict(torch_dist._named(checkpoint.restore_checkpoint(single)))
    tensors = {k for k, v in want.items() if isinstance(v, torch.Tensor)}
    assert tensors == set(state)
    for name in tensors:
        assert got[name].dtype == want[name].dtype == state[name].dtype, name
        assert torch.equal(_bits(got[name]), _bits(want[name])), name
        assert torch.equal(_bits(got[name]), _bits(state[name])), name
    assert got["opt.hyper.betas"] == (0.9, 0.95)  # the group's settings, as saved


def test_restored_onto_pp_tp_on_one_process(across):
    """Onto pp 2 x tp 2 of one process (``abstract_like`` targets): every
    local tensor bit-equal to its slice of the saved state."""
    folder, results = across
    state = _global(results)
    target_mesh = mesh.make_mesh(mesh.MeshPlan(dp=1, pp=2, tp=2), ["cpu"] * 4)
    cfg = _cfg()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shardings = jax.tree.map(lambda s: sharding.NamedSharding(target_mesh, s),
                             llama.param_pspecs(cfg), is_leaf=lambda x: isinstance(x, sharding.P))
    target_params = checkpoint.abstract_like(params, shardings)
    target = {"params": target_params,
              "opt": checkpoint.optimizer_state_like(llama.make_optimizer(target_params),
                                                     target_params),
              "bf16": checkpoint.abstract_like(
                  {k: v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else v
                   for k, v in params.items()} | {"layers": {k: v.to(torch.bfloat16) for k, v in
                                                             params["layers"].items()}},
                  shardings)}
    restored = dict(torch_dist._named(checkpoint.restore_checkpoint(folder, target)))
    for name, leaf in restored.items():
        if not isinstance(leaf, sharding.Sharded):
            continue
        for coord, local in leaf.distinct():
            want = state[name][leaf.slices(leaf.shard_index(coord))]
            assert torch.equal(_bits(local), _bits(want)), (name, coord)
    assert torch.equal(restored["opt.step"], state["opt.step"])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_restored_across_processes_holds_the_saved_slices(across, layout):
    """In the group, onto the same layout and onto dcn pp 2: every local
    of every process bit-equal to its slice of the saved state."""
    _, results = across
    state = _global(results)
    plan = LAYOUTS[layout]
    like_mesh = mesh.make_mesh(mesh.MeshPlan(**plan), ["cpu"] * 2)
    layout_of = _layout()
    for r in results:
        row = r[layout]
        assert list(row["crossing"]) == [a for a, n in plan.items() if n > 1]
        for name, held in row["held"].items():
            shape, dtype, spec = layout_of[name]
            if spec is None:
                assert torch.equal(_torch(held, dtype), state[name]), name
                continue
            like = sharding.zeros(shape, dtype, like_mesh, spec)
            for coord, array in held.items():
                want = state[name][like.slices(like.shard_index(coord))]
                assert torch.equal(_bits(_torch(array, dtype)), _bits(want)), (name, coord)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_each_process_reads_only_its_own_slices(across, layout):
    """A process's read plan asks for exactly one copy of each of its own
    slices and its plain tensors; no process reads another's."""
    _, results = across
    for r in results:
        assert r[layout]["read"] == r[layout]["own"], (layout, r[layout]["read"],
                                                       r[layout]["own"])


def test_each_slice_is_written_once(across):
    """Each process writes the slices whose first holder (in coordinate
    order) is one of its ranks, a replicated leaf by process 0 only, and
    the plain step at most; the writes add up to the state's bytes."""
    _, results = across
    state = _global(results)
    tp_mesh = mesh.make_mesh(mesh.MeshPlan(dp=1, tp=2), ["cpu"] * 2)
    tp = mesh.AXIS_ORDER.index("tp")
    expected = [0, 0]
    for name, (shape, dtype, spec) in _layout().items():
        if spec is None:
            continue
        like = sharding.zeros(shape, dtype, tp_mesh, spec)
        first = {}
        for coord in np.ndindex(tp_mesh.devices.shape):
            first.setdefault(like.shard_index(coord), coord)
        for index, coord in first.items():
            expected[coord[tp]] += like.local(tp=coord[tp]).numel() * like.local().element_size()
    step = state["opt.step"].numel() * state["opt.step"].element_size()
    wrote = [r["wrote"] for r in results]
    assert sum(wrote) == sum(t.numel() * t.element_size() for t in state.values())
    assert all(w - e in (0, step) for w, e in zip(wrote, expected)), (wrote, expected)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_resumed_step_matches_the_uninterrupted_one(across, layout):
    _, results = across
    for r in results:
        assert r["losses"][0] == results[0]["losses"][0]
        np.testing.assert_allclose(r[layout]["resumed"], r["losses"][1], **LOSS)
