"""Training over meshes whose axes cross processes, on the CPU.

The cases of one world size run in one gloo group of spawned processes on
the loopback interface (``tests/helpers/torch_dist.py``, ``GROUP_S`` a
group; each world's run cached for the module).  Every process builds
its mesh with ``make_hybrid_mesh(ici, dcn)``, its params with
``shard_tree`` and takes one ``train_step``, then serves a ``forward``
on the same mesh under ``no_grad``.  Cases, ICI (a process's ranks) x
DCN (across processes):

- 2 processes: the Llama with dcn tp 2, pp 2 and sp 2, and ici tp 2 x dcn
  sp 2 (two ranks a process); the MoE (float32: known behaviour 1 of
  ROADMAP.md) with dcn ep 2 and dp 2;
- 4 processes: the Llama with dcn pp 2 x tp 2, the MoE with dcn dp 2 x
  ep 2.

Each case holds:

- the loss, every gradient and every updated leaf within ``LOSS`` /
  ``LEAF`` of the port's single controller on the merged mesh (one CPU
  device a rank, so that every copy of a slice is a tensor of its own),
  and of ``jax.value_and_grad(loss_fn)`` and ``train_step`` on a JAX CPU
  mesh of the same shape; Adam's first step is a sign step, so an
  element whose gradient is within ``LEAF``'s atol of zero may step by up
  to 2 * lr (known behaviour 5);
- the copies of one slice bit-equal across processes (params and
  gradients), and the loss the same bits in every process;
- the forward serving this process's finite logits;
- backward transfers along every crossing axis, logged apart from the
  forward's.

Bit-equal and within tolerance: the loss is the single controller's bits
in every case (the forward's collectives sum in rank order, and the loss
adds the processes' shard sums in the single controller's order); the
gradients and updated leaves are within tolerance only.  Autograd adds a
tensor's gradient contributions in the order its graph finishes them,
and a process's graph holds its own ranks only (and the adjoint sums run
over processes, after each process's own), so the float32 sums
associate differently from the single controller's.

Also: each differentiable transfer's backward against its adjoint on
small tensors (the hop, the broadcast, ``all_gather_ranks``,
``all_reduce_ranks`` with ``grad="sum"`` and ``"same"``), and a planted
collective order mismatch, which the backward reports as a
``CollectiveOrderError`` in both processes instead of waiting.

Tolerances are those of ``tests/test_torch_training.py``: ``LOSS`` rtol
1e-5, ``LEAF`` atol 1e-6 / rtol 1e-4."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxNamedSharding

from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from llm_d_kv_cache_manager_tpu.models import moe as jax_moe
from llm_d_kv_cache_manager_tpu.parallel import mesh as jax_mesh
from tests.helpers import torch_dist
from tests.helpers.torch_port import port

llama = port("models.llama")
moe = port("models.moe")
mesh = port("parallel.mesh")
sharding = port("parallel.sharding")

LOSS = dict(rtol=1e-5)
LEAF = dict(atol=1e-6, rtol=1e-4)
LR = 3e-4
# Each group's own time limit, spawn and imports included.
GROUP_S = 150.0

JAX_CFGS = {
    "llama": jax_llama.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                                   n_kv_heads=2, d_ff=128, block_size=4, dtype="float32"),
    "moe": jax_moe.MoEConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                             d_ff=64, n_experts=4, top_k=2, dtype="float32"),
}
JAX_MODELS = {"llama": jax_llama, "moe": jax_moe}
MODELS = {"llama": llama, "moe": moe}
B, T = 4, 16

# {world: {case: (ici, dcn, family)}}
CASES = {
    2: {"llama-dcn-tp": (dict(dp=1), dict(dp=1, tp=2), "llama"),
        "llama-dcn-pp": (dict(dp=1), dict(dp=1, pp=2), "llama"),
        "llama-dcn-sp": (dict(dp=1), dict(dp=1, sp=2), "llama"),
        "llama-ici-tp-dcn-sp": (dict(dp=1, tp=2), dict(dp=1, sp=2), "llama"),
        "moe-dcn-ep": (dict(dp=1), dict(dp=1, ep=2), "moe"),
        "moe-dcn-dp": (dict(dp=1), dict(dp=2), "moe")},
    4: {"llama-dcn-pp-tp": (dict(dp=1), dict(dp=1, pp=2, tp=2), "llama"),
        "moe-dcn-dp-ep": (dict(dp=1), dict(dp=2, ep=2), "moe")},
}
WORLD = {case: world for world, cases in CASES.items() for case in cases}
ALL = [case for cases in CASES.values() for case in cases]


def _port_cfg(family):
    jcfg = JAX_CFGS[family]
    cls = llama.LlamaConfig if family == "llama" else moe.MoEConfig
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def _named(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_named(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def _merged(case):
    ici, dcn, _ = CASES[WORLD[case]][case]
    return {a: ici.get(a, 1) * dcn.get(a, 1) for a in mesh.AXIS_ORDER}


@pytest.fixture(scope="module")
def inputs():
    trees = {f: jax.tree_util.tree_map(np.asarray, JAX_MODELS[f].init_params(
        jax.random.PRNGKey(0), JAX_CFGS[f])) for f in JAX_CFGS}
    tokens = np.random.default_rng(90).integers(0, 128, (B, T)).astype(np.int32)
    return trees, tokens


def _run_world(world, trees, tokens):
    """Every process's answer for the cases of ``world`` (and, for 2,
    the adjoints and the planted order mismatch)."""
    cases = {name: (ici, dcn, family, trees[family], torch_dist.cfg_fields(_port_cfg(family)),
                    tokens)
             for name, (ici, dcn, family) in CASES[world].items()}
    extras = (("adjoints", (7,)), ("order_mismatch", ())) if world == 2 else ()
    return torch_dist.run_group(torch_dist.training_group, world, cases, extras, timeout=GROUP_S)


def _single(case, trees, tokens):
    """(loss, {leaf: Sharded after the step, grads on its locals}) of the
    port's single controller on the merged mesh, one CPU device a rank."""
    family = CASES[WORLD[case]][case][2]
    model, cfg = MODELS[family], _port_cfg(family)
    plan = _merged(case)
    n = int(np.prod(list(plan.values())))
    tmesh = mesh.make_mesh(mesh.MeshPlan(**plan), [f"cpu:{i}" for i in range(n)])
    params = sharding.shard_tree(model.params_from_numpy(trees[family], cfg, device="cpu"),
                                 tmesh, model.param_pspecs(cfg))
    loss = float(model.train_step(params, model.make_optimizer(params),
                                  torch.from_numpy(tokens), cfg))
    return loss, _named(params)


def _reference(case, trees, tokens):
    """(loss, {leaf: gradient}, {leaf: updated}) of the JAX reference on
    a mesh of the merged shape of CPU devices: ``jax.grad(loss_fn)`` and
    ``train_step`` in one program."""
    family = CASES[WORLD[case]][case][2]
    jmodel, jcfg = JAX_MODELS[family], JAX_CFGS[family]
    plan = _merged(case)
    n = int(np.prod(list(plan.values())))
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshPlan(**plan), jax.devices()[:n])
    params = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, trees[family]),
        jax.tree.map(lambda s: JaxNamedSharding(jmesh, s), jmodel.param_pspecs(jcfg)))
    optimizer = jmodel.make_optimizer()
    with jmesh:
        grads, (new, _, loss) = jax.jit(lambda p, o, t: (
            jax.grad(jmodel.loss_fn)(p, t, jcfg), jmodel.train_step(p, o, t, jcfg, optimizer)))(
                params, optimizer.init(params), jnp.asarray(tokens))
    return (float(loss), {k: np.asarray(v) for k, v in _named(grads).items()},
            {k: np.asarray(v) for k, v in _named(new).items()})


@pytest.fixture(scope="module")
def results(inputs):
    """({world: [each process's answer]}, {case: _single}, {case:
    _reference}): the groups run in a thread of their own while the
    single controllers and the references run here."""
    trees, tokens = inputs
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="gloo-groups") as pool:
        futures = {world: pool.submit(_run_world, world, trees, tokens) for world in CASES}
        singles = {case: _single(case, trees, tokens) for case in ALL}
        references = {case: _reference(case, trees, tokens) for case in ALL}
        return {world: f.result() for world, f in futures.items()}, singles, references


def _slice(leaf, coord, array):
    """``array`` (global) at the slice the rank at ``coord`` holds."""
    return array[leaf.slices(leaf.shard_index(coord))]


def _assert_step(got, want, grad, label):
    """``got`` within ``LEAF`` of ``want`` where the gradient ``grad`` is
    clear of float32 noise; elsewhere Adam's first (sign) step may move
    an element by up to 2 * lr."""
    free = np.abs(grad) <= LEAF["atol"]
    np.testing.assert_allclose(got[~free], want[~free], err_msg=label, **LEAF)
    assert np.abs(got[free] - want[free]).max(initial=0.0) <= 2 * LR, label


@pytest.mark.parametrize("case", ALL)
def test_train_step_across_processes_matches_single_controller(results, case):
    runs, singles, _ = results
    loss, params = singles[case]
    for rank, out in enumerate(runs[WORLD[case]]):
        got = out[case]
        assert got["loss"] == loss, (rank, got["loss"], loss)  # the same bits
        for name, leaf in params.items():
            for coord, grad in got["grads"][name].items():
                want = leaf.locals[coord]
                label = f"{case} process {rank} {name} {coord}"
                np.testing.assert_allclose(grad, want.grad.numpy(), err_msg=label, **LEAF)
                _assert_step(got["params"][name][coord], want.detach().numpy(),
                             want.grad.numpy(), label)


@pytest.mark.parametrize("case", ALL)
def test_train_step_across_processes_matches_reference(results, case):
    runs, singles, references = results
    _, params = singles[case]  # the layout: which slice each coordinate holds
    jloss, jgrads, jnew = references[case]
    for rank, out in enumerate(runs[WORLD[case]]):
        got = out[case]
        np.testing.assert_allclose(got["loss"], jloss, **LOSS)
        for name, leaf in params.items():
            for coord, grad in got["grads"][name].items():
                label = f"{case} process {rank} {name} {coord}"
                want_grad = _slice(leaf, coord, jgrads[name])
                np.testing.assert_allclose(grad, want_grad, err_msg=label, **LEAF)
                _assert_step(got["params"][name][coord], _slice(leaf, coord, jnew[name]),
                             want_grad, label)


@pytest.mark.parametrize("case", ALL)
def test_copies_of_a_slice_are_bit_equal_across_processes(results, case):
    """Every process holds each of its slices' whole gradient and the
    same update: the copies of one slice in different processes are the
    same bits, and each leaf's slices cover it."""
    runs, singles, _ = results
    _, params = singles[case]
    outs = [out[case] for out in runs[WORLD[case]]]
    assert len({out["loss"] for out in outs}) == 1
    for name, leaf in params.items():
        seen = {}
        for out in outs:
            for coord, value in out["params"][name].items():
                index = leaf.shard_index(coord)
                pair = (value, out["grads"][name][coord])
                if index in seen:
                    assert all(np.array_equal(a, b) for a, b in zip(pair, seen[index])), \
                        (name, coord)
                seen[index] = pair
        assert len(seen) == len({leaf.shard_index(c) for c, _ in leaf.distinct()}), name


@pytest.mark.parametrize("case", ALL)
def test_forward_serves_on_the_training_mesh(results, case):
    """After the step, ``forward`` over the same mesh gives every local
    entry of every process finite logits."""
    for out in results[0][WORLD[case]]:
        got = out[case]
        assert got["forward"] == sorted(got["owned"]), case


@pytest.mark.parametrize("case", ALL)
def test_backward_transfers_run_over_the_crossing_axes(results, case):
    """The gradients went back over each crossing axis, logged under the
    ``:bwd`` kinds: a hop back along pp, an all-gather's adjoint along
    sp and dp (the MoE's routing), an all-reduce's along tp and ep, each
    collective behind its order check; nothing went over an axis that
    stays inside a process."""
    ici, dcn, _ = CASES[WORLD[case]][case]
    crossing = sorted(a for a, n in dcn.items() if n > 1)
    want = {"pp": "hop:pp:bwd", "sp": "all_gather:sp:bwd", "dp": "all_gather:dp:bwd",
            "tp": "all_reduce:tp:bwd", "ep": "all_reduce:ep:bwd"}
    for out in results[0][WORLD[case]]:
        got = out[case]
        assert sorted(got["crossing"]) == crossing
        kinds = got["transfers"]
        for axis in crossing:
            assert want[axis] in kinds, (axis, sorted(kinds))
            if axis != "pp":
                assert f"order:{axis}" in kinds, (axis, sorted(kinds))
        assert all(kind.split(":")[1] in crossing for kind in kinds), sorted(kinds)


def test_each_transfer_backward_is_its_adjoint(results):
    """On small tensors over dcn tp 2, the loss ``sum(w_p * output)`` in
    each process p: the hop's sender gets the receiver's weights; the
    broadcast's root gets the sum of every process's; each process's part
    of an ``all_gather_ranks`` gets the sum of the weights on its part;
    ``all_reduce_ranks`` gives every part the sum (``grad="sum"``) or
    its own process's weights (``"same"``)."""
    got = [out["adjoints"] for out in results[0][2]]
    np.testing.assert_array_equal(got[0]["hop"]["grad"], got[1]["hop"]["w"])
    assert got[1]["hop"]["grad"] is None
    np.testing.assert_array_equal(got[1]["broadcast"]["grad"],
                                  got[0]["broadcast"]["w"] + got[1]["broadcast"]["w"])
    assert got[0]["broadcast"]["grad"] is None
    for p in range(2):
        np.testing.assert_array_equal(got[p]["gather"]["grad"],
                                      got[0]["gather"]["w"][p] + got[1]["gather"]["w"][p])
        np.testing.assert_array_equal(got[p]["sum"]["grad"],
                                      got[0]["sum"]["w"] + got[1]["sum"]["w"])
        np.testing.assert_array_equal(got[p]["same"]["grad"], got[p]["same"]["w"])


def test_collective_order_mismatch_raises_a_clear_error(results):
    """The processes call two chained collectives on one sub-group in
    opposite orders: the first backward's order check finds them at
    different calls and raises in both processes, within the group's
    time limit, naming the calls."""
    for p, out in enumerate(results[0][2]):
        message = out["order_mismatch"]
        assert message.startswith("collective order mismatch along tp over processes [0, 1]"), \
            message
        assert f"(process {p}) is at the backward of" in message
        assert "all_reduce:tp:bwd #1" in message and "all_gather:tp:bwd #1" in message
