"""Plain params over an ``sp_mesh`` whose axes cross processes, on the CPU.

``llama.forward`` and ``moe.forward`` take plain params (one ordinary
tensor a leaf, the same in every process) over a ``make_hybrid_mesh``
``sp_mesh``: the MoE on any layout, the Llama wherever an axis besides
``sp`` is in use (the reference's ``ring_for_mesh`` routes the batch
over ``dp`` and the heads over ``tp``).  Both share the params onto the
mesh (``sharding.share_tree``) and run the sharded path.  Each layout
below runs in a gloo group of spawned processes on the loopback
interface (``tests/helpers/torch_dist.py:plain_forward``), one group for
the layouts of 2 processes and one for those of 4, each run once for
the module.  Layouts, ICI (a process's ranks) x DCN (across processes):

- MoE: dcn sp 2; ici sp 2 x dcn sp 2 (a ring of 4 over 2 processes);
  ici tp 2 x dcn sp 2; dcn dp 2 x dcn sp 2 (4 processes);
- Llama: ici tp 2 x dcn sp 2 and dcn dp 2 x dcn sp 2, each contiguous
  and striped.

Every process's logits locals are held:

- ``torch.equal`` to their rows of the port's single controller on the
  merged mesh with ``sharding.shard_tree`` params (striped: in the
  ring's stripe order, which the processes keep);
- for the MoE over sp alone, ``torch.equal`` to the port's one-process
  plain ``forward(sp_mesh=...)`` as well;
- within ``LOGITS`` of the JAX ``forward(sp_mesh=...)`` with the same
  plain params on the merged mesh of the CPU devices ``conftest.py``
  gives JAX, through its own ``ring_for_mesh``, which runs every layout
  here.

The MoE's aux is the same in every process, equal to the single
controller's and within ``AUX`` of the JAX aux.  Also: ``share_tree``'s
locals alias the plain leaves' storage wherever a slice is contiguous
and keep autograd's graph; with a leaf that requires grad the forward
over an ``sp_mesh`` of several processes raises (the ring's K/V moves
between processes carry no gradient) and runs under ``no_grad``.

Tolerances are ``tests/test_torch_serving_processes.py``'s: logits 2e-4,
aux rtol 1e-5, float32 throughout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from llm_d_kv_cache_manager_tpu.models import moe as jax_moe
from llm_d_kv_cache_manager_tpu.parallel import mesh as jax_mesh
from tests.helpers import torch_dist
from tests.helpers.torch_port import port

llama = port("models.llama")
moe = port("models.moe")
mesh = port("parallel.mesh")
ring = port("ops.ring_attention")
sharding = port("parallel.sharding")

LOGITS = dict(rtol=2e-4, atol=2e-4)
AUX = dict(rtol=1e-5)
# Each group's own time limit, spawn and imports included.
GROUP_S = 150.0
DP, SP = (mesh.AXIS_ORDER.index(a) for a in ("dp", "sp"))

JCFG = jax_llama.LlamaConfig(vocab_size=128, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
                             d_ff=128, block_size=4, dtype="float32")
MOE_CFG = jax_moe.MoEConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=128, n_experts=4, top_k=2, dtype="float32")
B, T = 4, 16

# name: (family, ici, dcn, processes, striped)
CASES = {
    "moe-sp2": ("moe", dict(dp=1), dict(dp=1, sp=2), 2, False),
    "moe-sp2xsp2": ("moe", dict(dp=1, sp=2), dict(dp=1, sp=2), 2, False),
    "moe-tp2xsp2": ("moe", dict(dp=1, tp=2), dict(dp=1, sp=2), 2, False),
    "moe-dp2xsp2": ("moe", dict(dp=1), dict(dp=2, sp=2), 4, False),
    "llama-tp2xsp2-contiguous": ("llama", dict(dp=1, tp=2), dict(dp=1, sp=2), 2, False),
    "llama-tp2xsp2-striped": ("llama", dict(dp=1, tp=2), dict(dp=1, sp=2), 2, True),
    "llama-dp2xsp2-contiguous": ("llama", dict(dp=1), dict(dp=2, sp=2), 4, False),
    "llama-dp2xsp2-striped": ("llama", dict(dp=1), dict(dp=2, sp=2), 4, True),
}
SP_ONLY = ["moe-sp2", "moe-sp2xsp2"]
# Run with every leaf requiring grad: sp alone (the Llama's own ring
# path), and the shared path of each family.
GRAD_CASES = {
    "grad-llama-sp2": ("llama", dict(dp=1), dict(dp=1, sp=2), 2, False),
    "grad-llama-tp2xsp2": ("llama", dict(dp=1, tp=2), dict(dp=1, sp=2), 2, False),
    "grad-moe-sp2": ("moe", dict(dp=1), dict(dp=1, sp=2), 2, False),
}


def _merged(ici, dcn) -> dict:
    return {a: ici.get(a, 1) * dcn.get(a, 1) for a in set(ici) | set(dcn)}


def _port_cfg(family):
    jcfg = JCFG if family == "llama" else MOE_CFG
    cls = llama.LlamaConfig if family == "llama" else moe.MoEConfig
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def _shard(full, coord, sp: int, dp: int) -> np.ndarray:
    """Rank ``coord``'s rows and chunk of a global [B, T, V]."""
    b, tl = full.shape[0] // dp, full.shape[1] // sp
    return full[coord[DP] * b : (coord[DP] + 1) * b, coord[SP] * tl : (coord[SP] + 1) * tl]


@pytest.fixture(scope="module")
def trees():
    return {"llama": jax_llama.init_params(jax.random.PRNGKey(7), JCFG),
            "moe": jax_moe.init_params(jax.random.PRNGKey(8), MOE_CFG)}


def _tokens(name) -> np.ndarray:
    family = CASES.get(name, GRAD_CASES.get(name))[0]
    vocab = (JCFG if family == "llama" else MOE_CFG).vocab_size
    seed = 30 + sorted(list(CASES) + list(GRAD_CASES)).index(name)
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(np.int32)


def _args(name, spec, trees) -> tuple:
    family, ici, dcn, _, striped = spec
    tree = jax.tree_util.tree_map(np.asarray, trees[family])
    return (family, ici, dcn, tree, torch_dist.cfg_fields(_port_cfg(family)), _tokens(name),
            striped)


@pytest.fixture(scope="module")
def groups(trees):
    """{processes: {case: [each process's result]}}: one gloo group for
    the cases of each process count, the grad cases in the group of 2."""
    out = {}
    for n in sorted({spec[3] for spec in CASES.values()}):
        cases = {name: _args(name, spec, trees) for name, spec in CASES.items() if spec[3] == n}
        grad = {name: _args(name, spec, trees) for name, spec in GRAD_CASES.items()
                if spec[3] == n}
        results = torch_dist.run_group(torch_dist.plain_forward, n, cases, grad, timeout=GROUP_S)
        out[n] = {name: [r[name] for r in results] for name in list(cases) + list(grad)}
    return out


def _single_controller(name, trees):
    """The port's single controller on the merged mesh, params cut by
    ``shard_tree``: (logits in the ring's layout, aux or None)."""
    family, ici, dcn, _, striped = CASES[name]
    merged = _merged(ici, dcn)
    model, cfg = (llama if family == "llama" else moe), _port_cfg(family)
    tmesh = mesh.make_mesh(mesh.MeshPlan(**merged), ["cpu"] * int(np.prod(list(merged.values()))))
    params = model.params_from_numpy(jax.tree_util.tree_map(np.asarray, trees[family]), cfg,
                                     device="cpu")
    tokens = torch.from_numpy(_tokens(name))
    sharded = sharding.shard_tree(params, tmesh, model.param_pspecs(cfg))
    if family == "moe":
        return moe.forward(sharded, tokens, cfg, sp_mesh=tmesh)
    logits = llama.forward(sharded, tokens, cfg, sp_mesh=tmesh, ring_striped=striped)
    return (ring.stripe(logits, merged["sp"]) if striped else logits), None


def _jax_reference(name, trees):
    """The JAX ``forward(sp_mesh=...)`` with the plain params on the
    merged mesh of CPU devices: (logits in the ring's layout, aux)."""
    family, ici, dcn, _, striped = CASES[name]
    merged = _merged(ici, dcn)
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshPlan(**merged),
                               jax.devices()[:int(np.prod(list(merged.values())))])
    tokens = jnp.asarray(_tokens(name))
    if family == "moe":
        logits, aux = jax_moe.forward(trees["moe"], tokens, MOE_CFG, sp_mesh=jmesh)
        return np.asarray(logits), float(aux)
    logits = np.asarray(jax_llama.forward(trees["llama"], tokens, JCFG, sp_mesh=jmesh,
                                          ring_striped=striped))
    if striped:
        logits = ring.stripe(torch.from_numpy(np.array(logits)), merged["sp"]).numpy()
    return logits, None


@pytest.mark.parametrize("name", list(CASES))
def test_logits_equal_single_controller_and_near_reference(groups, trees, name):
    family, ici, dcn, n, _ = CASES[name]
    merged = _merged(ici, dcn)
    sp, dp = merged["sp"], merged.get("dp", 1)
    results = groups[n][name]
    single, single_aux = _single_controller(name, trees)
    want, want_aux = _jax_reference(name, trees)
    seen = set()
    for rank, out in enumerate(results):
        assert out["spec"] == ("dp", "sp", None)
        # This process's logits: one local a (d, s) shard it owns.
        assert {(c[DP], c[SP]) for c in out["logits"]} == {(c[DP], c[SP])
                                                           for c in out["owned"]}
        for coord, logits in out["logits"].items():
            assert torch.equal(torch.from_numpy(logits), _shard(single, coord, sp, dp)), (
                name, rank, coord)
            np.testing.assert_allclose(logits, _shard(want, coord, sp, dp),
                                       err_msg=f"{name} {rank} {coord}", **LOGITS)
            seen.add((coord[DP], coord[SP]))
        if family == "moe":
            assert out["aux"] == float(single_aux), (name, rank)
            np.testing.assert_allclose(out["aux"], want_aux, **AUX)
    assert seen == {(d, s) for d in range(dp) for s in range(sp)}


@pytest.mark.parametrize("name", SP_ONLY)
def test_moe_over_sp_equals_one_process_plain_ring(groups, trees, name):
    """Over sp alone the shared path reproduces the one-process plain
    ring (every op on the whole sequence) bit for bit, aux too."""
    _, ici, dcn, n, _ = CASES[name]
    merged = _merged(ici, dcn)
    tmesh = mesh.make_mesh(mesh.MeshPlan(**merged), ["cpu"] * merged["sp"])
    cfg = _port_cfg("moe")
    params = moe.params_from_numpy(jax.tree_util.tree_map(np.asarray, trees["moe"]), cfg,
                                   device="cpu")
    plain, plain_aux = moe.forward(params, torch.from_numpy(_tokens(name)), cfg, sp_mesh=tmesh)
    for rank, out in enumerate(groups[n][name]):
        assert out["aux"] == float(plain_aux), (name, rank)
        for coord, logits in out["logits"].items():
            assert torch.equal(torch.from_numpy(logits), _shard(plain, coord, merged["sp"], 1)), (
                name, rank, coord)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_forward_with_grad_raises_and_runs_without(groups, name):
    """A leaf that requires grad: the forward refuses rather than give the
    leaves a gradient without the other processes' share; under
    ``no_grad`` the same call runs."""
    for rank, out in enumerate(groups[GRAD_CASES[name][3]][name]):
        assert out["error"] is not None, (name, rank)
        assert "carry no gradient" in out["error"]
        assert out["no_grad_ran"] is True


# (family, MeshPlan): sp alone (every slice whole), tp x pp (column
# slices copied, a stage's layers viewed), ep x tp (the MoE's experts).
SHARE_MESHES = [("llama", dict(dp=1, sp=4)), ("llama", dict(dp=1, pp=2, tp=2)),
                ("moe", dict(dp=1, ep=2, tp=2))]


@pytest.mark.parametrize("family,plan", SHARE_MESHES)
def test_share_tree_aliases_contiguous_slices(family, plan):
    """Each local is a view of the plain leaf's storage wherever its slice
    is contiguous (``data_ptr`` equal), a contiguous copy elsewhere, and
    bit-equal to ``shard_tree``'s; the locals keep autograd's graph, so a
    loss on them reaches the plain leaves."""
    model, cfg = (llama if family == "llama" else moe), _port_cfg(family)
    params = model.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    tmesh = mesh.make_mesh(mesh.MeshPlan(**plan), ["cpu"] * int(np.prod(list(plan.values()))))
    specs = model.param_pspecs(cfg)
    shared = sharding.share_tree(params, tmesh, specs)
    copied = sharding.shard_tree(params, tmesh, specs)
    views = copies = 0
    for leaf, got, want in zip(sharding.tree_leaves(params), sharding.tree_leaves(shared),
                               sharding.tree_leaves(copied)):
        for (coord, local), (_, other) in zip(got.distinct(), want.distinct()):
            piece = leaf[got.slices(got.shard_index(coord))]
            assert torch.equal(local, other) and local.is_contiguous()
            if piece.is_contiguous():
                assert local.data_ptr() == piece.data_ptr()
                views += 1
            else:
                assert local.untyped_storage().data_ptr() != leaf.untyped_storage().data_ptr()
                copies += 1
    assert views > 0
    assert copies == 0 if plan.get("tp", 1) == 1 else copies > 0
    leaves =[leaf.detach().requires_grad_() for leaf in sharding.tree_leaves(params)]
    tree = _rebuild(params, iter(leaves))
    total = sum(t.sum() for leaf in sharding.tree_leaves(sharding.share_tree(tree, tmesh, specs))
                for _, t in leaf.distinct())
    total.backward()
    assert all(leaf.grad is not None and bool((leaf.grad != 0).any()) for leaf in leaves)


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    return next(leaves)
