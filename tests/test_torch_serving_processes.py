"""The port's serving entry points over meshes whose axes cross processes,
on the CPU.

Each plan runs in one gloo group of spawned processes on the loopback
interface (``tests/helpers/torch_dist.py``, ``GROUP_S`` a group), every
process building its mesh with ``make_hybrid_mesh(ici, dcn)`` and its
params with ``shard_tree``; a module-scoped fixture a plan runs every
call once.  Plans, ICI (a process's ranks) x DCN (across processes):

- tp 2 x dp 2: the reference's default fleet (tp inside a process, dp
  over the processes), 2 processes of 2 ranks;
- dp 1 x tp 2: tp across 2 processes of one rank;
- tp 2 x pp 2: the stages in 2 processes of 2 ranks;
- dp 2 x pp 2 across 4 processes of one rank;
- tp 2 x sp 2: the sequence chunks in 2 processes of 2 ranks, through the
  gather path and the ring, contiguous and striped.

Each runs ``prefill_paged``, ``prefill_continue`` and two ``decode_step``
calls (sp 2: the three forwards instead of the decode steps, which sp
does not cut) over a pool cut on its kv heads, as
``tests/test_torch_sharding.py::test_sharded_prefill_and_decode_match_reference``
does, and holds them:

- every process's logits ``torch.equal`` to its rows of the port's
  single controller on the merged mesh, and within ``LOGITS`` of the JAX
  function on the same merged mesh of CPU devices;
- every process's pool locals bit-equal to the single controller's at
  the same coordinate and within ``POOL`` of the JAX pool's
  ``addressable_shards`` there; every copy of a slice bit-equal across
  processes;
- the transfers went over the crossing axes only.

Also: ``make_decode_step`` over a pool across processes is eager
(``graph is None``) and gives ``decode_step``'s logits and pool; the MoE
forward over ep, ep x dp, pp (ici ep 2) and sp x tp across processes, at
float32, bit-equal to the single controller and within ``LOGITS`` of the
JAX forward (aux within 1e-5).

Tolerances are ``tests/test_torch_sharding.py``'s for the same functions:
logits 2e-4, pools 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP

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
POOL = dict(rtol=1e-5, atol=1e-5)
AUX = dict(rtol=1e-5)
# Each group's own time limit, spawn and imports included.
GROUP_S = 150.0
DP, SP, TP = (mesh.AXIS_ORDER.index(a) for a in ("dp", "sp", "tp"))

# 4 layers, so that pp 2 has two a stage; 2 KV heads, one a tp rank.
JCFG = jax_llama.LlamaConfig(vocab_size=128, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
                             d_ff=128, block_size=4, dtype="float32")
MOE_CFG = jax_moe.MoEConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=128, n_experts=4, top_k=2, dtype="float32")
B, T, TS, MAX_BLOCKS = 4, 16, 8, 7  # prompt, continuation, table width (2 decode steps)
SPEC = (None, None, None, None, "tp", None)
FORWARDS = {"forward-gather": (False, False), "ring-contiguous": (True, False),
            "ring-striped": (True, True)}

# name: (ici, dcn, processes)
PLANS = {
    "tp2xdp2": (dict(dp=1, tp=2), dict(dp=2), 2),
    "dp1xtp2": (dict(dp=1), dict(dp=1, tp=2), 2),
    "tp2xpp2": (dict(dp=1, tp=2), dict(dp=1, pp=2), 2),
    "dp2xpp2": (dict(dp=1), dict(dp=2, pp=2), 4),
    "tp2xsp2": (dict(dp=1, tp=2), dict(dp=1, sp=2), 2),
}
CROSSING = {"tp2xdp2": {"dp"}, "dp1xtp2": {"tp"}, "tp2xpp2": {"pp"}, "dp2xpp2": {"dp", "pp"},
            "tp2xsp2": {"sp"}}


def _merged(name) -> dict:
    ici, dcn, _ = PLANS[name]
    return {a: ici.get(a, 1) * dcn.get(a, 1) for a in set(ici) | set(dcn)}


def _calls(name) -> list:
    if _merged(name).get("sp", 1) > 1:
        return ["prefill", "continue"] + list(FORWARDS)
    return ["prefill", "continue", "decode0", "decode1"]


def _port_cfg(module, jcfg):
    cls = module.MoEConfig if module is moe else module.LlamaConfig
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def _shard(full, coord, sp: int, dp: int) -> np.ndarray:
    """Rank ``coord``'s rows (and chunk) of a global [B, T, V] or [B, V]."""
    b = full.shape[0] // dp
    x = full[coord[DP] * b : (coord[DP] + 1) * b]
    if x.ndim == 3:
        tl = x.shape[1] // sp
        x = x[:, coord[SP] * tl : (coord[SP] + 1) * tl]
    return x


@pytest.fixture(scope="module")
def llama_params():
    return jax_llama.init_params(jax.random.PRNGKey(4), JCFG)


@pytest.fixture(scope="module")
def runs():
    """{plan: its run}, each plan run once for the module."""
    return {}


@pytest.fixture
def plan(request, runs, llama_params):
    """The run of the plan named by the test's parameter (see
    :func:`_run`)."""
    if request.param not in runs:
        runs[request.param] = _run(request.param, llama_params)
    return runs[request.param]


def _run(name, llama_params):
    """One plan through the processes, the port's single controller and
    the JAX reference on the merged mesh: (name, per-process results,
    {call: single-controller logits}, {call: JAX logits}, single
    controller's pool, JAX pool, JAX mesh)."""
    ici, dcn, n = PLANS[name]
    merged = _merged(name)
    ranks = int(np.prod(list(merged.values())))
    sp = merged.get("sp", 1)
    tree = jax.tree_util.tree_map(np.asarray, llama_params)
    tcfg = _port_cfg(llama, JCFG)
    rng = np.random.default_rng(20 + list(PLANS).index(name))
    tokens = rng.integers(0, JCFG.vocab_size, (B, T + TS + 2)).astype(np.int32)
    table = (np.arange(MAX_BLOCKS)[None] + MAX_BLOCKS * np.arange(B)[:, None]).astype(np.int32)
    inputs = dict(tokens=tokens, table=table, T=T, Ts=TS, decode=0 if sp > 1 else 2,
                  forwards=FORWARDS if sp > 1 else {}, captured=name == "tp2xdp2")
    results = torch_dist.run_group(torch_dist.serve_plan, n, ici, dcn, tree,
                                   torch_dist.cfg_fields(tcfg), inputs, timeout=GROUP_S)
    # The port's single controller on the merged mesh.
    tmesh = mesh.make_mesh(mesh.MeshPlan(**merged), ["cpu"] * ranks)
    tparams = sharding.shard_tree(llama.params_from_numpy(tree, tcfg, device="cpu"), tmesh,
                                  llama.param_pspecs(tcfg))
    tpool = torch_dist._pool(tcfg, tmesh, table.size)
    tt, tb = torch.from_numpy(tokens), torch.from_numpy(table)
    bs = JCFG.block_size
    single = {"prefill": llama.prefill_paged(tparams, tt[:, :T], tpool.kv, tb[:, :T // bs],
                                             tcfg)[0],
              "continue": llama.prefill_continue(tparams, tt[:, T:T + TS], tpool.kv,
                                                 tb[:, :(T + TS) // bs], T, tcfg)[0]}
    # The reference on the merged mesh of CPU devices.
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshPlan(**merged), jax.devices()[:ranks])
    jparams = jax.device_put(llama_params, jax.tree.map(lambda s: JaxNamedSharding(jmesh, s),
                                                        jax_llama.param_pspecs(JCFG)))
    jpool = jax.device_put(jnp.zeros((JCFG.n_layers, table.size, 2, bs, JCFG.n_kv_heads,
                                      JCFG.head_dim), jnp.float32),
                           JaxNamedSharding(jmesh, JaxP(*SPEC)))
    ref = {}
    ref["prefill"], jpool = jax_llama.prefill_paged(
        jparams, jnp.asarray(tokens[:, :T]), jpool, jnp.asarray(table[:, :T // bs]), JCFG)
    ref["continue"], jpool = jax_llama.prefill_continue(
        jparams, jnp.asarray(tokens[:, T:T + TS]), jpool, jnp.asarray(table[:, :(T + TS) // bs]),
        T, JCFG)
    for i in range(inputs["decode"]):
        ctx = np.full((B,), T + TS + 1 + i, np.int32)
        single[f"decode{i}"] = llama.decode_step(tparams, tt[:, T + TS + i], tpool.kv, tb,
                                                 torch.from_numpy(ctx), tcfg)[0]
        ref[f"decode{i}"], jpool = jax_llama.decode_step(
            jparams, jnp.asarray(tokens[:, T + TS + i]), jpool, jnp.asarray(table),
            jnp.asarray(ctx), JCFG)
    for call, (on_ring, striped) in inputs["forwards"].items():
        single[call] = llama.forward(tparams, tt[:, :T], tcfg, sp_mesh=tmesh if on_ring else None,
                                     ring_striped=striped)
        ref[call] = jax_llama.forward(jparams, jnp.asarray(tokens[:, :T]), JCFG,
                                      sp_mesh=jmesh if on_ring else None, ring_striped=striped)
        if striped:  # the processes give their chunks in the ring's stripe order
            single[call] = ring.stripe(single[call], sp)
            ref[call] = ring.stripe(torch.tensor(np.asarray(ref[call])), sp)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    return name, results, single, ref, tpool.kv, jpool, jmesh


@pytest.mark.parametrize("plan,call", [(name, call) for name in PLANS for call in _calls(name)],
                         indirect=["plan"])
def test_logits_equal_single_controller_and_near_reference(plan, call):
    name, results, single, ref, _, _, _ = plan
    merged = _merged(name)
    sp, dp = merged.get("sp", 1), merged.get("dp", 1)
    seen = set()
    for rank, out in enumerate(results):
        got = out[call]
        owned = {(c[DP], c[SP]) for c in out["owned"]}
        # This process's logits: one local a (d, s) shard it owns.
        assert {(c[DP], c[SP]) for c in got} == owned, (rank, sorted(got))
        for coord, logits in got.items():
            want = _shard(single[call], coord, sp, dp)
            assert torch.equal(torch.from_numpy(logits), want), (name, call, rank, coord)
            np.testing.assert_allclose(logits, _shard(ref[call], coord, sp, dp),
                                       err_msg=f"{name} {call} {rank} {coord}", **LOGITS)
            seen.add((coord[DP], coord[SP]))
    assert seen == {(d, s) for d in range(dp) for s in range(sp)}


@pytest.mark.parametrize("plan", list(PLANS), indirect=True)
def test_pool_locals_match_single_controller_and_reference(plan):
    name, results, _, _, tpool, jpool, jmesh = plan
    shards = {c: np.asarray(s.data) for s in jpool.addressable_shards
              for c, d in np.ndenumerate(jmesh.devices) if d.id == s.device.id}
    checked = 0
    for rank, out in enumerate(results):
        for coord, local in out["pool"].items():
            assert torch.equal(torch.from_numpy(local), tpool.locals[coord]), (name, rank, coord)
            np.testing.assert_allclose(local, shards[coord], err_msg=f"{name} {rank} {coord}",
                                       **POOL)
            checked += 1
    assert checked >= len(results)


@pytest.mark.parametrize("plan", list(PLANS), indirect=True)
def test_pool_copies_agree_across_processes(plan):
    """Every process holds copies of the slices of its tp indices, all
    alike: what one rank wrote reached every copy (dp, sp and pp
    replicas included)."""
    name, results, _, _, _, _, _ = plan
    _, dcn, n = PLANS[name]
    by_slice = {}
    for out in results:
        for coord, local in out["pool"].items():
            by_slice.setdefault(coord[TP], []).append(local)
    assert len(by_slice) == _merged(name).get("tp", 1)
    for t, copies in by_slice.items():
        # One copy in each process that holds tp index t.
        assert len(copies) == n // dcn.get("tp", 1), (name, t)
        for copy in copies[1:]:
            assert np.array_equal(copy, copies[0]), (name, t)
        assert np.abs(copies[0]).sum() > 0


@pytest.mark.parametrize("plan", list(PLANS), indirect=True)
def test_transfers_cross_only_the_crossing_axes(plan):
    name, results, _, _, _, _, _ = plan
    for out in results:
        # "p2p" is the ring's rotation, over sp.
        axes = {kind.split(":")[1] if ":" in kind else "sp" for kind in out["transfers"]}
        assert axes == CROSSING[name], (name, out["transfers"])
        assert all(n > 0 for n in out["transfers"].values())


@pytest.mark.parametrize("plan", list(PLANS), indirect=True)
def test_each_process_owns_its_block_of_the_mesh(plan):
    name, results, _, _, _, _, _ = plan
    ici, dcn, n = PLANS[name]
    owned = [set(map(tuple, out["owned"])) for out in results]
    assert all(len(o) == int(np.prod(list(ici.values()))) for o in owned)
    assert len(set().union(*owned)) == n * len(owned[0])


@pytest.mark.parametrize("plan", ["tp2xdp2"], indirect=True)
def test_make_decode_step_across_processes_is_eager(plan):
    """Over a pool whose mesh spans processes no graph is captured: every
    call is ``decode_step``, with its logits and its pool."""
    _, results, _, _, _, _, _ = plan
    for out in results:
        captured = out["captured"]
        assert captured["graph"] is True
        assert captured["logits"] == [True, True]
        assert captured["pool"] is True


# ------------------------------------------------------------ MoE

MOE_PLANS = {
    "tp2xep2": (dict(dp=1, tp=2), dict(dp=1, ep=2), 2),
    "ep2xdp2": (dict(dp=1), dict(dp=2, ep=2), 4),
    "ep2xpp2": (dict(dp=1, ep=2), dict(dp=1, pp=2), 2),
    "sp2xtp2": (dict(dp=1), dict(dp=1, sp=2, tp=2), 4),
}


@pytest.fixture(scope="module")
def moe_params():
    return jax_moe.init_params(jax.random.PRNGKey(5), MOE_CFG)


@pytest.mark.parametrize("name", list(MOE_PLANS))
def test_moe_forward_across_processes(moe_params, name):
    """Routing joins every process's tokens; each process runs its (ep,
    tp) ranks' experts and the products sum across processes in rank
    order: its logits equal the single controller's bit for bit and the
    JAX forward's within ``LOGITS``, and every process has the same aux
    (gathered along pp where the stages lie in two processes)."""
    ici, dcn, n = MOE_PLANS[name]
    merged = {a: ici.get(a, 1) * dcn.get(a, 1) for a in set(ici) | set(dcn)}
    ranks = int(np.prod(list(merged.values())))
    tcfg = _port_cfg(moe, MOE_CFG)
    tree = jax.tree_util.tree_map(np.asarray, moe_params)
    tokens = np.random.default_rng(6 + n).integers(0, MOE_CFG.vocab_size, (4, 16)).astype(np.int32)
    results = torch_dist.run_group(torch_dist.moe_plan, n, ici, dcn, tree,
                                   torch_dist.cfg_fields(tcfg), tokens, timeout=GROUP_S)
    tmesh = mesh.make_mesh(mesh.MeshPlan(**merged), ["cpu"] * ranks)
    tparams = sharding.shard_tree(moe.params_from_numpy(tree, tcfg, device="cpu"), tmesh,
                                  moe.param_pspecs(tcfg))
    single, single_aux = moe.forward(tparams, torch.from_numpy(tokens), tcfg)
    want, want_aux = jax_moe.forward(moe_params, jnp.asarray(tokens), MOE_CFG)
    dp, sp = merged.get("dp", 1), merged.get("sp", 1)
    for rank, out in enumerate(results):
        assert out["aux"] == float(single_aux)
        np.testing.assert_allclose(out["aux"], float(want_aux), **AUX)
        assert {c[DP] for c in out["logits"]} == {c[DP] for c in out["owned"]}
        for coord, logits in out["logits"].items():
            rows = _shard(single, coord, sp, dp)
            assert torch.equal(torch.from_numpy(logits), rows), (rank, coord)
            np.testing.assert_allclose(logits, _shard(np.asarray(want), coord, sp, dp), **LOGITS)
