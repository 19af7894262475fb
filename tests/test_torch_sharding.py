"""The port's sharded execution against the JAX reference, on the CPU.

The port's meshes are ``["cpu"] * n`` (ranks that share one device) or,
where a case says "per rank", ``["cpu:0", ..., "cpu:n-1"]``: torch keeps
every such tensor in host memory, but the device objects differ, so the
mesh holds one tensor per rank as it would over several cards, and the
paths' copies, cross-device moves and ``sync_replica_grads`` all run.  The
reference runs on the suite's eight virtual host devices, its params
placed with ``jax.device_put(params, NamedSharding(mesh, pspecs))``.
Inputs come from a numpy seed and go to both packages; weights are the
reference's, carried across by ``params_from_numpy``.

- ``param_pspecs`` (Llama, MoE) equal to the reference's, leaf for leaf;
- ``shard``: every local tensor bit-equal to the JAX array's shard on the
  same mesh coordinate, for every spec of both trees, a round trip
  through ``unshard``, and storage shared where ranks share a device and
  a slice, one tensor per rank on a per-rank mesh; ``sync_replica_grads``
  over copies on distinct tensors;
- the ring with heads cut over tp against ``ring_attention_sharded(
  head_axis="tp")``;
- Llama over tp 2 x sp 2 (the reference suite's sharded forward cases,
  einsum and flash bodies, both layouts), sharded prefill and decode at
  ``_dryrun_tp_decode``'s widths over dp 4 x tp 2 (float32), sharded
  train steps (tp 2 x sp 2, and ``_plan_for(8)``'s dp 1 x pp 2 x tp 2 x
  sp 2); per rank: prefill and decode over dp 4 x tp 2, train steps over
  dp 2 x tp 2 and ``_plan_for(8)``, every copy of a slice bit-equal to
  the others after each;
- MoE train steps over ep 2 x sp 2 and dp 2 x ep 2 x tp 2 (also per rank);
- a checkpoint restored onto dp 4 x tp 2.

Tolerances are those of the unsharded port tests for the same function:
logits 2e-4, pools 1e-5, losses 1e-5 relative,
leaves 1e-6 + 1e-4 |ref| with Adam's near-zero-gradient elements held to
2 lr a step (tests/test_torch_training.py says why); the MoE loss against
the unsharded loss at the reference suite's own 1e-3."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxNamedSharding

from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from llm_d_kv_cache_manager_tpu.models import moe as jax_moe
from llm_d_kv_cache_manager_tpu.ops.ring_attention import (
    ring_attention_sharded as jax_ring_sharded,
)
from llm_d_kv_cache_manager_tpu.parallel import mesh as jax_mesh
from tests.helpers.torch_port import port

llama = port("models.llama")
moe = port("models.moe")
checkpoint = port("models.checkpoint")
pool_mod = port("models.kv_cache_pool")
ring = port("ops.ring_attention")
mesh = port("parallel.mesh")
sharding = port("parallel.sharding")

LOGITS = dict(rtol=2e-4, atol=2e-4)
POOL = dict(rtol=1e-5, atol=1e-5)
LOSS = dict(rtol=1e-5)
LEAF = dict(atol=1e-6, rtol=1e-4)
LR = 3e-4

LLAMA_CFG = jax_llama.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                                  n_kv_heads=2, d_ff=128, block_size=4, dtype="float32")
# The reference's own sharded-training config (tests/test_checkpoint.py,
# at float32 as tests/test_torch_training.py runs it), 4 layers so pp 2
# has two a stage.
TRAIN_CFG = jax_llama.LlamaConfig(vocab_size=256, d_model=64, n_layers=4, n_heads=4,
                                  n_kv_heads=2, d_ff=128, dtype="float32")
# __graft_entry__._CFG's widths (the tp decode dry run), at float32.
DECODE_CFG = jax_llama.LlamaConfig(vocab_size=2048, d_model=256, n_layers=4, n_heads=8,
                                   n_kv_heads=4, d_ff=704, dtype="float32")
MOE_CFG = jax_moe.MoEConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=128, n_experts=4, top_k=2, dtype="float32")


def _port_cfg(module, jcfg):
    cls = module.MoEConfig if module is moe else module.LlamaConfig
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def _meshes(per_rank=False, **plan):
    n = int(np.prod(list(plan.values())))
    devices = [f"cpu:{i}" for i in range(n)] if per_rank else ["cpu"] * n
    return (jax_mesh.make_mesh(jax_mesh.MeshPlan(**plan), jax.devices()[:n]),
            mesh.make_mesh(mesh.MeshPlan(**plan), devices))


def _assert_copies_agree(tree, per_rank):
    """Every copy of a slice bit-equal to the others; on a per-rank mesh
    one tensor per rank."""
    for name, leaf in _named(tree).items():
        if per_rank:
            assert len(leaf.distinct()) == leaf.locals.size, name
        groups = {}
        for coord, tensor in leaf.distinct():
            groups.setdefault(leaf.shard_index(coord), []).append(tensor)
        for copies in groups.values():
            assert all(torch.equal(_bits(copies[0]), _bits(c)) for c in copies[1:]), name


def _jax_put(tree, jmesh, specs):
    return jax.device_put(tree, jax.tree.map(lambda s: JaxNamedSharding(jmesh, s), specs))


def _port_params(module, jparams, jcfg):
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return module.params_from_numpy(tree, _port_cfg(module, jcfg), device="cpu")


def _named(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_named(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def _tokens(seed, B, T, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(np.int32)


def _bits(x):
    x = x.detach().contiguous()
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x.view(torch.int32)


@pytest.fixture(scope="module")
def llama_params():
    return jax_llama.init_params(jax.random.PRNGKey(0), LLAMA_CFG)


@pytest.fixture(scope="module")
def train_params():
    return jax_llama.init_params(jax.random.PRNGKey(0), TRAIN_CFG)


@pytest.fixture(scope="module")
def moe_params():
    return jax_moe.init_params(jax.random.PRNGKey(0), MOE_CFG)


# ------------------------------------------------------------ specs, shard


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_param_pspecs_match_reference(family):
    ours, ref, cfg = ((llama, jax_llama, LLAMA_CFG) if family == "llama"
                      else (moe, jax_moe, MOE_CFG))
    want = _named(ref.param_pspecs(cfg))
    got = _named(ours.param_pspecs(_port_cfg(ours, cfg)))
    assert got.keys() == want.keys()
    for name, spec in want.items():
        assert isinstance(got[name], sharding.P)
        assert tuple(got[name]) == tuple(spec), name


@pytest.mark.parametrize("family,plan,per_rank", [
    ("llama", dict(dp=1, pp=2, tp=2, sp=2), False),
    ("llama", dict(dp=4, tp=2), False),
    ("moe", dict(dp=2, ep=2, tp=2), False),
    ("llama", dict(dp=4, tp=2), True),
], ids=["llama-pp-tp-sp", "llama-dp-tp", "moe-dp-ep-tp", "llama-dp-tp-per-rank"])
def test_shard_matches_jax_shards(family, plan, per_rank, llama_params, moe_params):
    """Every local tensor equals, bit for bit, the data of the JAX shard
    on the device at the same mesh coordinate; unshard gives the tensor
    back; ranks on one device with one slice share storage, and a
    per-rank mesh holds one tensor per rank."""
    ours, jparams, jcfg = ((llama, llama_params, LLAMA_CFG) if family == "llama"
                           else (moe, moe_params, MOE_CFG))
    jmesh, tmesh = _meshes(per_rank, **plan)
    specs = ours.param_pspecs(_port_cfg(ours, jcfg))
    ref = jax_llama if ours is llama else jax_moe
    placed = _named(_jax_put(jparams, jmesh, ref.param_pspecs(jcfg)))
    tparams = _port_params(ours, jparams, jcfg)
    sharded = sharding.shard_tree(tparams, tmesh, specs)
    coords = {d.id: c for c, d in np.ndenumerate(jmesh.devices)}
    for name, leaf in _named(sharded).items():
        full = _named(tparams)[name]
        for shard in placed[name].addressable_shards:
            local = leaf.locals[coords[shard.device.id]]
            assert local.is_contiguous()
            np.testing.assert_array_equal(local.numpy(), np.asarray(shard.data), err_msg=name)
        assert torch.equal(_bits(sharding.unshard(leaf)), _bits(full)), name
        # Shared: one tensor per distinct slice, every rank on "cpu".
        # Per rank: one tensor per rank; a rank's replicas are the ranks
        # that hold its slice.
        slices = [leaf.shard_index(c) for c in np.ndindex(tmesh.devices.shape)]
        assert len(leaf.distinct()) == (len(slices) if per_rank else len(set(slices))), name
        for coord in np.ndindex(tmesh.devices.shape):
            same = leaf.replicas(**dict(zip(tmesh.axis_names, coord)))
            assert any(t is leaf.locals[coord] for t in same)
            assert len(same) == (slices.count(leaf.shard_index(coord)) if per_rank else 1)
        assert full.data_ptr() not in {t.data_ptr() for _, t in leaf.distinct()}


def test_shard_rejects_bad_specs():
    tmesh = mesh.make_mesh(mesh.MeshPlan(dp=1, tp=2), ["cpu"] * 2)
    x = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="divide"):
        sharding.shard(x, tmesh, sharding.P("tp"))
    with pytest.raises(ValueError, match="not an axis"):
        sharding.shard(x, tmesh, sharding.P("heads"))
    with pytest.raises(ValueError, match="more entries"):
        sharding.shard(x, tmesh, sharding.P(None, None, "tp"))
    with pytest.raises(ValueError, match="twice"):
        sharding.shard(x, tmesh, sharding.P("tp", "tp"))


def test_sync_replica_grads_sums_copies():
    """Copies of one slice on distinct tensors (as on distinct devices)
    each hold their ranks' share of the gradient; after the sync every
    copy holds the sum, in rank order, and a copy no rank used counts as
    zero.  Tensors shared by ranks are left alone."""
    tmesh = mesh.make_mesh(mesh.MeshPlan(dp=4), ["cpu"] * 4)
    x = sharding.shard(torch.zeros(3), tmesh, sharding.P(None))
    assert len(x.distinct()) == 1
    copies = [torch.zeros(3, requires_grad=True) for _ in range(4)]
    for i, t in enumerate(copies):
        x.locals[tmesh.coord(dp=i)] = t
        if i < 3:
            t.grad = torch.full((3,), float(i + 1))
    sharding.sync_replica_grads({"x": x})
    for t in copies:
        assert torch.equal(t.grad, torch.full((3,), 6.0))
    assert sharding.distinct_locals({"x": x}) == copies


# ------------------------------------------------------------ ring


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("striped", [False, True], ids=["contiguous", "striped"])
@pytest.mark.parametrize("plan", [dict(dp=1, tp=2, sp=2), dict(dp=2, tp=2, sp=2),
                                  dict(dp=1, tp=2, sp=4)], ids=str)
def test_ring_head_axis_matches_reference(plan, striped, impl):
    rng = np.random.default_rng(50 + plan["sp"])
    B, T, H, Hkv, D = 2, 16, 4, 2, 8
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, T, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    jmesh, tmesh = _meshes(**plan)
    want = jax_ring_sharded(jmesh, head_axis="tp", striped=striped, impl=impl,
                            interpret=impl == "flash")(*(jnp.asarray(a) for a in (q, k, v)))
    got = ring.ring_attention_sharded(tmesh, head_axis="tp", striped=striped, impl=impl)(
        *(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ llama


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("striped", [False, True], ids=["contiguous", "striped"])
def test_forward_sp_tp_mesh_matches_reference(llama_params, striped, impl):
    """test_llama_model.py's tp x sp cases: params cut by param_pspecs
    over tp 2 x sp 2, the ring per head shard, against the reference's
    sharded logits and the dense forward (2e-4, its own tolerance)."""
    jmesh, tmesh = _meshes(dp=1, tp=2, sp=2)
    tokens = _tokens(10, 2, 32, LLAMA_CFG.vocab_size)
    jsharded = _jax_put(llama_params, jmesh, jax_llama.param_pspecs(LLAMA_CFG))
    want = jax_llama.forward(jsharded, jnp.asarray(tokens), LLAMA_CFG, sp_mesh=jmesh,
                             ring_striped=striped, ring_impl=impl,
                             ring_interpret=impl == "flash")
    tcfg = _port_cfg(llama, LLAMA_CFG)
    tparams = _port_params(llama, llama_params, LLAMA_CFG)
    sharded = sharding.shard_tree(tparams, tmesh, llama.param_pspecs(tcfg))
    got = llama.forward(sharded, torch.from_numpy(tokens), tcfg, sp_mesh=tmesh,
                        ring_striped=striped, ring_impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    dense = llama.forward(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **LOGITS)


@pytest.mark.parametrize("plan", [dict(dp=2, tp=2, sp=2), dict(dp=1, pp=2, tp=2, sp=2),
                                  dict(dp=4, tp=2)], ids=str)
def test_forward_without_ring_matches_reference(llama_params, plan):
    """Sharded params without ``sp_mesh``: each sequence chunk attends
    over the K/V chunks gathered up to its own."""
    jmesh, tmesh = _meshes(**plan)
    tokens = _tokens(11, 4, 32, LLAMA_CFG.vocab_size)
    want = jax_llama.forward(_jax_put(llama_params, jmesh, jax_llama.param_pspecs(LLAMA_CFG)),
                             jnp.asarray(tokens), LLAMA_CFG)
    tcfg = _port_cfg(llama, LLAMA_CFG)
    sharded = sharding.shard_tree(_port_params(llama, llama_params, LLAMA_CFG), tmesh,
                                  llama.param_pspecs(tcfg))
    got = llama.forward(sharded, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


@pytest.fixture(scope="module")
def decode_params():
    return jax_llama.init_params(jax.random.PRNGKey(2), DECODE_CFG)


@pytest.mark.parametrize("plan,per_rank", [
    (dict(dp=4, tp=2), False), (dict(dp=1, tp=2), False), (dict(dp=2, pp=2, tp=2), False),
    (dict(dp=4, tp=2), True)], ids=["dp4-tp2", "tp2", "dp2-pp2-tp2", "dp4-tp2-per-rank"])
def test_sharded_prefill_and_decode_match_reference(decode_params, plan, per_rank):
    """_dryrun_tp_decode's widths and mesh (dp 4 x tp 2; also tp alone
    and with pp, and per rank): a sharded prefill_paged,
    prefill_continue and two decode steps over a pool cut on its kv
    heads, logits and pool against the reference's on the same mesh;
    per rank, every dp copy of a pool slice written alike."""
    jcfg = DECODE_CFG
    tcfg = _port_cfg(llama, jcfg)
    jmesh, tmesh = _meshes(per_rank, **plan)
    B, T, Ts, max_blocks = 4, 32, 16, 4
    tokens = _tokens(12, B, T + Ts + 2, jcfg.vocab_size)
    table = (np.arange(max_blocks)[None] + max_blocks * np.arange(B)[:, None]).astype(np.int32)
    spec = (None, None, None, None, "tp", None)
    shape = (jcfg.n_layers, B * max_blocks, 2, jcfg.block_size, jcfg.n_kv_heads,
             jcfg.head_dim)
    jpool = jax.device_put(jnp.zeros(shape, jnp.float32),
                           JaxNamedSharding(jmesh, jax.sharding.PartitionSpec(*spec)))
    jparams = _jax_put(decode_params, jmesh, jax_llama.param_pspecs(jcfg))
    tpool = pool_mod.KVCachePool(
        pool_mod.KVCachePoolConfig(*shape[:2], jcfg.block_size, jcfg.n_kv_heads, jcfg.head_dim,
                                   "float32"),
        sharding=sharding.NamedSharding(tmesh, sharding.P(*spec)))
    assert tpool.kv.local_shape == shape[:4] + (jcfg.n_kv_heads // 2, jcfg.head_dim)
    tparams = sharding.shard_tree(_port_params(llama, decode_params, jcfg), tmesh,
                                  llama.param_pspecs(tcfg))
    nb = T // jcfg.block_size
    jlog, jpool = jax_llama.prefill_paged(jparams, jnp.asarray(tokens[:, :T]), jpool,
                                          jnp.asarray(table[:, :nb]), jcfg)
    tlog, _ = llama.prefill_paged(tparams, torch.from_numpy(tokens[:, :T]), tpool.kv,
                                  torch.from_numpy(table[:, :nb]), tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS)
    nc = (T + Ts) // jcfg.block_size
    jlog, jpool = jax_llama.prefill_continue(jparams, jnp.asarray(tokens[:, T:T + Ts]), jpool,
                                             jnp.asarray(table[:, :nc]), T, jcfg)
    tlog, _ = llama.prefill_continue(tparams, torch.from_numpy(tokens[:, T:T + Ts]), tpool.kv,
                                     torch.from_numpy(table[:, :nc]), T, tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS)
    for step in range(2):
        ctx = np.full((B,), T + Ts + 1 + step, np.int32)
        nxt = tokens[:, T + Ts + step]
        jlog, jpool = jax_llama.decode_step(jparams, jnp.asarray(nxt), jpool,
                                            jnp.asarray(table), jnp.asarray(ctx), jcfg)
        tlog, _ = llama.decode_step(tparams, torch.from_numpy(nxt), tpool.kv,
                                    torch.from_numpy(table), torch.from_numpy(ctx), tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS)
    np.testing.assert_allclose(sharding.unshard(tpool.kv).numpy(), np.asarray(jpool), **POOL)
    _assert_copies_agree({"kv": tpool.kv}, per_rank)
    # The pool's slices: each rank's local equals the JAX pool's shard.
    coords = {d.id: c for c, d in np.ndenumerate(jmesh.devices)}
    for shard in jpool.addressable_shards:
        np.testing.assert_allclose(tpool.kv.locals[coords[shard.device.id]].numpy(),
                                   np.asarray(shard.data), **POOL)


def test_sharded_decode_step_captured_on_cpu_is_eager(decode_params):
    """make_decode_step over a sharded pool on the CPU: nothing to
    capture, every call the eager sharded step (same logits, same pool)."""
    tcfg = _port_cfg(llama, DECODE_CFG)
    _, tmesh = _meshes(dp=2, tp=2)
    tparams = sharding.shard_tree(_port_params(llama, decode_params, DECODE_CFG), tmesh,
                                  llama.param_pspecs(tcfg))
    spec = sharding.NamedSharding(tmesh, sharding.P(None, None, None, None, "tp", None))
    cfgp = pool_mod.KVCachePoolConfig(tcfg.n_layers, 8, tcfg.block_size, tcfg.n_kv_heads,
                                      tcfg.head_dim, "float32")
    pools = [pool_mod.KVCachePool(cfgp, sharding=spec) for _ in range(2)]
    step = llama.make_decode_step(tparams, pools[0].kv, tcfg, 2, 4)
    assert step.graph is None
    table = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    for i in range(2):
        tokens, ctx = torch.tensor([3 + i, 5 + i]), torch.tensor([1 + i, 3 + i])
        got = step(tokens, table[:, :2], ctx)
        want, _ = llama.decode_step(tparams, tokens, pools[1].kv, table[:, :2], ctx, tcfg)
        assert torch.equal(got, want)
    assert torch.equal(sharding.unshard(pools[0].kv), sharding.unshard(pools[1].kv))


def test_sharded_paths_refuse_mismatched_pools(decode_params):
    tcfg = _port_cfg(llama, DECODE_CFG)
    _, tmesh = _meshes(dp=1, tp=2)
    plain = _port_params(llama, decode_params, DECODE_CFG)
    tparams = sharding.shard_tree(plain, tmesh, llama.param_pspecs(tcfg))
    cfgp = pool_mod.KVCachePoolConfig(tcfg.n_layers, 4, tcfg.block_size, tcfg.n_kv_heads,
                                      tcfg.head_dim, "float32")
    plain_pool = pool_mod.KVCachePool(cfgp, device="cpu")
    heads_whole = pool_mod.KVCachePool(cfgp, sharding=sharding.NamedSharding(
        tmesh, sharding.P(None)))
    tokens, table = torch.zeros((1, 4), dtype=torch.long), torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(TypeError, match="sharded pool"):
        llama.prefill_paged(tparams, tokens, plain_pool.kv, table, tcfg)
    with pytest.raises(ValueError, match="kv heads over tp"):
        llama.prefill_paged(tparams, tokens, heads_whole.kv, table, tcfg)
    with pytest.raises(TypeError, match="sharded params"):
        llama.prefill_paged(plain, tokens, heads_whole.kv, table, tcfg)
    with pytest.raises(TypeError, match="unsharded params"):
        llama.prefill_chunked(tparams, tokens, plain_pool.kv, table, tcfg, chunk_tokens=4)
    with pytest.raises(TypeError, match="unsharded pool"):
        heads_whole.gather_to_host([0])


def _near_zero(params):
    return {name: np.abs(leaf.grad.numpy()) <= LEAF["atol"]
            for name, leaf in _named(params).items()}


def _assert_leaves(got, want, free, steps):
    for name, leaf in _named(got).items():
        g, w = leaf.detach().numpy(), np.asarray(want[name])
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g[~free[name]], w[~free[name]], err_msg=name, **LEAF)
        assert np.abs(g[free[name]] - w[free[name]]).max(initial=0.0) <= 2 * LR * steps, name


@pytest.mark.parametrize("plan,per_rank", [
    (dict(dp=1, tp=2, sp=2), False), (dict(dp=1, pp=2, tp=2, sp=2), False),
    (dict(dp=2, tp=2, sp=2), False), (dict(dp=2, tp=2), True),
    (dict(dp=1, pp=2, tp=2, sp=2), True),
], ids=["tp2-sp2", "pp2-tp2-sp2", "dp2-tp2-sp2", "dp2-tp2-per-rank", "pp2-tp2-sp2-per-rank"])
def test_sharded_train_step_matches_reference(train_params, plan, per_rank):
    """test_llama_model.py's sharded train step (tp 2 x sp 2) and
    _plan_for(8)'s mesh: the loss equals the unsharded loss (1e-5), every
    updated leaf is finite and within the leaf tolerance of the
    reference's sharded step.  Per rank, each rank's copies step on the
    replicas' summed gradient (``sync_replica_grads``) and stay equal."""
    jcfg, tcfg = TRAIN_CFG, _port_cfg(llama, TRAIN_CFG)
    jmesh, tmesh = _meshes(per_rank, **plan)
    tokens = _tokens(3, 2, 32, jcfg.vocab_size)
    optimizer = jax_llama.make_optimizer()
    jsharded = _jax_put(train_params, jmesh, jax_llama.param_pspecs(jcfg))
    jnew, _, jloss = jax_llama.train_step(jsharded, optimizer.init(jsharded),
                                          jnp.asarray(tokens), jcfg, optimizer)
    unsharded_loss = jax_llama.loss_fn(train_params, jnp.asarray(tokens), jcfg)
    sharded = sharding.shard_tree(_port_params(llama, train_params, jcfg), tmesh,
                                  llama.param_pspecs(tcfg))
    loss = llama.train_step(sharded, llama.make_optimizer(sharded), torch.from_numpy(tokens),
                            tcfg)
    np.testing.assert_allclose(float(loss), float(unsharded_loss), **LOSS)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS)
    free = {name: np.abs(sharding.unshard(sharding.grad_tree(leaf)).numpy()) <= LEAF["atol"]
            for name, leaf in _named(sharded).items()}
    _assert_leaves(sharding.unshard_tree(sharded), _named(jnew), free, 1)
    _assert_copies_agree(sharded, per_rank)



# ------------------------------------------------------------ MoE


@pytest.mark.parametrize("plan,B,per_rank", [
    (dict(dp=1, ep=2, sp=2), 2, False), (dict(dp=2, ep=2, tp=2), 4, False),
    (dict(dp=2, ep=2, tp=2), 4, True)], ids=["ep-sp", "dp-ep-tp", "dp-ep-tp-per-rank"])
def test_sharded_moe_train_steps_match_reference(moe_params, plan, B, per_rank):
    """test_moe_model.py's sharded steps (ep 2 x sp 2; dp 2 x ep 2 x tp
    2, two steps) under the mesh, against the reference's on the same
    mesh: losses within 1e-5 of its, the first within 1e-3 of the
    unsharded loss (the reference's tolerance), leaves finite and within
    the leaf tolerance of its updated ones; per rank, every copy of a
    slice equal to the others after each step."""
    jcfg, tcfg = MOE_CFG, _port_cfg(moe, MOE_CFG)
    jmesh, tmesh = _meshes(per_rank, **plan)
    tokens = _tokens(4, B, 32, jcfg.vocab_size)
    optimizer = jax_moe.make_optimizer()
    jparams = _jax_put(moe_params, jmesh, jax_moe.param_pspecs(jcfg))
    opt_state = optimizer.init(jparams)
    sharded = sharding.shard_tree(_port_params(moe, moe_params, jcfg), tmesh,
                                  moe.param_pspecs(tcfg))
    topt = moe.make_optimizer(sharded)
    free = {name: np.zeros(leaf.shape, bool) for name, leaf in _named(sharded).items()}
    unsharded = float(jax_moe.loss_fn(moe_params, jnp.asarray(tokens), jcfg))
    for step in range(2):
        with jmesh:
            jparams, opt_state, jloss = jax_moe.train_step(jparams, opt_state,
                                                           jnp.asarray(tokens), jcfg, optimizer)
        with mesh.activate(tmesh):
            loss = moe.train_step(sharded, topt, torch.from_numpy(tokens), tcfg)
        np.testing.assert_allclose(float(loss), float(jloss), err_msg=f"step {step}", **LOSS)
        if step == 0:
            np.testing.assert_allclose(float(loss), unsharded, rtol=1e-3)
        for name, leaf in _named(sharded).items():
            free[name] |= np.abs(sharding.unshard(sharding.grad_tree(leaf)).numpy()) <= LEAF["atol"]
        _assert_copies_agree(sharded, per_rank)
    _assert_leaves(sharding.unshard_tree(sharded), _named(jparams), free, 2)


def test_sharded_moe_forward_matches_reference(moe_params):
    """The forward over dp 2 x ep 2 x tp 2: global routing, so logits and
    aux equal the unsharded reference's."""
    jcfg, tcfg = MOE_CFG, _port_cfg(moe, MOE_CFG)
    _, tmesh = _meshes(dp=2, ep=2, tp=2)
    tokens = _tokens(5, 4, 32, jcfg.vocab_size)
    want, want_aux = jax_moe.forward(moe_params, jnp.asarray(tokens), jcfg)
    sharded = sharding.shard_tree(_port_params(moe, moe_params, jcfg), tmesh,
                                  moe.param_pspecs(tcfg))
    with mesh.activate(tmesh):
        got, aux = moe.forward(sharded, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_constrain_is_a_no_op_outside_a_mesh():
    """Outside a mesh ``_constrain`` returns its input, as the
    reference's does; under ``activate`` every rank holds the slice that
    the reference's constrained array holds on the device at the same
    coordinate (exact)."""
    x = np.arange(16.0, dtype=np.float32).reshape(8, 2)
    assert not mesh.mesh_is_active() and not jax_mesh.mesh_is_active()
    t = torch.from_numpy(x)
    assert moe._constrain(t, sharding.P("dp", "tp")) is t
    jmesh, tmesh = _meshes(dp=4, tp=2)
    with jax_mesh.activate(jmesh):
        want = jax.jit(lambda v: jax_moe._constrain(v, jax.sharding.PartitionSpec("dp", "tp")))(
            jnp.asarray(x))
    with mesh.activate(tmesh):
        placed = moe._constrain(t, sharding.P("dp", "tp"))
    assert isinstance(placed, sharding.Sharded) and placed.local_shape == (2, 1)
    coords = {d.id: c for c, d in np.ndenumerate(jmesh.devices)}
    for shard in want.addressable_shards:
        np.testing.assert_array_equal(placed.locals[coords[shard.device.id]].numpy(),
                                      np.asarray(shard.data))
    assert torch.equal(sharding.unshard(placed), t)


# ------------------------------------------------------------ checkpoint


def test_sharded_restore_onto_mesh(tmp_path, train_params):
    """test_checkpoint.py's sharded restore: params saved unsharded,
    restored onto dp 4 x tp 2 targets; every local bit-equal to the JAX
    shard on the same coordinate and to its slice of the saved tensor."""
    jmesh, tmesh = _meshes(dp=4, tp=2)
    tcfg = _port_cfg(llama, TRAIN_CFG)
    params = _port_params(llama, train_params, TRAIN_CFG)
    path = checkpoint.save_checkpoint(os.fspath(tmp_path / "ckpt"), params)
    specs = llama.param_pspecs(tcfg)

    def named(spec):
        if isinstance(spec, dict):
            return {k: named(v) for k, v in spec.items()}
        return sharding.NamedSharding(tmesh, spec)

    target = checkpoint.abstract_like(params, named(specs))
    restored = checkpoint.restore_checkpoint(path, target)
    assert restored is target
    assert restored["embed"].sharding == sharding.NamedSharding(tmesh, specs["embed"])
    placed = _named(_jax_put(train_params, jmesh, jax_llama.param_pspecs(TRAIN_CFG)))
    coords = {d.id: c for c, d in np.ndenumerate(jmesh.devices)}
    for name, leaf in _named(restored).items():
        full = _named(params)[name]
        for coord, local in leaf.distinct():
            assert torch.equal(local, full[leaf.slices(leaf.shard_index(coord))]), name
        for shard in placed[name].addressable_shards:
            np.testing.assert_array_equal(leaf.locals[coords[shard.device.id]].numpy(),
                                          np.asarray(shard.data), err_msg=name)
    # A sharded state saves whole and restores into plain targets.
    again = checkpoint.restore_checkpoint(
        checkpoint.save_checkpoint(os.fspath(tmp_path / "again"), restored),
        checkpoint.abstract_like(params))
    for name, leaf in _named(again).items():
        assert torch.equal(leaf, _named(params)[name]), name
