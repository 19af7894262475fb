"""The port's paths over meshes that span processes, on the CPU.

Each case starts its own gloo group of spawned processes on the loopback
interface (``tests/helpers/torch_dist.py``, a time limit a case) and
gathers what the processes return here, in the test:

- (a) the ring (``ring_attention_sharded`` over a hybrid mesh) over 4
  processes of one rank each, and over 2 processes of 2 ranks each
  (ici sp 2 x dcn sp 2), equals the single-controller ring bit for bit,
  both layouts, both bodies, with GQA, and the JAX ring within ``TOL``;
- (b) ``forward(sp_mesh=hybrid)`` over 2 processes of 2 ranks each
  equals the single-controller ring forward bit for bit and the JAX
  ``forward(sp_mesh=...)`` on 4 devices within ``LOGITS``;
- (c) one ``train_step`` at dp 2 across 2 processes (the reference's
  default DCN plan) equals the single-controller dp 2 step and the JAX
  ``train_step`` on a dp 2 mesh of 2 devices in loss, every gradient and
  every updated parameter, within ``test_torch_training.py``'s
  tolerances (training along every axis across processes:
  ``tests/test_torch_training_processes.py``; plain params over every
  layout of an ``sp_mesh`` across processes:
  ``tests/test_torch_plain_params_processes.py``).

Tolerances are those of ``test_torch_ring_attention.py`` (``TOL`` 1e-5
for float32 attention, ``LOGITS`` 5e-4 for logits after two layers) and
``test_torch_training.py`` (``LOSS`` rtol 1e-5, ``LEAF`` atol 1e-6 /
rtol 1e-4; Adam's first step is a sign step, so an element whose
gradient is within float32 noise of zero may step by up to 2 * lr)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from llm_d_kv_cache_manager_tpu.models import llama as jax_llama
from llm_d_kv_cache_manager_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from llm_d_kv_cache_manager_tpu.parallel import mesh as jax_mesh
from tests.helpers import torch_dist
from tests.helpers.torch_port import port

ring = port("ops.ring_attention")
mesh = port("parallel.mesh")
llama = port("models.llama")
sharding = port("parallel.sharding")

TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=5e-4, atol=5e-4)
LOSS = dict(rtol=1e-5)
LEAF = dict(atol=1e-6, rtol=1e-4)
LR = 3e-4
SP = mesh.AXIS_ORDER.index("sp")
# Each group's own time limit, spawn and imports included.
GROUP_S = 150.0

JAX_CFG = jax_llama.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                                d_ff=128, block_size=4, dtype="float32")


def _qkv(seed, B, T, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, T, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))


def _join_sp(results) -> torch.Tensor:
    """The chunks of every process joined along the sequence in sp
    order (each sp index once)."""
    chunks = {}
    for per_process in results:
        for coord, chunk in per_process.items():
            chunks.setdefault(coord[SP], chunk)
    return torch.cat([torch.from_numpy(chunks[s]) for s in sorted(chunks)], dim=1)


# ------------------------------------------------------------------ (a)

RING_LAYOUTS = [(4, 1, 4), (2, 2, 2)]  # processes, ranks a process (ici sp), dcn sp
RING_CASES = {f"{'striped' if s else 'contiguous'}-{impl}": (s, impl)
              for s in (False, True) for impl in ("einsum", "flash")}
RING_SHAPE = (2, 32, 4, 2, 8)  # B, T, H, Hkv, D: GQA groups of 2


@pytest.fixture(scope="module", params=RING_LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
def ring_runs(request):
    n, ici_sp, dcn_sp = request.param
    q, k, v = _qkv(50, *RING_SHAPE)
    cases = {name: (q, k, v, s, impl) for name, (s, impl) in RING_CASES.items()}
    results = torch_dist.run_group(torch_dist.ring_chunks, n, ici_sp, dcn_sp, cases,
                                   timeout=GROUP_S)
    return (q, k, v), results, ici_sp * dcn_sp


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_across_processes_equals_single_controller(ring_runs, case):
    (q, k, v), results, R = ring_runs
    striped, impl = RING_CASES[case]
    got = _join_sp([out[case] for out, _ in results])
    tq = [torch.from_numpy(x) for x in (q, k, v)]
    if striped:
        tq = [ring.stripe(x, R) for x in tq]
    single = ring.ring_attention_sharded(
        mesh.make_mesh(mesh.MeshPlan(dp=1, sp=R), ["cpu"] * R), striped=striped, impl=impl)(*tq)
    assert torch.equal(got, single)
    # ...and the JAX ring on R devices, in physical order.
    want = jax_ring_attention(*(jnp.asarray(x) for x in (q, k, v)),
                              jax_mesh.make_mesh(jax_mesh.MeshPlan(dp=1, sp=R),
                                                 jax.devices()[:R]),
                              striped=striped, impl=impl, interpret=impl == "flash")
    physical = ring.unstripe(got, R) if striped else got
    np.testing.assert_allclose(physical.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ici,dcn,n", [
    (dict(dp=1), dict(dp=1, pp=2, sp=2), 4),
    (dict(dp=1, sp=2), dict(dp=1, ep=2), 2),
], ids=["dcn-pp2-sp2", "ici-sp2-dcn-ep2"])
def test_ring_over_replicas_across_processes(ici, dcn, n):
    """A replica axis (pp, ep: the ring does not cut it) across processes:
    each process runs the rings of its own replica, every local chunk
    equal, bit for bit, to its rows of the single-controller ring."""
    q, k, v = _qkv(55, *RING_SHAPE)
    results = torch_dist.run_group(torch_dist.ring_replicas, n, ici, dcn, q, k, v,
                                   timeout=GROUP_S)
    merged = {a: ici.get(a, 1) * dcn.get(a, 1) for a in set(ici) | set(dcn)}
    R = merged["sp"]
    single = ring.ring_attention_sharded(
        mesh.make_mesh(mesh.MeshPlan(dp=1, sp=R), ["cpu"] * R), batch_axis=None)(
        *(torch.from_numpy(x) for x in (q, k, v)))
    t = q.shape[1] // R
    seen = 0
    for chunks, p2p in results:
        assert p2p == (R - 1 if dcn.get("sp", 1) > 1 else 0)
        for coord, chunk in chunks.items():
            s = coord[SP]
            assert torch.equal(torch.from_numpy(chunk), single[:, s * t:(s + 1) * t]), coord
            seen += 1
    assert seen == int(np.prod(list(merged.values())))


def test_ring_moves_chunks_through_the_group(ring_runs):
    """Every process sent and received its K/V chunk at each of the
    R - 1 rotations of each case, through the transport (gloo, CPU
    tensors: nothing staged)."""
    (q, k, v), results, R = ring_runs
    chunk = q.shape[0] * (q.shape[1] // R) * k.shape[2] * k.shape[3] * 4
    for _, log in results:
        assert len(log) == len(RING_CASES) * (R - 1)
        for rec in log:
            assert rec["bytes_out"] == rec["bytes_in"] == 2 * chunk
            assert rec["d2h_ms"] == rec["h2d_ms"] == 0


# ------------------------------------------------------------------ (b)


@pytest.fixture(scope="module")
def models():
    jparams = jax_llama.init_params(jax.random.PRNGKey(0), JAX_CFG)
    fields = torch_dist.cfg_fields(JAX_CFG)
    tcfg = llama.LlamaConfig(**{f.name: fields[f.name]
                                for f in dataclasses.fields(llama.LlamaConfig)})
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, tree, tcfg


FORWARD_RUNS = [(s, impl) for s in (False, True) for impl in ("einsum", "flash")]


@pytest.fixture(scope="module")
def forward_runs(models):
    _, tree, tcfg = models
    tokens = np.random.default_rng(60).integers(0, JAX_CFG.vocab_size, (1, 32)).astype(np.int32)
    results = torch_dist.run_group(torch_dist.forward_chunks, 2, 2, 2, tree,
                                   torch_dist.cfg_fields(tcfg), tokens, FORWARD_RUNS,
                                   timeout=GROUP_S)
    return tokens, results


@pytest.mark.parametrize("striped,impl", FORWARD_RUNS,
                         ids=[f"{'striped' if s else 'contiguous'}-{i}" for s, i in FORWARD_RUNS])
def test_forward_across_processes_matches_single_controller_and_reference(
        models, forward_runs, striped, impl):
    jparams, tree, tcfg = models
    tokens, results = forward_runs
    got = _join_sp([out[striped, impl] for out in results])
    # Each process holds its own two ranks' logits, nothing else.
    assert all(len(out[striped, impl]) == 2 for out in results)
    if striped:
        got = ring.unstripe(got, 4)
    params = llama.params_from_numpy(tree, tcfg, device="cpu")
    single = llama.forward(params, torch.from_numpy(tokens), tcfg,
                           sp_mesh=mesh.make_mesh(mesh.MeshPlan(dp=1, sp=4), ["cpu"] * 4),
                           ring_striped=striped, ring_impl=impl)
    assert torch.equal(got, single)
    want = jax_llama.forward(
        jparams, jnp.asarray(tokens), JAX_CFG,
        sp_mesh=jax_mesh.make_mesh(jax_mesh.MeshPlan(dp=1, sp=4), jax.devices()[:4]),
        ring_striped=striped, ring_impl=impl, ring_interpret=impl == "flash")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


# ------------------------------------------------------------------ (c)


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _assert_step(got, want, grad, label):
    """``got`` within ``LEAF`` of ``want`` where the gradient ``grad`` is
    clear of float32 noise; elsewhere Adam's first (sign) step may move
    an element by up to 2 * lr."""
    free = np.abs(grad) <= LEAF["atol"]
    np.testing.assert_allclose(got[~free], want[~free], err_msg=label, **LEAF)
    assert np.abs(got[free] - want[free]).max(initial=0.0) <= 2 * LR, label


def test_train_step_dp_across_processes_matches_single_controller_and_reference(models):
    jparams, tree, tcfg = models
    tokens = np.random.default_rng(70).integers(0, JAX_CFG.vocab_size, (4, 16)).astype(np.int32)
    results = torch_dist.run_group(torch_dist.train_dp, 2, tree, torch_dist.cfg_fields(tcfg),
                                   tokens, timeout=GROUP_S)
    # The single controller: dp 2 over two devices, one replica each.
    tmesh = mesh.make_mesh(mesh.MeshPlan(dp=2), ["cpu:0", "cpu:1"])
    params = sharding.shard_tree(llama.params_from_numpy(tree, tcfg, device="cpu"), tmesh,
                                 llama.param_pspecs(tcfg))
    opt = llama.make_optimizer(params)
    loss = float(llama.train_step(params, opt, torch.from_numpy(tokens), tcfg))
    # The reference: its train step on a dp 2 mesh of two CPU devices,
    # and the gradient that step applies.
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshPlan(dp=2), jax.devices()[:2])
    jsharded = jax.device_put(jparams, jax.tree.map(lambda s: NamedSharding(jmesh, s),
                                                    jax_llama.param_pspecs(JAX_CFG)))
    optimizer = jax_llama.make_optimizer()
    jgrads = dict(_leaves(jax.grad(jax_llama.loss_fn)(jsharded, jnp.asarray(tokens), JAX_CFG)))
    jnew, _, jloss = jax_llama.train_step(jsharded, optimizer.init(jsharded),
                                          jnp.asarray(tokens), JAX_CFG, optimizer)
    jnew = dict(_leaves(jnew))
    for rank, got in enumerate(results):
        assert got["shape"]["dp"] == 2
        np.testing.assert_allclose(got["loss"], loss, **LOSS)
        np.testing.assert_allclose(got["loss"], float(jloss), **LOSS)
        for name, leaf in _leaves(params):
            assert got["held"][name][0] == rank  # each process its own dp replica
            want = leaf.locals[got["held"][name]]
            grad = want.grad.numpy()
            np.testing.assert_allclose(got["grads"][name], grad, err_msg=name, **LEAF)
            _assert_step(got["params"][name], want.detach().numpy(), grad, name)
            jgrad = np.asarray(jgrads[name])
            np.testing.assert_allclose(got["grads"][name], jgrad, err_msg=name, **LEAF)
            _assert_step(got["params"][name], np.asarray(jnew[name]), jgrad, name)
    # The two processes' replicas are the same bits.
    for name in results[0]["params"]:
        assert np.array_equal(results[0]["params"][name], results[1]["params"][name])


# ------------------------------------------------------------ transport


def test_transport_moves_only_the_pairings_it_names():
    """gloo moves CPU tensors and stages CUDA ones through pinned host
    buffers; NCCL moves CUDA tensors; any other pairing raises."""
    pg = port("parallel.process_group")
    t = object.__new__(pg.MeshTransport)
    t.backend = "gloo"
    assert t._staged(torch.device("cpu")) is False
    assert t._staged(torch.device("cuda", 0)) is True
    t.backend = "nccl"
    assert t._staged(torch.device("cuda", 0)) is False
    with pytest.raises(RuntimeError, match="nccl backend does not move a cpu tensor"):
        t._staged(torch.device("cpu"))
    t.backend = "mpi"
    with pytest.raises(RuntimeError, match="mpi backend"):
        t._staged(torch.device("cpu"))
    with pytest.raises(RuntimeError, match="no torch.distributed group"):
        pg.MeshTransport(mesh.make_mesh(mesh.MeshPlan(dp=1), ["cpu"]))


def test_ring_of_several_processes_needs_a_transport():
    with pytest.raises(ValueError, match="needs their transport"):
        ring.Ring(["cpu"] * 2, processes=[0, 1], process=0)
    one = ring.Ring(["cpu"] * 3)
    assert one.local == [0, 1, 2] and one.transport is None
