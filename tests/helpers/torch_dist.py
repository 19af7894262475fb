"""gloo process groups on the CPU for the port's multi-process tests.

:func:`run_group` starts ``n`` processes with the ``spawn`` start method,
joins them in a gloo group over a ``FileStore`` in a temporary directory
(gloo's own connections on the loopback interface), runs one of this
module's functions in each and returns what each rank returned, or
raises with the traceback of a rank that failed.  Every call has a time
limit of its own.

The functions run in the children, which import this module and the
port only (no JAX): arguments and results are numpy arrays and plain
values.
"""

from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from tests.helpers.torch_port import port


def _child(rank, n, store, fn, args, results):
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=n, timeout=timedelta(seconds=60))
        try:
            value = fn(rank, n, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_group(fn, n: int, *args, timeout: float = 120.0) -> list:
    """``[fn(rank, n, *args) for rank in range(n)]``, each in its own
    process of one gloo group."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="gloo-") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_child, args=(r, n, os.path.join(tmp, "store"), fn, args,
                                                  results), daemon=True) for r in range(n)]
        for proc in procs:
            proc.start()
        got, failed = {}, []
        deadline = time.monotonic() + timeout
        try:
            while len(got) + len(failed) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{fn.__name__} over {n} processes: no answer from "
                                       f"ranks {sorted(set(range(n)) - set(got))} in {timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead and results.empty():
                        raise RuntimeError(f"{fn.__name__}: a process exited with {dead}")
                    continue
                if ok:
                    got[rank] = value
                else:
                    failed.append(f"rank {rank}:\n{value}")
        finally:
            for proc in procs:
                proc.join(timeout=10)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        if failed:
            raise RuntimeError("\n".join(failed))
        return [got[r] for r in range(n)]


# ------------------------------------------------------------ workers


def _mesh(ici: dict, dcn: dict, per_process: int):
    mesh = port("parallel.mesh")
    return mesh.make_hybrid_mesh(mesh.MeshPlan(**ici), mesh.MeshPlan(**dcn),
                                 devices=["cpu"] * per_process)


def _locals(sharded) -> dict:
    """{coordinate: numpy} of a Sharded's local tensors."""
    return {coord: t.detach().numpy().copy() for coord, t in sharded.distinct()}


def mesh_layout(rank, n, ici: dict, dcn: dict, per_process: int):
    """The hybrid mesh's shape, devices and processes, as this rank sees
    them, and which entries it owns."""
    devices = [f"cpu:{rank * per_process + j}" for j in range(per_process)]
    mesh = port("parallel.mesh")
    m = mesh.make_hybrid_mesh(mesh.MeshPlan(**ici), mesh.MeshPlan(**dcn), devices=devices)
    owned = [c for c in np.ndindex(m.devices.shape) if m.is_local(c)]
    return dict(shape=dict(m.shape), devices=[str(d) for d in m.devices.flat],
                processes=m.processes.tolist(), owned=owned, crossing=m.crossing_axes(),
                repr=repr(m))


def ring_chunks(rank, n, ici_sp: int, dcn_sp: int, cases: dict):
    """Each case ``{name: (q, k, v, striped, impl)}`` through
    ``ring_attention_sharded`` over ici sp x dcn sp (q/k/v in physical
    order; striped cases are striped first): {name: {coord: chunk}},
    and the point-to-point transfers of the transport's log."""
    ring = port("ops.ring_attention")
    mesh = _mesh(dict(dp=1, sp=ici_sp), dict(dp=1, sp=dcn_sp), ici_sp)
    R = ici_sp * dcn_sp
    out = {}
    for name, (q, k, v, striped, impl) in cases.items():
        q, k, v = (torch.from_numpy(x) for x in (q, k, v))
        if striped:
            q, k, v = (ring.stripe(x, R) for x in (q, k, v))
        out[name] = _locals(ring.ring_attention_sharded(mesh, striped=striped, impl=impl)(q, k, v))
    log = port("parallel.process_group").transport(mesh).log.records()
    return out, [r for r in log if r["kind"] == "p2p"]


def ring_replicas(rank, n, ici: dict, dcn: dict, q, k, v):
    """``ring_attention_sharded`` over the hybrid mesh ici x dcn, whose
    axes other than sp hold replicas: {coord: chunk} of every local
    entry, and the point-to-point transfers' count."""
    ring = port("ops.ring_attention")
    mesh = _mesh(ici, dcn, int(np.prod(list(ici.values()))))
    out = ring.ring_attention_sharded(mesh, batch_axis=None)(
        *(torch.from_numpy(x) for x in (q, k, v)))
    chunks = {c: t.numpy().copy() for c, t in np.ndenumerate(out.locals) if t is not None}
    log = port("parallel.process_group").transport(mesh).log.records()
    return chunks, sum(r["kind"] == "p2p" for r in log)


def _llama_cfg(fields: dict):
    return port("models.llama").LlamaConfig(**fields)


def forward_chunks(rank, n, ici_sp: int, dcn_sp: int, tree, fields: dict, tokens, runs):
    """``forward(sp_mesh=hybrid)`` of ``runs`` [(striped, impl)]:
    {(striped, impl): {coord: local logits}}."""
    llama = port("models.llama")
    cfg = _llama_cfg(fields)
    params = llama.params_from_numpy(tree, cfg, device="cpu")
    mesh = _mesh(dict(dp=1, sp=ici_sp), dict(dp=1, sp=dcn_sp), ici_sp)
    return {(striped, impl): _locals(llama.forward(params, torch.from_numpy(tokens), cfg,
                                                   sp_mesh=mesh, ring_striped=striped,
                                                   ring_impl=impl))
            for striped, impl in runs}


def train_dp(rank, n, tree, fields: dict, tokens):
    """One ``train_step`` over params sharded on the default hybrid mesh
    (dcn dp = n, one CPU device a process): the loss, every leaf's local
    copy after the step and its gradient, and what each leaf's locals
    are (one a process)."""
    llama = port("models.llama")
    sharding = port("parallel.sharding")
    cfg = _llama_cfg(fields)
    mesh = port("parallel.mesh").make_hybrid_mesh(devices=["cpu"])
    params = sharding.shard_tree(llama.params_from_numpy(tree, cfg, device="cpu"), mesh,
                                 llama.param_pspecs(cfg))
    opt = llama.make_optimizer(params)
    loss = float(llama.train_step(params, opt, torch.from_numpy(tokens), cfg))

    def leaves(tree, prefix=""):
        for key, value in tree.items():
            if isinstance(value, dict):
                yield from leaves(value, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", value

    out, grads, held = {}, {}, {}
    for name, leaf in leaves(params):
        (coord, tensor), = leaf.distinct()
        out[name] = tensor.detach().numpy().copy()
        grads[name] = tensor.grad.numpy().copy()
        held[name] = coord
    return dict(loss=loss, params=out, grads=grads, held=held, shape=dict(mesh.shape))


def training_guards(rank, n, tree, fields: dict, tokens, moe_fields: dict):
    """Over meshes whose tp, pp or sp (Llama) or ep or dp (MoE, whose
    routing joins the batch shards) crosses the processes: the error of
    ``loss_fn`` and of ``train_step``, and
    whether ``forward`` gave this process's logits; and the error of the
    MoE forward with plain params over an sp_mesh of several processes.
    {case: {"loss_fn": message, "train_step": message, "forward": shape}}."""
    llama, moe = port("models.llama"), port("models.moe")
    sharding = port("parallel.sharding")
    cfg = _llama_cfg(fields)
    params = llama.params_from_numpy(tree, cfg, device="cpu")
    tokens = torch.from_numpy(tokens)
    mcfg = moe.MoEConfig(**moe_fields)
    mparams = moe.init_params(mcfg, torch.Generator().manual_seed(0), device="cpu")
    out = {}
    for case, family, dcn in (("tp", "llama", dict(dp=1, tp=2)), ("pp", "llama", dict(dp=1, pp=2)),
                              ("sp", "llama", dict(dp=1, sp=2)), ("ep", "moe", dict(dp=1, ep=2)),
                              ("dp-moe", "moe", dict(dp=2))):
        mesh = _mesh(dict(dp=1), dcn, 1)
        model, p, c = (llama, params, cfg) if family == "llama" else (moe, mparams, mcfg)
        sharded = sharding.shard_tree(p, mesh, model.param_pspecs(c))
        row = {}
        for name, call in (("loss_fn", lambda: model.loss_fn(sharded, tokens, c)),
                           ("train_step", lambda: model.train_step(
                               sharded, model.make_optimizer(sharded), tokens, c))):
            try:
                call()
            except NotImplementedError as exc:
                row[name] = str(exc)
            else:
                row[name] = None
        with torch.no_grad():
            got = model.forward(sharded, tokens, c)
        logits = got[0] if family == "moe" else got
        row["forward"] = [list(t.shape) for _, t in logits.distinct()]
        row["finite"] = all(bool(t.isfinite().all()) for _, t in logits.distinct())
        out[case] = row
    sp_mesh = _mesh(dict(dp=1), dict(dp=1, sp=2), 1)
    try:
        moe.forward(mparams, tokens, mcfg, sp_mesh=sp_mesh)
    except NotImplementedError as exc:
        out["moe-plain-sp"] = str(exc)
    else:
        out["moe-plain-sp"] = None
    return out


def _pool(cfg, mesh, blocks: int):
    pool_mod, sharding = port("models.kv_cache_pool"), port("parallel.sharding")
    return pool_mod.KVCachePool(
        pool_mod.KVCachePoolConfig(cfg.n_layers, blocks, cfg.block_size, cfg.n_kv_heads,
                                   cfg.head_dim, "float32"),
        sharding=sharding.NamedSharding(mesh, sharding.P(None, None, None, None, "tp", None)))


def serve_plan(rank, n, ici: dict, dcn: dict, tree, fields: dict, inputs: dict):
    """The serving entry points over params and a head-sharded pool on
    the hybrid mesh ici x dcn (``ici``'s ranks a process, all on
    "cpu"): ``prefill_paged``, ``prefill_continue`` and ``inputs["decode"]``
    decode steps (when sp is 1), then the forwards of ``inputs["forwards"]``
    ({name: (ring, striped)}).  Returns each call's logits locals
    ({coord: numpy}), the pool's locals, the coordinates this process
    owns, the transfer log's kinds with their bytes, and, with
    ``inputs["captured"]``, ``make_decode_step`` over a copy of the pool
    held against ``decode_step``: {"graph": ..., "logits": [...], "pool": ...}."""
    llama, sharding = port("models.llama"), port("parallel.sharding")
    pg = port("parallel.process_group")
    cfg = _llama_cfg(fields)
    per_process = int(np.prod(list(ici.values())))
    mesh = _mesh(ici, dcn, per_process)
    params = sharding.shard_tree(llama.params_from_numpy(tree, cfg, device="cpu"), mesh,
                                 llama.param_pspecs(cfg))
    tokens, table = (torch.from_numpy(inputs[k]) for k in ("tokens", "table"))
    T, Ts, bs = inputs["T"], inputs["Ts"], cfg.block_size
    pool = _pool(cfg, mesh, table.numel())
    out = {"owned": [c for c in np.ndindex(mesh.devices.shape) if mesh.is_local(c)]}
    out["prefill"] = _locals(llama.prefill_paged(params, tokens[:, :T], pool.kv,
                                                 table[:, :T // bs], cfg)[0])
    out["continue"] = _locals(llama.prefill_continue(params, tokens[:, T:T + Ts], pool.kv,
                                                     table[:, :(T + Ts) // bs], T, cfg)[0])
    steps = [(tokens[:, T + Ts + i], torch.full((tokens.shape[0],), T + Ts + 1 + i,
                                                dtype=torch.int32))
             for i in range(inputs["decode"])]
    if inputs.get("captured"):
        copy = _pool(cfg, mesh, table.numel())
        for (_, a), (_, b) in zip(copy.kv.distinct(), pool.kv.distinct()):
            a.copy_(b)
        step = llama.make_decode_step(params, copy.kv, cfg, tokens.shape[0], table.shape[1])
    for i, (nxt, ctx) in enumerate(steps):
        logits = llama.decode_step(params, nxt, pool.kv, table, ctx, cfg)[0]
        out[f"decode{i}"] = _locals(logits)
        if inputs.get("captured"):
            got = step(nxt, table, ctx)
            out.setdefault("captured", {"graph": step.graph is None, "logits": []})
            out["captured"]["logits"].append(all(
                torch.equal(a, b) for (_, a), (_, b) in zip(got.distinct(), logits.distinct())))
    if inputs.get("captured"):
        out["captured"]["pool"] = all(torch.equal(a, b) for (_, a), (_, b)
                                      in zip(copy.kv.distinct(), pool.kv.distinct()))
    out["pool"] = _locals(pool.kv)
    for name, (ring, striped) in inputs.get("forwards", {}).items():
        out[name] = _locals(llama.forward(params, tokens[:, :T], cfg,
                                          sp_mesh=mesh if ring else None, ring_striped=striped))
    transfers = {}
    for rec in pg.transport(mesh).log.records():
        transfers[rec["kind"]] = transfers.get(rec["kind"], 0) + rec["bytes_out"] + rec["bytes_in"]
    out["transfers"] = transfers
    return out


def moe_plan(rank, n, ici: dict, dcn: dict, tree, fields: dict, tokens):
    """The MoE forward over params on the hybrid mesh ici x dcn: its
    logits locals and its aux loss."""
    moe, sharding = port("models.moe"), port("parallel.sharding")
    cfg = moe.MoEConfig(**fields)
    mesh = _mesh(ici, dcn, int(np.prod(list(ici.values()))))
    params = sharding.shard_tree(moe.params_from_numpy(tree, cfg, device="cpu"), mesh,
                                 moe.param_pspecs(cfg))
    logits, aux = moe.forward(params, torch.from_numpy(tokens), cfg)
    return {"logits": _locals(logits), "aux": float(aux),
            "owned": [c for c in np.ndindex(mesh.devices.shape) if mesh.is_local(c)]}


def cfg_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
