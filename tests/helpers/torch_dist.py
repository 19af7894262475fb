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


def plain_forward(rank, n, cases: dict, grad_cases: dict = None) -> dict:
    """``forward(plain params, sp_mesh=ici x dcn)`` of each case ({name:
    (family, ici, dcn, tree, fields, tokens, striped)}, ``ici``'s ranks a
    process, all on "cpu"), under ``no_grad``: its logits locals, its aux
    (MoE) and the coordinates this process owns.  Then each of
    ``grad_cases`` (the same tuples) with every leaf requiring grad: the
    error the forward raises with grad on (None if it ran), and whether
    it runs under ``no_grad``."""
    out = {}
    for name, (family, ici, dcn, tree, fields, tokens, striped) in cases.items():
        model, cfg = _family(family), _config(family, fields)
        mesh = _mesh(ici, dcn, int(np.prod(list(ici.values()))))
        params = model.params_from_numpy(tree, cfg, device="cpu")
        kwargs = dict(ring_striped=striped) if family == "llama" else {}
        with torch.no_grad():
            got = model.forward(params, torch.from_numpy(tokens), cfg, sp_mesh=mesh, **kwargs)
        logits, aux = got if family == "moe" else (got, None)
        out[name] = {"logits": _locals(logits), "aux": None if aux is None else float(aux),
                     "spec": tuple(logits.spec),
                     "owned": [c for c in np.ndindex(mesh.devices.shape) if mesh.is_local(c)]}
    for name, (family, ici, dcn, tree, fields, tokens, striped) in (grad_cases or {}).items():
        model, cfg = _family(family), _config(family, fields)
        mesh = _mesh(ici, dcn, int(np.prod(list(ici.values()))))
        params = model.params_from_numpy(tree, cfg, device="cpu")
        for leaf in port("parallel.sharding").tree_leaves(params):
            leaf.requires_grad_()
        tokens = torch.from_numpy(tokens)
        try:
            model.forward(params, tokens, cfg, sp_mesh=mesh)
            error = None
        except RuntimeError as exc:
            error = str(exc)
        with torch.no_grad():
            got = model.forward(params, tokens, cfg, sp_mesh=mesh)
        logits = got[0] if family == "moe" else got
        out[name] = {"error": error, "no_grad_ran": all(
            bool(t.isfinite().all()) for _, t in logits.distinct())}
    return out


def _named(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _named(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _family(name: str):
    return port("models.llama") if name == "llama" else port("models.moe")


def _config(family: str, fields: dict):
    model = _family(family)
    return model.LlamaConfig(**fields) if family == "llama" else model.MoEConfig(**fields)


def train_case(ici: dict, dcn: dict, family: str, tree, fields: dict, tokens) -> dict:
    """One ``train_step`` over params sharded on the hybrid mesh ici x
    dcn (``ici``'s ranks a process, all on "cpu"), then a forward under
    ``no_grad``: the loss; each leaf's {coord: local} after the step and
    of its gradient, for this process's distinct locals; whether the
    forward gave finite logits for every local entry; the transfers by
    kind ({kind: [calls, bytes out, bytes in]})."""
    model, sharding = _family(family), port("parallel.sharding")
    pg = port("parallel.process_group")
    cfg = _config(family, fields)
    mesh = _mesh(ici, dcn, int(np.prod(list(ici.values()))))
    params = sharding.shard_tree(model.params_from_numpy(tree, cfg, device="cpu"), mesh,
                                 model.param_pspecs(cfg))
    tokens = torch.from_numpy(tokens)
    loss = float(model.train_step(params, model.make_optimizer(params), tokens, cfg))
    out = {"loss": loss, "params": {}, "grads": {}, "crossing": mesh.crossing_axes(),
           "owned": [c for c in np.ndindex(mesh.devices.shape) if mesh.is_local(c)]}
    for name, leaf in _named(params):
        out["params"][name] = {c: t.detach().numpy().copy() for c, t in leaf.distinct()}
        out["grads"][name] = {c: t.grad.numpy().copy() for c, t in leaf.distinct()}
    transfers = {}
    for rec in pg.transport(mesh).log.records():
        row = transfers.setdefault(rec["kind"], [0, 0, 0])
        row[0] += 1
        row[1] += rec["bytes_out"]
        row[2] += rec["bytes_in"]
    out["transfers"] = transfers
    with torch.no_grad():
        got = model.forward(params, tokens, cfg)
    logits = got[0] if family == "moe" else got
    out["forward"] = sorted(c for c, t in np.ndenumerate(logits.locals) if t is not None
                            and bool(t.isfinite().all()))
    return out


def adjoints(rank, n, seed: int) -> dict:
    """Each differentiable transfer of the transport over dcn tp = n, one
    rank a process, on small tensors: this process's input, its weights
    (the loss is sum(weights * output)) and the input's gradient, for
    the hop 0 -> n - 1, the broadcast from n - 1, ``all_gather_ranks``
    and ``all_reduce_ranks`` with ``grad="sum"`` and ``"same"``."""
    pg = port("parallel.process_group")
    mesh = _mesh(dict(dp=1), dict(dp=1, tp=n), 1)
    tr = pg.transport(mesh)
    coord = next(c for c in np.ndindex(mesh.devices.shape) if mesh.is_local(c))
    rng = np.random.default_rng(seed + rank)
    out = {}
    for name, call in (
            ("hop", lambda x: tr.hop(x if rank == 0 else None, "tp", coord, 0, n - 1,
                                     ((3, 4), torch.float32, torch.device("cpu")))),
            ("broadcast", lambda x: tr.broadcast(x if rank == n - 1 else None, "tp", coord,
                                                 n - 1, ((3, 4), torch.float32,
                                                         torch.device("cpu")))),
            ("gather", lambda x: torch.stack(tr.all_gather_ranks([x], "tp", coord))),
            ("sum", lambda x: tr.all_reduce_ranks([x], "tp", coord, grad="sum")),
            ("same", lambda x: tr.all_reduce_ranks([x], "tp", coord, grad="same"))):
        with tr.chained(torch.device("cpu")):
            x = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
            x.requires_grad_()
            y = call(x)
            shape = (n, 3, 4) if name == "gather" else (3, 4)
            w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            loss = (y * w).sum() if y is not None else torch.zeros(())
            (loss + tr.tail()).backward()
        out[name] = {"x": x.detach().numpy(), "w": w.numpy(),
                     "grad": None if x.grad is None else x.grad.numpy()}
    return out


def order_mismatch(rank, n) -> str:
    """A planted fault: the processes call two chained collectives on one
    sub-group in opposite orders (the forward exchanges bytes of one
    size either way).  Returns the error the backward raises."""
    pg = port("parallel.process_group")
    mesh = _mesh(dict(dp=1), dict(dp=1, tp=n), 1)
    tr = pg.transport(mesh)
    coord = next(c for c in np.ndindex(mesh.devices.shape) if mesh.is_local(c))
    x = torch.ones(2, 3, requires_grad=True)
    with tr.chained(torch.device("cpu")):
        calls = [lambda: torch.stack(tr.all_gather_ranks([x], "tp", coord)).sum(0),
                 lambda: tr.all_reduce_ranks([x], "tp", coord)]
        outs = [call() for call in (calls if rank == 0 else calls[::-1])]
        loss = sum(o.sum() for o in outs) + tr.tail()
        try:
            loss.backward()
        except pg.CollectiveOrderError as exc:
            return str(exc)
    return ""


def training_group(rank, n, cases: dict, extras: tuple = ()) -> dict:
    """``train_case`` of every case ({name: (ici, dcn, family, tree,
    fields, tokens)}), in one group; then each of ``extras`` (names of
    this module's workers taking (rank, n) and a seed or nothing)."""
    out = {name: train_case(*args) for name, args in cases.items()}
    for name, args in extras:
        out[name] = globals()[name](rank, n, *args)
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


def _held(tree, mesh) -> dict:
    """{leaf name: {coord: numpy}} of a state's sharded leaves' distinct
    locals, and {leaf name: numpy} of its plain tensors."""
    sharding = port("parallel.sharding")
    out = {}
    for name, leaf in _named(tree):
        if isinstance(leaf, sharding.Sharded):
            out[name] = {c: _numpy(t) for c, t in leaf.distinct()}
        elif isinstance(leaf, torch.Tensor):
            out[name] = _numpy(leaf)
    return out


def _numpy(tensor):
    """A tensor's bytes as numpy (bf16 through its int16 view)."""
    tensor = tensor.detach()
    if tensor.dtype == torch.bfloat16:
        return tensor.view(torch.int16).numpy().copy()
    return tensor.numpy().copy()


def _own_bytes(tree) -> int:
    """Bytes of one local copy of each slice this process holds, and of
    its plain tensors: what a restore must read, and no more."""
    sharding = port("parallel.sharding")
    total = 0
    for _, leaf in _named(tree):
        if isinstance(leaf, sharding.Sharded):
            seen = {}
            for coord, t in leaf.distinct():
                seen[leaf.shard_index(coord)] = t.numel() * t.element_size()
            total += sum(seen.values())
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


def checkpoint_across(rank, n, tree, fields: dict, tokens, folder: str, layouts: dict) -> dict:
    """Over dcn tp 2: one float32 ``train_step``, then the state (those
    params, ``optimizer_state_tree`` of the optimizer, and bf16 params of
    the same weights) saved to ``folder`` with each process writing its
    own slices, then a second step (the uninterrupted run).  Then, for
    each of ``layouts`` ({name: dcn plan}), the checkpoint restored onto
    that layout (params, optimizer state, bf16 params) and one step
    resumed from it.  Returns the state as saved (``_held``), the bytes
    this process wrote, the losses, and per layout the restored state,
    the bytes its read plan asked for beside its own slices' bytes, and
    the resumed step's loss."""
    llama, sharding, ckpt = port("models.llama"), port("parallel.sharding"), port(
        "models.checkpoint")
    cfg = llama.LlamaConfig(**fields)
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    batches = [torch.from_numpy(t) for t in tokens]

    def named(mesh, specs):
        if isinstance(specs, dict):
            return {k: named(mesh, v) for k, v in specs.items()}
        return sharding.NamedSharding(mesh, specs)

    mesh = _mesh(dict(dp=1), dict(dp=1, tp=2), 1)
    params = sharding.shard_tree(llama.params_from_numpy(tree, cfg, device="cpu"), mesh,
                                 llama.param_pspecs(cfg))
    opt = llama.make_optimizer(params)
    losses = [float(llama.train_step(params, opt, batches[0], cfg))]
    state = {"params": params, "opt": ckpt.optimizer_state_tree(opt, params),
             "bf16": sharding.shard_tree(llama.params_from_numpy(tree, cfg16, device="cpu"),
                                         mesh, llama.param_pspecs(cfg16))}
    wrote = {}
    ckpt.save_checkpoint(folder, state, report=wrote)
    out = {"saved": _held(state, mesh), "wrote": wrote["bytes"]}
    losses.append(float(llama.train_step(params, opt, batches[1], cfg)))
    out["losses"] = losses
    for name, dcn in layouts.items():
        target_mesh = _mesh(dict(dp=1), dcn, 1)
        shardings = named(target_mesh, llama.param_pspecs(cfg))
        target_params = ckpt.abstract_like(state["params"], shardings)
        fresh = llama.make_optimizer(target_params)
        target = {"params": target_params,
                  "opt": ckpt.optimizer_state_like(fresh, target_params),
                  "bf16": ckpt.abstract_like(state["bf16"], shardings)}
        read = {}
        restored = ckpt.restore_checkpoint(folder, target, report=read)
        ckpt.load_optimizer_state_tree(fresh, restored["params"], restored["opt"])
        row = {"held": _held(restored, target_mesh), "read": read["bytes"],
               "own": _own_bytes(restored), "crossing": target_mesh.crossing_axes()}
        row["resumed"] = float(llama.train_step(restored["params"], fresh, batches[1], cfg))
        out[name] = row
    return out
