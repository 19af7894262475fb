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


def crossing_errors(rank, n, tree, fields: dict, tokens, moe_fields: dict):
    """The error of a sharded step whose tp, pp or sp crosses processes
    (Llama) and of the MoE's with ep or dp across them: {case: message}."""
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
                              ("dp", "moe", dict(dp=2))):
        mesh = _mesh(dict(dp=1), dcn, 1)
        model, p, c = (llama, params, cfg) if family == "llama" else (moe, mparams, mcfg)
        sharded = sharding.shard_tree(p, mesh, model.param_pspecs(c))
        try:
            model.loss_fn(sharded, tokens, c)
        except NotImplementedError as exc:
            out[case] = str(exc)
        else:
            out[case] = None
    return out


def cfg_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
