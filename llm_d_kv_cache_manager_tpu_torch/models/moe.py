"""Mixtral-style sparse-MoE decoder in PyTorch: serving and training.

Port of the reference's ``models/moe.py``.  The attention stack is the
Llama one of ``models/llama.py`` (GQA, RoPE, RMSNorm; on CUDA the
prefill kernel, or the ring-partial kernel under ``sp_mesh``), and the
MLP is a top-k routed expert layer in the GShard/Switch form: a static
expert capacity, one-hot dispatch and combine products (no dynamic
shapes), tokens over capacity dropped to the residual path.  Params are
the reference's tree: ``embed``, ``layers.{ln1, ln2, wq, wk, wv, wo,
router, w_gate, w_up, w_down}`` with a leading layer axis (experts on
the second axis of the expert weights), ``ln_f``; the router is float32
in every config, since its logits decide the routing.

Routing picks must equal the reference's: top-k is ``k`` rounds of
argmax (ties to the first expert on both sides), queue positions come
from a float32 cumsum, and the gates are renormalized by
``max(gate_sum, 1e-9)``.

Sharded: params cut by :func:`param_pspecs` (experts over ``ep``, each
expert's hidden width over ``tp``) run ``forward``, ``loss_fn`` and
``train_step`` over dp x pp x ep x tp x sp, the attention as in
``models/llama.py``.  Routing is global, as under the reference's jit:
every batch shard's and sequence chunk's normed tokens are gathered in
global token order, so capacity and queue positions are those of all
B x T tokens; :func:`_constrain` places the experts' batches on the ep
ranks (the dispatch), each (ep, tp) rank runs its experts' slice, and
the combine sums the ep ranks' outputs.  On a mesh whose axes cross
processes the forward runs in every process: the normed tokens come
from every process along dp and sp, each process routes them alike and
runs its own (ep, tp) ranks' experts, and the products are summed over
tp and ep across processes in rank order; it returns this process's
logits (a ``Sharded``, as ``llama.forward`` does) and the same aux loss
in every process.  Plain params over an ``sp_mesh`` of several
processes are shared onto it (``sharding.share_tree``) and take that
path.  ``loss_fn`` and ``train_step`` train there on any layout: the
gathers of the routing's tokens, the sums over tp and ep and the aux
loss's gather along pp carry their gradients back across processes,
and the loss counts the aux term once over the processes
(``llama._global_loss``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from llm_d_kv_cache_manager_tpu_torch.models.llama import (
    _grid,
    _Grid,
    _logits,
    _logits_out,
    _normal,
    _prefill_attention,
    _qkv,
    _refuse_ring_grad,
    _rms_norm,
    _sharded_nll,
    _sharded_run,
    chained,
    is_sharded,
    make_optimizer,  # noqa: F401  (the reference's moe.make_optimizer)
    next_token_nll,
    optimizer_step,
)
from llm_d_kv_cache_manager_tpu_torch.ops.ring_attention import ring_for_mesh
from llm_d_kv_cache_manager_tpu_torch.parallel.mesh import Mesh, active_mesh
from llm_d_kv_cache_manager_tpu_torch.parallel.sharding import (
    P,
    all_reduce,
    ranks_over,
    shard,
    share_tree,
)
from llm_d_kv_cache_manager_tpu_torch.utils.device import (
    from_numpy,
    resolve_device,
    torch_dtype,
)

Params = Dict[str, Any]

_LAYER_KEYS = (
    "ln1", "ln2", "wq", "wk", "wv", "wo", "router", "w_gate", "w_up", "w_down",
)


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    d_model: int = 1024
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 2816  # per-expert hidden dim
    n_experts: int = 8
    top_k: int = 2
    # Static per-expert slot budget: capacity = ceil(top_k * T / E *
    # factor).  Overflowing tokens fall back to the residual stream.
    capacity_factor: float = 1.25
    rope_theta: float = 500000.0
    block_size: int = 16
    dtype: str = "bfloat16"
    # As in LlamaConfig: the CPU's switch from the dense to the tiled op.
    flash_attention_min_len: int = 1024
    # Weight of the load-balancing auxiliary loss (Switch §2.2 form).
    router_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def capacity(self, tokens_per_batch: int) -> int:
        raw = self.top_k * tokens_per_batch / self.n_experts
        return max(int(math.ceil(raw * self.capacity_factor)), 1)


def _param_shapes(cfg: MoEConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """{layer key: (shape, fan_in)} of the stacked weights, router
    included."""
    L, D, H, Hkv, Dh, F_, E = (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        cfg.d_ff, cfg.n_experts,
    )
    return {
        "wq": ((L, D, H, Dh), D),
        "wk": ((L, D, Hkv, Dh), D),
        "wv": ((L, D, Hkv, Dh), D),
        "wo": ((L, H, Dh, D), H * Dh),
        "router": ((L, D, E), D),
        "w_gate": ((L, E, D, F_), D),
        "w_up": ((L, E, D, F_), D),
        "w_down": ((L, E, F_, D), F_),
    }


def init_params(
    cfg: MoEConfig,
    generator: torch.Generator,
    device: Union[str, torch.device] = "cuda",
) -> Params:
    """Random params in the reference's layout: normal(0, fan_in^-1/2)
    weights drawn in float32 from ``generator`` (which must live on
    ``device``) and stored in ``cfg.dtype``, the router in float32,
    norms at 1.  Tests that compare with the reference load its weights
    through :func:`params_from_numpy`."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    D = cfg.d_model
    layers = {
        "ln1": torch.ones((cfg.n_layers, D), dtype=dtype, device=dev),
        "ln2": torch.ones((cfg.n_layers, D), dtype=dtype, device=dev),
    }
    for key, (shape, fan_in) in _param_shapes(cfg).items():
        leaf_dtype = torch.float32 if key == "router" else dtype
        layers[key] = _normal(shape, fan_in, leaf_dtype, generator, dev)
    return {
        "embed": _normal((cfg.vocab_size, D), D, dtype, generator, dev),
        "layers": layers,
        "ln_f": torch.ones((D,), dtype=dtype, device=dev),
    }


def params_from_numpy(
    tree: Params, cfg: MoEConfig, device: Union[str, torch.device] = "cuda"
) -> Params:
    """The reference's ``init_params`` pytree, as numpy arrays, in the
    port's layout (the same one): bf16 leaves carried bit for bit
    through their ``uint16`` view, the router as float32, others by
    value in ``cfg.dtype``."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def conv(array, leaf_dtype=dtype) -> torch.Tensor:
        return from_numpy(np.asarray(array), leaf_dtype).to(dev)

    shapes = _param_shapes(cfg)
    layers = {}
    for key in _LAYER_KEYS:
        layers[key] = conv(tree["layers"][key],
                           torch.float32 if key == "router" else dtype)
        want = shapes[key][0] if key in shapes else (cfg.n_layers, cfg.d_model)
        if tuple(layers[key].shape) != want:
            raise ValueError(
                f"layers.{key} has shape {tuple(layers[key].shape)}, "
                f"config wants {want}"
            )
    return {
        "embed": conv(tree["embed"]),
        "layers": layers,
        "ln_f": conv(tree["ln_f"]),
    }


def param_pspecs(cfg: MoEConfig) -> Params:
    """The reference's spec tree (axes: ``parallel/mesh.py``): experts
    over ``ep``, each expert's hidden width over ``tp``, the layer axis
    over ``pp``, attention as in ``llama.param_pspecs``."""
    return {
        "embed": P(None, "tp"),
        "layers": {
            "ln1": P("pp", None),
            "ln2": P("pp", None),
            "wq": P("pp", None, "tp", None),
            "wk": P("pp", None, "tp", None),
            "wv": P("pp", None, "tp", None),
            "wo": P("pp", "tp", None, None),
            "router": P("pp", None, None),
            "w_gate": P("pp", "ep", None, "tp"),
            "w_up": P("pp", "ep", None, "tp"),
            "w_down": P("pp", "ep", "tp", None),
        },
        "ln_f": P(None),
    }


def _constrain(x: torch.Tensor, spec: P, mesh: Optional[Mesh] = None):
    """The reference's sharding constraint, made explicit.  Outside any
    mesh (none given, none active: ``parallel.mesh.activate`` or ``with
    mesh:``) it returns ``x`` itself, the reference's deterministic
    no-op.  Otherwise it places ``x`` as ``spec`` says over the mesh:
    a ``parallel.sharding.Sharded`` whose every rank holds its slice on
    its device, autograd's graph kept."""
    mesh = mesh if mesh is not None else active_mesh()
    return x if mesh is None else shard(x, mesh, spec)


def _layer(params: Params, i: int) -> Params:
    return {key: params["layers"][key][i] for key in _LAYER_KEYS}


def _route(
    x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing with static capacity.

    x: [S, D] flattened tokens.  Returns (dispatch [S, E, C] one-hot,
    combine [S, E, C] gate-weighted, aux load-balancing loss), all
    float32."""
    S = x.shape[0]
    E, C = cfg.n_experts, cfg.capacity(S)
    logits = x.float() @ router.float()  # [S, E]
    probs = torch.softmax(logits, dim=-1)

    # Top-k as k sequential argmax rounds (ties go to the first expert).
    remaining = probs
    picks, picked_gates = [], []
    for _ in range(cfg.top_k):
        choice = remaining.argmax(dim=-1)  # [S]
        picks.append(choice)
        picked_gates.append(torch.gather(probs, -1, choice[:, None])[:, 0])
        remaining = remaining * (1.0 - F.one_hot(choice, E).float())

    # Normalize the k gates per token (Mixtral renormalizes top-k).
    gate_sum = sum(picked_gates)
    dispatch = torch.zeros((S, E, C), dtype=torch.float32, device=x.device)
    combine = torch.zeros_like(dispatch)
    # Slots already taken per expert, accumulated across rounds.
    fill = torch.zeros((E,), dtype=torch.int32, device=x.device)
    slots = torch.arange(C, device=x.device)
    for choice, gate in zip(picks, picked_gates):
        onehot = F.one_hot(choice, E).float()  # [S, E]
        # Position of each token within its chosen expert's queue:
        # tokens are served in sequence order, after the slots earlier
        # rounds filled.
        position = torch.cumsum(onehot, dim=0) - 1.0 + fill[None, :].float()
        position_tok = (position * onehot).sum(dim=-1)  # [S]
        keep = position_tok < C  # capacity drop
        # A dropped token's slot index is C, which matches no slot: the
        # reference's one_hot of an out-of-range index, a zero row.
        slot = (position_tok.long()[:, None] == slots).float()  # [S, C]
        contrib = onehot[:, :, None] * slot[:, None, :]  # [S, E, C]
        dispatch = dispatch + contrib * keep[:, None, None]
        combine = combine + contrib * (
            (gate / torch.clamp(gate_sum, min=1e-9)) * keep
        )[:, None, None]
        fill = fill + (onehot * keep[:, None]).sum(dim=0).int()

    # Load-balancing aux loss: E * sum_e f_e * p_e (Switch/GShard).
    token_frac = F.one_hot(picks[0], E).float().mean(dim=0)
    prob_frac = probs.mean(dim=0)
    aux = cfg.n_experts * (token_frac * prob_frac).sum()
    return dispatch, combine, aux


def _moe_mlp(
    x: torch.Tensor, lp: Params, cfg: MoEConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed expert MLP.  x: [B, T, D] -> ([B, T, D], aux loss)."""
    B, T, D = x.shape
    flat = x.reshape(B * T, D)
    dispatch, combine, aux = _route(flat, lp["router"], cfg)
    # [S, E, C] x [S, D] -> the experts' batches [E, C, D].
    expert_in = torch.einsum("sec,sd->ecd", dispatch.to(x.dtype), flat)
    gate = torch.einsum("ecd,edf->ecf", expert_in, lp["w_gate"])
    up = torch.einsum("ecd,edf->ecf", expert_in, lp["w_up"])
    hidden = F.silu(gate.float()).to(x.dtype) * up
    expert_out = torch.einsum("ecf,efd->ecd", hidden, lp["w_down"])
    out = torch.einsum("sec,ecd->sd", combine.to(x.dtype), expert_out)
    return out.reshape(B, T, D), aux


def _sharded_moe_block(params: Params, cfg: MoEConfig, grid: _Grid, B: int, T: int,
                       auxes: list):
    """The routed MLP over sharded params: the normed tokens of every
    (batch shard, sequence chunk) gathered in global token order onto
    this process's first rank of the stage (from every process along dp
    and sp), routed there as one [B*T] batch, the experts' batches
    placed on the ep ranks (:func:`_constrain`), each (ep, tp) rank's
    partial product summed over tp, and the combine summed over ep, in
    rank order (across processes too).  Appends each layer's aux loss
    to ``auxes``.  Ranks along dp and sp hold replicas of the experts:
    a process computes its (ep, tp) ranks' products at its first dp and
    sp index."""
    E = cfg.n_experts // grid.ep
    d0, s0, t0 = grid.dps[0], grid.sps[0], grid.tps[0]

    def block(i: int, p: int, xs) -> None:
        home = grid.dev(d0, p, grid.e, s0, t0)
        normed = {(d, s): _rms_norm(x, grid.take(params["layers"]["ln2"], i, d, p, grid.e, s,
                                                 t0))
                  for (d, s), x in xs.items()}
        flat = grid.assemble(normed, p, home).reshape(B * T, -1)
        dispatch, combine, aux = _route(flat, grid.take(params["layers"]["router"], i, d0, p,
                                                        grid.e, s0, t0), cfg)
        auxes.append(aux)
        expert_in = _constrain(torch.einsum("sec,sd->ecd", dispatch.to(flat.dtype), flat),
                               P("ep", None, None), grid.mesh)
        outs = []
        for e in grid.eps:
            parts = []
            for t in grid.tps:
                lp = grid.layer(params, ("w_gate", "w_up", "w_down"), i, d0, p, e, s0, t)
                x_in = expert_in.locals[grid.coord(d0, p, e, s0, t)]
                gate = torch.einsum("ecd,edf->ecf", x_in, lp["w_gate"])
                up = torch.einsum("ecd,edf->ecf", x_in, lp["w_up"])
                hidden = F.silu(gate.float()).to(x_in.dtype) * up
                parts.append(torch.einsum("ecf,efd->ecd", hidden, lp["w_down"]))
            expert_out = grid.reduce("tp", parts, grid.coord(d0, p, e, s0, t0),
                                     grid.dev(d0, p, e, s0, t0))
            weights = combine[:, e * E : (e + 1) * E].to(expert_out.device, expert_out.dtype)
            outs.append(torch.einsum("sec,ecd->sd", weights, expert_out))
        out = grid.reduce("ep", outs, grid.lead(p), home).reshape(B, T, -1)
        for (d, s), x in list(xs.items()):
            xs[d, s] = x + grid.cut(out, d, s).to(x.device)

    return block


def _sharded_forward(params: Params, tokens: torch.Tensor, cfg: MoEConfig, grid: _Grid,
                     use_flash: bool, sp_mesh: Optional[Mesh], ring_impl: str,
                     every_stage: bool = True):
    """(hidden shards, aux) of the sharded forward: the aux of every
    layer, gathered along pp where the stages lie in several processes,
    summed in layer order (``every_stage`` as for
    ``llama._sharded_stack``)."""
    auxes = []
    xs, _ = _sharded_run(params, tokens, cfg, grid, use_flash=use_flash, sp_mesh=sp_mesh,
                         impl=ring_impl,
                         mlp_block=_sharded_moe_block(params, cfg, grid, *tokens.shape, auxes),
                         every_stage=every_stage)
    per = grid.per_stage
    stages = [torch.stack(auxes[k * per : (k + 1) * per]) for k in range(len(grid.pps))]
    auxes = [a for stage in ranks_over(stages, grid.mesh, "pp", grid.lead()) for a in stage]
    return xs, all_reduce(auxes, grid.home) / cfg.n_layers


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: MoEConfig,
    use_flash: bool = True,
    sp_mesh: Optional[Mesh] = None,
    ring_impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense forward: tokens [B, T] -> (logits [B, T, V], aux loss).

    Attention is routed as in ``llama.forward``: ``use_flash=False``
    forces the dense op; otherwise the prefill kernel on CUDA.
    ``sp_mesh``: ring attention over the mesh's ``sp`` axis, in the
    CONTIGUOUS layout only: capacity routing consumes expert slots in
    token order, so the striped layout would change which tokens
    overflow.  ``ring_impl`` as in ``llama.forward``.  Over sharded
    params (see the module's note) the logits come back whole on the
    first rank's device, or, over a mesh of several processes, as this
    process's ``Sharded`` logits over ``P("dp", "sp", None)``, with the
    same aux in every process.  Plain params over an ``sp_mesh`` of
    several processes, the same in every process, give the same: they
    are shared onto the mesh by :func:`param_pspecs`
    (``sharding.share_tree``: views wherever a rank's slice is
    contiguous) and run the sharded path, whose routing joins every
    token of the batch.  There a leaf that requires grad raises outside
    ``torch.no_grad()``: the ring's K/V moves between processes carry
    no gradient."""
    if sp_mesh is not None and sp_mesh.multi_process:
        _refuse_ring_grad(params)
        if not is_sharded(params):
            params = share_tree(params, sp_mesh, param_pspecs(cfg))
    if is_sharded(params):
        grid = _grid(params, cfg)
        xs, aux = _sharded_forward(params, tokens, cfg, grid, use_flash, sp_mesh, ring_impl)
        return _logits_out(params, grid, xs, tokens.shape + (cfg.vocab_size,)), aux
    B, T = tokens.shape
    dev = params["embed"].device
    tokens = tokens.to(dev)
    positions = torch.arange(T, device=dev).expand(B, T)
    x = params["embed"][tokens.long()]
    ring = None
    if sp_mesh is not None:
        ring = ring_for_mesh(sp_mesh, impl=ring_impl)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = _rms_norm(x, lp["ln1"])
        q, k, v = _qkv(h, lp, positions, cfg.rope_theta)
        if ring is not None:
            attn = ring(q, k, v)
        else:
            attn = _prefill_attention(q, k, v, cfg, use_flash=use_flash)
        x = x + torch.einsum("bthk,hkd->btd", attn, lp["wo"])
        moe_out, layer_aux = _moe_mlp(_rms_norm(x, lp["ln2"]), lp, cfg)
        x = x + moe_out
        aux = aux + layer_aux
    return _logits(x, params), aux / cfg.n_layers


def loss_fn(params: Params, tokens: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Next-token cross entropy plus the router's load-balancing loss,
    through the dense attention op (``use_flash=False``); over a mesh of
    several processes as ``llama.loss_fn``."""
    if is_sharded(params):
        grid = _grid(params, cfg)
        with chained(grid.mesh, grid.home):
            xs, aux = _sharded_forward(params, tokens, cfg, grid, False, None, "auto",
                                       every_stage=False)
            return _sharded_nll(params, tokens, grid, xs, extra=cfg.router_aux_weight * aux)
    logits, aux = forward(params, tokens, cfg, use_flash=False)
    return next_token_nll(logits, tokens.to(logits.device)) + cfg.router_aux_weight * aux


def train_step(
    params: Params, optimizer: torch.optim.Optimizer, tokens: torch.Tensor, cfg: MoEConfig
) -> torch.Tensor:
    """One AdamW step on :func:`loss_fn`, updating ``params`` and
    ``optimizer`` (``make_optimizer(params)``, shared with the Llama
    family) in place; returns the loss before the update."""
    return optimizer_step(lambda: loss_fn(params, tokens, cfg), optimizer, params)
