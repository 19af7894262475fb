"""Llama-family decoder in PyTorch: serving, ring prefill and training.

Port of the reference's ``models/llama.py``: its serving path, its
ring-attention prefill (``forward(sp_mesh=...)``) and its training
step (``next_token_nll``, ``loss_fn``, ``make_optimizer``,
``train_step``): the same
stacked-layer params tree (``embed``, ``layers.{ln1, ln2, wq, wk, wv,
wo, w_gate, w_up, w_down}`` with a leading layer axis, ``ln_f``), the
same layouts, bf16 matmuls with f32 norm/softmax/logits, and the paged
pool ``[L, num_blocks, 2, block_size, Hkv, Dh]`` of
``models/kv_cache_pool.py``.

Attention routing follows the tensors' device, not a backend probe:

- ``forward(sp_mesh=...)``: ring attention over the mesh's ``sp``
  axis in every layer (``ops/ring_attention.py``; on CUDA its steps run
  the kernel of ``ops/ring_flash_cuda.py``).
- ``use_flash=False`` (``forward``; ``loss_fn`` passes it): the dense
  op of ``ops/attention.py`` on every device, as in the reference.
  The kernels are forward-only and raise under autograd; training
  differentiates through the dense op.
- CUDA tensors otherwise: every prefill attention (``forward``,
  ``prefill_paged``, ``prefill_continue`` with ``q_offset=prefix_len``,
  ``prefill_chunked`` with ``q_offset=start``) runs the hand-written
  kernel of ``ops/flash_cuda.py`` and every ``decode_step`` attention
  the one of ``ops/paged_decode_cuda.py``; :func:`make_decode_step`
  gives the decode step as one captured CUDA graph, replayed per token.
- CPU tensors: the reference's routing off the TPU, exactly — dense
  attention below ``flash_attention_min_len`` keys, the tiled op at or
  above it, the gather op at decode.

Sharded execution: params cut by :func:`param_pspecs` over a
``parallel.mesh.Mesh`` (``parallel.sharding.shard_tree``) carry their
mesh, and ``forward`` (also with ``sp_mesh``, the tp x sp ring),
``prefill_paged``, ``prefill_continue``, ``decode_step`` and
``make_decode_step`` (over a pool cut on its kv heads), ``loss_fn`` and
``train_step`` compute the function the unsharded params give, over dp
x pp x tp x sp: batch shards, layer stages, head and hidden-width
shards, sequence chunks.  The collectives are explicit (see the
"sharded" section below).  On a mesh of one process the logits come
back whole, on the first rank's device.  On a mesh whose axes cross
processes (``make_hybrid_mesh``) the serving entry points run in every
process, each computing its own ranks, and return this process's
logits as a ``Sharded``; ``loss_fn`` and ``train_step`` train there on
any layout, their gradients carried back through the cross-process
transfers (see the "training" section below).  Plain params take that
path too under ``forward(sp_mesh=...)`` over such a mesh with an axis
besides ``sp`` in use: they are shared onto it
(``parallel.sharding.share_tree``, views of the plain leaves where it
can).

Mixed blocks (Mellum's): the serving entry points (``prefill_paged``,
``prefill_continue``, ``prefill_chunked``, ``decode_step``, hence
``CapturedDecodeStep``) also serve a :class:`MixedLlamaConfig`: a
stated ``head_dim``, an untied output head (a ``head`` leaf [V, D]
beside ``embed``), a per-layer :class:`AttentionKind` (a sliding window
or none; RoPE's theta, YaRN frequencies and the attention factor that
multiplies cos and sin) and routed experts in place of the dense MLP
(``n_experts``: leaves ``w_router`` [L, D, E], ``e_gate``, ``e_up`` [L,
E, D, F] and ``e_down`` [L, E, F, D]).  A layer is then::

    n1 = RMSNorm1(x)
    h  = x + W_o Attn_kind(RoPE_kind(W_q n1), RoPE_kind(W_k n1), W_v n1)
    n2 = RMSNorm2(h)
    p  = softmax(W_router n2)                  (float32, all E experts)
    x' = h + sum_{e in topk(p)} p_e / sum_topk(p) * W_down,e(SiLU(W_gate,e n2) * W_up,e n2)

attention scaled by head_dim^-0.5, causal, and on a windowed layer over
keys q - window < j <= q; logits ``W_head RMSNorm_f(x)``.  The experts are
``ops/moe_experts.py``'s dropless kernels, inside the decode graph too.
A :class:`LlamaConfig` is the dense Llama block, its launches and graphs
unchanged.  ``forward``, training and the sharded paths take the dense
block alone and refuse a mixed one.

The reference's arrays are immutable; here ``prefill_*`` and
``decode_step`` write the new K/V into ``kv_pool`` IN PLACE and return
``(logits, kv_pool)`` with that same tensor, so callers that compare
pools clone them first.  Likewise ``train_step`` updates the params
and the optimizer's state in place and returns the loss, where the
reference returns new params and optimizer state.
"""

from __future__ import annotations

import functools
import math
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from llm_d_kv_cache_manager_tpu_torch.metrics.collector import count_build
from llm_d_kv_cache_manager_tpu_torch.obs.trace import profiler_range
from llm_d_kv_cache_manager_tpu_torch.ops.attention import causal_gqa_attention
from llm_d_kv_cache_manager_tpu_torch.ops.flash_attention import (
    flash_gqa_attention,
)
from llm_d_kv_cache_manager_tpu_torch.ops.flash_cuda import (
    flash_gqa_attention_cuda,
)
from llm_d_kv_cache_manager_tpu_torch.ops.layer_fused import (
    rms_norm_fused,
    rms_norm_plain,
    rope_freqs,
    rope_kv_fused,
    rope_plain,
    silu_mul_fused,
    silu_mul_plain,
    write_kv_slots,
    yarn_freqs,
)
from llm_d_kv_cache_manager_tpu_torch.ops.moe_experts import (
    counters as moe_counters,
    routed_experts_fused,
)
from llm_d_kv_cache_manager_tpu_torch.ops.paged_decode_cuda import (
    paged_decode_attention_cuda,
)
from llm_d_kv_cache_manager_tpu_torch.ops.ring_attention import (
    ring_body,
    ring_for_mesh,
    ring_of,
    stripe,
    unstripe,
)
from llm_d_kv_cache_manager_tpu_torch.parallel.mesh import AXIS_ORDER, AXIS_SP, Mesh
from llm_d_kv_cache_manager_tpu_torch.parallel.process_group import transport
from llm_d_kv_cache_manager_tpu_torch.parallel.sharding import (
    P,
    Sharded,
    all_gather,
    all_gather_over,
    all_reduce,
    all_reduce_over,
    distinct_locals,
    ranks_over,
    share_tree,
    sum_over_processes,
    sync_replica_grads,
    tree_leaves,
    tree_mesh,
)
from llm_d_kv_cache_manager_tpu_torch.utils.device import (
    from_numpy,
    resolve_device,
    torch_dtype,
)

Params = Dict[str, Any]

_LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class AttentionKind:
    """One layer's attention: ``window`` (a sliding window of that many
    positions, a query at q seeing keys q - window < j <= q; None: every
    earlier key) and its RoPE: theta, YaRN's ``(factor, original max
    positions, beta_fast, beta_slow)`` where ``yarn`` is set
    (``ops/layer_fused.py:yarn_freqs``), and ``rope_scale``, the factor
    that multiplies cos and sin (YaRN's attention factor)."""

    window: Optional[int] = None
    rope_theta: float = 500000.0
    yarn: Optional[Tuple[float, int, float, float]] = None
    rope_scale: float = 1.0


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1408
    rope_theta: float = 500000.0
    block_size: int = 16  # paged-KV block, matches the index block size
    dtype: str = "bfloat16"
    # Key-axis length at/above which CPU prefill attention switches from
    # the dense op to the tiled op (the reference's routing off the TPU).
    # CUDA tensors take the prefill kernel unless use_flash=False.
    flash_attention_min_len: int = 1024
    # The reference's decode routing and Pallas tile settings, with its
    # defaults: accepted and ignored, so that a config written for it
    # constructs here.  No code of the port reads them.  On CUDA every
    # decode step runs the decode kernel, and on the CPU its plain
    # version, whatever ``decode_attention`` holds (the reference, too,
    # takes any string and runs its gather for all but "pallas").
    # ``decode_blocks_per_step`` and ``decode_mxu_native`` size the
    # Pallas kernel's grid step and operand type; the CUDA kernel sets
    # its own (csrc/paged_decode.cu).
    decode_attention: str = "auto"
    decode_blocks_per_step: int = 4
    decode_mxu_native: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def kind(self, layer: int) -> AttentionKind:
        """Layer ``layer``'s attention kind: causal, RoPE at rope_theta."""
        return AttentionKind(rope_theta=self.rope_theta)

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256,
            d_model=4096,
            n_layers=32,
            n_heads=32,
            n_kv_heads=8,
            d_ff=14336,
        )


@dataclass
class MixedLlamaConfig(LlamaConfig):
    """A :class:`LlamaConfig` whose block is mixed (see the module note),
    served by the serving entry points alone."""

    # The head dim, stated apart from d_model / n_heads (None: derived).
    head_dim: Optional[int] = None
    # Each layer's attention kind, n_layers of them (None: every layer
    # causal, RoPE at rope_theta).
    attention_kinds: Optional[Tuple[AttentionKind, ...]] = None
    # Routed experts as every layer's MLP (0: the dense SwiGLU of d_ff).
    n_experts: int = 0
    experts_per_token: int = 0
    d_expert: int = 0
    norm_topk_prob: bool = False
    # False: the output head is its own leaf, params["head"] [V, D].
    tie_embeddings: bool = True

    def __post_init__(self) -> None:
        if self.head_dim is None:
            self.head_dim = self.d_model // self.n_heads

    def kind(self, layer: int) -> AttentionKind:
        if self.attention_kinds is None:
            return AttentionKind(rope_theta=self.rope_theta)
        return self.attention_kinds[layer]


def _param_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """{layer key: (shape, fan_in)} of the stacked weight tensors."""
    L, D, H, Hkv, Dh, F_ = (
        cfg.n_layers,
        cfg.d_model,
        cfg.n_heads,
        cfg.n_kv_heads,
        cfg.head_dim,
        cfg.d_ff,
    )
    attention = {
        "wq": ((L, D, H, Dh), D),
        "wk": ((L, D, Hkv, Dh), D),
        "wv": ((L, D, Hkv, Dh), D),
        "wo": ((L, H, Dh, D), H * Dh),
    }
    if _mixed(cfg) and cfg.n_experts:
        E, Fe = cfg.n_experts, cfg.d_expert
        return {**attention,
                "w_router": ((L, D, E), D),
                "e_gate": ((L, E, D, Fe), D),
                "e_up": ((L, E, D, Fe), D),
                "e_down": ((L, E, Fe, D), Fe)}
    return {
        **attention,
        "w_gate": ((L, D, F_), D),
        "w_up": ((L, D, F_), D),
        "w_down": ((L, F_, D), F_),
    }


def _normal(shape, fan_in, dtype, generator, device) -> torch.Tensor:
    """normal(0, fan_in^-1/2) drawn in float32 from ``generator`` and
    stored in ``dtype``, in slices along the leading axis of at most
    2^26 elements (one layer of the largest weight), so the float32
    scratch stays a fraction of the stack."""
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, (1 << 26) // math.prod(shape[1:]))
    for i in range(0, shape[0], rows):
        n = min(rows, shape[0] - i)
        draw = torch.randn(
            (n,) + tuple(shape[1:]), generator=generator, device=device,
            dtype=torch.float32,
        )
        out[i : i + n] = (draw * fan_in**-0.5).to(dtype)
    return out


def init_params(
    cfg: LlamaConfig,
    generator: torch.Generator,
    device: Union[str, torch.device] = "cuda",
) -> Params:
    """Random params in the reference's layout: normal(0, fan_in^-1/2)
    weights drawn in float32 from ``generator`` (which must live on
    ``device``), norms at 1.  ``jax.random`` and torch give different
    numbers from one seed; tests that compare with the reference load
    its weights through :func:`params_from_numpy` instead."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    D = cfg.d_model

    def normal(shape, fan_in):
        return _normal(shape, fan_in, dtype, generator, dev)

    layers = {
        "ln1": torch.ones((cfg.n_layers, D), dtype=dtype, device=dev),
        "ln2": torch.ones((cfg.n_layers, D), dtype=dtype, device=dev),
    }
    for key, (shape, fan_in) in _param_shapes(cfg).items():
        layers[key] = normal(shape, fan_in)
    params = {
        "embed": normal((cfg.vocab_size, D), D),
        "layers": layers,
        "ln_f": torch.ones((D,), dtype=dtype, device=dev),
    }
    if _mixed(cfg) and not cfg.tie_embeddings:
        params["head"] = normal((cfg.vocab_size, D), D)
    return params


def params_from_numpy(
    tree: Params, cfg: LlamaConfig, device: Union[str, torch.device] = "cuda"
) -> Params:
    """The reference's ``init_params`` pytree, as numpy arrays, in the
    port's layout (which is the same one): bf16 weights are carried bit
    for bit through their ``uint16`` view, others by value in
    ``cfg.dtype``."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def conv(array) -> torch.Tensor:
        return from_numpy(np.asarray(array), dtype).to(dev)

    shapes = _param_shapes(cfg)
    layers = {}
    for key in _LAYER_KEYS:
        layers[key] = conv(tree["layers"][key])
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


def param_pspecs(cfg: LlamaConfig) -> Params:
    """The reference's spec tree for :func:`init_params`'s params (axes:
    ``parallel/mesh.py``): the layer axis over ``pp``, heads and the
    MLP's hidden width over ``tp``, the embedding's width over ``tp``.
    ``parallel.sharding.shard_tree(params, mesh, param_pspecs(cfg))``
    cuts params by it; every entry point takes the result."""
    return {
        "embed": P(None, "tp"),
        "layers": {
            "ln1": P("pp", None),
            "ln2": P("pp", None),
            "wq": P("pp", None, "tp", None),
            "wk": P("pp", None, "tp", None),
            "wv": P("pp", None, "tp", None),
            "wo": P("pp", "tp", None, None),
            "w_gate": P("pp", None, "tp"),
            "w_up": P("pp", None, "tp"),
            "w_down": P("pp", "tp", None),
        },
        "ln_f": P(None),
    }


def _layer(params: Params, i: int) -> Params:
    return {key: leaf[i] for key, leaf in params["layers"].items()}


def _mixed(cfg: LlamaConfig) -> bool:
    return isinstance(cfg, MixedLlamaConfig)


def _dense_only(cfg: LlamaConfig, what: str) -> None:
    """Raise where a path that serves the dense block alone is given a
    mixed one."""
    if _mixed(cfg):
        raise ValueError(f"{what} takes the dense Llama block; a MixedLlamaConfig is served "
                         "by prefill_paged, prefill_continue, prefill_chunked and decode_step")


_rms_norm = rms_norm_plain


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, T, H, D] (D even); positions: [B, T].  Angles in float32,
    as in the reference."""
    return rope_plain(x, positions, rope_freqs(x.shape[-1], theta, x.device))


def _mlp(x: torch.Tensor, lp: Params) -> torch.Tensor:
    gate = torch.einsum("btd,df->btf", x, lp["w_gate"])
    up = torch.einsum("btd,df->btf", x, lp["w_up"])
    return torch.einsum("btf,fd->btd", silu_mul_plain(gate, up), lp["w_down"])


def _qkv(x: torch.Tensor, lp: Params, positions: torch.Tensor, theta: float):
    q = torch.einsum("btd,dhk->bthk", x, lp["wq"])
    k = torch.einsum("btd,dhk->bthk", x, lp["wk"])
    v = torch.einsum("btd,dhk->bthk", x, lp["wv"]).contiguous()
    return _rope(q, positions, theta), _rope(k, positions, theta), v


def _logits(x: torch.Tensor, params: Params) -> torch.Tensor:
    """Shared epilogue: final norm + tied-embedding head, f32 logits."""
    x = _rms_norm(x, params["ln_f"])
    return torch.einsum("...d,vd->...v", x.float(), params["embed"].float())


def _attn_out(attn: torch.Tensor, lp: Params) -> torch.Tensor:
    return torch.einsum("bthk,hkd->btd", attn, lp["wo"])


def _prefill_attention(q, k, v, cfg: LlamaConfig, q_offset: int = 0, use_flash=True,
                       window: Optional[int] = None):
    """Prefill attention.  ``use_flash=False`` forces the dense op on
    every device, as in the reference: neither the kernel nor the tiled
    op has a backward, so training differentiates through the dense op.
    Otherwise routed by device: the prefill kernel on CUDA; on the CPU
    dense below ``flash_attention_min_len`` keys and the tiled op at or
    above it.  ``window``: a windowed layer's (see AttentionKind)."""
    kw = _windowed(window)
    if not use_flash:
        return causal_gqa_attention(q, k, v, q_offset=q_offset, **kw)
    if q.is_cuda:
        return flash_gqa_attention_cuda(q, k, v, q_offset=q_offset, **kw)
    if k.shape[1] >= cfg.flash_attention_min_len:
        return flash_gqa_attention(q, k, v, q_offset=q_offset, **kw)
    return causal_gqa_attention(q, k, v, q_offset=q_offset, **kw)


def _windowed(window: Optional[int]) -> Dict[str, int]:
    """The attention ops' keyword for a layer's window: none for a full
    layer, so that the dense block's calls are the ones they were."""
    return {} if window is None else {"window": window}


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


# ------------------------------------------------------------ inference
#
# The inference entry points (prefill_paged, prefill_continue,
# prefill_chunked, decode_step, hence every CapturedDecodeStep) run each
# elementwise stage of a layer as one launch of ops/layer_fused.py:
# RMSNorm (both norms and ln_f), RoPE of q and k with the K/V pool write,
# and SiLU(gate) * up; each projection is one matmul on 2-D views.  Those
# kernels are forward-only, so forward(), loss_fn, train_step, the MoE
# model and the sharded paths keep _rms_norm, _rope, _qkv and _mlp above,
# which autograd records.  Those chains are the kernels' plain versions
# (rms_norm_plain, rope_plain, silu_mul_plain, write_kv_slots), which the
# fused helpers also take on CPU tensors.


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` [..., K] times ``w`` [K, ...] as one matmul on 2-D views:
    the GEMM of the einsums above, [rows, w's other axes flattened]."""
    return x.reshape(-1, x.shape[-1]) @ w.reshape(x.shape[-1], -1)


def _rope_slots(block_table: torch.Tensor, block_size: int) -> torch.Tensor:
    """Each token's pool slot (block id * block_size + offset) for
    sequences written whole into the blocks of ``block_table`` [B, n]:
    [B, n * block_size]."""
    offsets = torch.arange(block_size, device=block_table.device)
    return (block_table.long()[:, :, None] * block_size + offsets).reshape(
        block_table.shape[0], -1)


@functools.lru_cache(maxsize=64)
def _kind_freqs(kind: AttentionKind, head_dim: int, device: torch.device) -> torch.Tensor:
    """The float32 RoPE frequencies of a layer kind on ``device``."""
    if kind.yarn is None:
        return rope_freqs(head_dim, kind.rope_theta, device)
    return yarn_freqs(head_dim, kind.rope_theta, *kind.yarn).to(device)


def _attn_in(x: torch.Tensor, lp: Params, cfg: LlamaConfig, positions: torch.Tensor,
             slots: torch.Tensor, kv_layer: torch.Tensor, kind: AttentionKind, k_out=None,
             v_out=None):
    """ln1, the q/k/v projections, RoPE and the pool write of one layer,
    fused: x [B, T, D] -> (q rotated [B, T, H, Dh], k, v projected [B, T,
    Hkv, Dh]); k and v go rotated into their ``slots`` of ``kv_layer``
    and, where given, into ``k_out`` / ``v_out`` (see rope_kv_fused).
    RoPE is the layer ``kind``'s."""
    B, T = x.shape[:2]
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm_fused(x, lp["ln1"])
    q = _mm(h, lp["wq"]).view(B, T, H, Dh)
    k = _mm(h, lp["wk"]).view(B, T, Hkv, Dh)
    v = _mm(h, lp["wv"]).view(B, T, Hkv, Dh)
    freqs = _kind_freqs(kind, Dh, x.device)
    return rope_kv_fused(q, k, v, positions, freqs, kv_layer, slots, k_out, v_out,
                         kind.rope_scale), k, v


def _layer_out(x: torch.Tensor, attn: torch.Tensor, lp: Params, cfg: LlamaConfig,
               path: str = "prefill") -> torch.Tensor:
    """The rest of a layer after attention, fused: x + attn @ wo, then
    the MLP block (ln2, SiLU(gate) * up, w_down) added, or where the
    layer has a router the routed experts (a ``model.moe`` profiler range;
    ``path`` names the device counters they add to).  x: [..., D]; attn:
    [..., H, Dh] over the same leading axes."""
    x = x + _mm(attn.flatten(-2), lp["wo"]).view(x.shape)
    h = rms_norm_fused(x, lp["ln2"])
    if "w_router" in lp:
        with profiler_range("model.moe", {"tokens": h.numel() // h.shape[-1]}):
            counts = moe_counters(path, x.device) if x.is_cuda else None
            out = routed_experts_fused(
                x.reshape(-1, x.shape[-1]), h.reshape(-1, h.shape[-1]), lp["w_router"],
                lp["e_gate"], lp["e_up"], lp["e_down"], cfg.experts_per_token,
                cfg.norm_topk_prob, counts)
            return out.view(x.shape)
    hidden = silu_mul_fused(_mm(h, lp["w_gate"]), _mm(h, lp["w_up"]))
    return x + _mm(hidden, lp["w_down"]).view(x.shape)


def _head(params: Params) -> torch.Tensor:
    """The output head, [V, D]: its own leaf where untied, else the
    embedding."""
    return params["head"] if "head" in params else params["embed"]


def _logits_fused(x: torch.Tensor, params: Params,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`_logits` with the fused final norm; the head is the same
    float32 product, written into ``out`` where given (see
    :func:`_logits_buffer`)."""
    x = rms_norm_fused(x, params["ln_f"])
    if out is None:
        return torch.einsum("...d,vd->...v", x.float(), _head(params).float())
    torch.mm(x.reshape(-1, x.shape[-1]).float(), _head(params).float().t(),
             out=out.view(-1, out.shape[-1]))
    return out


def _logits_buffer(cfg: LlamaConfig, B: int, T: int, dev) -> Optional[torch.Tensor]:
    """A mixed block's prefill logits, float32 [B, T, V], taken before
    its layers run: the largest tensor a prefill makes then finds the
    caching allocator's largest free block whole, where after the layers
    a leftover activation may have split it.  None for the dense block,
    whose head product allocates its own output after its layers as it
    always has: taken first, the buffer would stay live through them and
    add to its prefills' peak (on an H100, Mistral-7B's measured
    activation reserve at its cell's longest prompt 3.20 -> 3.64 GiB)."""
    if not _mixed(cfg):
        return None
    return torch.empty((B, T, cfg.vocab_size), dtype=torch.float32, device=dev)


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    positions: Optional[torch.Tensor] = None,
    use_flash: bool = True,
    sp_mesh: Optional[Mesh] = None,
    ring_striped: bool = False,
    ring_impl: str = "auto",
) -> torch.Tensor:
    """Dense forward: tokens [B, T] -> logits [B, T, V].

    ``sp_mesh``: a :class:`~llm_d_kv_cache_manager_tpu_torch.parallel.mesh.Mesh`
    with an ``sp`` axis routes every layer's attention through ring
    attention (``ops/ring_attention.py``) — the long-context prefill
    path: the sequence is cut into ``sp`` chunks, K/V chunks rotate
    around the ring, per-step partials merge by log-sum-exp.  The ring's
    causal mask derives from each chunk's ring position, i.e. global
    positions 0..T-1, so custom ``positions`` are rejected rather than
    silently mismasked.

    ``ring_striped``: run the whole network in the striped (token-
    interleaved) sequence layout — tokens AND positions are striped at
    entry, every layer computes in stripe order, attention runs the
    balanced striped ring, and the hidden states are unstriped before
    the logits, so the returned contract is unchanged.  ``ring_impl``:
    ``"auto"`` (the partial kernel on CUDA, the einsum body on the
    CPU), ``"flash"`` or ``"einsum"``.

    An ``sp_mesh`` over several processes (``make_hybrid_mesh``) takes
    plain params, the same in every process, and the same tokens in every
    process, and gives this process's logits as a
    :class:`~llm_d_kv_cache_manager_tpu_torch.parallel.sharding.Sharded`
    of the [B, T, V] logits in the layout the ring ran: with
    ``ring_striped``, the stripe order, which :func:`unstripe` of the
    joined chunks puts back.  Over ``sp`` alone each process embeds,
    projects and runs the MLP only for its own ranks' positions and only
    attention communicates (:func:`_ring_forward_local`; ``P(None, "sp",
    None)``).  Where ``dp``, ``tp``, ``pp`` or ``ep`` has degree > 1 as
    well (the reference's ring routes the batch over ``dp`` and the heads
    over ``tp``), the params are shared onto the mesh by
    :func:`param_pspecs` (``sharding.share_tree``: views wherever a
    rank's slice is contiguous) and run the sharded path (``P("dp", "sp",
    None)``).  Params sharded over a mesh of several processes (with or
    without ``sp_mesh``, which is then their mesh) give this process's
    logits likewise, the ring's stripe order kept.  The ring's K/V moves
    between processes carry no gradient, so over an ``sp_mesh`` of
    several processes a leaf that requires grad raises outside
    ``torch.no_grad()``.
    """
    B, T = tokens.shape
    _dense_only(cfg, "forward")
    if sp_mesh is not None and positions is not None:
        raise ValueError(
            "sp_mesh ring attention assumes default positions 0..T-1 "
            "(its causal mask is derived from ring chunk indices); "
            "custom positions would be RoPE-rotated but mis-masked"
        )
    if sp_mesh is not None and sp_mesh.multi_process:
        _refuse_ring_grad(params)
        if not is_sharded(params) and any(
                sp_mesh.size(axis) > 1 for axis in sp_mesh.axis_names if axis != AXIS_SP):
            params = share_tree(params, sp_mesh, param_pspecs(cfg))
    if is_sharded(params):
        grid = _grid(params, cfg)
        xs, striped = _sharded_run(params, tokens, cfg, grid, positions=positions,
                                   use_flash=use_flash, sp_mesh=sp_mesh,
                                   striped=ring_striped, impl=ring_impl)
        logits = _logits_out(params, grid, xs, (B, T, cfg.vocab_size))
        return unstripe(logits, grid.sp) if striped and not grid.mesh.multi_process else logits
    if sp_mesh is not None and sp_mesh.multi_process:
        return _ring_forward_local(params, tokens, cfg, sp_mesh, ring_striped, ring_impl)
    dev = params["embed"].device
    tokens = tokens.to(dev)
    if positions is None:
        positions = torch.arange(T, device=dev).expand(B, T)
    ring = None
    striped = False
    if sp_mesh is not None:
        ring_size = sp_mesh.shape["sp"]
        striped = ring_striped and ring_size > 1
        if striped:
            tokens = stripe(tokens, ring_size)
            # Positions stay PHYSICAL (RoPE rotates by true token
            # index); only their order is striped to match the tokens.
            positions = stripe(positions, ring_size)
        ring = ring_for_mesh(sp_mesh, striped=striped, impl=ring_impl)
    x = _embed(params, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = _rms_norm(x, lp["ln1"])
        q, k, v = _qkv(h, lp, positions, cfg.rope_theta)
        if ring is not None:
            attn = ring(q, k, v)
        else:
            attn = _prefill_attention(q, k, v, cfg, use_flash=use_flash)
        x = x + _attn_out(attn, lp)
        x = x + _mlp(_rms_norm(x, lp["ln2"]), lp)
    if striped:
        x = unstripe(x, sp_mesh.shape["sp"])
    return _logits(x, params)


def _ring_forward_local(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, sp_mesh: Mesh,
                        striped: bool, impl: str) -> Sharded:
    """:func:`forward` over an ``sp_mesh`` of several processes: this
    process's ring ranks' chunks of the sequence (striped or contiguous,
    positions cut with them) through every layer, the ring's K/V moves
    between processes through their group; returns their logits.  Every
    axis but ``sp`` has degree 1."""
    B, T = tokens.shape
    R = sp_mesh.size(AXIS_SP)
    if T % R:
        raise ValueError(f"sequence {T} not divisible by ring {R}")
    coords = [sp_mesh.coord(sp=r) for r in range(R)]
    ring = ring_of(sp_mesh, coords)
    dev = params["embed"].device
    tokens = tokens.to(dev)
    positions = torch.arange(T, device=dev).expand(B, T)
    striped = striped and R > 1
    if striped:
        # Positions stay PHYSICAL; their order is striped with the tokens.
        tokens, positions = stripe(tokens, R), stripe(positions, R)
    t_loc = T // R
    xs = {r: _embed(params, tokens[:, r * t_loc : (r + 1) * t_loc]) for r in ring.local}
    pos = {r: positions[:, r * t_loc : (r + 1) * t_loc] for r in ring.local}
    body = ring_body(impl, dev.type)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        qkv = {r: _qkv(_rms_norm(xs[r], lp["ln1"]), lp, pos[r], cfg.rope_theta)
               for r in ring.local}
        q, k, v = ({r: t[j].contiguous().to(ring.devices[r]) for r, t in qkv.items()}
                   for j in range(3))
        attn = body(q, k, v, ring, striped=striped)
        for r in ring.local:
            x = xs[r] + _attn_out(attn[r].to(dev), lp)
            xs[r] = x + _mlp(_rms_norm(x, lp["ln2"]), lp)
    locals_ = np.empty(sp_mesh.devices.shape, dtype=object)
    for r in ring.local:
        locals_[coords[r]] = _logits(xs[r], params)
    return Sharded(sp_mesh, P(None, AXIS_SP, None), (B, T, cfg.vocab_size), torch.float32,
                   locals_)


def _refuse_ring_grad(params: Params) -> None:
    """Raise where autograd would record a forward over an ``sp_mesh`` of
    several processes: the ring moves K/V between processes with no
    gradient, so the chunks another process attends to would give the
    leaves no gradient, without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in distinct_locals(params)):
        raise RuntimeError(
            "forward over an sp_mesh of several processes is forward-only: the ring's K/V "
            "moves between processes carry no gradient; call it under torch.no_grad(), or "
            "train through loss_fn")


def _scatter_kv_blocks(kv_layer, k, v, block_ids, block_size) -> None:
    """Write per-token K/V ([B, T, Hkv, Dh] each, T a multiple of
    ``block_size``) IN PLACE into the pool blocks named by ``block_ids``
    ([B, T/block_size]).  ONE layout for every prefill path."""
    write_kv_slots(kv_layer, k, v, _rope_slots(block_ids, block_size))


def prefill_paged(
    params: Params,
    tokens: torch.Tensor,
    kv_pool: torch.Tensor,
    block_table: torch.Tensor,
    cfg: LlamaConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill writing per-layer K/V into the paged pool, in place.

    tokens: [B, T] with T % block_size == 0; kv_pool:
    [L, num_blocks, 2, block_size, Hkv, Dh] (``KVCachePool.kv``);
    block_table: [B, T/block_size] pool block ids for each sequence.
    Returns (logits [B, T, V], kv_pool) — the same pool tensor, updated.
    A ``model.prefill_paged`` profiler range (batch, new and prefix
    tokens) around ``model.prefill.inputs``, ``.layers`` and ``.logits``.

    Unsharded, each layer's elementwise stages are single launches of
    ``ops/layer_fused.py`` on CUDA tensors (their plain versions on the
    CPU): RMSNorm, RoPE with the pool write (rotated k also written out
    for the attention), SiLU(gate) * up, and RMSNorm before the head.
    Those kernels are forward-only; ``forward``, ``loss_fn`` and the
    sharded paths keep the op-by-op chains, which autograd records.
    """
    B, T = tokens.shape
    with profiler_range("model.prefill_paged", {"batch": B, "new": T, "prefix": 0}):
        if is_sharded(params):
            return _prefill_sharded(params, tokens, kv_pool, block_table, cfg, 0)
        dev = _plain_pool(kv_pool).device
        with profiler_range("model.prefill.inputs"):
            tokens, block_table = tokens.to(dev), block_table.to(dev)
            positions = torch.arange(T, device=dev).expand(B, T)
            slots = _rope_slots(block_table, cfg.block_size)
        logits = _logits_buffer(cfg, B, T, dev)
        with profiler_range("model.prefill.layers"):
            x = _embed(params, tokens)
            for i in range(cfg.n_layers):
                lp, kind = _layer(params, i), cfg.kind(i)
                k_rot = torch.empty((B, T, cfg.n_kv_heads, cfg.head_dim), dtype=x.dtype,
                                    device=dev)
                q, _, v = _attn_in(x, lp, cfg, positions, slots, kv_pool[i], k_out=k_rot,
                                   kind=kind)
                attn = _prefill_attention(q, k_rot, v, cfg, window=kind.window)
                x = _layer_out(x, attn, lp, cfg)
        with profiler_range("model.prefill.logits"):
            return _logits_fused(x, params, logits), kv_pool


def prefill_continue(
    params: Params,
    tokens: torch.Tensor,
    kv_pool: torch.Tensor,
    block_table: torch.Tensor,
    prefix_len: int,
    cfg: LlamaConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill only the uncached suffix of a prompt (prefix-cache hit).

    The first ``prefix_len`` tokens' K/V already live in the pool; this
    computes the suffix attending over gathered-prefix + new K/V and
    writes the suffix blocks into the pool in place.

    tokens: [B, Ts] suffix tokens, Ts % block_size == 0.
    block_table: [B, (prefix_len + Ts) / block_size] — prefix blocks
    first, then the blocks to write.  Returns (suffix logits
    [B, Ts, V], kv_pool).  A ``model.prefill_continue`` profiler range
    around ``model.prefill.inputs``, ``.layers`` and ``.logits``, as
    :func:`prefill_paged` has.

    Unsharded, on the fused path of :func:`prefill_paged`: each layer
    gathers the prefix K/V into the head of a [B, prefix_len + Ts, Hkv,
    Dh] pair, and the RoPE kernel writes the suffix's rotated k and its
    v into their tail as it writes their pool slots, so no
    concatenation follows.
    """
    B, Ts = tokens.shape
    with profiler_range("model.prefill_continue",
                        {"batch": B, "new": Ts, "prefix": prefix_len}):
        if is_sharded(params):
            return _prefill_sharded(params, tokens, kv_pool, block_table, cfg, prefix_len)
        dev = _plain_pool(kv_pool).device
        if prefix_len % cfg.block_size or Ts % cfg.block_size:
            raise ValueError("prefix_len and Ts must be block_size multiples")
        npre = prefix_len // cfg.block_size
        nsuf = Ts // cfg.block_size
        with profiler_range("model.prefill.inputs"):
            tokens, block_table = tokens.to(dev), block_table.to(dev)
            positions = (prefix_len + torch.arange(Ts, device=dev)).expand(B, Ts)
            slots = _rope_slots(block_table[:, npre : npre + nsuf], cfg.block_size)
        logits = _logits_buffer(cfg, B, Ts, dev)
        with profiler_range("model.prefill.layers"):
            x = _embed(params, tokens)
            prefix_ids = block_table[:, :npre].long()  # [B, npre]
            Hkv, Dh, bs = cfg.n_kv_heads, cfg.head_dim, cfg.block_size
            for i in range(cfg.n_layers):
                lp, kind = _layer(params, i), cfg.kind(i)
                kv_layer = kv_pool[i]
                # The layer's prefix + suffix K/V, [B, prefix_len + Ts, Hkv,
                # Dh]: the prefix gathered from the pool, the suffix
                # written by the RoPE kernel into the tail.
                k_full, v_full = (torch.empty((B, prefix_len + Ts, Hkv, Dh), dtype=x.dtype,
                                              device=dev) for _ in range(2))
                q, _, _ = _attn_in(x, lp, cfg, positions, slots, kv_layer,
                                   k_out=k_full[:, prefix_len:], v_out=v_full[:, prefix_len:],
                                   kind=kind)
                # Gathered after the projections' weights have streamed
                # through L2, so that the attention finds the prefix there.
                pre = kv_layer[prefix_ids]  # [B, npre, 2, block, Hkv, Dh]
                k_full[:, :prefix_len].view(B, npre, bs, Hkv, Dh).copy_(pre[:, :, 0])
                v_full[:, :prefix_len].view(B, npre, bs, Hkv, Dh).copy_(pre[:, :, 1])
                attn = _prefill_attention(q, k_full, v_full, cfg, q_offset=prefix_len,
                                          window=kind.window)
                x = _layer_out(x, attn, lp, cfg)
        with profiler_range("model.prefill.logits"):
            return _logits_fused(x, params, logits), kv_pool


def prefill_chunked(
    params: Params,
    tokens: torch.Tensor,
    kv_pool: torch.Tensor,
    block_table: torch.Tensor,
    cfg: LlamaConfig,
    chunk_tokens: int = 2048,
    seq_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounded-activation long-prompt prefill: the prompt runs in
    ``chunk_tokens`` chunks, each writing its K/V blocks into the pool
    FIRST and then attending over every pool position so far with the
    chunk's ``q_offset`` (causality hides the blocks not written yet).

    tokens: [B, T] with T % chunk_tokens == 0 and chunk_tokens %
    block_size == 0; block_table: [B, T / block_size].  ``seq_len``
    ([B], defaults to T): each sequence's true length; the logits come
    from position ``seq_len - 1`` (clamped into range), never a pad.
    Returns (last-position logits [B, V], kv_pool).  Takes unsharded
    params and pool only.  Runs the fused stages of :func:`prefill_paged`
    (the RoPE kernel writes each chunk's K/V into the pool before the
    attention reads it back).
    """
    if is_sharded(params):
        raise TypeError("prefill_chunked takes unsharded params; prefill_paged and "
                        "prefill_continue take sharded ones")
    dev = _plain_pool(kv_pool).device
    tokens, block_table = tokens.to(dev), block_table.to(dev)
    B, T = tokens.shape
    C = chunk_tokens
    if T % C or C % cfg.block_size:
        raise ValueError(
            "chunk_tokens must divide T, and block_size must divide "
            f"chunk_tokens (T={T}, chunk={C}, block={cfg.block_size})"
        )
    blocks_per_chunk = C // cfg.block_size
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    if seq_len is None:
        seq_len = torch.full((B,), T, dtype=torch.long, device=dev)
    # Clamped into range, as in the reference: an out-of-range length
    # must still select a real position.
    last_pos = torch.clamp(seq_len.to(dev).long() - 1, 0, T - 1)  # [B]
    table = block_table.long()
    last_h = torch.zeros((B, cfg.d_model), dtype=params["embed"].dtype, device=dev)
    for c in range(T // C):
        start = c * C
        tok = tokens[:, start : start + C]
        positions = (torch.arange(C, device=dev) + start).expand(B, C)
        x = _embed(params, tok)
        slots = _rope_slots(
            block_table[:, c * blocks_per_chunk : (c + 1) * blocks_per_chunk], cfg.block_size)
        for i in range(cfg.n_layers):
            lp, kind = _layer(params, i), cfg.kind(i)
            kv_layer = kv_pool[i]
            q, k, v = _attn_in(x, lp, cfg, positions, slots, kv_layer, kind=kind)
            full = kv_layer[table]  # [B, nb, 2, bs, Hkv, Dh]
            k_full = full[:, :, 0].reshape(B, T, Hkv, Dh).to(k.dtype)
            v_full = full[:, :, 1].reshape(B, T, Hkv, Dh).to(v.dtype)
            attn = flash_gqa_attention_cuda(q, k_full, v_full, q_offset=start,
                                            **_windowed(kind.window))
            x = _layer_out(x, attn, lp, cfg)
        in_chunk = (last_pos // C) == c  # [B]
        offset = torch.clamp(last_pos - start, 0, C - 1)
        picked = x[torch.arange(B, device=dev), offset]
        last_h = torch.where(in_chunk[:, None], picked, last_h)
    return _logits_fused(last_h, params), kv_pool


def decode_step(
    params: Params,
    tokens: torch.Tensor,
    kv_pool: torch.Tensor,
    block_table: torch.Tensor,
    context_len: torch.Tensor,
    cfg: LlamaConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step over the paged pool.

    tokens: [B] current token ids; context_len: [B] length *including*
    the current token; block_table: [B, max_blocks].  Writes the new
    token's K/V into its pool slot in place, attends over the table,
    and returns (logits [B, V], kv_pool).

    Unsharded, on the fused path of :func:`prefill_paged`: the RoPE
    kernel writes the token's K/V into the slot that the table and
    ``context_len`` name, both read on the device, so a captured step
    writes where each replay's inputs say.  Sharded params take
    ``_decode_sharded``, with the op-by-op chains.
    """
    if is_sharded(params):
        return _decode_sharded(params, tokens, kv_pool, block_table, context_len, cfg)
    dev = _plain_pool(kv_pool).device
    tokens = tokens.to(dev)
    # The decode kernel reads int32 tables and lengths.
    block_table = block_table.to(dev, torch.int32).contiguous()
    context_len = context_len.to(dev, torch.int32).contiguous()
    pos = context_len.long()[:, None] - 1  # [B, 1]
    x = _embed(params, tokens)[:, None]  # [B, 1, D]
    # The token's pool slot, from the table and the lengths on the
    # device, so a captured graph writes where each replay's inputs say.
    block_ids = torch.gather(block_table.long(), 1, pos // cfg.block_size)
    slots = block_ids * cfg.block_size + pos % cfg.block_size  # [B, 1]
    for i in range(cfg.n_layers):
        lp, kind = _layer(params, i), cfg.kind(i)
        kv_layer = kv_pool[i]
        q, _, _ = _attn_in(x, lp, cfg, pos, slots, kv_layer, kind=kind)
        attn = paged_decode_attention_cuda(q[:, 0], kv_layer, block_table, context_len,
                                           **_windowed(kind.window))
        x = _layer_out(x, attn[:, None], lp, cfg, path="decode")
    return _logits_fused(x[:, 0], params), kv_pool


class CapturedDecodeStep:
    """:func:`decode_step` for one (batch, table width), replayed from
    one CUDA graph: the port's form of the reference's jitted step with
    its pool donated.  Made by :func:`make_decode_step`.

    ``step(tokens, block_table, context_len)`` returns logits ``[B, V]``.
    On a CUDA pool the inputs are copied into static device buffers and
    the graph is replayed; the first call runs :func:`decode_step` once
    eagerly on those buffers on a side stream (which builds the kernel
    and lets cuBLAS choose its algorithms), captures it, and replays.
    The eager run, the capture and the replay write the same K/V into
    the same slot, so the first call is exact.  The pool is written IN
    PLACE.  The logits returned are the graph's static output, valid
    until the next call: a caller that keeps them clones them.  The
    graph's private memory pool holds the step's intermediates for the
    life of this object, the float32 copy of the embedding that
    ``_logits`` makes among them (4 bytes per embedding element).

    ``block_table`` may be narrower than ``max_blocks``: it is copied
    into the left columns, and the step reads nothing past a context.
    Another batch size or a wider table raises; make another step for
    it.  A sharded pool (``KVCachePool(..., sharding=...)``, with
    sharded params) whose ranks all share one CUDA device is captured
    whole, every shard's kernels in one graph.  On a CPU pool, or one
    whose ranks span several devices, there is nothing to capture and
    every call is :func:`decode_step`; so it is over a pool whose mesh
    spans processes: a gloo transfer waits on the host (the staging
    copies synchronize), which no CUDA graph can hold, and the step
    returns this process's logits (a ``Sharded``, as ``decode_step``
    does).  ``replays`` counts graph
    replays; ``graph`` is the ``torch.cuda.CUDAGraph`` (None when
    nothing is captured), made empty here
    and captured by the first call, so that a caller who wants to
    inspect the captured graph can replace it before that call with one
    that keeps it (``torch.cuda.CUDAGraph(keep_graph=True)``).

    The graph holds :func:`decode_step`'s fused stages (three launches
    of ``ops/layer_fused.py`` and the decode kernel a layer besides the
    GEMMs and residual adds), so a replay runs 15 to 20 kernels a layer;
    with routed experts, the five launches of ``ops/moe_experts.py``'s
    grouped path in place of the dense MLP's, adding to the "decode"
    device counters at every replay.

    Each call is a ``model.decode_step`` profiler range (its batch
    bucket) around ``model.decode.inputs`` (the three copies), then
    ``model.decode.capture`` (the first call's eager run and capture,
    counted in ``kvtpu_kernel_builds_total{what="graph"}``) and
    ``model.decode.replay``, or ``model.decode.eager`` where nothing is
    captured.
    """

    def __init__(self, params: Params, kv_pool: torch.Tensor, cfg: LlamaConfig,
                 batch: int, max_blocks: int) -> None:
        if batch < 1 or max_blocks < 1:
            raise ValueError(f"batch and max_blocks must be positive, got {batch}, {max_blocks}")
        self.params, self.kv_pool, self.cfg = params, kv_pool, cfg
        self.batch, self.max_blocks = batch, max_blocks
        self.replays = 0
        self._range_attrs = {"batch": batch}
        if isinstance(kv_pool, Sharded):
            # One graph holds the step of every shard when all ranks
            # share one device; across devices or processes every call
            # runs eagerly.
            devices = set(kv_pool.mesh.devices.flat)
            dev = kv_pool.distinct()[0][1].device
            self.device = (dev if len(devices) == 1 and dev.type == "cuda"
                           and not kv_pool.mesh.multi_process else None)
        else:
            dev = kv_pool.device
            self.device = dev if dev.type == "cuda" else None
        self.graph = torch.cuda.CUDAGraph() if self.device is not None else None
        self.logits = None  # the graph's static output, once captured
        self.tokens = torch.zeros((batch,), dtype=torch.long, device=dev)
        self.block_table = torch.zeros((batch, max_blocks), dtype=torch.int32, device=dev)
        self.context_len = torch.ones((batch,), dtype=torch.int32, device=dev)

    def _run(self) -> torch.Tensor:
        return decode_step(self.params, self.tokens, self.kv_pool, self.block_table,
                           self.context_len, self.cfg)[0]

    def _capture(self) -> None:
        t0 = time.perf_counter()
        with profiler_range("model.decode.capture"):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._run()
            torch.cuda.current_stream(self.device).wait_stream(side)
            with torch.cuda.graph(self.graph):
                self.logits = self._run()
        count_build("graph", time.perf_counter() - t0)

    def __call__(self, tokens: torch.Tensor, block_table: torch.Tensor,
                 context_len: torch.Tensor) -> torch.Tensor:
        width = block_table.shape[-1]
        if (tuple(tokens.shape) != (self.batch,) or tuple(context_len.shape) != (self.batch,)
                or block_table.dim() != 2 or block_table.shape[0] != self.batch
                or width > self.max_blocks):
            raise ValueError(
                f"this step was made for batch {self.batch} and tables up to "
                f"{self.max_blocks} blocks wide; got tokens {tuple(tokens.shape)}, "
                f"block_table {tuple(block_table.shape)}, context_len "
                f"{tuple(context_len.shape)}")
        with profiler_range("model.decode_step", self._range_attrs):
            with profiler_range("model.decode.inputs"):
                self.tokens.copy_(tokens)
                self.block_table[:, :width].copy_(block_table)
                self.context_len.copy_(context_len)
            if self.graph is None:
                with profiler_range("model.decode.eager"):
                    return self._run()
            with torch.cuda.device(self.device):
                if self.logits is None:
                    self._capture()
                with profiler_range("model.decode.replay"):
                    self.graph.replay()
        self.replays += 1
        return self.logits


def make_decode_step(
    params: Params,
    kv_pool: torch.Tensor,
    cfg: LlamaConfig,
    batch: int,
    max_blocks: int,
) -> CapturedDecodeStep:
    """The decode step over ``kv_pool`` for ``batch`` sequences and
    tables up to ``max_blocks`` wide, as a callable that replays one
    captured CUDA graph (see :class:`CapturedDecodeStep`)."""
    return CapturedDecodeStep(params, kv_pool, cfg, batch, max_blocks)


# ---------------------------------------------------------------- sharded
#
# Params cut by param_pspecs over a Mesh (parallel/sharding.py) carry the
# mesh, as a JAX array carries its sharding, and every entry point above
# takes them.  Rank (d, p, e, s, t) holds batch shard d, layer stage p,
# expert shard e, sequence chunk s and head shard t.  A process computes
# the ranks it owns (every rank, on a mesh of one process), walking them
# in one fixed order: layer, then d, s and t ascending, so that every
# process calls the collectives of each sub-group in one order.  An
# activation shard [B/dp, T/sp, D] lives on the device of its first tp
# rank of the current stage; a collective over an axis joins or sums
# every rank's part in rank order, moved with .to(device) inside a
# process and through the process group across processes
# (sharding.all_gather_over / all_reduce_over), so that every process
# gets the single controller's bits.  Ranks along ep (and, for the
# expert weights, along dp and sp) hold replicas: a process computes
# them once, on its first ep index; processes along ep compute the same.
# Across pp, a stage's activations hop to the next stage's process, and
# the last stage's hidden states go to every process along pp, which
# makes the logits itself (ln_f and the embedding are not cut over pp).


class _Grid:
    """A sharded path's view of its params' mesh: each axis's degree,
    each rank's device, each layer's stage, and the indices along each
    axis that this process computes (``dps``, ``pps``, ``eps``, ``sps``,
    ``tps``: one run of each axis, every index on a mesh of one
    process)."""

    def __init__(self, mesh: Mesh, n_layers: int) -> None:
        if set(mesh.axis_names) != set(AXIS_ORDER):
            raise ValueError(f"a sharded path takes a mesh with the axes {AXIS_ORDER} "
                             f"(make_mesh), not {mesh.axis_names}")
        self.mesh = mesh
        self.dp, self.pp, self.ep, self.sp, self.tp = (
            mesh.size(a) for a in ("dp", "pp", "ep", "sp", "tp"))
        if n_layers % self.pp:
            raise ValueError(f"{n_layers} layers do not divide over pp={self.pp}")
        self.per_stage = n_layers // self.pp
        local = [c for c in np.ndindex(mesh.devices.shape) if mesh.is_local(c)]
        owned = {a: sorted({c[k] for c in local}) for k, a in enumerate(mesh.axis_names)}
        for a, run in owned.items():
            if (run != list(range(run[0], run[-1] + 1)) or mesh.size(a) % len(run)
                    or run[0] % len(run)):
                raise ValueError(f"this process's {a} indices {run} are not one of "
                                 f"{mesh.size(a)} // {len(run)} equal runs")
        if len(local) != math.prod(len(run) for run in owned.values()):
            raise ValueError(f"this process's entries of {mesh} are not a box of it")
        self.dps, self.pps, self.eps, self.sps, self.tps = (
            owned[a] for a in ("dp", "pp", "ep", "sp", "tp"))
        self.e = self.eps[0]
        self.home = self.dev(self.dps[0], self.pps[0], self.e, self.sps[0], self.tps[0])

    def coord(self, d=0, p=0, e=0, s=0, t=0) -> Tuple[int, ...]:
        return self.mesh.coord(dp=d, pp=p, ep=e, sp=s, tp=t)

    def dev(self, d=0, p=0, e=0, s=0, t=0) -> torch.device:
        return self.mesh.devices[self.coord(d, p, e, s, t)]

    def lead(self, p: Optional[int] = None) -> Tuple[int, ...]:
        """This process's first coordinate (at stage ``p``): the lines
        along any axis through it are this process's."""
        return self.coord(self.dps[0], self.pps[0] if p is None else p, self.e, self.sps[0],
                          self.tps[0])

    def stage(self, layer: int) -> int:
        return layer // self.per_stage

    def take(self, leaf: Sharded, layer: Optional[int] = None, d=0, p=0, e=0, s=0,
             t=0) -> torch.Tensor:
        """The rank's slice of ``leaf``; of one layer for a stacked leaf,
        whose axis 0 may be cut over ``pp``."""
        x = leaf.locals[self.coord(d, p, e, s, t)]
        if layer is None:
            return x
        return x[layer - p * self.per_stage if leaf.spec[0] == "pp" else layer]

    def layer(self, params: Params, keys, i: int, d=0, p=0, e=0, s=0, t=0) -> Params:
        return {key: self.take(params["layers"][key], i, d, p, e, s, t) for key in keys}

    def cut(self, x: torch.Tensor, d: int, s: Optional[int] = None) -> torch.Tensor:
        """Batch shard d (and sequence chunk s) of a global [B, T, ...]."""
        b = x.shape[0] // self.dp
        x = x[d * b : (d + 1) * b]
        if s is None:
            return x
        tl = x.shape[1] // self.sp
        return x[:, s * tl : (s + 1) * tl]

    def shards(self):
        """This process's (d, s) shards, in the order it walks them."""
        return [(d, s) for d in self.dps for s in self.sps]

    def ranks(self, axis: str, parts, coord) -> list:
        return ranks_over(parts, self.mesh, axis, coord)

    def gather(self, axis: str, parts, coord, device, dim: int) -> torch.Tensor:
        return all_gather_over(parts, self.mesh, axis, coord, device, dim)

    def reduce(self, axis: str, parts, coord, device, grad: str = "sum") -> torch.Tensor:
        return all_reduce_over(parts, self.mesh, axis, coord, device, grad=grad)

    def assemble(self, shards: Dict[Tuple[int, int], torch.Tensor], p: int,
                 device: torch.device) -> torch.Tensor:
        """The global tensor of {(d, s): shard} (of stage ``p``) on
        ``device``: each process's shards joined over sp and dp with
        every other process's."""
        rows = [self.gather("sp", [shards[d, s] for s in self.sps],
                            self.coord(d, p, self.e, self.sps[0], self.tps[0]), device, 1)
                for d in self.dps]
        return self.gather("dp", rows, self.lead(p), device, 0)

    def hop(self, xs, p_from: int, p_to: int, like) -> None:
        """The stage hop between processes: the shards of ``xs`` go from
        the process of stage ``p_from`` to the one of ``p_to`` along pp
        (in one tensor); inside a process the layer loop moves them."""
        if "pp" not in self.mesh.crossing_axes():
            return
        coord = self.lead()
        k = self.mesh.axis_names.index("pp")
        ends = [self.mesh.process_of(coord[:k] + (p,) + coord[k + 1:]) for p in (p_from, p_to)]
        if ends[0] == ends[1] or self.mesh.process not in ends:
            return
        keys = self.shards()
        sent = torch.stack([xs.pop(k) for k in keys]) if p_from in self.pps else None
        shape, dtype = like
        got = transport(self.mesh).hop(sent, "pp", coord, p_from, p_to,
                                       ((len(keys),) + shape, dtype, self.home))
        if got is not None:
            xs.update(zip(keys, got.unbind(0)))

    def from_last_stage(self, xs, like):
        """The last stage's hidden shards in every process along pp (a
        broadcast where pp crosses processes)."""
        if "pp" not in self.mesh.crossing_axes():
            return xs
        keys = self.shards()
        last = self.pp - 1
        sent = torch.stack([xs[k] for k in keys]) if last in self.pps else None
        shape, dtype = like
        got = transport(self.mesh).broadcast(sent, "pp", self.lead(), last,
                                             ((len(keys),) + shape, dtype, self.home))
        return dict(zip(keys, got.unbind(0)))

    def write_kv(self, kv_pool: Sharded, i: int, d: int, p: int, s: int, t: int,
                 write: Callable) -> None:
        """``write(layer i)`` into every copy of rank (d, p, s, t)'s pool
        slice that this process holds: copies on other devices hold the
        same heads (copies in other processes: :func:`_share_written`)."""
        for copy in kv_pool.replicas(dp=d, pp=p, ep=self.e, sp=s, tp=t):
            write(copy[i - p * self.per_stage if kv_pool.spec[0] == "pp" else i])


def is_sharded(params: Params) -> bool:
    """Whether ``params`` were cut over a mesh (``shard_tree``)."""
    return isinstance(params["embed"], Sharded)


def _same_mesh(a: Mesh, b: Mesh) -> bool:
    return a is b or (a.axis_names == b.axis_names and a.devices.shape == b.devices.shape
                      and all(x == y for x, y in zip(a.devices.flat, b.devices.flat))
                      and np.array_equal(a.processes, b.processes))


def _grid(params: Params, cfg, kv_pool=None) -> _Grid:
    """The grid of sharded params, checking a pool beside them: it must
    lie on the same mesh with its kv heads cut over ``tp`` (and maybe its
    layers over ``pp``), and nothing else cut."""
    if not all(isinstance(leaf, Sharded) for leaf in param_leaves(params)):
        raise TypeError("params are partly sharded: shard every leaf (shard_tree)")
    grid = _Grid(tree_mesh(params), cfg.n_layers)
    if kv_pool is not None:
        if not isinstance(kv_pool, Sharded):
            raise TypeError("sharded params take a sharded pool (KVCachePool(..., sharding=...))")
        spec = kv_pool.spec
        if not (_same_mesh(kv_pool.mesh, grid.mesh) and spec[0] in (None, "pp")
                and spec[1:4] == (None, None, None) and spec[5] is None
                and spec[4] == ("tp" if grid.tp > 1 else spec[4]) and spec[4] in (None, "tp")):
            raise ValueError(f"a pool cut by {spec} over {kv_pool.mesh} does not match params "
                             f"over {grid.mesh}: cut its kv heads over tp")
    return grid


def _plain_pool(kv_pool) -> torch.Tensor:
    if isinstance(kv_pool, Sharded):
        raise TypeError("a sharded pool takes sharded params "
                        "(shard_tree(params, mesh, param_pspecs(cfg)))")
    return kv_pool


def _sharded_stack(params: Params, tokens: torch.Tensor, positions: torch.Tensor, cfg,
                   grid: _Grid, attend: Callable, mlp_block: Callable, every_stage: bool = True):
    """Embed, then run every layer over this process's ranks.  ``tokens``
    and ``positions``: global [B, T].  ``attend(i, d, p, t, qs, ks, vs)``
    gives layer i's attention of batch shard d and head shard t, {s: out}
    for this process's sequence chunks s ({s: q} and so on);
    ``mlp_block(i, p, xs)`` adds the MLP's output to every shard of
    ``xs``.  Returns ``xs``, {(d, s): hidden [B/dp, T/sp, D]} of the last
    stage for this process's batch shards and chunks, in every process;
    with ``every_stage`` False only in the processes of the last stage
    (empty in the others: the loss is made once, where the stage is)."""
    B, T = tokens.shape
    if B % grid.dp or T % grid.sp:
        raise ValueError(f"[B={B}, T={T}] does not divide over dp={grid.dp} x sp={grid.sp}")
    like = ((B // grid.dp, T // grid.sp, cfg.d_model), params["embed"].dtype)
    e, t0 = grid.e, grid.tps[0]
    xs = {}
    if 0 in grid.pps:
        # The embedding's width is cut over tp: each rank looks up its
        # columns, and an all-gather joins them.
        for d, s in grid.shards():
            parts = [grid.take(params["embed"], None, d, 0, e, s, t)[
                grid.cut(tokens, d, s).to(grid.dev(d, 0, e, s, t)).long()] for t in grid.tps]
            xs[d, s] = grid.gather("tp", parts, grid.coord(d, 0, e, s, t0),
                                   grid.dev(d, 0, e, s, t0), -1)
    keys = ("ln1", "wq", "wk", "wv", "wo")
    for i in range(cfg.n_layers):
        p = grid.stage(i)
        if p and i == p * grid.per_stage:
            grid.hop(xs, p - 1, p, like)
        if p not in grid.pps:
            continue
        for d in grid.dps:
            lps, qkv = {}, {}
            for s in grid.sps:
                # A stage's first layer: the activations hop stages.
                xs[d, s] = xs[d, s].to(grid.dev(d, p, e, s, t0))
                for t in grid.tps:
                    dev = grid.dev(d, p, e, s, t)
                    lps[s, t] = lp = grid.layer(params, keys, i, d, p, e, s, t)
                    h = _rms_norm(xs[d, s].to(dev), lp["ln1"])
                    qkv[s, t] = _qkv(h, lp, grid.cut(positions, d, s).to(dev), cfg.rope_theta)
            attn = {}
            for t in grid.tps:
                chunks = ({s: qkv[s, t][j] for s in grid.sps} for j in range(3))
                for s, out in attend(i, d, p, t, *chunks).items():
                    attn[s, t] = out
            # wo's rows are cut over tp: an all-reduce sums the partials.
            for s in grid.sps:
                xs[d, s] = xs[d, s] + grid.reduce(
                    "tp", [_attn_out(attn[s, t], lps[s, t]) for t in grid.tps],
                    grid.coord(d, p, e, s, t0), xs[d, s].device)
        mlp_block(i, p, xs)
    return grid.from_last_stage(xs, like) if every_stage else xs


def _tp_mlp_block(params: Params, grid: _Grid) -> Callable:
    """The gated MLP with its hidden width cut over tp: each rank's
    partial ``w_down`` product, summed by an all-reduce."""
    keys = ("ln2", "w_gate", "w_up", "w_down")

    def block(i: int, p: int, xs) -> None:
        for (d, s), x in list(xs.items()):
            parts = []
            for t in grid.tps:
                lp = grid.layer(params, keys, i, d, p, grid.e, s, t)
                parts.append(_mlp(_rms_norm(x.to(grid.dev(d, p, grid.e, s, t)), lp["ln2"]), lp))
            xs[d, s] = x + grid.reduce("tp", parts, grid.coord(d, p, grid.e, s, grid.tps[0]),
                                       x.device)

    return block


def _sharded_logits(params: Params, x: torch.Tensor, grid: _Grid, d: int, s: int):
    """:func:`_logits` of shard (d, s): the embedding's width is cut over
    tp, so each rank's float32 product is partial and an all-reduce sums
    them in float32 (in rank order, across processes too).  Every process
    along tp holds the same logits and seeds the same loss on them, so
    across processes each partial's gradient is its own process's
    (``grad="same"``): no transfer in the backward."""
    p, e, w = grid.pps[-1], grid.e, x.shape[-1] // grid.tp
    parts = []
    for t in grid.tps:
        dev = grid.dev(d, p, e, s, t)
        h = _rms_norm(x.to(dev), grid.take(params["ln_f"], None, d, p, e, s, t))
        embed = grid.take(params["embed"], None, d, p, e, s, t)
        parts.append(torch.einsum("...d,vd->...v", h[..., t * w : (t + 1) * w].float(),
                                  embed.float()))
    return grid.reduce("tp", parts, grid.coord(d, p, e, s, grid.tps[0]), x.device, grad="same")


def _logits_out(params: Params, grid: _Grid, xs, shape: Tuple[int, ...]):
    """The logits of the hidden shards ``xs``, of global ``shape`` ([B, T,
    V], or [B, V] for shards of one position each).  On a mesh of one
    process, the whole tensor on the first rank's device.  Over several
    processes, this process's: a :class:`Sharded` over ``P("dp", "sp",
    None)`` (``P("dp", None)`` for [B, V]) whose every local entry holds
    its (d, s) shard, the same bits in every process that holds it."""
    logits = {}
    for (d, s), x in xs.items():
        logits[d, s] = _sharded_logits(params, x, grid, d, s)
        if len(shape) == 2:
            logits[d, s] = logits[d, s][:, 0]
    if not grid.mesh.multi_process:
        return grid.assemble(logits, grid.pps[-1], grid.home)
    mesh = grid.mesh
    spec = P("dp", "sp", None) if len(shape) == 3 else P("dp", None)
    locals_ = np.empty(mesh.devices.shape, dtype=object)
    for coord in np.ndindex(mesh.devices.shape):
        if mesh.is_local(coord):
            x = logits[coord[mesh.axis_names.index("dp")], coord[mesh.axis_names.index("sp")]]
            locals_[coord] = x.to(mesh.devices[coord])
    return Sharded(mesh, spec, shape, torch.float32, locals_)


def _gather_attend(cfg, use_flash: bool, grid: _Grid) -> Callable:
    """Attention over an sp-cut sequence without a ring: each chunk's
    queries attend over the K/V chunks up to its own, gathered onto its
    device (later chunks lie wholly in its future; across processes the
    chunks of every process along sp), at the ``q_offset`` of its first
    position, on the op :func:`_prefill_attention` routes to.  With sp =
    1, each head shard's attention on its own."""

    def attend(i, d, p, t, qs, ks, vs):
        coord = grid.coord(d, p, grid.e, grid.sps[0], t)
        k_all = grid.ranks("sp", [ks[s] for s in grid.sps], coord)
        v_all = grid.ranks("sp", [vs[s] for s in grid.sps], coord)
        out = {}
        for s, q in qs.items():
            dev = grid.dev(d, p, grid.e, s, t)
            out[s] = _prefill_attention(q, all_gather(k_all[: s + 1], dev, 1),
                                        all_gather(v_all[: s + 1], dev, 1), cfg,
                                        q_offset=s * q.shape[1], use_flash=use_flash)
        return out

    return attend


def _sharded_run(params: Params, tokens: torch.Tensor, cfg, grid: _Grid, *,
                 positions: Optional[torch.Tensor] = None, use_flash: bool = True,
                 sp_mesh: Optional[Mesh] = None, striped: bool = False, impl: str = "auto",
                 mlp_block: Optional[Callable] = None, every_stage: bool = True):
    """The dense forward's layers over sharded params (``forward``'s
    arguments; ``mlp_block`` replaces the gated MLP; ``every_stage`` as
    for :func:`_sharded_stack`).  Returns (xs, striped): the hidden
    shards of :func:`_sharded_stack` and whether they are in the stripe
    layout."""
    B, T = tokens.shape
    out = grid.home
    tokens = tokens.to(out)
    positions = (torch.arange(T, device=out).expand(B, T) if positions is None
                 else positions.to(out))
    if sp_mesh is not None:
        if not _same_mesh(sp_mesh, grid.mesh):
            raise ValueError(f"sp_mesh {sp_mesh} is not the params' mesh {grid.mesh}")
        striped = striped and grid.sp > 1
        if striped:
            tokens, positions = stripe(tokens, grid.sp), stripe(positions, grid.sp)
        body = ring_body(impl, out.type)

        def attend(i, d, p, t, qs, ks, vs):
            ring = ring_of(grid.mesh, [grid.coord(d, p, grid.e, s, t) for s in range(grid.sp)])
            return body(qs, ks, vs, ring, striped=striped)
    else:
        striped = False
        attend = _gather_attend(cfg, use_flash, grid)
    xs = _sharded_stack(params, tokens, positions, cfg, grid, attend,
                        mlp_block or _tp_mlp_block(params, grid), every_stage)
    return xs, striped


def _sharded_nll(params: Params, tokens: torch.Tensor, grid: _Grid, xs,
                 extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`next_token_nll` over the shards, in its shift-and-mask
    form, plus ``extra`` (the MoE's weighted aux loss, the same in every
    process): a chunk's last target is the next chunk's first token,
    taken from the global roll; each shard's logits are made and dropped
    in turn, and the shards' sums add in rank order.  On a mesh of
    several processes the loss of the whole batch, the same in every
    process (:func:`_global_loss`)."""
    B, T = tokens.shape
    out = grid.home
    tokens = tokens.to(out).long()
    targets = torch.roll(tokens, -1, dims=1)
    mask = (torch.arange(T, device=out) < T - 1).expand(B, T)
    sums = []
    for (d, s), x in xs.items():
        logp = torch.log_softmax(_sharded_logits(params, x, grid, d, s), dim=-1)
        nll = -torch.gather(logp, -1, grid.cut(targets, d, s).to(logp.device)[..., None])[..., 0]
        sums.append((nll * grid.cut(mask, d, s).to(nll.device, nll.dtype)).sum())
    if grid.mesh.multi_process:
        return _global_loss(grid, sums, B * (T - 1), extra)
    loss = all_reduce(sums, out) / (B * (T - 1))
    return loss if extra is None else loss + extra


class _Valued(torch.autograd.Function):
    """``value`` as the loss, the gradient going to ``seeded``."""

    @staticmethod
    def forward(ctx, seeded, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _global_loss(grid: _Grid, sums: List[torch.Tensor], n: int,
                 extra: Optional[torch.Tensor]) -> torch.Tensor:
    """The loss over processes: its value is the whole batch's (this
    process's shard sums added to every other process's, in the crossing
    axes' order, then ``/ n``, plus ``extra``), and its backward seeds
    each term once over the mesh.  A (d, s) shard's nll is made in every
    process along tp, ep and (with ``every_stage``) pp that holds it: it
    is seeded in the processes of the last stage at their first ep
    index, every one along tp alike (the logits' all-reduce passes each
    its own gradient); ``extra``, the same in every process, is seeded in
    the process of the mesh's first rank.  The value counts each shard in
    the process that also leads tp.  Then every process's gradient of a
    replicated leaf is its share (``sync_replica_grads`` sums them), and
    the chained transfers' token joins the graph."""
    mesh, home = grid.mesh, grid.home
    zero = torch.zeros((), device=home)
    mine = all_reduce(sums, home) if sums else zero
    seeds = grid.pps[-1] == grid.pp - 1 and grid.eps[0] == 0
    counted = mine.detach() if seeds and grid.tps[0] == 0 else zero
    value = sum_over_processes(counted, mesh) / n
    seeded = mine / n if seeds else zero
    if extra is not None:
        value = value + extra.detach()
        if mesh.process == int(mesh.processes.flat[0]):
            seeded = seeded + extra
    tail = transport(mesh).tail()
    if tail is not None:
        seeded = seeded + tail
    return _Valued.apply(seeded, value)


@contextmanager
def chained(mesh: Optional[Mesh], device: torch.device):
    """Around a training forward on a mesh of several processes: the
    cross-process transfers it makes in one chain, so that every process
    runs their backwards in one order (``MeshTransport.chained``).  A
    no-op on a mesh of one process or without autograd."""
    if mesh is None or not mesh.multi_process or not torch.is_grad_enabled():
        yield
        return
    with transport(mesh).chained(device):
        yield


def _share_written(kv_pool: Sharded, grid: _Grid, written: Callable, n_layers: int) -> None:
    """Make the pool's copies in every process hold what this call wrote,
    as XLA keeps a replicated pool: ``written(d, s)`` are the block ids
    rank (d, s) wrote in each layer (on the pool's device).  Layer by
    layer, the processes of the layer's stage gather along sp and then dp
    the blocks each holds, and, where the pool is not cut over pp, the
    stage's process broadcasts them along pp to the other stages'.
    Processes along ep wrote the same blocks alike.  A no-op unless one
    of those axes crosses processes."""
    crossing = grid.mesh.crossing_axes()
    axes = [a for a in ("sp", "dp") if a in crossing]
    along_pp = "pp" in crossing and kv_pool.spec[0] != "pp"
    if not axes and not along_pp:
        return
    tr = transport(grid.mesh)
    every = {"dp": list(range(grid.dp)), "sp": list(range(grid.sp))}
    for i in range(n_layers):
        p = grid.stage(i)
        at = p if p in grid.pps else grid.pps[0]
        layer = i - at * grid.per_stage if kv_pool.spec[0] == "pp" else i
        copies = [kv_pool.replicas(dp=grid.dps[0], pp=at, ep=grid.e, sp=grid.sps[0], tp=t)
                  for t in grid.tps]

        def ids(held):
            return torch.cat([written(d, s) for d in held["dp"] for s in held["sp"]])

        def read(held):
            return torch.stack([c[0][layer][ids(held).to(c[0].device)] for c in copies])

        def write(held, data):
            for c, part in zip(copies, data):
                for copy in c:
                    copy[layer][ids(held).to(copy.device)] = part.to(copy.device)

        if p in grid.pps:
            held = {"dp": list(grid.dps), "sp": list(grid.sps)}
            for axis in axes:
                run = len(held[axis])
                for j, part in enumerate(tr.all_gather(read(held), axis, grid.lead(p))):
                    theirs = dict(held, **{axis: list(range(j * run, (j + 1) * run))})
                    if theirs[axis] != held[axis]:
                        write(theirs, part)
                held[axis] = every[axis]
        if along_pp:
            sent = read(every) if p in grid.pps else None
            like = copies[0][0][layer]
            got = tr.broadcast(sent, "pp", grid.lead(), p,
                               ((len(copies), len(ids(every))) + tuple(like.shape[1:]),
                                like.dtype, like.device))
            if p not in grid.pps:
                write(every, got)


def _prefill_sharded(params, tokens, kv_pool, block_table, cfg, prefix_len: int):
    """``prefill_paged`` (``prefix_len`` 0) and ``prefill_continue`` over
    sharded params and pool: each chunk attends over the cached prefix,
    read from its rank's pool slice, and the chunks up to its own; then
    every chunk's K/V goes into every copy of its head slice."""
    _dense_only(cfg, "a sharded prefill")
    grid = _grid(params, cfg, kv_pool)
    out = grid.home
    tokens, table = tokens.to(out), block_table.to(out).long()
    B, Ts = tokens.shape
    bs = cfg.block_size
    if prefix_len % bs or Ts % (bs * grid.sp):
        raise ValueError(f"prefix_len must be a block_size multiple and Ts a multiple of "
                         f"block_size x sp (prefix {prefix_len}, Ts {Ts}, block {bs}, "
                         f"sp {grid.sp})")
    npre, chunk_blocks = prefix_len // bs, Ts // bs // grid.sp
    positions = (prefix_len + torch.arange(Ts, device=out)).expand(B, Ts)

    def written(d, s):
        return grid.cut(table, d)[:, npre + s * chunk_blocks : npre + (s + 1) * chunk_blocks]

    def attend(i, d, p, t, qs, ks, vs):
        rows = grid.cut(table, d)
        coord = grid.coord(d, p, grid.e, grid.sps[0], t)
        k_all = grid.ranks("sp", [ks[s] for s in grid.sps], coord)
        v_all = grid.ranks("sp", [vs[s] for s in grid.sps], coord)
        outs = {}
        for s, q in qs.items():
            dev = grid.dev(d, p, grid.e, s, t)
            k_parts, v_parts = list(k_all[: s + 1]), list(v_all[: s + 1])
            if npre:
                kv_layer = grid.take(kv_pool, i, d, p, grid.e, s, t)
                pre = kv_layer[rows[:, :npre].to(dev)].permute(0, 2, 1, 3, 4, 5)
                pre = pre.reshape(rows.shape[0], 2, prefix_len, *k_parts[0].shape[2:])
                k_parts.insert(0, pre[:, 0].to(k_parts[0].dtype))
                v_parts.insert(0, pre[:, 1].to(v_parts[0].dtype))
            outs[s] = _prefill_attention(
                q, all_gather(k_parts, dev, 1), all_gather(v_parts, dev, 1), cfg,
                q_offset=prefix_len + s * q.shape[1])
        for s in grid.sps:
            grid.write_kv(kv_pool, i, d, p, s, t, lambda layer, s=s: _scatter_kv_blocks(
                layer, ks[s].to(layer.device), vs[s].to(layer.device),
                written(d, s).to(layer.device), bs))
        return outs

    xs = _sharded_stack(params, tokens, positions, cfg, grid, attend,
                        _tp_mlp_block(params, grid))
    logits = _logits_out(params, grid, xs, (B, Ts, cfg.vocab_size))
    _share_written(kv_pool, grid, lambda d, s: written(d, s).reshape(-1), cfg.n_layers)
    return logits, kv_pool


def _decode_sharded(params, tokens, kv_pool, block_table, context_len, cfg):
    """``decode_step`` over sharded params and pool (dp x pp x tp): each
    head shard writes its K/V into every copy of its pool slice and runs
    the decode kernel on its own."""
    _dense_only(cfg, "a sharded decode step")
    grid = _grid(params, cfg, kv_pool)
    if grid.sp > 1:
        raise ValueError(f"a decode step has one token a sequence; sp={grid.sp} cuts nothing")
    out = grid.home
    tokens = tokens.to(out)
    block_table = block_table.to(out, torch.int32)
    context_len = context_len.to(out, torch.int32)
    B = tokens.shape[0]
    if B % grid.dp:
        raise ValueError(f"batch {B} does not divide over dp={grid.dp}")
    pos = context_len.long() - 1
    block_ids = torch.gather(block_table.long(), 1, (pos // cfg.block_size)[:, None])[:, 0]
    slot = pos % cfg.block_size
    # The kernel reads contiguous, 16-byte-aligned tables and lengths: a
    # batch shard's rows are copied.
    tables = {d: grid.cut(block_table, d).clone() for d in grid.dps}
    lens = {d: grid.cut(context_len, d).clone() for d in grid.dps}

    def attend(i, d, p, t, qs, ks, vs):
        dev = grid.dev(d, p, grid.e, 0, t)
        kv_new = torch.stack((ks[0][:, 0], vs[0][:, 0]), dim=1)  # [b, 2, Hkv/tp, Dh]
        ids, slots = grid.cut(block_ids, d), grid.cut(slot, d)

        def write(layer):
            layer[ids.to(layer.device), :, slots.to(layer.device)] = kv_new.to(
                layer.device, layer.dtype)

        grid.write_kv(kv_pool, i, d, p, 0, t, write)
        attn = paged_decode_attention_cuda(
            qs[0][:, 0].contiguous(), grid.take(kv_pool, i, d, p, grid.e, 0, t),
            tables[d].to(dev), lens[d].to(dev))
        return {0: attn[:, None]}

    xs = _sharded_stack(params, tokens[:, None], pos[:, None], cfg, grid, attend,
                        _tp_mlp_block(params, grid))
    logits = _logits_out(params, grid, xs, (B, cfg.vocab_size))
    _share_written(kv_pool, grid, lambda d, s: grid.cut(block_ids, d), cfg.n_layers)
    return logits, kv_pool


# ---------------------------------------------------------------- training
#
# Across processes, the forward's transfers carry their gradients back
# (parallel/process_group.py), and the loss decides what each process's
# gradient means: every term of it is seeded once over the mesh, so a
# process's gradient of a replicated leaf is its own ranks' share, which
# sync_replica_grads sums over the processes that hold copies.  A (d, s)
# shard's loss is made on the last pp stage only (no broadcast of the
# hidden states), in every process along tp alike (the logits'
# all-reduce passes each partial its own process's gradient), and at the
# first ep index (the processes along ep compute it alike).  The
# transfers a training forward makes are chained (``chained``), so every
# process runs their backwards in one order.


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy from full-length [B, T, V] logits.

    Shift-and-mask, not slice, as in the reference: the targets are the
    tokens rolled left by one and the last position is masked out, so
    every intermediate keeps the [B, T] shape that a sequence-sharded
    mesh cuts evenly.  Shared by the Llama and MoE losses."""
    B, T = tokens.shape
    targets = torch.roll(tokens.long(), -1, dims=1)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = (torch.arange(T, device=nll.device) < T - 1).to(nll.dtype)
    return (nll * mask).sum() / (B * (T - 1))


def loss_fn(params: Params, tokens: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Next-token cross entropy over tokens [B, T], through the dense
    attention op (``use_flash=False``): the kernels have no backward.
    Over sharded params each shard's logits feed the loss in turn (the
    sp chunks' dense attention gathers K/V; see :func:`_sharded_nll`);
    over a mesh of several processes every process returns the whole
    batch's loss, and its backward gives each process its share of each
    replicated leaf's gradient (:func:`_global_loss`), the cross-process
    transfers chained (:func:`chained`)."""
    if is_sharded(params):
        grid = _grid(params, cfg)
        with chained(grid.mesh, grid.home):
            xs, _ = _sharded_run(params, tokens, cfg, grid, use_flash=False, every_stage=False)
            return _sharded_nll(params, tokens, grid, xs)
    logits = forward(params, tokens, cfg, use_flash=False)
    return next_token_nll(logits, tokens.to(logits.device))


def param_leaves(params: Params) -> Iterator[torch.Tensor]:
    """The tensors of a params tree, depth first in dict order: the
    order of the optimizer's param indices."""
    return tree_leaves(params)


def make_optimizer(params: Params, lr: float = 3e-4) -> torch.optim.AdamW:
    """The reference's ``optax.adamw(lr, b1=0.9, b2=0.95,
    weight_decay=0.1)`` over every leaf of ``params``, norms included
    (the reference passes no mask).  AdamW's decoupled update equals
    optax's ``scale_by_adam``, ``add_decayed_weights`` and
    ``scale_by_learning_rate`` chain in exact arithmetic.  Turns on
    ``requires_grad`` of every leaf: these are training's params, which
    the kernels then refuse outside ``torch.no_grad()``.  Over sharded
    params it steps every distinct local tensor once."""
    leaves = [leaf.requires_grad_() for leaf in distinct_locals(params)]
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)


def optimizer_step(
    loss: Callable[[], torch.Tensor], optimizer: torch.optim.Optimizer, params: Params
) -> torch.Tensor:
    """One step: zero the grads, differentiate ``loss()``, give every
    copy of a sharded slice the slice's whole gradient
    (``sync_replica_grads`` of ``params``), update the params in place.
    Returns the loss, detached (over params sharded across processes,
    the whole batch's, the same in every process)."""
    optimizer.zero_grad(set_to_none=True)
    value = loss()
    value.backward()
    sync_replica_grads(params)
    optimizer.step()
    return value.detach()


def train_step(
    params: Params, optimizer: torch.optim.Optimizer, tokens: torch.Tensor, cfg: LlamaConfig
) -> torch.Tensor:
    """One AdamW step on :func:`loss_fn`, updating ``params`` and
    ``optimizer`` (from :func:`make_optimizer`) in place; returns the
    loss before the update."""
    return optimizer_step(lambda: loss_fn(params, tokens, cfg), optimizer, params)
