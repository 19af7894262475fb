"""The ``mellum`` family: Mellum2's block as the port's ``models/llama.py``
serves it through its mixed-block fields (Mellum2-12B-A2.5B): RMSNorm,
grouped-query attention with a stated head dim, layers of two kinds
(``layer_types``: windowed with default RoPE, full with YaRN RoPE and its
attention factor), routed experts as every layer's MLP (top-k of a float32
softmax, weights renormalised, dropless), an untied output head, and one
uniform ``KVCachePool`` of ``[layers, blocks, 2, block, kv_heads,
head_dim]`` (every block id holds all layers' K/V, windowed or not).  The
layer equations are in ``reference/mellum.py``, the plain reference.  The
contract is in ``families/__init__.py``.

Costs are summed by layer kind: a windowed layer's attention counts the
keys inside its window (pairs in prefill, pool slots in decode), a full
layer's every earlier key; the experts count ``num_experts_per_tok`` of
``num_experts`` a token.  ``expert_bound_s`` is the expert kernel's
roofline; ``Shape.counters`` carries the port's device counters of the
decode path (``ops/moe_experts.py``: routed rows, distinct experts read,
rows dropped, calls) of the model this file built, read when the record
asks for the shape after the window; None where there are none (the CPU
path keeps none).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from bench_port import roofline
from bench_port.reference import mellum as reference
from bench_port.serve import PORT, port
from bench_port.weights import Draw

WINDOWED = "sliding_attention"
ITEMSIZE = 2  # bf16
# The standard deviation of every drawn matrix: the initializer_range of
# Hugging Face's Llama-family configs, which a freshly built model of this
# config draws its linear layers and embeddings from (the catalog's
# config gives none).  With fan_in^-1/2 the expert products (fan-in 896)
# add 1.67x and the output projection (fan-in 4096) 0.78x as much to the
# residual stream, and routing picks flipped by rounding cascade through
# the layers until the served-logit gap is half a float8 computation's.
INIT_STD = 0.02


def window_pairs(tq: int, q_offset: int, window: int) -> int:
    """(query, key) pairs a window of ``window`` keys keeps when query
    ``i`` sits at position ``q_offset + i`` and sees keys ``p - window < j
    <= p``: the sum over positions p = q_offset + 1 .. q_offset + tq of
    min(p, window)."""
    lo, hi = q_offset + 1, q_offset + tq
    inside = max(0, min(hi, window) - lo + 1)  # positions p <= window: p keys
    first = lo
    pairs = inside * (first + first + inside - 1) // 2
    return pairs + (tq - inside) * window


@dataclass(frozen=True)
class Shape:
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab: int
    n_experts: int
    top_k: int
    d_expert: int
    window: int
    windowed: int  # layers with a window
    counters: Optional[Dict[str, int]] = field(default=None, compare=False)

    @property
    def full(self) -> int:
        return self.n_layers - self.windowed

    @property
    def expert_params(self) -> int:
        """One expert's weights: gate, up and down."""
        return 3 * self.d_model * self.d_expert

    @property
    def matmul_flops_per_token(self) -> float:
        """2 x the weights one token multiplies through, over all layers:
        q, k, v, o, the router and its top-k experts (no embedding lookup)."""
        d, hd = self.d_model, self.head_dim
        per_layer = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                     + self.n_heads * hd * d + d * self.n_experts
                     + self.top_k * self.expert_params)
        return 2.0 * per_layer * self.n_layers

    @property
    def head_flops(self) -> float:
        return 2.0 * self.d_model * self.vocab

    def _attention_flops(self, keys: float, layers: int) -> float:
        return 4.0 * self.n_heads * self.head_dim * keys * layers

    def prefill_flops(self, prefix: int, new: int) -> float:
        full = roofline.causal_pairs(new, prefix + new, prefix)
        windowed = window_pairs(new, prefix, self.window)
        return (new * self.matmul_flops_per_token + self._attention_flops(full, self.full)
                + self._attention_flops(windowed, self.windowed) + self.head_flops)

    def decode_flops(self, contexts) -> float:
        rows = len(contexts)
        windowed = sum(min(c, self.window) for c in contexts)
        return (rows * (self.matmul_flops_per_token + self.head_flops)
                + self._attention_flops(sum(contexts), self.full)
                + self._attention_flops(windowed, self.windowed))

    def prefill_attention_bound_s(self, prefix: int, new: int, peaks: Dict[str, float]) -> float:
        """One prefill kernel call a layer: the full layers' causal calls
        and the windowed layers', which read the keys of the window of
        the first new row on and keep the window's pairs."""
        H, Hkv, Dh = self.n_heads, self.n_kv_heads, self.head_dim
        full = roofline.prefill_attention(1, new, prefix + new, H, Hkv, Dh, prefix)
        keys = prefix + new - max(0, prefix + 1 - self.window)
        windowed = roofline.Cost(4.0 * Dh * H * window_pairs(new, prefix, self.window),
                                 float((2 * new * H + 2 * keys * Hkv) * Dh * ITEMSIZE))
        return self.full * full.bound_s(peaks) + self.windowed * windowed.bound_s(peaks)

    def decode_attention_bound_s(self, contexts, kv_tokens: Optional[int],
                                 peaks: Dict[str, float]) -> float:
        """One decode kernel call a layer: the full layers over the rows'
        contexts, the windowed layers over the last ``window`` positions
        of each (at most ``kv_tokens`` distinct slots either way)."""
        H, Hkv, Dh = self.n_heads, self.n_kv_heads, self.head_dim
        inside = [min(c, self.window) for c in contexts]
        full = roofline.paged_decode(contexts, H, Hkv, Dh, kv_tokens=kv_tokens)
        windowed = roofline.paged_decode(
            inside, H, Hkv, Dh, kv_tokens=None if kv_tokens is None else min(kv_tokens,
                                                                             sum(inside)))
        return self.full * full.bound_s(peaks) + self.windowed * windowed.bound_s(peaks)

    def expert_bound_s(self, rows: float, experts_read: float, peaks: Dict[str, float]) -> float:
        """The expert kernel's least time for one layer's call: ``rows``
        routed rows (2 x 3 x d_model x d_expert FLOPs each) and the
        weights of ``experts_read`` distinct experts, read once."""
        cost = roofline.Cost(2.0 * rows * self.expert_params,
                             float(experts_read * self.expert_params * ITEMSIZE))
        return cost.bound_s(peaks)

    def expected_experts(self, tokens: int) -> float:
        """Distinct experts a layer reads for ``tokens`` tokens whose
        picks are independent and uniform: E (1 - (1 - k / E)^tokens)."""
        return self.n_experts * (1.0 - (1.0 - self.top_k / self.n_experts) ** tokens)


def _sizes(config: Dict[str, Any]) -> Dict[str, Any]:
    kinds = config["layer_types"]
    return dict(
        d_model=config["hidden_size"],
        n_layers=config["num_hidden_layers"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        head_dim=config["head_dim"],
        vocab=config["vocab_size"],
        n_experts=config["num_experts"],
        top_k=config["num_experts_per_tok"],
        d_expert=config["moe_intermediate_size"],
        window=config["sliding_window"],
        windowed=sum(1 for k in kinds[: config["num_hidden_layers"]] if k == WINDOWED),
    )


def shape(config: Dict[str, Any]) -> Shape:
    """The sizes of a configuration file (Hugging Face ``config.json``
    keys), with the decode path's device counters where the port has
    kept any."""
    return Shape(**_sizes(config), counters=decode_counters())


def decode_counters() -> Optional[Dict[str, int]]:
    """The port's decode-path expert counters (``ops/moe_experts.py``),
    or None where the port was not loaded or kept none."""
    moe = sys.modules.get(f"{PORT}.ops.moe_experts")
    return None if moe is None else moe.read_counters("decode")


def _layer_shapes(s: Shape) -> Dict[str, tuple]:
    """{leaf: shape} of the stacked layer weights."""
    L, D, H, K, Dh = s.n_layers, s.d_model, s.n_heads, s.n_kv_heads, s.head_dim
    E, F = s.n_experts, s.d_expert
    return {
        "wq": (L, D, H, Dh),
        "wk": (L, D, K, Dh),
        "wv": (L, D, K, Dh),
        "wo": (L, H, Dh, D),
        "w_router": (L, D, E),
        "e_gate": (L, E, D, F),
        "e_up": (L, E, D, F),
        "e_down": (L, E, F, D),
    }


def weights(config: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, Any]:
    """The layout ``models/llama.py`` takes for routed experts: stacked
    layers ``{ln1, ln2, wq, wk, wv, wo, w_router, e_gate, e_up, e_down}``
    with a leading layer axis (the experts' second), ``embed``, the
    untied ``head`` [vocab, d_model] and ``ln_f``; matrices normal(0,
    ``INIT_STD``), norms 1 + normal(0, 0.1)."""
    s = Shape(**_sizes(config))
    draw = Draw(config, seed, device)
    layers = {"ln1": draw.norm((s.n_layers, s.d_model)), "ln2": draw.norm((s.n_layers, s.d_model))}
    for key, dims in _layer_shapes(s).items():
        layers[key] = draw.normal(dims, INIT_STD)
    return {
        "embed": draw.normal((s.vocab, s.d_model), INIT_STD),
        "layers": layers,
        "ln_f": draw.norm((s.d_model,)),
        "head": draw.normal((s.vocab, s.d_model), INIT_STD),
    }


def _kinds(config: Dict[str, Any], llama) -> tuple:
    """The port's AttentionKind of each layer."""
    rope = config["rope_parameters"]
    out = []
    for kind in config["layer_types"][: config["num_hidden_layers"]]:
        p = rope[kind]
        yarn = None
        if p.get("rope_type", "default") == "yarn":
            yarn = (float(p["factor"]), int(p["original_max_position_embeddings"]),
                    float(p["beta_fast"]), float(p["beta_slow"]))
        out.append(llama.AttentionKind(
            window=int(config["sliding_window"]) if kind == WINDOWED else None,
            rope_theta=float(p["rope_theta"]), yarn=yarn,
            rope_scale=float(p.get("attention_factor", 1.0))))
    return tuple(out)


class Model:
    """The port's ``MixedLlamaConfig`` for a configuration file at the
    mix's block size, and its entry points."""

    def __init__(self, config: Dict[str, Any], mix: Dict[str, Any]) -> None:
        s = Shape(**_sizes(config))
        self._llama = port("models.llama")
        self.cfg = cfg = self._llama.MixedLlamaConfig(
            vocab_size=s.vocab, d_model=s.d_model, n_layers=s.n_layers, n_heads=s.n_heads,
            n_kv_heads=s.n_kv_heads, d_ff=config["intermediate_size"],
            rope_theta=float(config["rope_parameters"][WINDOWED]["rope_theta"]),
            block_size=int(mix["multiple"]), dtype=config["torch_dtype"],
            head_dim=s.head_dim, attention_kinds=_kinds(config, self._llama),
            n_experts=s.n_experts, experts_per_token=s.top_k, d_expert=s.d_expert,
            norm_topk_prob=bool(config["norm_topk_prob"]), tie_embeddings=False)
        self.block_size, self.vocab_size = cfg.block_size, cfg.vocab_size
        # K and V of a block's tokens in every layer, in bf16.
        self.block_bytes = 2 * cfg.n_layers * cfg.block_size * cfg.n_kv_heads * cfg.head_dim * 2

    def pool(self, blocks: int, device: torch.device):
        cfg, pool_mod = self.cfg, port("models.kv_cache_pool")
        return pool_mod.KVCachePool(pool_mod.KVCachePoolConfig(
            cfg.n_layers, blocks, cfg.block_size, cfg.n_kv_heads, cfg.head_dim, cfg.dtype),
            device=device)

    def graph_bytes(self, buckets) -> int:
        """Each decode graph's private pool: a float32 copy of the untied
        head, its logits, and room for the step's other intermediates."""
        per = self.cfg.vocab_size * self.cfg.d_model * 4 + (256 << 20)
        return sum(per + b * self.cfg.vocab_size * 8 for b in buckets)

    def prefill_paged(self, params, tokens, kv, table):
        return self._llama.prefill_paged(params, tokens, kv, table, self.cfg)

    def prefill_continue(self, params, tokens, kv, table, prefix_len: int):
        return self._llama.prefill_continue(params, tokens, kv, table, prefix_len, self.cfg)

    def make_decode_step(self, params, kv, batch: int, width: int):
        return self._llama.make_decode_step(params, kv, self.cfg, batch, width)


def model(config: Dict[str, Any], mix: Dict[str, Any]) -> Model:
    return Model(config, mix)


def reference_logits(params, config: Dict[str, Any], tokens: torch.Tensor, first: int,
                     quant: Optional[str] = None) -> torch.Tensor:
    return reference.logits(params, config, tokens, first, quant=quant)
