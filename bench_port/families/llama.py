"""The ``llama`` family: a dense decoder block as the port's
``models/llama.py`` serves it (Mistral-7B, DeepSeek-LLM-7B): RMSNorm,
grouped-query attention with RoPE, a SwiGLU MLP, the output head tied to
the embedding, and one uniform ``KVCachePool`` of
``[layers, blocks, 2, block, kv_heads, head_dim]``.  The contract is in
``families/__init__.py``; the plain reference is ``reference/model.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from bench_port import roofline
from bench_port.reference import model as reference
from bench_port.serve import port
from bench_port.weights import Draw


@dataclass(frozen=True)
class Shape:
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    @property
    def matmul_flops_per_token(self) -> float:
        """2 x the weights one token multiplies through, over all layers:
        q, k, v, o and the three MLP matrices (no embedding lookup)."""
        d, hd = self.d_model, self.head_dim
        per_layer = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                     + self.n_heads * hd * d + 3 * d * self.d_ff)
        return 2.0 * per_layer * self.n_layers

    def attention_flops(self, keys: int) -> float:
        """QK^T and PV for one query over ``keys`` keys, all layers."""
        return 4.0 * self.n_heads * self.head_dim * keys * self.n_layers

    @property
    def head_flops(self) -> float:
        return 2.0 * self.d_model * self.vocab

    def prefill_flops(self, prefix: int, new: int) -> float:
        pairs = roofline.causal_pairs(new, prefix + new, prefix)
        return new * self.matmul_flops_per_token + self.attention_flops(pairs) + self.head_flops

    def decode_flops(self, contexts) -> float:
        rows = len(contexts)
        return (rows * (self.matmul_flops_per_token + self.head_flops)
                + self.attention_flops(sum(contexts)))

    def prefill_attention_bound_s(self, prefix: int, new: int, peaks: Dict[str, float]) -> float:
        """One prefill kernel call a layer, every layer alike."""
        cost = roofline.prefill_attention(1, new, prefix + new, self.n_heads, self.n_kv_heads,
                                          self.head_dim, prefix)
        return self.n_layers * cost.bound_s(peaks)

    def decode_attention_bound_s(self, contexts, kv_tokens: Optional[int],
                                 peaks: Dict[str, float]) -> float:
        """One decode kernel call a layer, every layer alike."""
        cost = roofline.paged_decode(contexts, self.n_heads, self.n_kv_heads, self.head_dim,
                                     kv_tokens=kv_tokens)
        return self.n_layers * cost.bound_s(peaks)


def shape(config: Dict[str, Any]) -> Shape:
    """The sizes of a configuration file (Hugging Face ``config.json`` keys)."""
    heads = config["num_attention_heads"]
    return Shape(
        d_model=config["hidden_size"],
        n_layers=config["num_hidden_layers"],
        n_heads=heads,
        n_kv_heads=config["num_key_value_heads"],
        head_dim=config.get("head_dim") or config["hidden_size"] // heads,
        d_ff=config["intermediate_size"],
        vocab=config["vocab_size"],
    )


def _layer_shapes(s: Shape) -> Dict[str, tuple]:
    """{leaf: (shape, fan_in)} of the stacked layer weights."""
    L, D, H, K, Dh, F = s.n_layers, s.d_model, s.n_heads, s.n_kv_heads, s.head_dim, s.d_ff
    return {
        "wq": ((L, D, H, Dh), D),
        "wk": ((L, D, K, Dh), D),
        "wv": ((L, D, K, Dh), D),
        "wo": ((L, H, Dh, D), H * Dh),
        "w_gate": ((L, D, F), D),
        "w_up": ((L, D, F), D),
        "w_down": ((L, F, D), F),
    }


def weights(config: Dict[str, Any], seed: int, device: torch.device) -> Dict[str, Any]:
    """The layout ``models/llama.py`` takes: stacked layers ``{ln1, ln2, wq,
    wk, wv, wo, w_gate, w_up, w_down}`` with a leading layer axis,
    ``embed`` (also the output head, tied) and ``ln_f``; matrices
    normal(0, fan_in^-1/2)."""
    s = shape(config)
    draw = Draw(config, seed, device)
    layers = {"ln1": draw.norm((s.n_layers, s.d_model)), "ln2": draw.norm((s.n_layers, s.d_model))}
    for key, (dims, fan_in) in _layer_shapes(s).items():
        layers[key] = draw.normal(dims, fan_in ** -0.5)
    return {
        "embed": draw.normal((s.vocab, s.d_model), s.d_model ** -0.5),
        "layers": layers,
        "ln_f": draw.norm((s.d_model,)),
    }


class Model:
    """The port's ``LlamaConfig`` for a configuration file at the mix's
    block size, and its entry points."""

    def __init__(self, config: Dict[str, Any], mix: Dict[str, Any]) -> None:
        s = shape(config)
        self._llama = port("models.llama")
        self.cfg = cfg = self._llama.LlamaConfig(
            vocab_size=s.vocab, d_model=s.d_model, n_layers=s.n_layers, n_heads=s.n_heads,
            n_kv_heads=s.n_kv_heads, d_ff=s.d_ff, rope_theta=float(config["rope_theta"]),
            block_size=int(mix["multiple"]), dtype=config["torch_dtype"])
        self.block_size, self.vocab_size = cfg.block_size, cfg.vocab_size
        # K and V of a block's tokens in every layer, in bf16.
        self.block_bytes = 2 * cfg.n_layers * cfg.block_size * cfg.n_kv_heads * cfg.head_dim * 2

    def pool(self, blocks: int, device: torch.device):
        cfg, pool_mod = self.cfg, port("models.kv_cache_pool")
        return pool_mod.KVCachePool(pool_mod.KVCachePoolConfig(
            cfg.n_layers, blocks, cfg.block_size, cfg.n_kv_heads, cfg.head_dim, cfg.dtype),
            device=device)

    def graph_bytes(self, buckets) -> int:
        """Each decode graph's private pool: a float32 copy of the
        embedding (the tied head), its logits, and room for the step's
        other intermediates."""
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
