"""The plain reference of the ``mellum`` family (Mellum2-12B-A2.5B), in
float32.

The block as its published ``config.json`` describes it (Hugging Face's
``mellum`` model type): each of the ``num_hidden_layers`` layers is

    n1 = RMSNorm1(x)
    h  = x + W_o Attn_kind(RoPE_kind(W_q n1), RoPE_kind(W_k n1), W_v n1)
    n2 = RMSNorm2(h)
    p  = softmax(W_router n2)                        over all experts
    x' = h + sum_{e in top-k(p)} p_e / sum_top-k(p) * W_down,e(SiLU(W_gate,e n2) * W_up,e n2)

and the logits are ``W_head RMSNorm_f(x)`` with the head untied
(``tie_word_embeddings`` false).  Attention is grouped-query
(``num_attention_heads`` over ``num_key_value_heads``, ``head_dim``
stated), scaled by ``head_dim ** -0.5``, no bias, no q/k norm.  A layer's
kind is ``layer_types[i]``: ``full_attention`` layers are causal with
YaRN RoPE (``rope_parameters.full_attention``: the frequencies of Hugging
Face's ``_compute_yarn_parameters``, cos and sin multiplied by
``attention_factor``); ``sliding_attention`` layers see the keys j with
q - sliding_window < j <= q, with default RoPE at their own theta.  RoPE
rotates each head's two halves (``rotate_half``).  Every layer's MLP is
sparse (``mlp_layer_types``): ``num_experts`` experts of width
``moe_intermediate_size``, the top ``num_experts_per_tok`` of the float32
softmax, their weights divided by their sum (``norm_topk_prob``), no
shared expert.  RMSNorm eps is ``rms_norm_eps``.

Departures from the published model: the MTP head that the model family
describes is not computed (the config declares none); weights are random
from the run's seed (``families/mellum.py``).

Computed layer by layer, each layer's weights raised to float32 only
while it runs (an expert's while its tokens run), attention in blocks of
query rows over only the keys a block can see, routing on this
reference's own float32 scores, and logits only for the positions asked
for, so that it fits beside what is left on the card.  TF32 is off.
Imports nothing of the program or the harness.

``quant="fp8"`` is the control: every matrix product (the router's and
the head's too) takes its weight and its input rounded to float8 e4m3 (a
scale per output column and per input row), the step below the
configuration's bfloat16.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

QUERY_ROWS = 1024  # attention's query block


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the largest magnitude maps to 448), returned in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """x [T, in] @ w [in, out], w raised to float32."""
    w = w.float()
    if quant == "fp8":
        return fp8_round(x, 1) @ fp8_round(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def inv_freq(head_dim: int, params: Dict[str, Any]) -> torch.Tensor:
    """A layer kind's RoPE frequencies, float64: default, or YaRN as
    Hugging Face's ``_compute_yarn_parameters`` has it."""
    base = float(params["rope_theta"])
    pos = base ** (torch.arange(0, head_dim, 2, dtype=torch.float64) / head_dim)
    if params.get("rope_type", "default") == "default":
        return 1.0 / pos
    factor = float(params["factor"])
    original = int(params["original_max_position_embeddings"])

    def dim_of(turns: float) -> float:
        return head_dim * math.log(original / (turns * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(dim_of(float(params["beta_fast"]))), 0)
    high = min(math.ceil(dim_of(float(params["beta_slow"]))), head_dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float64) - low)
                       / (high - low), 0, 1)
    keep = 1 - ramp  # the original frequency's share
    return (1.0 / (factor * pos)) * (1 - keep) + (1.0 / pos) * keep


def rope(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor,
         scale: float) -> torch.Tensor:
    """x [T, H, D]: each head's two halves rotated by position, cos and
    sin times ``scale``."""
    d = x.shape[-1]
    ang = (positions.to(torch.float64)[:, None] * freqs.to(x.device)[None]).to(torch.float32)
    cos, sin = (torch.cos(ang) * scale)[:, None, :], (torch.sin(ang) * scale)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int]) -> torch.Tensor:
    """q [T, H, D], k, v [T, Hkv, D]: causal, grouped by H / Hkv; with a
    window, query i sees keys j with i - window < j <= i."""
    t, h, d = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)  # [H, T, D]
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for start in range(0, t, QUERY_ROWS):
        stop = min(t, start + QUERY_ROWS)
        lo = 0 if window is None else max(0, start - window + 1)
        qb = q[start:stop].transpose(0, 1)  # [H, rows, D]
        s = (qb @ k[:, lo:stop].transpose(1, 2)) * d ** -0.5  # [H, rows, keys]
        rows = torch.arange(start, stop, device=q.device)[:, None]
        keys = torch.arange(lo, stop, device=q.device)[None, :]
        hidden = keys > rows
        if window is not None:
            hidden = hidden | (keys <= rows - window)
        s = s.masked_fill(hidden, float("-inf"))
        out[start:stop] = (torch.softmax(s, dim=-1) @ v[:, lo:stop]).transpose(0, 1)
    return out


def experts(h: torch.Tensor, lay: Dict[str, torch.Tensor], i: int, top_k: int, norm: bool,
            quant: Optional[str]) -> torch.Tensor:
    """The sparse MLP of layer ``i`` over h [T, D] (float32)."""
    probs = torch.softmax(_linear(h, lay["w_router"][i], quant), dim=-1)
    wts, ids = torch.topk(probs, top_k, dim=-1)
    if norm:
        wts = wts / wts.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in torch.unique(ids).tolist():
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        rows = h[tok]
        hidden = (torch.nn.functional.silu(_linear(rows, lay["e_gate"][i, e], quant))
                  * _linear(rows, lay["e_up"][i, e], quant))
        out.index_add_(0, tok, wts[tok, slot][:, None] * _linear(hidden, lay["e_down"][i, e],
                                                                 quant))
    return out


def logits(params: Dict[str, Any], config: Dict[str, Any], tokens: torch.Tensor, first: int,
           quant: Optional[str] = None) -> torch.Tensor:
    """Logits [len(tokens) - first, vocab] at positions ``first ..`` of
    the sequence ``tokens`` (int64, on the weights' device)."""
    _no_tf32()
    heads, kv_heads = config["num_attention_heads"], config["num_key_value_heads"]
    d_model, head_dim = config["hidden_size"], config["head_dim"]
    eps = float(config["rms_norm_eps"])
    kinds = config["layer_types"]
    rope_params = config["rope_parameters"]
    freqs = {kind: inv_freq(head_dim, rope_params[kind]) for kind in set(kinds)}
    scales = {kind: float(rope_params[kind].get("attention_factor", 1.0)) for kind in freqs}
    window = int(config["sliding_window"])
    t = tokens.shape[0]
    pos = torch.arange(t, device=tokens.device)
    lay = params["layers"]
    with torch.no_grad():
        x = params["embed"][tokens].float()
        for i in range(config["num_hidden_layers"]):
            kind = kinds[i]
            h = rms_norm(x, lay["ln1"][i], eps)
            q = _linear(h, lay["wq"][i].reshape(d_model, -1), quant).view(t, heads, head_dim)
            k = _linear(h, lay["wk"][i].reshape(d_model, -1), quant).view(t, kv_heads, head_dim)
            v = _linear(h, lay["wv"][i].reshape(d_model, -1), quant).view(t, kv_heads, head_dim)
            q = rope(q, pos, freqs[kind], scales[kind])
            k = rope(k, pos, freqs[kind], scales[kind])
            a = attention(q, k, v, window if kind == "sliding_attention" else None)
            x = x + _linear(a.reshape(t, -1), lay["wo"][i].reshape(-1, d_model), quant)
            h = rms_norm(x, lay["ln2"][i], eps)
            x = x + experts(h, lay, i, int(config["num_experts_per_tok"]),
                            bool(config["norm_topk_prob"]), quant)
            del h, q, k, v, a
        out = rms_norm(x[first:], params["ln_f"], eps)
        return _linear(out, params["head"].t(), quant)
