"""The plain reference of the configurations' decoder, in float32.

A Llama-family block as the model cards describe it (Mistral-7B,
DeepSeek-LLM-7B): RMSNorm before attention and before the MLP, rotary
position embedding on the two halves of each head (the Hugging Face
``rotate_half`` form, ``theta ** (-2i / head_dim)``), causal grouped-query
attention scaled by ``head_dim ** -0.5``, a SwiGLU MLP, no biases, a final
RMSNorm and the output head.  The output head is the embedding (tied), as
the configuration files state under ``assumed``.

Computed layer by layer, each layer's weights raised to float32 only
while it runs, attention in blocks of query rows, and logits only for
the positions asked for, so that it fits beside what is left on the
card.  TF32 is off.  Imports nothing of the program.

``quant="fp8"`` is the control: every matrix product takes its weight and
its input rounded to float8 e4m3 (a scale per output column and per
input row), the step below the configuration's bfloat16.
"""

from __future__ import annotations

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
    """x [T, in] @ w [in, out]."""
    if quant == "fp8":
        return fp8_round(x, 1) @ fp8_round(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, D]: each head's two halves rotated by position."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = (positions.to(torch.float64)[:, None] * inv[None]).to(torch.float32)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [T, H, D], k, v [T, Hkv, D]: causal, grouped by H / Hkv."""
    t, h, d = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)  # [H, T, D]
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for start in range(0, t, QUERY_ROWS):
        stop = min(t, start + QUERY_ROWS)
        qb = q[start:stop].transpose(0, 1)  # [H, rows, D]
        s = (qb @ k[:, :stop].transpose(1, 2)) * d ** -0.5  # [H, rows, stop]
        rows = torch.arange(start, stop, device=q.device)[:, None]
        s = s.masked_fill(torch.arange(stop, device=q.device)[None, :] > rows, float("-inf"))
        out[start:stop] = (torch.softmax(s, dim=-1) @ v[:, :stop]).transpose(0, 1)
    return out


def logits(params: Dict[str, Any], config: Dict[str, Any], tokens: torch.Tensor, first: int,
           quant: Optional[str] = None) -> torch.Tensor:
    """Logits [len(tokens) - first, vocab] at positions ``first ..`` of
    the sequence ``tokens`` (int64, on the weights' device)."""
    _no_tf32()
    heads = config["num_attention_heads"]
    kv_heads = config["num_key_value_heads"]
    d_model = config["hidden_size"]
    head_dim = config.get("head_dim") or d_model // heads
    # As run: a value the configuration file lists under ``assumed`` is
    # the one served in place of the published one.
    eps = float(config.get("assumed", {}).get("rms_norm_eps", config["rms_norm_eps"]))
    theta = float(config["rope_theta"])
    t = tokens.shape[0]
    pos = torch.arange(t, device=tokens.device)
    lay = params["layers"]
    with torch.no_grad():
        x = params["embed"][tokens].float()
        for i in range(config["num_hidden_layers"]):
            w = {key: lay[key][i].float() for key in lay}
            h = rms_norm(x, w["ln1"], eps)
            q = _linear(h, w["wq"].reshape(d_model, -1), quant).view(t, heads, head_dim)
            k = _linear(h, w["wk"].reshape(d_model, -1), quant).view(t, kv_heads, head_dim)
            v = _linear(h, w["wv"].reshape(d_model, -1), quant).view(t, kv_heads, head_dim)
            a = causal_attention(rope(q, pos, theta), rope(k, pos, theta), v)
            x = x + _linear(a.reshape(t, -1), w["wo"].reshape(-1, d_model), quant)
            h = rms_norm(x, w["ln2"], eps)
            gate = _linear(h, w["w_gate"], quant)
            up = _linear(h, w["w_up"], quant)
            x = x + _linear(torch.nn.functional.silu(gate) * up, w["w_down"], quant)
            del w, h, q, k, v, a, gate, up
        out = rms_norm(x[first:], params["ln_f"].float(), eps)
        return _linear(out, params["embed"].float().t(), quant)
