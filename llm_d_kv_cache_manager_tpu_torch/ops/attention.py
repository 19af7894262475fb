"""Dense causal grouped-query attention (plain PyTorch).

Port of the reference's ``ops/attention.py``: the short-prompt prefill
path on CPU tensors and the oracle the kernels are checked against.
Accumulation is float32 whatever the input dtype; the output is in q's
dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def causal_gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal attention with grouped KV heads.

    q: [B, Tq, H, D]; k/v: [B, Tk, Hkv, D] with H % Hkv == 0.
    ``q_offset`` is the absolute position of q[0] within the key axis.
    ``kv_len`` ([B]) masks padded keys beyond each sequence's length.
    ``window``: a sliding window, the row at position p seeing keys
    ``p - window < j <= p`` (the port's windowed layers; the reference
    has none).  Returns [B, Tq, H, D] in q.dtype.
    """
    B, Tq, H, D = q.shape
    _, Tk, Hkv, _ = k.shape
    groups = H // Hkv

    qf = q.float() * (D**-0.5)
    qf = qf.reshape(B, Tq, Hkv, groups, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())

    q_pos = torch.arange(Tq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(Tk, device=q.device)[None, :]
    mask = k_pos <= q_pos  # [Tq, Tk]
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    if kv_len is not None:
        mask = mask[None] & (k_pos[None] < kv_len[:, None, None])
        mask = mask[:, None, None]  # [B,1,1,Tq,Tk]
    else:
        mask = mask[None, None, None]
    scores = torch.where(mask, scores, NEG_INF)

    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    weights = weights / weights.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", weights, v.float())
    return out.reshape(B, Tq, H, D).to(q.dtype)
