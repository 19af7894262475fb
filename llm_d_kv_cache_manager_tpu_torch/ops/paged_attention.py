"""Paged decode attention over the block-table KV layout, plain
PyTorch.

Port of the reference's ``ops/paged_attention.py``: gather every table
block of the layer's pool (``[num_blocks, 2, block_size, Hkv, D]``)
into a dense [B, T, Hkv, D] K and V, then attend with positions at or
past ``context_len`` masked.  It is the decode path on CPU tensors (as
the gather is the reference's decode path under
``decode_attention="auto"``) and the plain version the decode kernel
(``ops/paged_decode_cuda.py``) is held against.

``context_len == 0`` leaves every score at ``NEG_INF``, so the softmax
is uniform and the result is the mean of the gathered V; the decode
kernel returns 0 there, as the reference's Pallas kernel does.  Real
decode always has a context of at least one token.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def paged_attention(
    q: torch.Tensor,
    kv_layer: torch.Tensor,
    block_table: torch.Tensor,
    context_len: torch.Tensor,
    window: Optional[int] = None,
) -> torch.Tensor:
    """q: [B, H, D]; kv_layer: [num_blocks, 2, block_size, Hkv, D];
    block_table: [B, max_blocks] int (pad with any valid id);
    context_len: [B] int.  ``window``: a sliding window, the last
    ``window`` positions of each context alone (None: all of it).
    Returns [B, H, D] in q.dtype."""
    B, H, D = q.shape
    _, _, block_size, Hkv, _ = kv_layer.shape
    groups = H // Hkv
    max_blocks = block_table.shape[1]
    T = max_blocks * block_size

    # [B, max_blocks, 2, block_size, Hkv, D] -> [B, T, Hkv, D] x2
    gathered = kv_layer[block_table.long()]
    k = gathered[:, :, 0].reshape(B, T, Hkv, D)
    v = gathered[:, :, 1].reshape(B, T, Hkv, D)

    qf = q.float().reshape(B, Hkv, groups, D) * (D**-0.5)
    scores = torch.einsum("bhgd,bkhd->bhgk", qf, k.float())
    positions = torch.arange(T, device=q.device)[None, :]
    ctx = context_len.to(q.device)[:, None]
    mask = positions < ctx  # [B, T]
    if window is not None:
        mask = mask & (positions >= ctx - window)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)

    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    weights = weights / weights.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bkhd->bhgd", weights, v.float())
    return out.reshape(B, H, D).to(q.dtype)
