"""Blockwise causal GQA attention (flash-style online softmax), plain
PyTorch.

Port of the reference's ``ops/flash_attention.py``: the same tiling —
an outer loop over query blocks, an inner loop over key/value chunks
carrying the running max, denominator and weighted accumulator in
float32 — with Python loops in place of ``lax.scan``.  The reference's
runtime skip of fully masked chunks (``lax.cond``) is an ``if`` here,
so causal prefill does about half the work of dense attention.  Peak
memory is one [q_block, kv_block] score tile per head group.

It is the long-prompt prefill path on CPU tensors and the plain version
the prefill kernel (``ops/flash_cuda.py``) is held against.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def flash_gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,
    q_block: int = 256,
    kv_block: int = 256,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal GQA attention, tiled.  q: [B, Tq, H, D]; k/v:
    [B, Tk, Hkv, D]; returns [B, Tq, H, D] in q.dtype.  ``window``: a
    sliding window, as ``ops/attention.py`` takes it; key chunks below
    every row's window are skipped."""
    B, Tq, H, D = q.shape
    _, Tk, Hkv, _ = k.shape
    groups = H // Hkv
    q_offset = int(q_offset)

    q_block = min(q_block, Tq)
    kv_block = min(kv_block, Tk)
    q_pad = (-Tq) % q_block
    k_pad = (-Tk) % kv_block
    if k_pad:
        # Padded keys are masked off by position (k_pos >= Tk).
        k = F.pad(k, (0, 0, 0, 0, 0, k_pad))
        v = F.pad(v, (0, 0, 0, 0, 0, k_pad))
    if q_pad:
        q = F.pad(q, (0, 0, 0, 0, 0, q_pad))
    nq = (Tq + q_pad) // q_block
    nk = (Tk + k_pad) // kv_block

    dev = q.device
    k_limit = (
        torch.full((B,), Tk, device=dev)
        if kv_len is None
        else torch.as_tensor(kv_len, device=dev).expand(B)
    )
    max_limit = int(k_limit.max())
    qs = q.reshape(B, nq, q_block, Hkv, groups, D)
    ks = k.reshape(B, nk, kv_block, Hkv, D)
    vs = v.reshape(B, nk, kv_block, Hkv, D)
    out = torch.empty(
        (B, nq, q_block, Hkv, groups, D), dtype=torch.float32, device=dev
    )
    for qi in range(nq):
        q_tile = qs[:, qi].float() * (D**-0.5)  # [B, q_block, Hkv, G, D]
        q_pos = q_offset + qi * q_block + torch.arange(q_block, device=dev)
        m = torch.full((B, q_block, Hkv, groups), NEG_INF, device=dev)
        l = torch.zeros((B, q_block, Hkv, groups), device=dev)
        o = torch.zeros((B, q_block, Hkv, groups, D), device=dev)
        for ki in range(nk):
            k_start = ki * kv_block
            # Runtime causal skip: a chunk entirely above the diagonal
            # (or past every sequence's valid length) does no work.
            if k_start > q_offset + (qi + 1) * q_block - 1:
                break
            if k_start >= max_limit:
                break
            if window is not None and k_start + kv_block <= q_offset + qi * q_block - window + 1:
                continue
            k_pos = k_start + torch.arange(kv_block, device=dev)
            s = torch.einsum(
                "bqhgd,bkhd->bqhgk", q_tile, ks[:, ki].float()
            )  # [B, q_block, Hkv, G, kv_block]
            visible = k_pos[None, :] <= q_pos[:, None]
            if window is not None:
                visible = visible & (k_pos[None, :] > q_pos[:, None] - window)
            mask = visible[None] & (
                k_pos[None, None, :] < k_limit[:, None, None]
            )  # [B, q_block, kv_block]
            s = torch.where(mask[:, :, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            scale = torch.exp(m - m_new)
            l = l * scale + p.sum(dim=-1)
            o = o * scale[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p, vs[:, ki].float()
            )
            m = m_new
        out[:, qi] = o / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(B, Tq + q_pad, H, D)
    return out[:, :Tq].to(q.dtype)
