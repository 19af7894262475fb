"""Ring-attention partials: the plain PyTorch version of the partial
kernel and the log-sum-exp algebra that merges partials across steps.

Port of the reference's ``ops/ring_flash_pallas.py`` without its Pallas
kernel: ``NEG_INF``, :func:`neutral_partial`, :func:`merge_partials`
and :func:`normalize_partial` are the same tensor code, and
:func:`flash_partial_plain` is a float32 port of ``_partial_kernel``'s
masked online softmax (key chunks of ``KV_CHUNK``, the same ``m_safe``
guard, masked probabilities forced to 0).  It is the CPU path of the
ring's flash body and the oracle the kernel (``ops/ring_flash_cuda.py``,
``csrc/ring_partial.cu``) is held against.

A partial is ``(acc [B, Tq, H, D], m [B, Tq, H], l [B, Tq, H])``, all
float32: ``acc / l`` is the softmax output over the step's keys alone,
``m`` the row max of the ``D**-0.5``-scaled scores in natural-log
units, and a row that sees no key is exactly ``(0, NEG_INF, 0)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
KV_CHUNK = 512  # keys per online-softmax step, the reference's default

Partial = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def flash_partial_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal_offset: Optional[int] = 0,
) -> Partial:
    """Unnormalized GQA partial over one K/V chunk, in float32.

    q: [B, Tq, H, D]; k/v: [B, Tk, Hkv, D].  ``causal_offset``: keys
    visible to LOCAL row a are b <= a + offset (0: diagonal included;
    -1: strictly below, the striped ring's behind-me step); ``None``:
    every key is visible."""
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    groups = H // Hkv
    dev = q.device
    qf = q.float().reshape(B, Tq, Hkv, groups, D) * (D**-0.5)
    acc = torch.zeros((B, Tq, Hkv, groups, D), device=dev)
    m = torch.full((B, Tq, Hkv, groups), NEG_INF, device=dev)
    l = torch.zeros((B, Tq, Hkv, groups), device=dev)
    rows = torch.arange(Tq, device=dev)
    # Keys past the last row's causal limit are masked for every row.
    end = Tk if causal_offset is None else max(0, min(Tk, Tq + causal_offset))
    for k_start in range(0, end, KV_CHUNK):
        kc = k[:, k_start : k_start + KV_CHUNK].float()
        vc = v[:, k_start : k_start + KV_CHUNK].float()
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kc)
        k_pos = k_start + torch.arange(kc.shape[1], device=dev)
        if causal_offset is None:
            mask = torch.ones((Tq, kc.shape[1]), dtype=torch.bool, device=dev)
        else:
            mask = k_pos[None, :] <= rows[:, None] + causal_offset
        mask = mask[None, :, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # Fully-masked rows keep m at NEG_INF; the guard keeps exp()
        # away from the sentinel.
        m_safe = torch.clamp(m_new, min=0.5 * NEG_INF)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        correction = torch.exp(torch.clamp(m, min=0.5 * NEG_INF) - m_safe)
        l = l * correction + p.sum(dim=-1)
        acc = acc * correction[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vc)
        m = m_new
    return acc.reshape(B, Tq, H, D), m.reshape(B, Tq, H), l.reshape(B, Tq, H)


def neutral_partial(q: torch.Tensor) -> Partial:
    """The identity element of :func:`merge_partials` (a fully-masked
    step): zero accumulator, NEG_INF max, zero sum, shaped after q."""
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    zero = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    return acc, zero + NEG_INF, zero


def merge_partials(state: Partial, update: Partial) -> Partial:
    """Log-sum-exp combine of two unnormalized partials (flash-decoding
    merge).  Both are ``(acc, m, l)`` with acc [..., D] and m/l [...];
    associative, identity :func:`neutral_partial`."""
    acc_a, m_a, l_a = state
    acc_b, m_b, l_b = update
    m_new = torch.maximum(m_a, m_b)
    m_safe = torch.clamp(m_new, min=0.5 * NEG_INF)
    s_a = torch.exp(torch.clamp(m_a, min=0.5 * NEG_INF) - m_safe)
    s_b = torch.exp(torch.clamp(m_b, min=0.5 * NEG_INF) - m_safe)
    return (
        acc_a * s_a[..., None] + acc_b * s_b[..., None],
        m_new,
        l_a * s_a + l_b * s_b,
    )


def normalize_partial(acc: torch.Tensor, l: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Final softmax division; fully-masked rows yield 0, not NaN."""
    return (acc / torch.clamp(l, min=1e-20)[..., None]).to(dtype)
