"""Causal GQA prefill attention: the Hopper kernel and its plain version.

Replaces the reference's Pallas TPU kernel ``_flash_kernel``
(``ops/flash_pallas.py``, entry ``flash_gqa_attention_pallas``).  The
kernel, ``csrc/flash_prefill.cu``, is CUDA C++ for ``sm_90a``; its
header note says what bounds it on an H100 and what its design does
about that.  Unlike the TPU kernel it has no VMEM-style cap on the key
length (K/V stream through shared memory tile by tile), and
``q_offset`` is a runtime argument, so one build serves full prefill,
prefix-hit continuation and chunked prefill.  When the (q-tile, head,
batch) grid is smaller than the card, the keys are split across CTAs
and a merge kernel combines the splits (:func:`split_plan`).

:func:`flash_gqa_attention_cuda` launches the kernel for CUDA tensors
and takes the plain version, :func:`flash_gqa_attention_plain` (the
tiled op of ``ops/flash_attention.py``), only for CPU tensors.  There
is no fallback: on a CUDA tensor it launches or raises.
"""

from __future__ import annotations

import ctypes

import torch

from llm_d_kv_cache_manager_tpu_torch.ops import _build
from llm_d_kv_cache_manager_tpu_torch.ops.flash_attention import (
    flash_gqa_attention,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
Q_TILE = KV_TILE = 64  # rows per CTA and keys per stage in the kernel
# CTAs per SM that a key split aims for when the grid is small.
CTAS_PER_SM = 4


def flash_gqa_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_offset: int = 0
) -> torch.Tensor:
    """The plain PyTorch version the kernel is held against: the tiled
    online-softmax op (same result as dense attention, without its
    [Tq, Tk] score matrix)."""
    return flash_gqa_attention(q, k, v, q_offset=q_offset)


def split_plan(ctas: int, kv_tiles: int, sms: int):
    """(splits, key tiles per split) for a bf16 launch of ``ctas``
    (q-tile, head, batch) CTAs whose longest key loop is ``kv_tiles``
    tiles: no split when the grid already covers the SMs, else about
    ``CTAS_PER_SM`` CTAs per SM, each split at least one tile."""
    if ctas >= sms or kv_tiles <= 1:
        return 1, max(1, kv_tiles)
    want = min(kv_tiles, -(-CTAS_PER_SM * sms // ctas))
    per_split = -(-kv_tiles // want)
    return -(-kv_tiles // per_split), per_split


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q [B,Tq,H,D] and k/v [B,Tk,Hkv,D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(
            f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree on "
            "batch or head dim, or H is not a multiple of Hkv"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must have one dtype")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def flash_gqa_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_offset: int = 0
) -> torch.Tensor:
    """Causal GQA attention.  q: [B, Tq, H, D]; k/v: [B, Tk, Hkv, D];
    query row i sits at key position ``q_offset + i``.  Returns
    [B, Tq, H, D] in q's dtype.

    CUDA tensors run the kernel (bf16 or float32, contiguous, head dim
    64 or 128) and every launch adds one to
    ``flash_gqa_attention_cuda.launches``; CPU tensors run
    :func:`flash_gqa_attention_plain`."""
    q_offset = int(q_offset)
    _check(q, k, v, q_offset)
    if q.device.type == "cpu":
        return flash_gqa_attention_plain(q, k, v, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes bf16 or float32, not {q.dtype}")
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS}, not {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0 or Tq == 0:
        return out
    q_tiles = -(-Tq // Q_TILE)
    kv_tiles = -(-min(q_offset + q_tiles * Q_TILE, Tk) // KV_TILE)
    splits, per_split = 1, max(1, kv_tiles)
    if q.dtype == torch.bfloat16:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits, per_split = split_plan(q_tiles * H * B, kv_tiles, sms)
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((splits, B, Tq, H, D), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((splits, B, Tq, H, 2), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_prefill")
    fn = lib.flash_prefill
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if part_o is None else part_o.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            B, Tq, Tk, H, Hkv, D, q_offset, splits, per_split,
            _DTYPE_CODES[q.dtype], stream,
        )
    _build.check(lib, "flash_prefill launch", rc)
    flash_gqa_attention_cuda.launches += 1
    return out


flash_gqa_attention_cuda.launches = 0
