"""Causal GQA prefill attention: the Hopper kernel and its plain version.

Replaces the reference's Pallas TPU kernel ``_flash_kernel``
(``ops/flash_pallas.py``, entry ``flash_gqa_attention_pallas``).  The
kernel, ``csrc/flash_prefill.cu``, is CUDA C++ for ``sm_90a``; its
header note says what bounds it on an H100 and what its design does
about that.  Unlike the TPU kernel it has no VMEM-style cap on the key
length (K/V stream through shared memory tile by tile), and
``q_offset`` is a runtime argument, so one build serves full prefill,
prefix-hit continuation and chunked prefill.  The bf16 kernel is
persistent and walks a work list of (batch, head, 128-row q tile, key
range) items from :func:`~.tile_plan.work_list`; when those items are
too few to fill the card, the keys are split across items and a merge
kernel combines the splits (:func:`split_plan`).

:func:`flash_gqa_attention_cuda` launches the kernel for CUDA tensors
and takes the plain version, :func:`flash_gqa_attention_plain` (the
tiled op of ``ops/flash_attention.py``), only for CPU tensors.  There
is no fallback: on a CUDA tensor it launches or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from llm_d_kv_cache_manager_tpu_torch.ops import _build
from llm_d_kv_cache_manager_tpu_torch.ops.flash_attention import (
    flash_gqa_attention,
)
from llm_d_kv_cache_manager_tpu_torch.ops.tile_plan import (  # noqa: F401
    HEAD_DIMS,
    KV_TILE,
    check_head_dim,
    key_tile,
    split_plan,
    work_list,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_gqa_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_offset: int = 0,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch version the kernel is held against: the tiled
    online-softmax op (same result as dense attention, without its
    [Tq, Tk] score matrix)."""
    return flash_gqa_attention(q, k, v, q_offset=q_offset, window=window)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
           window: Optional[int] = None):
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
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def flash_gqa_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_offset: int = 0,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal GQA attention.  q: [B, Tq, H, D]; k/v: [B, Tk, Hkv, D];
    query row i sits at key position ``q_offset + i``.  Returns
    [B, Tq, H, D] in q's dtype.  ``window``: a sliding window, row i
    seeing keys ``q_offset + i - window < j <= q_offset + i`` (None:
    causal alone); the key tiles below every row of a q tile's window
    are left out of its work item, never loaded.

    CUDA tensors run the kernel (bf16 or float32, contiguous, 16-byte
    aligned, head dim a multiple of 16 from 32 to 256, any H / Hkv; bf16
    also at least one key; any other head dim raises ``ValueError``) and every
    launch adds one to ``flash_gqa_attention_cuda.launches``; CPU tensors
    run :func:`flash_gqa_attention_plain`.  The kernel is forward-only:
    on any other device, grad mode with an input that requires grad
    raises ``RuntimeError`` before the launch."""
    q_offset = int(q_offset)
    window = None if window is None else int(window)
    _check(q, k, v, q_offset, window)
    if q.device.type == "cpu":
        return flash_gqa_attention_plain(q, k, v, q_offset=q_offset, window=window)
    _build.refuse_grad("flash_gqa_attention_cuda", q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes bf16 or float32, not {q.dtype}")
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    check_head_dim("the prefill kernel", D)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0 or Tq == 0:
        return out
    items, n_items, ctas, splits = None, 0, 0, 1
    if q.dtype == torch.bfloat16:
        if Tk == 0:
            raise ValueError("the bf16 kernel needs at least one key")
        plan = work_list(B, H, Tq, Tk, q_offset, q.device, split_keys=True,
                         kv_tile=key_tile(D), window=window)
        items, n_items, ctas, splits = plan.items, len(plan.items), plan.ctas, plan.splits
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((splits, B, Tq, H, D), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((splits, B, Tq, H, 2), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_prefill")
    fn = lib.flash_prefill
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if part_o is None else part_o.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            None if items is None else items.data_ptr(), n_items, ctas,
            B, Tq, Tk, H, Hkv, D, q_offset, window or 0, splits, _DTYPE_CODES[q.dtype],
            stream,
        )
    _build.check(lib, "flash_prefill launch", rc)
    flash_gqa_attention_cuda.launches += 1
    return out


flash_gqa_attention_cuda.launches = 0
