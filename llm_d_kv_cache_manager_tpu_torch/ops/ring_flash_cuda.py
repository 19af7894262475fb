"""One ring step's attention partial: the Hopper kernel and its plain
version.

Replaces the reference's Pallas TPU kernel ``_partial_kernel``
(``ops/ring_flash_pallas.py``, entry ``flash_partial``).  The kernel,
``csrc/ring_partial.cu``, is CUDA C++ for ``sm_90a``; its header note
says what bounds it on an H100 and what its design does about that.
It has no VMEM-style cap on the key length, and the mask is a runtime
argument: ``causal_offset=None`` is passed as an explicit "no mask"
flag, never as a large offset, so one build serves every ring step.
The bf16 kernel is persistent and walks a work list of (batch, head,
128-row q tile, key range) items from :func:`~.tile_plan.work_list`.

:func:`flash_partial_cuda` launches the kernel for CUDA tensors and
takes the plain version, :func:`flash_partial_plain`
(``ops/ring_flash.py``), only for CPU tensors.  There is no fallback:
on a CUDA tensor it launches or raises.  The reference's ``q_block``,
``kv_chunk`` and ``interpret`` are Pallas tiling and TPU knobs and have
no counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from llm_d_kv_cache_manager_tpu_torch.ops import _build
from llm_d_kv_cache_manager_tpu_torch.ops.ring_flash import (
    Partial,
    flash_partial_plain,
)
from llm_d_kv_cache_manager_tpu_torch.ops.tile_plan import (  # noqa: F401
    HEAD_DIMS,
    KV_TILE,
    check_head_dim,
    key_tile,
    work_list,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel computes row + offset + 1 in 64 bits; the C interface
# carries the offset as an int.
_OFFSET_RANGE = (-(2**31), 2**31 - 1)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal_offset):
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
    if causal_offset is not None and not (
        _OFFSET_RANGE[0] <= causal_offset <= _OFFSET_RANGE[1]
    ):
        raise ValueError(f"causal_offset {causal_offset} does not fit an int32")


def flash_partial_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal_offset: Optional[int] = 0,
) -> Partial:
    """Unnormalized GQA partial over one K/V chunk.  q: [B, Tq, H, D];
    k/v: [B, Tk, Hkv, D]; keys visible to local row a are b <= a +
    ``causal_offset`` (``None``: every key).  Returns float32
    ``(acc [B, Tq, H, D], m [B, Tq, H], l [B, Tq, H])`` as
    :func:`flash_partial_plain` does.

    CUDA tensors run the kernel (bf16 or float32, contiguous, 16-byte
    aligned, head dim a multiple of 16 from 32 to 256, any H / Hkv; bf16
    also at least one key; any other head dim raises ``ValueError``) and every
    launch adds one to ``flash_partial_cuda.launches``; CPU tensors
    run :func:`flash_partial_plain`.  The kernel is forward-only: on any
    other device, grad mode with an input that requires grad raises
    ``RuntimeError`` before the launch."""
    if causal_offset is not None:
        causal_offset = int(causal_offset)
    _check(q, k, v, causal_offset)
    if q.device.type == "cpu":
        return flash_partial_plain(q, k, v, causal_offset=causal_offset)
    _build.refuse_grad("flash_partial_cuda", q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes bf16 or float32, not {q.dtype}")
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    check_head_dim("the ring partial kernel", D)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    acc = torch.empty((B, Tq, H, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, Tq, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Tq, H), dtype=torch.float32, device=q.device)
    if B == 0 or Tq == 0:
        return acc, m, l
    items, n_items, ctas = None, 0, 0
    if q.dtype == torch.bfloat16:
        if Tk == 0:
            raise ValueError("the bf16 kernel needs at least one key")
        plan = work_list(B, H, Tq, Tk, causal_offset, q.device, kv_tile=key_tile(D))
        items, n_items, ctas = plan.items, len(plan.items), plan.ctas
    lib = _build.library("ring_partial")
    fn = lib.ring_partial
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    causal = causal_offset is not None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            None if items is None else items.data_ptr(), n_items, ctas,
            B, Tq, Tk, H, Hkv, D, int(causal), causal_offset if causal else 0,
            _DTYPE_CODES[q.dtype], stream,
        )
    _build.check(lib, "ring_partial launch", rc)
    flash_partial_cuda.launches += 1
    return acc, m, l


flash_partial_cuda.launches = 0
