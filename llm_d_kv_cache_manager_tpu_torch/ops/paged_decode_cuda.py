"""Paged decode attention: the Hopper kernel and its plain version.

Replaces the reference's Pallas TPU kernel ``_decode_kernel``
(``ops/paged_decode_pallas.py``, entry
``paged_decode_attention_pallas``).  The kernel,
``csrc/paged_decode.cu``, is CUDA C++ for ``sm_90a``; its header note
says what bounds it on an H100 and what its design does about that.
The TPU kernel carries its online softmax along a sequential grid axis;
here one wave of CTAs cuts the live 16-token key tiles of all sequences
and KV heads into equal runs on the device (:func:`work_items` mirrors
that arithmetic for the tests), streams them through shared-memory rings,
and the last CTA of a (sequence, KV head) to arrive merges its partials
by log-sum-exp inside the same kernel.  The kernel reads the block table
itself and never reads an entry at or past
``ceil(context_len / block_size)``; under a sliding window of ``W``
positions (``window``) it reads only the key tiles that hold positions at
or above ``context_len - W``, and no table entry below them.  The host plan (:func:`split_plan`)
reads shapes only and the wrapper never waits for the device, so a call
can be captured in a CUDA graph.

:func:`paged_decode_attention_cuda` launches the kernels for CUDA
tensors and takes the plain version, :func:`paged_decode_attention_plain`
(``ops/paged_attention.py``'s gather + dense attention), only for CPU
tensors.  There is no fallback: on a CUDA tensor it launches or raises.

``context_len == 0`` gives 0 from the kernel and the mean of V from the
plain version (see ``ops/paged_attention.py``); decode never has an
empty context.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from llm_d_kv_cache_manager_tpu_torch.ops import _build
from llm_d_kv_cache_manager_tpu_torch.ops.paged_attention import (
    paged_attention,
)
from llm_d_kv_cache_manager_tpu_torch.ops.tile_plan import (
    HEAD_DIMS,
    HEAD_DIMS_TEXT,
    compiled_width,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The shapes the kernel takes, as the reference's Pallas kernel does:
# any head dim of HEAD_DIMS, group H / Hkv and pool block size below.
BLOCK_SIZES = (8, 16, 32, 64, 128)
GROUPS = tuple(range(1, 17))
TILE_TOKENS = 16  # tokens a unit of work: one m16n8k16 key tile
# CTAs of each kernel variant that one SM holds, asked of the library
# once: {(device index, head_dim, heads a line, dtype code, block size):
# CTAs}.
RESIDENT_CTAS = {}


def paged_decode_attention_plain(
    q: torch.Tensor,
    kv_layer: torch.Tensor,
    block_table: torch.Tensor,
    context_len: torch.Tensor,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The plain PyTorch version the kernel is held against."""
    return paged_attention(q, kv_layer, block_table, context_len, window)


def head_split(group: int, head_dim: int, dtype: torch.dtype):
    """(heads a line, lines a KV head): how the kernel cuts each group
    of query heads.  bf16 keeps the group whole (up to 16 heads are the
    rows of one tensor-core tile); the float32 engine holds at most
    ``1024 // compiled_width(head_dim)`` heads' state a lane, so a larger
    group is cut into equal sub-groups, each a line of its own over the
    same K and V (``kSimtHeads`` in csrc/paged_decode.cu)."""
    if dtype != torch.float32:
        return group, 1
    most = 1024 // compiled_width(head_dim)
    heads = max(d for d in range(1, min(group, most) + 1) if group % d == 0)
    return heads, group // heads


def max_tiles(max_blocks: int, block_size: int) -> int:
    """Key tiles a table row of ``max_blocks`` pool blocks holds."""
    return -(-max_blocks * block_size // TILE_TOKENS)


def split_plan(batch: int, kv_heads: int, max_blocks: int, sms: int,
               ctas_per_sm: int, *, block_size: int = 16) -> int:
    """The grid: one wave of CTAs (``sms * ctas_per_sm``), or one CTA per
    (sequence, line, key tile) where the table has fewer; ``kv_heads``
    counts lines (KV heads times :func:`head_split`'s lines).  From
    shapes alone; the kernel cuts the work among them from the lengths."""
    return max(1, min(sms * ctas_per_sm,
                      batch * kv_heads * max_tiles(max_blocks, block_size)))


def first_tile(n: int, window: Optional[int]) -> int:
    """The first key tile a sequence of ``n`` live tokens reads: 0, or
    under a window the tile of its first position in the window."""
    return 0 if window is None else max(0, n - window) // TILE_TOKENS


def work_items(context_len, kv_heads: int, max_blocks: int, ctas: int, *,
               block_size: int = 16, window: Optional[int] = None):
    """The kernel's split of one call, as ``(cta, b, line, first tile,
    end tile)`` pieces, a tile being 16 tokens (``TILE_TOKENS``): tile
    ``j`` of a sequence holds its tokens ``[16 j, 16 j + 16)``, inside
    one pool block of 16 or more tokens, over two blocks of 8.  A
    sequence's live tiles cover ``min(context_len, max_blocks *
    block_size)`` tokens.  The live tiles of every (line, sequence), in
    that order, form one line of units; CTA ``c`` takes units
    ``[c * per, (c + 1) * per)`` with ``per = ceil(units / ctas)``, and
    each stretch of its run inside one (sequence, line) is a piece.  A
    piece that is not the whole pair leaves a partial that the pair's
    last CTA merges.  At block size 16 a tile is a pool block.  Under a
    ``window`` a sequence's tiles start at :func:`first_tile`, and its
    pieces count from there."""
    cap = max_blocks * block_size
    live = [0 if n <= 0 else -(-min(int(n), cap) // TILE_TOKENS)
            - first_tile(min(int(n), cap), window) for n in context_len]
    per_head = sum(live)
    total = kv_heads * per_head
    per = -(-total // ctas)
    items = []
    for cta in range(ctas):
        at, run_end = cta * per, min((cta + 1) * per, total)
        while at < run_end:
            kvh = at // per_head
            seg_start = kvh * per_head
            for b, nb in enumerate(live):
                if seg_start <= at < min(run_end, seg_start + nb):
                    stop = min(run_end, seg_start + nb)
                    items.append((cta, b, kvh, at - seg_start, stop - seg_start))
                    at = stop
                seg_start += nb
    return items


def check_shape(head_dim: int, block_size: int, group: int) -> None:
    """Raise ``ValueError`` unless the kernel takes this head dim, pool
    block size and group H / Hkv."""
    if head_dim not in HEAD_DIMS or block_size not in BLOCK_SIZES or group not in GROUPS:
        raise ValueError(
            f"the decode kernel takes head_dim {HEAD_DIMS_TEXT}, block_size in "
            f"{BLOCK_SIZES} and H/Hkv from 1 to 16; got {head_dim}, {block_size}, {group}"
        )


def _check(q, kv_layer, block_table, context_len):
    if q.dim() != 3 or kv_layer.dim() != 5 or kv_layer.shape[1] != 2:
        raise ValueError(
            f"expected q [B,H,D] and kv_layer [nb,2,bs,Hkv,D], got "
            f"{tuple(q.shape)}, {tuple(kv_layer.shape)}"
        )
    B, H, D = q.shape
    Hkv = kv_layer.shape[3]
    if kv_layer.shape[4] != D or H % Hkv:
        raise ValueError(
            f"q {tuple(q.shape)} and kv_layer {tuple(kv_layer.shape)} "
            "disagree on head dim, or H is not a multiple of Hkv"
        )
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError(f"block_table must be [B, max_blocks], got {tuple(block_table.shape)}")
    if tuple(context_len.shape) != (B,):
        raise ValueError(f"context_len must be [B], got {tuple(context_len.shape)}")
    if q.dtype != kv_layer.dtype:
        raise ValueError("q and kv_layer must have one dtype")
    devices = {t.device for t in (q, kv_layer, block_table, context_len)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")


def _bind(lib) -> None:
    lib.paged_decode.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.paged_decode.restype = ctypes.c_int
    lib.paged_decode_ctas_per_sm.argtypes = [ctypes.c_int] * 4
    lib.paged_decode_ctas_per_sm.restype = ctypes.c_int
    lib.paged_decode_scratch_bytes.argtypes = [ctypes.c_int] * 5
    lib.paged_decode_scratch_bytes.restype = ctypes.c_long


def paged_decode_attention_cuda(
    q: torch.Tensor,
    kv_layer: torch.Tensor,
    block_table: torch.Tensor,
    context_len: torch.Tensor,
    window: Optional[int] = None,
) -> torch.Tensor:
    """q: [B, H, D]; kv_layer: [num_blocks, 2, block_size, Hkv, D];
    block_table: [B, max_blocks]; context_len: [B].  Returns [B, H, D]
    in q's dtype.  ``window``: a sliding window, each row attending to
    the last ``window`` positions of its context (None: all of them);
    the kernel reads only the tiles that hold them.

    CUDA tensors run the kernel (bf16 or float32, contiguous, block size
    8, 16, 32, 64 or 128, head dim a multiple of 16 from 32 to 256, H/Hkv
    from 1 to 16, int32 table and lengths; any other shape raises
    ``ValueError``) and every launch adds one to
    ``paged_decode_attention_cuda.launches``; CPU tensors run
    :func:`paged_decode_attention_plain`.  The kernel is forward-only:
    on any other device, grad mode with an input that requires grad
    raises ``RuntimeError`` before the launch."""
    _check(q, kv_layer, block_table, context_len)
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, kv_layer, block_table, context_len, window)
    _build.refuse_grad("paged_decode_attention_cuda", q, kv_layer)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, D = q.shape
    num_blocks, _, block_size, Hkv, _ = kv_layer.shape
    max_blocks = block_table.shape[1]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes bf16 or float32, not {q.dtype}")
    check_shape(D, block_size, H // Hkv)
    if block_table.dtype != torch.int32 or context_len.dtype != torch.int32:
        raise ValueError("block_table and context_len must be int32")
    for name, t in (("q", q), ("kv_layer", kv_layer), ("block_table", block_table),
                    ("context_len", context_len)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0 or max_blocks == 0 or num_blocks == 0:
        return out.zero_()
    lib = _build.library("paged_decode")
    _bind(lib)
    code = _DTYPE_CODES[q.dtype]
    heads, nsub = head_split(H // Hkv, D, q.dtype)
    key = (q.device.index, D, heads, code, block_size)
    if key not in RESIDENT_CTAS:
        with torch.cuda.device(q.device):
            resident = lib.paged_decode_ctas_per_sm(D, heads, block_size, code)
        if resident <= 0:
            _build.check(lib, "paged_decode occupancy", -resident or 1)
        RESIDENT_CTAS[key] = resident
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    lines = Hkv * nsub
    ctas = split_plan(B, lines, max_blocks, sms, RESIDENT_CTAS[key], block_size=block_size)
    scratch = torch.empty(
        lib.paged_decode_scratch_bytes(B, lines, heads, D, ctas),
        dtype=torch.uint8, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.paged_decode(
            q.data_ptr(), kv_layer.data_ptr(), block_table.data_ptr(),
            context_len.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            B, H, Hkv, D, block_size, num_blocks, max_blocks, ctas, nsub,
            0 if window is None else int(window), code, stream,
        )
    _build.check(lib, "paged_decode launch", rc)
    paged_decode_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0
