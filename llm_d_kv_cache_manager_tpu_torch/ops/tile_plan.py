"""The work list of the bf16 attention kernels.

Both bf16 kernels, ``csrc/flash_prefill.cu`` and ``csrc/ring_partial.cu``,
run the tile loop of ``csrc/attention_tiles.cuh``: a persistent grid of
at most one CTA per SM walks a list of work items, each one (batch,
head, ``Q_TILE``-row q tile, range of ``KV_TILE``-key tiles).  This
module builds that list, so the kernels' control flow (which tiles each
row sees, which of them need the mask, how the keys are split) is plain
Python that the CPU tests reach.

A key is visible to query row ``a`` while it is below the row's end:
``clamp(a + offset + 1, 0, Tk)``, or ``Tk`` when ``offset`` is None.
Causal prefill is ``offset = q_offset``; a ring step passes its own
signed offset, or None for an unmasked step.  A sliding window of ``W``
keys (``window``) also hides the keys below the row's begin, ``a +
offset + 1 - W``: row ``a`` sees keys ``j`` with ``a + offset - W < j
<= a + offset``.  For a q tile, key tiles below ``kt_full_end`` and at
or above ``kt_full_begin`` are visible to every row of the tile (below
Tq) and take no mask; tiles in ``[kt_full_end, kt_end)`` straddle some
row's end and tiles in ``[kt_begin, kt_full_begin)`` some row's begin,
and are masked element by element; no row sees a key below ``kt_begin
* KV_TILE`` or at or past ``kt_end * KV_TILE``, and those tiles are
never loaded.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from llm_d_kv_cache_manager_tpu_torch.metrics.collector import count_build
from llm_d_kv_cache_manager_tpu_torch.obs.trace import profiler_range
from llm_d_kv_cache_manager_tpu_torch.utils.lru import LRUCache

Q_TILE = 128  # query rows per work item: two consumer warpgroups of 64
KV_TILE = 128  # keys per shared-memory K/V stage, up to a head dim of 128
# The head dims the three attention kernels take: every multiple of 16
# from 32 to 256, as the reference's Pallas kernels do (they tile the
# whole head dim).  Each is served by the kernel compiled for the next
# multiple of 64 (``compiled_width``), its extra columns zeros.
HEAD_DIMS = tuple(range(32, 257, 16))
HEAD_DIMS_TEXT = "a multiple of 16 from 32 to 256"
# CTAs per SM the persistent grid launches (one fills an SM's shared
# memory); a key split aims at CTAS_PER_SM * SMs items.
CTAS_PER_SM = 1
# One work item, int32 fields in this order (``enum`` in attention_tiles.cuh).
ITEM_FIELDS = ("b", "h", "q_tile", "kt_begin", "kt_full_end", "kt_end", "split",
               "kt_full_begin")


class WorkList(NamedTuple):
    """A launch's work: ``items`` int32 [n, len(ITEM_FIELDS)] on the
    kernel's device, the persistent grid ``ctas``, and ``splits``, the
    number of key splits per q tile (1: none)."""

    items: torch.Tensor
    ctas: int
    splits: int


def compiled_width(head_dim: int) -> int:
    """The width of the kernel that serves ``head_dim``: the next
    multiple of 64 (``compiled_width`` in csrc/attention_tiles.cuh)."""
    return -(-head_dim // 64) * 64


def key_tile(head_dim: int) -> int:
    """Keys per K/V stage of the bf16 kernels at ``head_dim``: 128, or
    64 above a compiled width of 128, where two stages of 128 keys would
    not fit in shared memory beside Q (``key_tile`` in
    csrc/attention_tiles.cuh)."""
    return KV_TILE if compiled_width(head_dim) <= 128 else KV_TILE // 2


def check_head_dim(what: str, head_dim: int) -> None:
    """Raise ``ValueError`` for a head dim outside ``HEAD_DIMS``."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{what} takes head_dim {HEAD_DIMS_TEXT}, not {head_dim}")


def row_end(row: int, Tk: int, offset: Optional[int]) -> int:
    """Keys ``[0, end)`` visible to query row ``row``."""
    if offset is None:
        return Tk
    return min(max(row + offset + 1, 0), Tk)


def row_begin(row: int, Tk: int, offset: Optional[int], window: Optional[int]) -> int:
    """The first key visible to query row ``row``: 0, or under a window
    of ``window`` keys the row's end less the window (never past the
    end)."""
    end = row_end(row, Tk, offset)
    if window is None:
        return 0
    if offset is None:
        raise ValueError("a window needs a causal offset")
    return min(max(row + offset + 1 - window, 0), end)


# A work item's fixed cost, in key tiles: its Q load, its epilogue and,
# split, its float32 partial's write and merge.
ITEM_OVERHEAD_TILES = 2


def split_plan(ctas: int, kv_tiles: int, sms: int) -> Tuple[int, int]:
    """(splits, key tiles per split) for ``ctas`` (q tile, head, batch)
    items whose longest key range is ``kv_tiles`` tiles.  The splits
    minimize the persistent grid's makespan: waves of ``CTAS_PER_SM *
    sms`` items times a split's tiles plus ``ITEM_OVERHEAD_TILES``,
    fewer splits winning a tie.  No split when the items already fill
    the SMs; every split has at least one tile."""
    slots = CTAS_PER_SM * sms
    if ctas >= slots or kv_tiles <= 1:
        return 1, max(1, kv_tiles)
    best = None
    for want in range(1, kv_tiles + 1):
        per_split = -(-kv_tiles // want)
        splits = -(-kv_tiles // per_split)
        cost = -(-ctas * splits // slots) * (per_split + ITEM_OVERHEAD_TILES)
        if best is None or cost < best[0]:
            best = (cost, splits, per_split)
    return best[1], best[2]


def key_tiles(Tq: int, Tk: int, offset: Optional[int], kv_tile: int = KV_TILE,
              window: Optional[int] = None, q_tile: int = Q_TILE) -> int:
    """The longest key range of a q tile, in key tiles: the tiles the
    last query row sees, or under a window the widest span of one q
    tile's rows."""
    if window is None:
        return -(-row_end(Tq - 1, Tk, offset) // kv_tile)
    spans = (_tile_range(qt, Tq, Tk, offset, window, q_tile, kv_tile)
             for qt in range(-(-Tq // q_tile)))
    return max(end - begin for begin, _, _, end in spans)


def _tile_range(qt: int, Tq: int, Tk: int, offset: Optional[int], window: Optional[int],
                q_tile: int, kv_tile: int) -> Tuple[int, int, int, int]:
    """(kt_begin, kt_full_begin, kt_full_end, kt_end) of q tile ``qt``."""
    first, last = qt * q_tile, min((qt + 1) * q_tile, Tq) - 1
    kt_end = -(-row_end(last, Tk, offset) // kv_tile)
    kt_full_end = row_end(first, Tk, offset) // kv_tile
    kt_begin = row_begin(first, Tk, offset, window) // kv_tile
    kt_full_begin = -(-row_begin(last, Tk, offset, window) // kv_tile)
    return kt_begin, kt_full_begin, kt_full_end, kt_end


def tile_plan(
    B: int, H: int, Tq: int, Tk: int, offset: Optional[int], splits: int = 1,
    per_split: Optional[int] = None, *, q_tile: int = Q_TILE, kv_tile: int = KV_TILE,
    window: Optional[int] = None,
) -> np.ndarray:
    """Every work item of one launch, int32 [n, len(ITEM_FIELDS)], sorted
    by key range longest first (stable, so the heads of one q tile stay
    together and share their K/V in L2).  The kernels' tiles are
    ``Q_TILE`` and ``KV_TILE``; other sizes serve the tests.

    ``splits`` > 1 cuts each q tile's key tiles ``[kt_begin, kt_end)``
    into ranges of ``per_split`` tiles, one item per (q tile, split,
    batch, head) even when its range is empty, since the merge reads
    every split.  ``window``: a sliding window of that many keys (see
    the module note); None is causal (or unmasked) alone."""
    if per_split is None:
        per_split = max(1, -(-key_tiles(Tq, Tk, offset, kv_tile, window, q_tile) // splits))
    rows = []
    for qt in range(-(-Tq // q_tile)):
        kt_begin, kt_full_begin, kt_full, kt_end = _tile_range(
            qt, Tq, Tk, offset, window, q_tile, kv_tile)
        for split in range(splits):
            lo = min(kt_begin + split * per_split, kt_end) if splits > 1 else kt_begin
            hi = min(lo + per_split, kt_end) if splits > 1 else kt_end
            full = min(max(kt_full, lo), hi)
            full_begin = min(max(kt_full_begin, lo), hi)
            rows.append((qt, lo, full, hi, split, full_begin))
    items = np.array(
        [(b, h, qt, lo, full, hi, split, full_begin)
         for qt, lo, full, hi, split, full_begin in rows for b in range(B) for h in range(H)],
        dtype=np.int32,
    ).reshape(-1, len(ITEM_FIELDS))
    return items[np.argsort(items[:, 3] - items[:, 5], kind="stable")]


# Device copies of plans, so a launch after the first copies nothing.
_DEVICE_PLANS: LRUCache = LRUCache(256)


def work_list(
    B: int, H: int, Tq: int, Tk: int, offset: Optional[int], device: torch.device,
    *, split_keys: bool = False, sms: Optional[int] = None, kv_tile: int = KV_TILE,
    window: Optional[int] = None,
) -> WorkList:
    """The work list of a bf16 launch on ``device``: the items of
    :func:`tile_plan` in key tiles of ``kv_tile`` keys (the kernel's,
    :func:`key_tile`) as a cached int32 device tensor, a persistent grid
    of at most ``CTAS_PER_SM`` CTAs per SM, and, with ``split_keys``,
    the key split of :func:`split_plan` when the items are too few to
    fill the card; ``window`` as :func:`tile_plan` takes it.  ``sms``
    defaults to the CUDA device's SM count.  A
    miss (the plan's build and its upload) is an ``ops.plan_build``
    profiler range and counts in ``kvtpu_kernel_builds_total{what="plan"}``."""
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    key = (B, H, Tq, Tk, offset, split_keys, sms, kv_tile, window, str(device))
    cached = _DEVICE_PLANS.get(key)
    if cached is not None:
        return cached
    t0 = time.perf_counter()
    with profiler_range("ops.plan_build", {"batch": B, "heads": H, "q": Tq, "k": Tk}):
        splits, per_split = 1, None
        if split_keys:
            splits, per_split = split_plan(
                -(-Tq // Q_TILE) * H * B, key_tiles(Tq, Tk, offset, kv_tile, window), sms)
        plan = tile_plan(B, H, Tq, Tk, offset, splits, per_split, kv_tile=kv_tile,
                         window=window)
        result = WorkList(
            torch.from_numpy(plan).to(device),
            min(len(plan), CTAS_PER_SM * sms),
            splits,
        )
    count_build("plan", time.perf_counter() - t0)
    _DEVICE_PLANS.put(key, result)
    return result
