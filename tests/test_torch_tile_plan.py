"""The work list of the port's bf16 attention kernels (``ops/tile_plan.py``),
checked on the CPU against the mask it stands for.

The kernels (``csrc/flash_prefill.cu``, ``csrc/ring_partial.cu``) walk
this list and trust it: a key tile missing from it is a key never seen,
a tile marked full is never masked.  So for each plan, pair by pair:
every visible (row, key) pair lies in exactly one item's range, no
masked pair lies in a full tile, items run longest first, and a q
tile's splits cover its keys exactly once."""

import numpy as np
import pytest
import torch

from tests.helpers.torch_port import port

tile_plan = port("ops.tile_plan")
flash_cuda = port("ops.flash_cuda")
ring_flash_cuda = port("ops.ring_flash_cuda")

B_, H_, QT, BEGIN, FULL, END, SPLIT = range(7)


def _check(B, H, Tq, Tk, offset, splits=1, per_split=None, q_tile=None, kv_tile=None):
    q_tile = q_tile or tile_plan.Q_TILE
    kv_tile = kv_tile or tile_plan.KV_TILE
    items = tile_plan.tile_plan(B, H, Tq, Tk, offset, splits, per_split,
                                q_tile=q_tile, kv_tile=kv_tile)
    assert items.dtype == np.int32 and items.shape[1] == len(tile_plan.ITEM_FIELDS)
    lengths = items[:, END] - items[:, BEGIN]
    assert (lengths >= 0).all()
    assert (np.diff(lengths) <= 0).all(), "items must run longest first"
    assert ((items[:, BEGIN] <= items[:, FULL]) & (items[:, FULL] <= items[:, END])).all()

    # The mask, per (row, key tile): row a sees keys [0, ends[a]).  A
    # tile holds a visible pair of row a when it starts below ends[a];
    # it is wholly visible (keys past Tk count as masked) when it ends
    # at or below ends[a].
    rows = np.arange(Tq)
    ends = np.full(Tq, Tk) if offset is None else np.clip(rows + offset + 1, 0, Tk)
    starts = np.arange(-(-Tk // kv_tile)) * kv_tile
    some_visible = starts[None, :] < ends[:, None]
    all_visible = starts[None, :] + kv_tile <= ends[:, None]

    seen = np.zeros((B, H) + some_visible.shape, np.int32)
    for b, h, qt, lo, full, hi, split, _ in items:
        span = slice(qt * q_tile, min((qt + 1) * q_tile, Tq))
        seen[b, h, span, lo:hi] += 1
        assert some_visible[span, lo:hi].any(0).all(), "an item holds a tile no row sees"
        assert all_visible[span, lo:full].all(), "a full tile holds a masked pair"
        if full < hi:  # masked only because some row of the tile needs it
            assert not all_visible[span, full].all()
    assert (seen[:, :, some_visible] == 1).all(), "a visible pair is seen 0 or 2+ times"
    assert (seen <= 1).all()
    # Every (b, h, q tile) has one item per split, the splits in order
    # and back to back from key tile 0 to the tile's last visible key.
    key = (items[:, B_].astype(np.int64) * H + items[:, H_]) * Tq + items[:, QT]
    for k in np.unique(key):
        mine = items[key == k]
        mine = mine[np.argsort(mine[:, SPLIT])]
        assert list(mine[:, SPLIT]) == list(range(splits))
        assert mine[0, BEGIN] == 0
        assert (mine[1:, BEGIN] == mine[:-1, END]).all()
        last = min((mine[0, QT] + 1) * q_tile, Tq) - 1
        assert mine[-1, END] == -(-tile_plan.row_end(last, Tk, offset) // kv_tile)
    assert len(np.unique(key)) == B * H * -(-Tq // q_tile)
    return items


PREFILL_SHAPES = [
    # (B, Tq, Tk, H, q_offset): the serving shapes and chip_smoke's edges
    (1, 8448, 8448, 2, 0),
    (1, 256, 8448, 2, 8192),
    (2, 100, 100, 2, 0),
    (1, 192, 192, 2, 0),
    (1, 256, 8400, 2, 8144),
    (1, 40, 300, 2, 260),
    (1, 1, 77, 1, 76),
]


@pytest.mark.parametrize("B,Tq,Tk,H,q_offset", PREFILL_SHAPES)
def test_prefill_plan_covers_the_causal_mask(B, Tq, Tk, H, q_offset):
    """The prefill plan, split as the wrapper splits it on a 132-SM card
    with 32 heads (H here is cut to keep the check fast)."""
    sms = 132
    splits, per_split = flash_cuda.split_plan(
        -(-Tq // tile_plan.Q_TILE) * 32 * B, tile_plan.key_tiles(Tq, Tk, q_offset), sms)
    _check(B, H, Tq, Tk, q_offset, splits, per_split)


@pytest.mark.parametrize(
    "B,Tq,Tk,offset",
    [
        (1, 2048, 2048, 0),
        (1, 2048, 2048, -1),
        (1, 2048, 2048, None),
        (1, 77, 77, -1),
        (2, 130, 130, -1),
        (1, 192, 320, 0),
        (2, 64, 200, None),
        (1, 100, 300, 10**6),  # every key visible, the last tile ragged
        (1, 100, 300, -(10**6)),  # no key visible: every item is empty
        (1, 300, 100, -250),  # rows 0..249 see nothing
    ],
)
def test_ring_plan_covers_the_step_mask(B, Tq, Tk, offset):
    items = _check(B, 2, Tq, Tk, offset)
    if offset is not None and offset <= -Tq:
        assert (items[:, END] == 0).all()


def test_ring_plan_keeps_every_row_of_an_empty_tile():
    """A q tile that sees no key still has its item, so the kernel
    writes its rows' (0, -1e30, 0) sentinel."""
    items = _check(1, 1, 300, 100, -250)
    assert sorted(items[:, QT]) == [0, 1, 2]
    assert items[items[:, QT] == 0, END].tolist() == [0]


def test_plan_property():
    """Random shapes, offsets, tile sizes and split plans (hypothesis is
    loaded here, not imported by the module: CI's pip list lacks it)."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=60, deadline=None)
    @hypothesis.given(
        B=st.integers(1, 2),
        H=st.integers(1, 2),
        Tq=st.integers(1, 300),
        Tk=st.integers(1, 300),
        offset=st.one_of(st.none(), st.integers(-400, 400)),
        q_tile=st.sampled_from([1, 16, 64, 128]),
        kv_tile=st.sampled_from([1, 16, 64, 128]),
        sms=st.integers(1, 200),
    )
    def check(B, H, Tq, Tk, offset, q_tile, kv_tile, sms):
        n_qt = -(-Tq // q_tile)
        splits, per_split = flash_cuda.split_plan(
            n_qt * H * B, tile_plan.key_tiles(Tq, Tk, offset, kv_tile), sms)
        _check(B, H, Tq, Tk, offset, splits, per_split, q_tile=q_tile, kv_tile=kv_tile)

    check()


@pytest.mark.parametrize(
    "ctas,kv_tiles,sms",
    [(64, 66, 132), (128, 132, 132), (8, 3, 132), (1, 500, 132), (2112, 66, 132)],
)
def test_split_plan_never_worse_than_no_split(ctas, kv_tiles, sms):
    """The chosen split's makespan (waves x (tiles + fixed cost)) is
    the least over every split count, and covers the keys."""
    splits, per_split = flash_cuda.split_plan(ctas, kv_tiles, sms)
    assert (splits - 1) * per_split < kv_tiles <= splits * per_split

    def cost(s):
        per = -(-kv_tiles // s)
        s = -(-kv_tiles // per)
        return -(-ctas * s // sms) * (per + tile_plan.ITEM_OVERHEAD_TILES)

    assert cost(splits) == min(cost(s) for s in range(1, kv_tiles + 1))


def test_work_list_is_cached_and_fills_the_sms():
    """The wrapper's work list: the plan as an int32 tensor on the
    device, made once per shape, and a grid of at most one CTA per SM."""
    first = tile_plan.work_list(1, 32, 256, 8448, 8192, "cpu", split_keys=True, sms=132)
    again = tile_plan.work_list(1, 32, 256, 8448, 8192, "cpu", split_keys=True, sms=132)
    assert again is first
    assert first.items.dtype == torch.int32 and first.items.device.type == "cpu"
    assert first.splits == 2 and len(first.items) == 2 * 2 * 32
    assert first.ctas == min(len(first.items), tile_plan.CTAS_PER_SM * 132)
    ring = tile_plan.work_list(1, 32, 2048, 2048, 0, "cpu", sms=132)
    assert ring.splits == 1 and len(ring.items) == 16 * 32 and ring.ctas == 132
    np.testing.assert_array_equal(
        ring.items.numpy(), tile_plan.tile_plan(1, 32, 2048, 2048, 0))


def test_wrappers_share_the_kernels_tiles():
    """chip_smoke's planted faults skip one key tile of the wrappers'
    size, the kernels' 128 keys (``kBK`` in attention_tiles.cuh)."""
    assert flash_cuda.KV_TILE == ring_flash_cuda.KV_TILE == tile_plan.KV_TILE == 128
    assert tile_plan.Q_TILE == 128
