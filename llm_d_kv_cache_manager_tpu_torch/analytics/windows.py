"""Windowed aggregation frames for the cache-efficiency ledger.

A :class:`WindowRing` is a bounded ring of fixed-span frames: recording
lands in the frame covering "now", and reading aggregates only the
frames still inside the window.  Three standard rings (1m / 10m / 1h)
give the ledger a scrapeable short view and a snapshottable long view
without unbounded memory — the ring holds ``frames`` frames, ever.

Frames are CBOR-serializable through the project's canonical encoder
(``kvcache/kvblock/cbor_canonical.py``) so a snapshot is deterministic
bytes: the same counts always encode identically (the persistence
subsystem's rule, applied here so future eviction-policy training can
diff snapshots byte-wise).  The canonical encoder supports no maps, so
a frame encodes as a fixed-shape list (see :meth:`Frame.to_wire`).

Time is injected (``now`` parameters) rather than read, so tests drive
rotation deterministically; callers pass ``time.monotonic()``.

Copied from the JAX reference's ``analytics/windows.py``.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.cbor_canonical import (
    encode_canonical,
)

# Wire-format version of the frame list shape below.
FRAME_WIRE_VERSION = 1

OUTCOMES = ("hit", "partial", "miss")


class Frame:
    """Counts for one fixed time slot."""

    __slots__ = (
        "slot",
        "requests",
        "hits",
        "partials",
        "misses",
        "blocks_matched",
        "blocks_total",
        "tiers",
    )

    def __init__(self, slot: int) -> None:
        self.slot = slot
        self.requests = 0
        self.hits = 0
        self.partials = 0
        self.misses = 0
        self.blocks_matched = 0
        self.blocks_total = 0
        self.tiers: Dict[str, int] = {}

    def record(
        self,
        outcome: str,
        matched_blocks: int,
        total_blocks: int,
        tiers: Optional[Dict[str, int]],
    ) -> None:
        self.requests += 1
        if outcome == "hit":
            self.hits += 1
        elif outcome == "partial":
            self.partials += 1
        else:
            self.misses += 1
        self.blocks_matched += matched_blocks
        self.blocks_total += total_blocks
        if tiers:
            mine = self.tiers
            for tier, count in tiers.items():
                mine[tier] = mine.get(tier, 0) + count

    def merge(self, other: "Frame") -> None:
        """Fold another frame's counts into this one (the ledger's
        1-second accumulator absorbs into each ring once per slot roll
        instead of updating three rings per record)."""
        self.requests += other.requests
        self.hits += other.hits
        self.partials += other.partials
        self.misses += other.misses
        self.blocks_matched += other.blocks_matched
        self.blocks_total += other.blocks_total
        if other.tiers:
            mine = self.tiers
            for tier, count in other.tiers.items():
                mine[tier] = mine.get(tier, 0) + count

    def to_wire(self) -> list:
        """Fixed-shape list for canonical CBOR (no maps there): tiers
        become a name-sorted ``[name, count]`` list so equal counts
        always encode to equal bytes."""
        return [
            self.slot,
            self.requests,
            self.hits,
            self.partials,
            self.misses,
            self.blocks_matched,
            self.blocks_total,
            [[name, self.tiers[name]] for name in sorted(self.tiers)],
        ]

    def to_dict(self) -> dict:
        return {
            "slot": self.slot,
            "requests": self.requests,
            "hits": self.hits,
            "partials": self.partials,
            "misses": self.misses,
            "blocks_matched": self.blocks_matched,
            "blocks_total": self.blocks_total,
            "tiers": dict(self.tiers),
        }


class WindowRing:
    """Ring of ``frames`` frames, each spanning ``span_s`` seconds.

    Unlocked by design: the owning ledger serializes access (its
    aggregate lock), keeping this class a plain data structure.
    """

    def __init__(self, span_s: float, frames: int) -> None:
        if span_s <= 0 or frames <= 0:
            raise ValueError("span_s and frames must be positive")
        self.span_s = float(span_s)
        self.frames = frames
        self._ring: Deque[Frame] = deque()

    @property
    def window_s(self) -> float:
        return self.span_s * self.frames

    def _slot(self, now: float) -> int:
        return int(now // self.span_s)

    def _advance(self, now: float) -> None:
        """Drop frames that rotated out of the window."""
        floor = self._slot(now) - self.frames + 1
        ring = self._ring
        while ring and ring[0].slot < floor:
            ring.popleft()

    def record(
        self,
        now: float,
        outcome: str,
        matched_blocks: int,
        total_blocks: int,
        tiers: Optional[Dict[str, int]] = None,
    ) -> None:
        self._advance(now)
        slot = self._slot(now)
        ring = self._ring
        if not ring or ring[-1].slot != slot:
            # Slots between the last frame and now simply never existed
            # (no traffic there); the ring stores only non-empty frames.
            ring.append(Frame(slot))
        ring[-1].record(outcome, matched_blocks, total_blocks, tiers)

    def absorb(self, at: float, frame: Frame) -> None:
        """Fold pre-aggregated counts (a completed accumulator frame)
        into the ring frame covering time ``at``."""
        self._advance(at)
        slot = self._slot(at)
        ring = self._ring
        if not ring or ring[-1].slot != slot:
            ring.append(Frame(slot))
        ring[-1].merge(frame)

    def live_frames(self, now: float) -> List[Frame]:
        self._advance(now)
        return list(self._ring)

    def totals(self, now: float) -> dict:
        """Aggregate over the live frames, plus derived hit rate."""
        frames = self.live_frames(now)
        out = {
            "window_s": self.window_s,
            "frames": len(frames),
            "requests": 0,
            "hits": 0,
            "partials": 0,
            "misses": 0,
            "blocks_matched": 0,
            "blocks_total": 0,
            "tiers": {},
        }
        tiers: Dict[str, int] = out["tiers"]
        for frame in frames:
            out["requests"] += frame.requests
            out["hits"] += frame.hits
            out["partials"] += frame.partials
            out["misses"] += frame.misses
            out["blocks_matched"] += frame.blocks_matched
            out["blocks_total"] += frame.blocks_total
            for tier, count in frame.tiers.items():
                tiers[tier] = tiers.get(tier, 0) + count
        requests = out["requests"]
        out["hit_rate"] = (
            round(out["hits"] / requests, 4) if requests else None
        )
        out["block_hit_rate"] = (
            round(out["blocks_matched"] / out["blocks_total"], 4)
            if out["blocks_total"]
            else None
        )
        return out

    def to_cbor(self, now: float) -> bytes:
        """Canonical CBOR snapshot of the live frames."""
        frames = self.live_frames(now)
        payload = [
            FRAME_WIRE_VERSION,
            # span in milliseconds: the canonical encoder is int-only.
            int(self.span_s * 1000),
            self.frames,
            [frame.to_wire() for frame in frames],
        ]
        return encode_canonical(payload)


def standard_windows() -> List[Tuple[str, WindowRing]]:
    """The ledger's three standard windows: scrape-friendly 1m, trend
    10m, snapshot 1h."""
    return [
        ("1m", WindowRing(span_s=5.0, frames=12)),
        ("10m", WindowRing(span_s=30.0, frames=20)),
        ("1h", WindowRing(span_s=300.0, frames=12)),
    ]
