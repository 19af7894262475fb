"""Operations, bytes and bounds, computed from shapes alone.

Every roofline share and every model-FLOP utilisation the benchmark
reports is worked out from the shapes of the work, here and in the
model families built on it, never from what an implementation
launches: a later kernel that does the same work is held to the same
count.

- A kernel's bound is the larger of its operations over the chip's peak
  rate and its bytes over the peak bandwidth.  Inputs are counted as
  read once and outputs as written once, whatever the kernel reads
  again.
- Model FLOPs count each layer's matrix products and causal attention
  for every token computed, and the output head for the positions whose
  logits a server needs (the last one of a prefill, each row of a
  decode step).  A model family's shape (``families/<family>.py``) counts
  them, and sums its layers' attention bounds, from these primitives.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit.
PEAKS: Dict[str, Dict[str, float]] = {
    "H100 SXM": {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks_for(device_name: str) -> Dict[str, float]:
    """The peak table of a card by its ``torch.cuda.get_device_name()``.
    "NVIDIA H100 80GB HBM3" is the SXM part."""
    if "H100" in device_name and "HBM3" in device_name:
        return PEAKS["H100 SXM"]
    raise ValueError(f"no peak table for card {device_name!r}")


def causal_pairs(tq: int, tk: int, q_offset: int) -> int:
    """(query, key) pairs a causal mask keeps when query ``i`` sits at
    position ``q_offset + i`` of ``tk`` keys."""
    # sum over i of min(q_offset + i + 1, tk), in closed form.
    full = max(0, min(tq, tk - q_offset))  # rows whose window is not cut by tk
    pairs = full * (q_offset + 1) + full * (full - 1) // 2
    return pairs + (tq - full) * tk


def visible_pairs(tq: int, tk: int, offset) -> int:
    """Pairs a ring partial keeps: key <= row + offset and key < tk
    (``None``: every pair)."""
    if offset is None:
        return tq * tk
    return sum(min(max(i + offset + 1, 0), tk) for i in range(tq))


@dataclass(frozen=True)
class Cost:
    flops: float
    bytes: float

    def bound_s(self, peaks: Dict[str, float], flops_key: str = "bf16_flops") -> float:
        return max(self.flops / peaks[flops_key], self.bytes / peaks["hbm_bytes"])


def prefill_attention(batch: int, tq: int, tk: int, heads: int, kv_heads: int,
                      head_dim: int, q_offset: int, itemsize: int = 2) -> Cost:
    """The prefill kernel's call: Q [B, tq, H, D] against K, V [B, tk,
    Hkv, D], causal at ``q_offset``; O written once."""
    flops = 4.0 * head_dim * heads * causal_pairs(tq, tk, q_offset) * batch
    elems = batch * (2 * tq * heads + 2 * tk * kv_heads) * head_dim
    return Cost(flops, float(elems * itemsize))


def ring_partial(batch: int, tq: int, tk: int, heads: int, kv_heads: int, head_dim: int,
                 offset, itemsize: int = 2) -> Cost:
    flops = 4.0 * head_dim * heads * visible_pairs(tq, tk, offset) * batch
    elems = batch * (2 * tq * heads + 2 * tk * kv_heads) * head_dim
    return Cost(flops, float(elems * itemsize))


def paged_decode(contexts, heads: int, kv_heads: int, head_dim: int, itemsize: int = 2,
                 kv_tokens: Optional[int] = None) -> Cost:
    """The decode kernel's call over rows with the given live context
    lengths: the K and V of the tokens it reads, plus q and out.
    ``kv_tokens``: the distinct pool slots the rows read, where rows share
    blocks (a cached prefix); each row's context otherwise."""
    total = sum(contexts)
    flops = 4.0 * head_dim * heads * total
    read = total if kv_tokens is None else kv_tokens
    elems = 2 * read * kv_heads * head_dim + 2 * len(contexts) * heads * head_dim
    return Cost(flops, float(elems * itemsize))
