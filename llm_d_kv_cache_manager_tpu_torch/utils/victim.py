"""Shared eviction-policy invocation guard.

The host-tier cache (``offload/host_tier.py``; in the JAX package the
cost-aware index too) hands a pluggable eviction policy an LRU-ordered
``(key, byte_cost)`` sample and needs a safety contract around the
call: the policy's answer is bounds-checked, and ANY policy failure
falls back to the LRU-first victim — eviction must never wedge a
cache.  The same guard as the JAX package's ``utils/victim.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def sample_limit(policy) -> int:
    """How many LRU-ordered candidates the policy wants ranked."""
    return max(1, getattr(policy, "sample", 1))


def guarded_select(policy, sample: Sequence[Tuple[int, int]], logger) -> int:
    """Index into ``sample`` of the victim the policy chose; 0 (the
    LRU-first candidate) on any policy failure or out-of-range
    answer.  Runs under the caller's lock — the policy contract says
    it takes no locks of its own."""
    try:
        index = policy.select_victim(sample)
        if not 0 <= index < len(sample):
            raise IndexError(index)
        return index
    except Exception:  # noqa: BLE001 — eviction must never wedge
        logger.exception("eviction policy failed; using LRU victim")
        return 0
