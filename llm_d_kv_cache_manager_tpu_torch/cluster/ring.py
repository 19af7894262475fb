"""Deterministic, versioned rendezvous hash ring over block-key space.

Rendezvous (highest-random-weight) hashing instead of a virtual-node
token ring: every ``(key, member)`` pair gets a deterministic 64-bit
weight and the key's owner is the member with the highest weight.  The
properties the cluster leans on fall out of the construction:

* **Determinism across processes.**  Weights are pure functions of the
  member id string and the key integer (blake2b member seed + a
  splitmix64-style finalizer) — never Python's seeded ``hash()`` — so
  every router and replica computes the same ownership, whatever its
  ``PYTHONHASHSEED`` (property-pinned by a subprocess test).
* **Minimal disruption.**  Removing a member reassigns exactly the keys
  it owned — each to its rendezvous runner-up — and adding a member
  steals ~1/N of the key space, spread evenly over the survivors; no
  other key moves.  This is also what makes failover warm: the
  runner-up (``owners(key, 2)[1]``) is the key's standby, and a
  follower syncing the standby slice holds precisely the keys it will
  inherit (see ``replication.py``).
* **Versioning.**  Membership changes produce a NEW ring with
  ``version + 1``; the ring itself is immutable, so readers snapshot it
  once per operation and per-version ownership caches stay sound.

Block keys are FNV-64 outputs (uniform already), but the weight mix
must decorrelate keys that differ in few bits AND decorrelate members,
hence the two-level mix below.

Copied from the JAX reference's ``cluster/ring.py``.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

__all__ = ["HashRing"]

_MASK64 = (1 << 64) - 1
# splitmix64 finalizer constants (Steele et al.); full-avalanche on
# 64-bit inputs, cheap enough for a per-key per-member Python loop.
_C1 = 0xFF51AFD7ED558CCD
_C2 = 0xC4CEB9FE1A85EC53


def _mix64(x: int) -> int:
    x &= _MASK64
    x ^= x >> 33
    x = (x * _C1) & _MASK64
    x ^= x >> 33
    x = (x * _C2) & _MASK64
    x ^= x >> 33
    return x


def _member_seed(member: str) -> int:
    """Stable 64-bit seed for a member id (process-independent)."""
    digest = hashlib.blake2b(member.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big")


class HashRing:
    """Immutable rendezvous ring over a set of replica ids."""

    __slots__ = ("_members", "_seeds", "_version")

    def __init__(self, members: Sequence[str], version: int = 0) -> None:
        unique = sorted(set(members))
        if not unique:
            raise ValueError("a hash ring needs at least one member")
        for member in unique:
            if not member:
                raise ValueError("empty replica id")
        self._members: Tuple[str, ...] = tuple(unique)
        self._seeds: Tuple[int, ...] = tuple(
            _member_seed(m) for m in unique
        )
        self._version = version

    @property
    def members(self) -> Tuple[str, ...]:
        return self._members

    @property
    def version(self) -> int:
        return self._version

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, member: str) -> bool:
        return member in self._members

    # -- ownership ------------------------------------------------------

    def owner(self, key: int) -> str:
        """The member with the highest rendezvous weight for ``key``."""
        mixed = _mix64(key)
        best = None
        best_weight = -1
        for member, seed in zip(self._members, self._seeds):
            weight = _mix64(mixed ^ seed)
            if weight > best_weight:
                best_weight = weight
                best = member
        return best  # type: ignore[return-value] — members is non-empty

    def owners(self, key: int, n: int = 2) -> List[str]:
        """The top-``n`` members by weight: ``[primary, standby, ...]``.

        ``owners(key, 2)[1]`` is the key's failover target — remove the
        primary from the ring and ``owner(key)`` on the new ring IS
        that runner-up (the rendezvous property replication relies on).
        Weight ties are impossible in practice (64-bit), but broken by
        member id for bit-determinism anyway.
        """
        mixed = _mix64(key)
        ranked = sorted(
            (
                (_mix64(mixed ^ seed), member)
                for member, seed in zip(self._members, self._seeds)
            ),
            key=lambda pair: (-pair[0], pair[1]),
        )
        return [member for _, member in ranked[:n]]

    # -- membership changes (new ring, version + 1) ---------------------

    def without(self, member: str) -> "HashRing":
        if member not in self._members:
            return self
        remaining = [m for m in self._members if m != member]
        return HashRing(remaining, version=self._version + 1)

    def with_member(self, member: str) -> "HashRing":
        if member in self._members:
            return self
        return HashRing(
            list(self._members) + [member], version=self._version + 1
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"HashRing(v{self._version}, "
            f"members={list(self._members)!r})"
        )
