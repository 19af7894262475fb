"""Default in-memory index: lock-striped shards of bounded LRU maps.

``request_key -> PodCache`` (an LRU of PodEntry) plus
``engine_key -> request_key`` for evictions, mirroring the reference's
two-level design (pkg/kvcache/kvblock/in_memory.go:105-270) with atomic
put-if-absent instead of Go's double-checked insert.

The request-key map is sharded N ways (power of two, key-masked): block
keys are FNV-64 outputs, so the low bits are uniformly distributed and a
bitmask spreads keys evenly.  Each shard is its own ``LRUCache`` with its
own lock, so concurrent scoring reads and kvevents applies touching
different shards never convoy on one lock (the pre-shard design
serialized every reader and the event writer behind a single map lock).
Capacity is budgeted per shard (``ceil(size / shards)``), which makes the
global bound approximate: eviction is LRU *within* a shard, the standard
striped-cache trade.  ``shards=1`` restores the exact single-LRU
semantics.

The engine->request map stays a single LRU: it is only touched by the
event write path (adds, evictions, parent resolution), never by scoring
reads, so it does not contend with the read path.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import (
    Index,
    InMemoryIndexConfig,
    PodEntry,
)
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.lru import LRUCache

# The global acquisition order of this backend, declared once for both
# halves of KV006: the comments feed the static analyzer, the
# ``lockorder`` calls arm the runtime watchdog (asserted under the
# concurrency storms with KVTPU_LOCK_ORDER_DEBUG=1).  Shard stripes
# are LRUCache instances acquired in ascending shard-index order by
# every cross-shard operation below (never nested — the rank check is
# armed in case that ever changes).  A shard lock is never held across
# a pod-cache call, but a pod-cache lock IS held while its bounded
# ``entries`` LRU takes its own lock (add_all/snapshot/purge), so the
# pod-cache lock precedes LRUCache._lock globally.
# kvlint: lock-order: LRUCache._lock ascending
lockorder.declare_ascending("LRUCache._lock")
# kvlint: lock-order: _PodCache.lock < LRUCache._lock
lockorder.declare_order("_PodCache.lock", "LRUCache._lock")


class _PodCache:
    """Bounded recency set of PodEntry for one block key."""

    __slots__ = ("entries", "lock", "_snap")

    def __init__(self, capacity: int) -> None:
        self.entries: LRUCache[PodEntry, None] = LRUCache(capacity)
        self.lock = lockorder.tracked(
            threading.Lock(), "_PodCache.lock"
        )
        # Cached immutable snapshot of the entries, rebuilt lazily after
        # each mutation.  Read WITHOUT the lock by design: a reader
        # either sees a fully-built tuple published before the last
        # mutation (linearizes before it) or None (rebuilds under the
        # lock) — never a torn value, since tuple publication is a
        # single reference store.  This turns the steady-state scoring
        # read (hundreds of snapshots per request) into one attribute
        # load instead of a lock round-trip + list build per key.
        self._snap: Optional[Tuple[PodEntry, ...]] = None

    def add_all(self, entries: Sequence[PodEntry]) -> None:
        with self.lock:
            for entry in entries:
                self.entries.put(entry, None)
            self._snap = None

    def remove_all(self, entries: Sequence[PodEntry]) -> bool:
        """Remove entries; return True if the cache is now empty."""
        with self.lock:
            for entry in entries:
                self.entries.remove(entry)
            self._snap = None
            return len(self.entries) == 0

    def purge(self, pod_identifier: str) -> Tuple[int, bool]:
        """Drop every entry of one pod; returns (removed, now_empty)."""
        with self.lock:
            victims = [
                entry
                for entry in self.entries.keys()
                if entry.pod_identifier == pod_identifier
            ]
            for entry in victims:
                self.entries.remove(entry)
            if victims:
                self._snap = None
            return len(victims), len(self.entries) == 0

    def snapshot(self) -> Sequence[PodEntry]:
        # gil-atomic: single ref read; a stale None only costs a rebuild
        snap = self._snap
        if snap is None:
            with self.lock:
                snap = tuple(self.entries.keys())
                self._snap = snap
        return snap

    def __len__(self) -> int:
        return len(self.entries)


def _shard_count(requested: int) -> int:
    """Round the configured shard count up to a power of two (>= 1)."""
    if requested <= 1:
        return 1
    n = 1
    while n < requested:
        n <<= 1
    return n


class InMemoryIndex(Index):
    def __init__(self, config: Optional[InMemoryIndexConfig] = None) -> None:
        self.config = config or InMemoryIndexConfig()
        n_shards = _shard_count(self.config.shards)
        self._mask = n_shards - 1
        per_shard = max(1, -(-self.config.size // n_shards))
        self._shards: List[LRUCache[int, _PodCache]] = [
            LRUCache(per_shard, lock_rank=i) for i in range(n_shards)
        ]
        self._engine_to_request: LRUCache[int, int] = LRUCache(
            self.config.size
        )
        # Shard grouping memo for lookup_chain, keyed on key-TUPLE
        # identity: the fast lane re-presents the same memoized key
        # tuple request after request, and its shard grouping is a pure
        # function of the keys.  Entries hold a strong ref and are
        # validated with ``is`` (id() reuse can never alias); bounded
        # by wholesale clear; single-key dict ops only (benign under
        # the GIL).  Lists (fresh per request) are never cached.
        self._group_cache: Dict[int, tuple] = {}
        # Per-shard mutation counters backing the indexer's score memo
        # (docs/performance.md): every score-relevant mutation — entry
        # add/remove, capacity eviction, restore, purge — bumps its
        # shard AFTER the mutation is visible, so an optimistic reader
        # that captured the vector BEFORE its walk can never validate
        # a result the mutation invalidated.  Recency touches do not
        # bump (they change eviction order, not scores; the eviction
        # itself bumps when it happens).  Deliberately lock-free: a
        # racing ``+= 1`` pair can lose an increment, but counters only
        # ever advance, so a completed bump still always differs from
        # any vector captured before it — equality validation stays
        # sound — and a global lock here would re-serialize exactly the
        # reader/writer paths the shard striping de-convoys.
        self._versions: List[int] = [0] * n_shards

    _GROUP_CACHE_MAX = 1024

    # -- shard plumbing -------------------------------------------------

    def _shard(self, request_key: int) -> LRUCache[int, _PodCache]:
        return self._shards[request_key & self._mask]

    def _peek_ordered(
        self,
        request_keys: Sequence[int],
        groups: Optional[Dict[int, Tuple[List[int], List[int]]]] = None,
    ) -> List[Optional[_PodCache]]:
        """Per-key pod caches in input order, one lock round-trip per
        shard touched (not per key).  Pass precomputed ``groups`` (from
        ``_chain_groups``) to reuse one grouping for peek + touch."""
        if not self._mask:
            return self._shards[0].peek_many(request_keys)
        if groups is None:
            groups = self._chain_groups(request_keys)
        out: List[Optional[_PodCache]] = [None] * len(request_keys)
        # Ascending shard order here and in every other cross-shard
        # walk: the locks are taken sequentially today, so this is
        # deadlock-proofing by construction (KV006's ascending
        # declaration above holds even if a walk ever becomes
        # two-phase), at the cost of one tiny sort per call.
        for shard_index in sorted(groups):
            positions, keys = groups[shard_index]
            values = self._shards[shard_index].peek_many(keys)
            for i, value in zip(positions, values):
                out[i] = value
        return out

    def _chain_groups(
        self, request_keys: Sequence[int]
    ) -> Dict[int, Tuple[List[int], List[int]]]:
        """shard index -> (positions, keys) for one key sequence; the
        grouping is memoized for tuples (see ``_group_cache``)."""
        is_tuple = type(request_keys) is tuple
        if is_tuple:
            cached = self._group_cache.get(id(request_keys))
            if cached is not None and cached[0] is request_keys:
                return cached[1]
        groups: Dict[int, Tuple[List[int], List[int]]] = {}
        mask = self._mask
        for i, key in enumerate(request_keys):
            group = groups.get(key & mask)
            if group is None:
                group = groups[key & mask] = ([], [])
            group[0].append(i)
            group[1].append(key)
        if is_tuple:
            cache = self._group_cache
            if len(cache) >= self._GROUP_CACHE_MAX:
                cache.clear()
            # gil-atomic: single-key dict put; value is pure in the key
            cache[id(request_keys)] = (request_keys, groups)
        return groups

    def _bump_shards(self, shard_indices) -> None:
        """Advance the mutation version of each shard in
        ``shard_indices`` (duplicates allowed; called after the
        mutation is visible)."""
        versions = self._versions
        for shard_index in shard_indices:
            # gil-atomic: lone-advance counter; a lost ++ still differs
            # from every vector captured before this bump
            versions[shard_index] += 1

    def version_vector(self) -> Tuple[int, ...]:
        """Point-in-time per-shard mutation versions.  Equal vectors
        before and after an optimistic read prove no score-relevant
        mutation landed in between (the indexer's score-memo
        validation; see docs/performance.md).  The fixed-length list
        snapshots atomically under the GIL; see ``_versions`` for why
        the counters need no lock."""
        return tuple(self._versions)

    def touch_chain(self, request_keys: Sequence[int]) -> None:
        """Refresh recency for a previously-consumed chain (the score
        memo's hit path): keeps LRU eviction order identical to the
        walk the memo elides; missing keys are ignored."""
        self._touch_keys(request_keys)

    def _touch_keys(self, request_keys: Sequence[int]) -> None:
        """Batched recency refresh, grouped per shard."""
        if not self._mask:
            self._shards[0].touch_many(request_keys)
            return
        groups: Dict[int, List[int]] = {}
        mask = self._mask
        for key in request_keys:
            groups.setdefault(key & mask, []).append(key)
        for shard_index in sorted(groups):  # ascending shard order
            self._shards[shard_index].touch_many(groups[shard_index])

    # -- read path ------------------------------------------------------

    def lookup(
        self,
        request_keys: Sequence[int],
        pod_identifier_set: Optional[Set[str]] = None,
    ) -> Dict[int, List[PodEntry]]:
        if not request_keys:
            raise ValueError("no request keys provided for lookup")

        pods_per_key: Dict[int, List[PodEntry]] = {}
        # Batched lock round-trips for the whole chain instead of one
        # per key (a long-prompt lookup walks hundreds): peek first,
        # then refresh recency ONLY for keys that yielded pods — never
        # the dead break key or the unreachable suffix, which would
        # push live entries out under LRU pressure.  Deferring the
        # touch does widen the window in which a concurrent add can
        # evict a key this lookup already read (the old per-key get
        # made each key MRU before examining the next); that race
        # existed between get and snapshot anyway, and the index is
        # advisory — continuously rebuilt from engine events — so a
        # transiently stale read is the accepted cost of the batching.
        caches = self._peek_ordered(request_keys)
        touched: List[int] = []
        for key, pod_cache in zip(request_keys, caches):
            if pod_cache is None:
                continue
            pods = pod_cache.snapshot()
            if not pods:
                # The prefix chain is broken here for every pod: stop.
                break
            touched.append(key)
            selected: List[PodEntry]
            if pod_identifier_set:
                # Filter only when something is actually filtered out
                # (the common case passes every pod the index knows
                # about — the old code built a filtered copy per key
                # regardless).
                covered = True
                for entry in pods:
                    if entry.pod_identifier not in pod_identifier_set:
                        covered = False
                        break
                if covered:
                    selected = list(pods)
                else:
                    selected = [
                        p
                        for p in pods
                        if p.pod_identifier in pod_identifier_set
                    ]
            else:
                selected = list(pods)
            if selected:
                pods_per_key[key] = selected
        if touched:
            self._touch_keys(touched)
        return pods_per_key

    def lookup_chain(
        self, request_keys: Sequence[int]
    ) -> List[Sequence[PodEntry]]:
        """Aligned, unfiltered per-key pod snapshots for the fast-lane
        scoring walk (see ``Index.lookup_chain``): stops at the first
        key with no resident pods, allocates no per-key dicts or
        filtered copies (the scorer filters inline), and refreshes
        recency only for the keys consumed.  The shard grouping built
        for the peek pass is reused for the recency pass when the whole
        chain was consumed (the steady-state warm case), so a request
        pays one grouping walk, not two."""
        out: List[Sequence[PodEntry]] = []
        if not self._mask:
            shard = self._shards[0]
            caches = shard.peek_many(request_keys)
            for pod_cache in caches:
                if pod_cache is None:
                    break
                pods = pod_cache.snapshot()
                if not pods:
                    break
                out.append(pods)
            if out:
                shard.touch_many(request_keys[: len(out)])
            return out

        n_keys = len(request_keys)
        groups = self._chain_groups(request_keys)
        flat = self._peek_ordered(request_keys, groups)
        for pod_cache in flat:
            if pod_cache is None:
                break
            pods = pod_cache.snapshot()
            if not pods:
                break
            out.append(pods)
        consumed = len(out)
        if consumed == n_keys:
            for shard_index in sorted(groups):  # ascending shard order
                self._shards[shard_index].touch_many(groups[shard_index][1])
        elif consumed:
            self._touch_keys(request_keys[:consumed])
        return out

    # -- write path -----------------------------------------------------

    def add(
        self,
        engine_keys: Sequence[int],
        request_keys: Sequence[int],
        entries: Sequence[PodEntry],
    ) -> None:
        if not engine_keys or not request_keys or not entries:
            raise ValueError("no keys or entries provided for add")
        if len(engine_keys) != len(request_keys):
            raise ValueError(
                "engine keys and request keys length mismatch: "
                f"{len(engine_keys)} != {len(request_keys)}"
            )
        self.add_mappings(engine_keys, request_keys)
        self.add_entries_batch([(request_keys, entries)])

    def add_mappings(
        self, engine_keys: Sequence[int], request_keys: Sequence[int]
    ) -> None:
        """Publish engine->request key mappings (one lock round-trip).

        Split out of :meth:`add` so the batched kvevents apply path can
        publish mappings eagerly — later events in the same batch
        resolve their parents through ``get_request_key`` — while pod
        entries are still being grouped per shard.
        """
        self._engine_to_request.put_many(
            list(zip(engine_keys, request_keys))
        )

    def add_entries_batch(
        self,
        items: Sequence[Tuple[Sequence[int], Sequence[PodEntry]]],
    ) -> None:
        """Admit ``(request_keys, entries)`` groups, per-shard batched.

        All request keys across ``items`` are grouped by shard first, so
        each shard's lock is taken once per call instead of once per
        key (the kvevents batched apply path drains tens of messages
        per wake-up; see docs/performance.md).
        """
        mask = self._mask
        pod_cache_size = self.config.pod_cache_size
        # shard index -> ([request_key, ...], [entries_per_key, ...])
        groups: Dict[int, Tuple[List[int], List[Sequence[PodEntry]]]] = {}
        for request_keys, entries in items:
            for request_key in request_keys:
                group = groups.get(request_key & mask)
                if group is None:
                    group = groups[request_key & mask] = ([], [])
                group[0].append(request_key)
                group[1].append(entries)
        for shard_index in sorted(groups):  # ascending shard order
            keys, entry_lists = groups[shard_index]
            caches = self._shards[shard_index].get_or_create_many(
                keys, lambda: _PodCache(pod_cache_size)
            )
            for pod_cache, entries in zip(caches, entry_lists):
                pod_cache.add_all(entries)
        if groups:
            self._bump_shards(groups.keys())

    def evict(self, engine_key: int, entries: Sequence[PodEntry]) -> None:
        if not entries:
            raise ValueError("no entries provided for eviction")

        request_key = self._engine_to_request.get(engine_key)
        if request_key is None:
            return
        shard = self._shard(request_key)
        pod_cache = shard.get(request_key)
        if pod_cache is None:
            self._engine_to_request.remove(engine_key)
            return

        if pod_cache.remove_all(entries):
            # Re-check under the current resident cache to narrow the race
            # with a concurrent add; worst case an empty cache lingers until
            # LRU pressure clears it.
            current = shard.get(request_key)
            if current is not None and len(current) == 0:
                shard.remove(request_key)
                self._engine_to_request.remove(engine_key)
        self._bump_shards((request_key & self._mask,))

    def get_request_key(self, engine_key: int) -> int:
        request_key = self._engine_to_request.get(engine_key)
        if request_key is None:
            raise KeyError(f"engine key not found: {engine_key:#x}")
        return request_key

    # -- persistence / admin --------------------------------------------

    def dump_entries(
        self,
    ) -> Tuple[List[Tuple[int, List[PodEntry]]], List[Tuple[int, int]]]:
        # keys() snapshots LRU-first per shard; the dump concatenates
        # shard segments, so the global order is least-recently-used
        # within each shard (exact only for shards=1) — a
        # capacity-bounded restore into the same shard layout re-evicts
        # the same per-shard victims.  A concurrent eviction between
        # the key snapshot and the per-key peek just drops that key
        # from the dump — the journal replays whatever raced past it.
        block_entries: List[Tuple[int, List[PodEntry]]] = []
        for shard in self._shards:
            for request_key in shard.keys():
                pod_cache = shard.peek(request_key)
                if pod_cache is None:
                    continue
                pods = list(pod_cache.snapshot())
                if pods:
                    block_entries.append((request_key, pods))
        engine_map = [
            (engine_key, request_key)
            for engine_key, request_key in self._engine_to_request.items()
        ]
        return block_entries, engine_map

    def restore_entries(
        self,
        block_entries: Sequence[Tuple[int, Sequence[PodEntry]]],
        engine_map: Sequence[Tuple[int, int]],
    ) -> int:
        restored = 0
        touched_shards: Set[int] = set()
        for request_key, pods in block_entries:
            if not pods:
                continue
            shard = self._shard(request_key)
            pod_cache = shard.get(request_key)
            if pod_cache is None:
                pod_cache = shard.put_if_absent(
                    request_key, _PodCache(self.config.pod_cache_size)
                )
            pod_cache.add_all(list(pods))
            touched_shards.add(request_key & self._mask)
            restored += 1
        for engine_key, request_key in engine_map:
            self._engine_to_request.put(engine_key, request_key)
        if touched_shards:
            self._bump_shards(touched_shards)
        return restored

    def request_keys(self) -> List[int]:
        """Resident request keys, concatenated per shard — the
        keys-only walk (no pod-cache snapshots, no entry lists) backing
        slice-scoped scans like the replication follower's purge
        replay.  Point-in-time per shard, like :meth:`dump_entries`."""
        out: List[int] = []
        for shard in self._shards:
            out.extend(shard.keys())
        return out

    def purge_pod_keys(
        self, pod_identifier: str, request_keys: Sequence[int]
    ) -> int:
        """Purge one pod's entries restricted to ``request_keys``.

        The replication follower's slice-scoped purge
        (docs/replication.md): replaying a PEER's pod-wide purge record
        against the whole local index would wipe admissions this
        replica applied to its OWN slice after the purge — so the
        follower purges only the keys of the peer's slice.  Keys whose
        pod set empties are removed exactly like :meth:`purge_pod`'s.
        """
        removed = 0
        touched: Set[int] = set()
        for request_key in request_keys:
            shard = self._shard(request_key)
            pod_cache = shard.get(request_key)
            if pod_cache is None:
                continue
            victims, now_empty = pod_cache.purge(pod_identifier)
            removed += victims
            if victims:
                touched.add(request_key & self._mask)
            if now_empty:
                current = shard.get(request_key)
                if current is not None and len(current) == 0:
                    shard.remove(request_key)
        if touched:
            self._bump_shards(touched)
        return removed

    def purge_pod(self, pod_identifier: str) -> int:
        removed = 0
        for shard in self._shards:
            for request_key in shard.keys():
                pod_cache = shard.get(request_key)
                if pod_cache is None:  # raced with LRU eviction
                    continue
                victims, now_empty = pod_cache.purge(pod_identifier)
                removed += victims
                if now_empty:
                    # An empty pod set would read as a broken prefix
                    # chain for EVERY pod (lookup early-stop); drop the
                    # key.  Re-check under the resident cache first
                    # (same race narrowing as evict()): a concurrent
                    # add may have published a fresh claim since the
                    # purge released the pod-cache lock.
                    current = shard.get(request_key)
                    if current is not None and len(current) == 0:
                        shard.remove(request_key)
        # Bump every shard AFTER the sweep (administrative op; shards
        # untouched by the purge over-invalidate the score memo, which
        # only costs a re-walk) — bumping first would let a concurrent
        # walk memoize partially-purged state under the new vector.
        self._bump_shards(range(len(self._shards)))
        return removed
