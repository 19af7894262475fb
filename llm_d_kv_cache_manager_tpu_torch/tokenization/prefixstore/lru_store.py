"""Prefix store: amortizes tokenization on the scoring hot path.

Prompts in a KV-aware fleet share long prefixes (system prompts, few-shot
preambles).  The store caches *text-chunk -> tokens* so a new prompt's
shared prefix resolves to tokens without running the tokenizer; only when
coverage falls below the pool's overlap threshold does a full tokenization
run.

Design (capability parity: pkg/tokenization/prefixstore/lru_store.go):
fixed-size text chunks, chained xxhash64 keyed on
``little_endian(prev_hash) || chunk_bytes`` so a chunk's identity encodes
its whole prefix; each block stores the tokens whose end offset falls
inside the chunk; lookups walk the chain until the first miss and report
the covered fraction of the prompt.

This store is purely indexer-internal (no cross-system hash contract), so
it chunks the UTF-8 *bytes* of the prompt and expects tokenizer offsets in
byte units (see ``tokenization.tokenizers.Encoding``).

Read-path fast lane (docs/performance.md): alongside tokens, chunks can
carry *block-key memoization records* — the already-chained KV block keys
for the token prefix ending in that chunk, attached by the indexer after
it hashes a chain (:meth:`LRUTokenStore.attach_block_keys`) and returned
by :meth:`LRUTokenStore.probe` so a multi-turn conversation only hashes
its new suffix.  Records are keyed by ``(chunk hash, key space)`` where
the key space is the token processor's ``(seed hash, block size)``
identity.  The chunk hash pins the exact text prefix but NOT the token
split — a later tokenization of an overlapping prompt may re-split
tokens across a shared chunk boundary (straddling tokens belong to the
later chunk) — so each record also anchors the exact chunk token-tuple
OBJECTS its keys were derived from: every overwrite installs fresh
tuples, so an ``is``-walk at probe time (microseconds) proves the
tokens being returned are bit-identical to the ones the keys were
hashed from (attach validates content against its caller's token list,
so anchor identity implies token equality).  A failed check, like an
evicted or missing record, only costs a re-hash; records never need
explicit invalidation.

Copied from the JAX reference's ``tokenization/prefixstore/lru_store.py``;
its chunk keys come from the port's native XXH64 (``kvtpu_xxh64``) instead
of the ``xxhash`` package, bit-equal to it, so the two stores hold the
same chain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.native import get_library
from llm_d_kv_cache_manager_tpu_torch.utils.lru import LRUCache

DEFAULT_CHUNK_BYTES = 256
DEFAULT_MAX_BLOCKS = 500_000


@dataclass
class LRUStoreConfig:
    cache_size: int = DEFAULT_MAX_BLOCKS
    # Chunk size in bytes of UTF-8 prompt text.
    block_size: int = DEFAULT_CHUNK_BYTES


def _xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` through the native library (``kvtpu_xxh64``);
    bit-equal to ``xxhash.xxh64_intdigest(data, seed)``."""
    return get_library().kvtpu_xxh64(data, len(data), seed)


def _chain_hash(prev_hash: int, chunk: bytes) -> int:
    # One C call over the concatenated input; bit-identical to the
    # two-update form (xxh64 is stream-position independent).
    return _xxh64(prev_hash.to_bytes(8, "little") + chunk)


def _chain_seed(model_name: str) -> int:
    """Root of the chunk chain.

    Tokenizations from different models must never alias — the same text
    tokenized by two vocabularies yields different tokens — so the chain is
    rooted in the model name.
    """
    if not model_name:
        return 0
    return _xxh64(model_name.encode("utf-8"))


def _chunk_hashes(data: bytes, model_name: str, size: int) -> List[int]:
    """Chained hash of each full ``size``-byte chunk of ``data``.

    The single definition of the chunking rule (stride, seed, tail
    handling): every chain walk — indexing, probing, attaching — must
    agree on which hash pairs with which chunk, so they all call here.
    Hashes depend only on the text, never on cache contents, so callers
    compute the whole chain up front (xxh64 is C-speed) and batch
    their cache reads.
    """
    hashes: List[int] = []
    prev_hash = _chain_seed(model_name)
    for start in range(0, len(data) - size + 1, size):
        prev_hash = _chain_hash(prev_hash, data[start : start + size])
        hashes.append(prev_hash)
    return hashes


class ProbeResult(NamedTuple):
    """One prefix-store probe: cached tokens, their byte coverage, and —
    when a key space was supplied and a memo record matched — the
    already-chained block keys covering ``blocks`` full blocks of the
    returned token list (``keys[i]`` is the chain value after block
    ``i``; tokens beyond ``blocks * block_size`` still need hashing)."""

    tokens: List[int]
    coverage: float
    keys: Tuple[int, ...]
    blocks: int


class LRUTokenStore:
    def __init__(self, config: LRUStoreConfig | None = None) -> None:
        self.config = config or LRUStoreConfig()
        if self.config.block_size <= 0:
            raise ValueError("block_size must be positive")
        self._cache: LRUCache[int, Tuple[int, ...]] = LRUCache(
            self.config.cache_size
        )
        # chunk hash + key space -> (full blocks ending by that chunk,
        # shared block-key tuple).  One tuple object is shared by every
        # chunk record of an attach pass, so memory stays O(chain), not
        # O(chain^2).
        self._keys_cache: LRUCache[tuple, Tuple[int, Tuple[int, ...]]] = (
            LRUCache(self.config.cache_size)
        )

    def add_tokenization(
        self,
        prompt: str,
        tokens: Sequence[int],
        offsets: Sequence[Tuple[int, int]],
        model_name: str = "",
    ) -> None:
        """Index a full tokenization of ``prompt``.

        ``offsets[i]`` is the byte range of ``tokens[i]`` in the UTF-8
        prompt.  A token belongs to the chunk its *end* offset falls in;
        tokens straddling a boundary belong to the later chunk.
        """
        if not prompt or not tokens:
            return
        if len(tokens) != len(offsets):
            raise ValueError("tokens and offsets length mismatch")

        data = prompt.encode("utf-8")
        size = self.config.block_size
        token_idx = 0
        for i, chunk_hash in enumerate(_chunk_hashes(data, model_name, size)):
            end = (i + 1) * size
            block_tokens: List[int] = []
            while token_idx < len(tokens) and offsets[token_idx][1] <= end:
                block_tokens.append(tokens[token_idx])
                token_idx += 1
            self._cache.put(chunk_hash, tuple(block_tokens))

    def probe(
        self,
        prompt: str,
        model_name: str = "",
        key_space: Optional[tuple] = None,
    ) -> ProbeResult:
        """Walk the chunk chain until the first miss.

        Returns the concatenated tokens of the matched chunks, the
        fraction of the prompt's bytes they cover, and — when
        ``key_space`` is given — the deepest attached block-key record
        along the matched chain (empty when none is attached)."""
        tokens: List[int] = []
        data = prompt.encode("utf-8")
        size = self.config.block_size
        # Hash the whole chain first, then resolve every chunk in ONE
        # lock round-trip (peek_many) instead of a locked get per chunk.
        hashes = _chunk_hashes(data, model_name, size)
        coverage = 0.0
        keys: Tuple[int, ...] = ()
        blocks = 0
        matched = 0
        chunk_tuples: List[Tuple[int, ...]] = []
        if hashes:
            # peek (no recency) then touch ONLY the consumed prefix:
            # resident chunks beyond the first miss are unreachable
            # from this prompt, and promoting them would push other
            # prompts' live chunks out under LRU pressure (the same
            # invariant the index lookup keeps for its key chains).
            for block in self._cache.peek_many(hashes):
                if block is None:
                    break
                tokens.extend(block)
                chunk_tuples.append(block)
                matched += 1
            if matched:
                self._cache.touch_many(hashes[:matched])
            coverage = matched * size / len(data)
        if key_space is not None and matched:
            # Deepest attached record wins; records are monotone along
            # the chain, so scanning backward finds it on the first hit
            # (one memo read on the warm path, not one per chunk).
            keys_cache = self._keys_cache
            record = None
            for i in range(matched - 1, -1, -1):
                record = keys_cache.get((hashes[i], key_space))
                if record is not None:
                    break
            if record is not None:
                r_blocks, r_keys, n_chunks, anchors = record
                # Accept the record ONLY if every chunk token tuple it
                # was derived from is still the resident object (an
                # overwritten split installs fresh tuples): identity
                # implies the tokens being returned are bit-identical
                # to the ones the keys were hashed from — a stale
                # pairing would silently diverge scores.
                if n_chunks <= matched and n_chunks <= len(
                    anchors
                ) and all(
                    anchor is resident
                    for anchor, resident in zip(
                        anchors, chunk_tuples[:n_chunks]
                    )
                ):
                    blocks = r_blocks
                    keys = (
                        r_keys
                        if len(r_keys) == r_blocks
                        else r_keys[:r_blocks]
                    )
        return ProbeResult(tokens, coverage, keys, blocks)

    def attach_block_keys(
        self,
        prompt: str,
        model_name: str,
        key_space: tuple,
        block_keys: Sequence[int],
        tokens: Sequence[int],
        min_blocks: int = 0,
    ) -> int:
        """Attach a hashed block-key chain to the prompt's chunk chain.

        Called by the indexer after deriving ``block_keys`` from
        ``tokens`` — the token list this store resolved (or indexed)
        for ``prompt``.  Each matched chunk gets a record of how many
        full blocks its token prefix spans, pointing at one shared key
        tuple plus a signature of the exact token prefix the keys were
        hashed from (probe() verifies it before serving the record);
        returns the number of chunk records written.  Walking stops at
        the first chunk whose token entry is missing (evicted
        mid-flight) or whose cumulative token count diverges from
        ``tokens`` (overwritten by a different tokenization): beyond it
        the block alignment is unknown.

        ``min_blocks`` skips record writes for chunks covering no more
        than that many blocks: a multi-turn caller passes the depth its
        probe already resumed from, so only the NEW suffix's chunks pay
        a record write (records below that depth are value-identical —
        a chunk's block count and key prefix never change).
        """
        if not prompt or not block_keys:
            return 0
        shared = tuple(block_keys)
        block_size = key_space[1]
        data = prompt.encode("utf-8")
        size = self.config.block_size
        # Same hash-all-then-batch-read shape as probe(): the chunk
        # token entries resolve in ONE lock round-trip instead of a
        # locked peek per chunk.
        hashes = _chunk_hashes(data, model_name, size)
        if not hashes:
            return 0
        blocks_per_chunk = self._cache.peek_many(hashes)
        cum_tokens = 0
        anchors: List[Tuple[int, ...]] = []
        # (chunk_hash, blocks, n_chunks) records to publish once the
        # shared anchor tuple is final.
        pending: List[Tuple[int, int, int]] = []
        for chunk_hash, block in zip(hashes, blocks_per_chunk):
            if block is None:
                break
            cum_tokens += len(block)
            if cum_tokens > len(tokens) or list(block) != tokens[
                cum_tokens - len(block) : cum_tokens
            ]:
                # The resident chunk entries no longer describe the
                # tokenization our keys came from (overwritten by a
                # different split mid-flight): anchoring them would
                # pair our keys with someone else's tokens.
                break
            anchors.append(block)
            blocks = cum_tokens // block_size
            if blocks > len(shared):
                blocks = len(shared)
            if blocks > min_blocks:
                pending.append((chunk_hash, blocks, len(anchors)))
            if blocks == len(shared):
                # Every remaining chunk would claim the same (capped)
                # record; deeper chunks gain nothing.
                break
        if not pending:
            return 0
        anchors_shared = tuple(anchors)
        for chunk_hash, blocks, n_chunks in pending:
            self._keys_cache.put(
                (chunk_hash, key_space),
                (blocks, shared, n_chunks, anchors_shared),
            )
        return len(pending)

    def find_longest_contained_tokens(
        self, prompt: str, model_name: str = ""
    ) -> Tuple[List[int], float]:
        """Tokens + coverage of the longest cached chunk chain (the
        pre-fast-lane probe surface, kept for compatibility)."""
        result = self.probe(prompt, model_name)
        return result.tokens, result.coverage
