"""Token-sequence -> chained KV-block-hash pipeline.

This is the cross-system contract at the heart of KV-aware routing: the
indexer must reproduce, bit for bit, the block hashes that engine pods
compute for their paged KV cache, so that a prompt tokenized centrally maps
onto the same chain of block keys the fleet advertises in KVEvents.

Semantics match the reference indexer (pkg/kvcache/kvblock/
token_processor.go:75-159) and, transitively, vLLM's chunked token database:

* ``init_hash   = FNV-64a(hash_seed_bytes)`` — the seed must equal the
  fleet's ``PYTHONHASHSEED`` (docs/configuration.md:481).
* ``model_init  = FNV-64a(CBOR([init_hash, null, model_name]))``.
* per chunk of ``block_size`` tokens (**no partial blocks**):
  ``h_i = FNV-64a(CBOR([h_{i-1}, chunk_tokens, null]))``.
* an explicit ``parent_key`` continues an existing chain (used by the event
  write path to chain off a stored parent block).

The hot loop runs in the native C++ library (``native_hash_chain``, see
``llm_d_kv_cache_manager_tpu_torch.native``); the pure-Python chain is the
parity oracle for tests and takes ids outside uint32.  Copied from the JAX
reference's ``kvcache/kvblock/token_processor.py``, with one difference: a
native library that fails to build raises here instead of leaving the
processor on the Python chain; ``use_native=False`` asks for that chain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.cbor_canonical import (
    encode_chunk_payload,
    encode_hash_payload,
)

# Sentinel for "no parent": hash chains start from the per-model init hash.
EMPTY_BLOCK_HASH = 0

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF

# Default number of tokens per KV block; matches vLLM's default block size
# (reference: token_processor.go:29-31).
DEFAULT_BLOCK_SIZE = 16


def fnv1a_64(data) -> int:
    """64-bit FNV-1a over ``data`` (bytes-like).

    ``bytes`` and ``bytearray`` iterate as ints natively, so the hash
    hot loop's working ``bytearray`` passes straight through; anything
    else (e.g. ``memoryview``) is copied to ``bytes`` first — iterating
    a view costs more than the copy it avoids.
    """
    if type(data) not in (bytes, bytearray):
        data = bytes(data)
    h = _FNV64_OFFSET
    prime = _FNV64_PRIME
    mask = _MASK64
    for byte in data:
        h = ((h ^ byte) * prime) & mask
    return h


@dataclass
class TokenProcessorConfig:
    """Block-hash chain parameters.

    ``hash_seed`` must be aligned with the serving fleet's
    ``PYTHONHASHSEED`` — a mismatch silently zeroes the cache-hit rate.
    """

    block_size: int = DEFAULT_BLOCK_SIZE
    hash_seed: str = ""


class TokenProcessor(Protocol):
    """Converts token sequences into chained KV-block keys."""

    def tokens_to_kv_block_keys(
        self, parent_key: int, tokens: Sequence[int], model_name: str
    ) -> List[int]:
        ...


class ChunkedTokenDatabase:
    """Chunked, chained block hashing compatible with the fleet's engines."""

    def __init__(
        self,
        config: Optional[TokenProcessorConfig] = None,
        use_native: bool = True,
    ) -> None:
        self.config = config or TokenProcessorConfig()
        if self.config.block_size <= 0:
            raise ValueError(
                f"block_size must be positive, got {self.config.block_size}"
            )
        self._init_hash = fnv1a_64(self.config.hash_seed.encode("utf-8"))
        # Per-model chain roots are deterministic; memoize them.
        self._model_init_cache: dict = {}
        self._native_chain = None
        if use_native:
            from llm_d_kv_cache_manager_tpu_torch.native import get_library
            from llm_d_kv_cache_manager_tpu_torch.native.engine import (
                native_hash_chain,
            )

            # Trigger the (possibly slow) first build here at
            # construction, not inside the first scoring request; a
            # failed build raises.
            get_library()
            self._native_chain = native_hash_chain

    @property
    def block_size(self) -> int:
        return self.config.block_size

    @property
    def key_space(self) -> Tuple[int, int]:
        """Identity of this processor's hash space: two chains agree on
        every block key iff their ``(seed hash, block size)`` pairs (and
        the model name, carried separately) agree.  Memoization caches
        (the prefix store's block-key records) key on this so a config
        change can never replay keys from a different space."""
        return (self._init_hash, self.config.block_size)

    def chunk_hash(
        self, parent: int, tokens: Sequence[int] | None, extra=None
    ) -> int:
        """One link of the chain: FNV-64a over the canonical CBOR payload."""
        if extra is None and tokens is not None:
            # The per-chunk shape [parent, tokens, null]: precomputed
            # framing, no bytes() copy (parity pinned against the
            # generic encoder by the golden-chain tests).
            return fnv1a_64(encode_chunk_payload(parent, tokens))
        return fnv1a_64(encode_hash_payload(parent, tokens, extra))

    def model_init_hash(self, model_name: str) -> int:
        cached = self._model_init_cache.get(model_name)
        if cached is None:
            cached = self.chunk_hash(self._init_hash, None, model_name)
            self._model_init_cache[model_name] = cached
        return cached

    def tokens_to_kv_block_keys(
        self, parent_key: int, tokens: Sequence[int], model_name: str
    ) -> List[int]:
        """Hash ``tokens`` into a chain of block keys.

        Only full ``block_size`` chunks are hashed; a trailing partial block
        produces no key.  ``parent_key == EMPTY_BLOCK_HASH`` starts a fresh
        chain rooted at the per-model init hash.
        """
        if parent_key != EMPTY_BLOCK_HASH:
            prefix = parent_key & _MASK64
        else:
            prefix = self.model_init_hash(model_name)

        size = self.config.block_size
        if self._native_chain is not None:
            keys = self._native_chain(prefix, tokens, size)
            if keys is not None:
                return keys

        n_chunks = len(tokens) // size
        keys = []
        for i in range(n_chunks):
            chunk = tokens[i * size : (i + 1) * size]
            prefix = self.chunk_hash(prefix, chunk, None)
            keys.append(prefix)
        return keys

    def extend_block_keys(
        self, parent_key: int, tokens: Sequence[int], model_name: str
    ) -> List[int]:
        """Resume a block-key chain off ``parent_key``.

        The memoization fast lane's suffix path: block keys are pure
        functions of ``(seed, model, block size, token chain)``, so a
        multi-turn conversation whose prefix keys are already known
        only hashes its new suffix — ``tokens`` must start at the first
        token NOT covered by a full block of the parent chain (i.e. at
        offset ``len(prefix_keys) * block_size`` of the full token
        list).  ``parent_key == EMPTY_BLOCK_HASH`` starts a fresh chain
        (identical to :meth:`tokens_to_kv_block_keys`); resumed chains
        are bit-identical to fresh full-chain hashing (pinned by the
        property tests in tests/test_read_path_fastlane.py).
        """
        return self.tokens_to_kv_block_keys(parent_key, tokens, model_name)


def engine_hash_to_uint64(raw) -> int:
    """Normalize an engine-reported block hash to uint64.

    Engines may report block hashes as integers (legacy) or as byte strings
    (e.g. vLLM's ``sha256_cbor`` digests).  Byte strings use the last 8
    bytes big-endian; shorter strings are zero-padded on the left
    (reference: pkg/kvevents/pool.go:336-363).
    """
    if isinstance(raw, bool):
        raise TypeError("boolean is not a valid block hash")
    if isinstance(raw, int):
        return raw & _MASK64
    if isinstance(raw, (bytes, bytearray)):
        if len(raw) == 0:
            raise ValueError("empty block-hash byte string")
        tail = bytes(raw[-8:])
        return int.from_bytes(tail, "big")
    raise TypeError(f"unsupported block-hash type: {type(raw)!r}")
