"""Alternative prefix store: byte trie with per-node token bookkeeping.

Capability parity with the reference's non-default trie store
(pkg/tokenization/prefixstore/trie_store.go): exact-prefix matching at byte
granularity in exchange for more memory and slower walks.  Each node
remembers how many tokens are fully contained in the prompt prefix ending
at that node, plus a reference to a token sequence passing through it.

Copied from the JAX reference's ``tokenization/prefixstore/trie_store.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from llm_d_kv_cache_manager_tpu_torch.tokenization.prefixstore.lru_store import (
    ProbeResult,
)


class _Node:
    __slots__ = ("children", "token_count", "tokens_ref")

    def __init__(self) -> None:
        self.children: Dict[int, "_Node"] = {}
        # Tokens fully contained in the prefix ending here (None = unset).
        self.token_count: int = 0
        # A token sequence whose encoding path passes through this node;
        # its first `token_count` entries are valid at this node.
        self.tokens_ref: Sequence[int] = ()


class TrieTokenStore:
    def __init__(self, max_depth_bytes: int = 4096) -> None:
        # One trie root per model: vocabularies must never alias.
        self._roots: Dict[str, _Node] = {}
        self._max_depth = max_depth_bytes

    def _root_for(self, model_name: str) -> _Node:
        root = self._roots.get(model_name)
        if root is None:
            root = self._roots[model_name] = _Node()
        return root

    def add_tokenization(
        self,
        prompt: str,
        tokens: Sequence[int],
        offsets: Sequence[Tuple[int, int]],
        model_name: str = "",
    ) -> None:
        if not prompt or not tokens:
            return
        if len(tokens) != len(offsets):
            raise ValueError("tokens and offsets length mismatch")
        data = prompt.encode("utf-8")[: self._max_depth]
        ends = [offset[1] for offset in offsets]
        tokens = tuple(tokens)

        node = self._root_for(model_name)
        token_idx = 0
        for depth, byte in enumerate(data, start=1):
            node = node.children.setdefault(byte, _Node())
            while token_idx < len(ends) and ends[token_idx] <= depth:
                token_idx += 1
            if token_idx >= node.token_count:
                node.token_count = token_idx
                node.tokens_ref = tokens

    def find_longest_contained_tokens(
        self, prompt: str, model_name: str = ""
    ) -> Tuple[List[int], float]:
        data = prompt.encode("utf-8")
        node = self._root_for(model_name)
        best: Tuple[Sequence[int], int] = ((), 0)
        depth = 0
        for byte in data:
            child = node.children.get(byte)
            if child is None:
                break
            node = child
            depth += 1
            if node.token_count > best[1]:
                best = (node.tokens_ref, node.token_count)
        coverage = depth / len(data) if data else 0.0
        tokens_ref, count = best
        return list(tokens_ref[:count]), coverage

    def probe(
        self,
        prompt: str,
        model_name: str = "",
        key_space: Optional[tuple] = None,
    ) -> ProbeResult:
        """Interface parity with ``LRUTokenStore.probe``; the trie does
        not memoize block keys, so the record is always empty."""
        tokens, coverage = self.find_longest_contained_tokens(
            prompt, model_name
        )
        return ProbeResult(tokens, coverage, (), 0)

    def attach_block_keys(
        self,
        prompt: str,
        model_name: str,
        key_space: tuple,
        block_keys: Sequence[int],
        tokens: Sequence[int],
        min_blocks: int = 0,
    ) -> int:
        """No-op (no block-key memoization in the trie store)."""
        return 0
