"""The plain reference of the router: what ``get_pod_scores`` should
return, worked out again from the requests' text and the pods' KV
events.

- Tokens.  The router tokenizes ``t<id>`` words, and its prefix store
  serves the tokens of a prompt's leading 256-byte chunks that an earlier
  full tokenization left there, where they cover at least 80% of the
  prompt's bytes (a token belongs to the chunk its end falls in); below
  that it tokenizes the prompt whole and stores its chunks.
- Residency.  Each pod's frames, in order, add and remove blocks; a
  block is named by the tokens from the sequence's start to its end.
- Scores.  A pod scores one (its device tier's weight) for each block of
  the router's tokens that it holds, from the first block on, up to the
  first it lacks.

The event pool applies frames on its own threads, so a score may be
taken at any state between the last frame known applied when the
router was called and the last one published.  A score is right when it
equals the score at that state or, where frames were in flight, lies
within the scores of the states they pass through.  Imports nothing of
the program.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

CHUNK_BYTES = 256
MIN_COVERAGE = 0.8
STORE_CHUNKS = 500_000


def word_tokens(text: str) -> Tuple[List[int], List[int]]:
    """Token ids and the byte offset at which each token ends."""
    tokens, ends, pos = [], [], 0
    for word in text.split(" "):
        tokens.append(int(word[1:]))
        pos += len(word)
        ends.append(pos)
        pos += 1
    return tokens, ends


class PrefixStore:
    """Text chunk chains to the tokens that end inside each chunk."""

    def __init__(self) -> None:
        self.chunks: Dict[bytes, Tuple[int, ...]] = {}

    @staticmethod
    def _keys(data: bytes) -> List[bytes]:
        keys, prev = [], b"root"
        for start in range(0, len(data) - CHUNK_BYTES + 1, CHUNK_BYTES):
            prev = hashlib.blake2b(prev + data[start:start + CHUNK_BYTES], digest_size=16).digest()
            keys.append(prev)
        return keys

    def tokens(self, text: str) -> List[int]:
        """The tokens the router sees for ``text``."""
        data = text.encode()
        keys = self._keys(data)
        served: List[int] = []
        matched = 0
        for key in keys:
            chunk = self.chunks.get(key)
            if chunk is None:
                break
            served.extend(chunk)
            matched += 1
        if keys and matched * CHUNK_BYTES / len(data) >= MIN_COVERAGE:
            return served
        tokens, ends = word_tokens(text)
        i = 0
        for n, key in enumerate(keys):
            end = (n + 1) * CHUNK_BYTES
            start = i
            while i < len(tokens) and ends[i] <= end:
                i += 1
            self.chunks[key] = tuple(tokens[start:i])
        if len(self.chunks) > STORE_CHUNKS:
            raise RuntimeError("the run outgrew the prefix store; its evictions are not modelled")
        return tokens


def block_keys(tokens: Sequence[int], block_size: int, parent: bytes = b"") -> List[bytes]:
    """A name for each full block: a digest of every token up to its end."""
    data = np.asarray(tokens, dtype="<i8")
    keys = []
    for start in range(0, len(data) - block_size + 1, block_size):
        parent = hashlib.blake2b(parent + data[start:start + block_size].tobytes(),
                                 digest_size=16).digest()
        keys.append(parent)
    return keys


class Residency:
    """The blocks each pod holds, frame by frame."""

    def __init__(self, block_size: int) -> None:
        self.block_size = block_size
        self.names: Dict[bytes, bytes] = {}  # engine hash -> block name

    def apply(self, held: Set[bytes], frame) -> None:
        for h in frame.removed:
            held.discard(self.names[h])
        for run in frame.stored:
            parent = self.names[run.parent] if run.parent is not None else b""
            for h, key in zip(run.hashes, block_keys(run.tokens, self.block_size, parent)):
                self.names[h] = key
                held.add(key)


def score(held: Set[bytes], keys: Sequence[bytes], weight: float = 1.0) -> float:
    total = 0.0
    for key in keys:
        if key not in held:
            break
        total += weight
    return total


def expected_scores(calls: Iterable, frames: Dict[str, List], block_size: int):
    """For each router call (``text``, ``bracket`` {pod: (applied,
    published)}), in call order: {pod: (low, high)} of the scores it may
    return.  ``frames``: each pod's frames in publish order."""
    store = PrefixStore()
    res = Residency(block_size)
    held = {pod: set() for pod in frames}
    at = {pod: 0 for pod in frames}
    out = []
    for text, bracket in calls:
        keys = block_keys(store.tokens(text), block_size)
        want: Dict[str, Tuple[float, float]] = {}
        for pod, (lo, hi) in bracket.items():
            while at[pod] < lo:
                res.apply(held[pod], frames[pod][at[pod]])
                at[pod] += 1
            seen = [score(held[pod], keys)]
            if hi > lo:
                ahead = set(held[pod])
                for k in range(lo, hi):
                    res.apply(ahead, frames[pod][k])
                    seen.append(score(ahead, keys))
            want[pod] = (min(seen), max(seen))
        out.append(want)
    return out


def mismatches(got: Sequence[Dict[str, float]], want: Sequence[Dict[str, Tuple[float, float]]],
               ) -> Tuple[int, Optional[str]]:
    """Calls whose scores fall outside what the reference allows, and the
    first of them, described."""
    bad, first = 0, None
    for i, (g, w) in enumerate(zip(got, want)):
        wrong = {pod: (g.get(pod, 0.0), lo_hi) for pod, lo_hi in w.items()
                 if not lo_hi[0] <= g.get(pod, 0.0) <= lo_hi[1]}
        if wrong:
            bad += 1
            if first is None:
                first = f"call {i}: got vs allowed {wrong}"
    return bad, first
