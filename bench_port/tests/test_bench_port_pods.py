"""The pods' prefix cache: refcounts, LRU eviction, and never evicting a
block that a running sequence holds."""

import numpy as np
import pytest

from bench_port.pods import Pod, chain_hashes


def test_chain_hashes_name_the_whole_prefix():
    a = chain_hashes(list(range(48)), 16)
    b = chain_hashes(list(range(32)) + [99] * 16, 16)
    assert len(a) == 3 and a[:2] == b[:2] and a[2] != b[2]
    # A block of the same tokens after another prefix is another block.
    c = chain_hashes([7] * 16 + list(range(16, 32)), 16)
    assert c[1] != a[1]
    assert chain_hashes(list(range(20)), 16) == a[:1]


def test_take_reuses_free_blocks_then_the_least_recently_released():
    pod = Pod("p", range(1, 5))
    ids, evicted = pod.take(4)
    assert evicted == [] and pod.take(1) is None
    for bid, h in zip(ids, [b"a", b"b", b"c", b"d"]):
        assert pod.commit(bid, h)
    for bid in ids[::-1]:  # released last block first, as a sequence lets go
        pod.release(bid)
    got, evicted = pod.take(2)
    assert evicted == [b"d", b"c"]
    assert pod.cached_prefix([b"a", b"b", b"c"]) == ids[:2]
    pod.check()


def test_a_held_block_is_never_evicted():
    pod = Pod("p", range(1, 4))
    ids, _ = pod.take(3)
    for bid, h in zip(ids, [b"x", b"y", b"z"]):
        pod.commit(bid, h)
    pod.release(ids[1])
    pod.release(ids[2])
    pod.acquire(ids[1])  # a new request reuses the cached block
    assert pod.take(2) is None
    got, evicted = pod.take(1)
    assert evicted == [b"z"] and got == [ids[2]]
    assert pod.cached_prefix([b"x", b"y"]) == ids[:2]
    pod.check()


def test_commit_of_a_cached_hash_keeps_the_block_private():
    pod = Pod("p", range(1, 3))
    (a, b), _ = pod.take(2)
    assert pod.commit(a, b"h") and not pod.commit(b, b"h")
    pod.release(b)
    assert list(pod.free) == [b]
    pod.check()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_traffic_keeps_the_invariants(seed):
    rng = np.random.default_rng(seed)
    pod = Pod("p", range(1, 65))
    running = []
    chains = [chain_hashes(rng.integers(1, 50, 16 * 12), 16) for _ in range(6)]
    for _ in range(400):
        if running and rng.random() < 0.4:
            blocks = running.pop(int(rng.integers(len(running))))
            for bid in reversed(blocks):
                pod.release(bid)
        else:
            chain = chains[int(rng.integers(len(chains)))][: int(rng.integers(1, 13))]
            cached = pod.cached_prefix(chain)
            for bid in cached:
                pod.acquire(bid)
            got = pod.take(len(chain) - len(cached) + int(rng.integers(0, 3)))
            if got is None:
                for bid in reversed(cached):
                    pod.release(bid)
                continue
            fresh, evicted = got
            held = {b for blocks in running for b in blocks} | set(cached)
            assert not held & set(fresh), "a held block was handed out again"
            for j, bid in enumerate(fresh[: len(chain) - len(cached)]):
                pod.commit(bid, chain[len(cached) + j])
            running.append(cached + fresh)
        pod.check()
