"""The port's KVCachePool against the JAX reference's: the same writes
give byte-identical gathers in both layouts."""

import numpy as np
import pytest

from llm_d_kv_cache_manager_tpu.models.kv_cache_pool import (
    KVCachePool as JaxPool,
    KVCachePoolConfig as JaxConfig,
)
from llm_d_kv_cache_manager_tpu.offload.worker import host_dtype
from tests.helpers.torch_port import port

pool_mod = port("models.kv_cache_pool")

SHAPE = dict(num_layers=3, num_blocks=12, block_size=4, num_kv_heads=2, head_dim=8)


def _pools(dtype):
    jax_pool = JaxPool(JaxConfig(dtype=dtype, **SHAPE))
    torch_pool = pool_mod.KVCachePool(
        pool_mod.KVCachePoolConfig(dtype=dtype, **SHAPE), device="cpu"
    )
    return jax_pool, torch_pool


def _blocks(rng, n, dtype, *, block_major=False):
    c = SHAPE
    lead = (n, c["num_layers"]) if block_major else (c["num_layers"], n)
    data = rng.standard_normal(
        lead + (2, c["block_size"], c["num_kv_heads"], c["head_dim"])
    )
    return data.astype(host_dtype(dtype))


def _same_bytes(a, b):
    assert a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["write_block", "scatter_from_host", "scatter_block_major"])
def test_same_writes_give_identical_gathers(dtype, writer):
    rng = np.random.default_rng(0)
    jax_pool, torch_pool = _pools(dtype)
    if writer == "write_block":
        for block_id in (0, 5, 11):
            block = _blocks(rng, 1, dtype)[:, 0]
            jax_pool.write_block(block_id, block)
            torch_pool.write_block(block_id, block)
    elif writer == "scatter_from_host":
        ids = [7, 2, 9]
        blocks = _blocks(rng, 3, dtype)
        jax_pool.scatter_from_host(ids, blocks)
        torch_pool.scatter_from_host(ids, blocks)
    else:
        ids = [3, 10]
        group = _blocks(rng, 2, dtype, block_major=True)
        jax_pool.scatter_block_major(ids, group)
        torch_pool.scatter_block_major(ids, group)
    ids = [11, 0, 2, 3, 5, 7, 9, 10, 1]
    _same_bytes(jax_pool.gather_to_host(ids), torch_pool.gather_to_host(ids))
    _same_bytes(jax_pool.gather_block_major(ids), torch_pool.gather_block_major(ids))
    assert jax_pool.block_nbytes == torch_pool.block_nbytes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float64_host_blocks_round_like_the_reference(dtype):
    """Host arrays in another float type are converted by value (round
    to nearest even), as ``jnp.asarray(x, dtype)`` does."""
    rng = np.random.default_rng(1)
    jax_pool, torch_pool = _pools(dtype)
    blocks = rng.standard_normal(
        (SHAPE["num_layers"], 2, 2, SHAPE["block_size"], SHAPE["num_kv_heads"],
         SHAPE["head_dim"])
    )
    jax_pool.scatter_from_host([4, 6], blocks)
    torch_pool.scatter_from_host([4, 6], blocks)
    _same_bytes(jax_pool.gather_to_host([4, 6]), torch_pool.gather_to_host([4, 6]))


def test_block_major_round_trip_through_the_port():
    """Gathered file bytes scatter back bit for bit (the offload round
    trip), bf16 carried as its uint16 bit patterns."""
    rng = np.random.default_rng(2)
    _, torch_pool = _pools("bfloat16")
    torch_pool.scatter_from_host([1, 2, 3], _blocks(rng, 3, "bfloat16"))
    group = torch_pool.gather_block_major([1, 2, 3])
    assert group.dtype == np.uint16
    _, other = _pools("bfloat16")
    other.scatter_block_major([4, 5, 6], group)
    _same_bytes(other.gather_block_major([4, 5, 6]), group)
