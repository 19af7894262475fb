"""Paged KV-cache pool: the device-resident block store the serving
path writes and the offload connector pages.

Same layout as the JAX reference (``models/kv_cache_pool.py``): one
stacked tensor ``[num_layers, num_blocks, 2(K/V), block_size,
num_kv_heads, head_dim]``, so one gather or scatter moves a block batch
across every layer.  Unlike the reference, whose arrays are immutable,
``KVCachePool.kv`` is updated in place: scatters and the serving path's
prefill/decode writes land in the same tensor, and ``kv`` is never
rebound.

Host arrays: gathers return numpy arrays with the pool's bytes (bf16 as
``uint16`` bit patterns, see ``utils/device.py``); scatters take either
those bit patterns or any float array, converted by value.

Sharded pools, as the reference's ``sharding=``: with a
``parallel.sharding.NamedSharding`` (the reference's tp serving spec is
``P(None, None, None, None, "tp", None)``), ``kv`` is a
``parallel.sharding.Sharded`` whose every tp rank holds
``[num_layers, num_blocks, 2, block_size, num_kv_heads / tp,
head_dim]``; the sharded serving paths of ``models/llama.py`` write and
read it.  Over a mesh of several processes (``make_hybrid_mesh``) each
process allocates only its own entries' slices, and the serving paths
keep every copy of a slice the same bits in every process, as XLA keeps
a replicated pool: what a rank writes also reaches the copies that other
processes hold along dp, sp and (for a pool not cut over pp) pp.  The
block gathers, scatters and host copies below move whole blocks of an
unsharded pool and refuse a sharded one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from llm_d_kv_cache_manager_tpu_torch.parallel.sharding import NamedSharding, zeros
from llm_d_kv_cache_manager_tpu_torch.utils.device import (
    from_numpy,
    resolve_device,
    to_numpy,
    torch_dtype,
)


def supports_pinned_host(device: Union[str, torch.device, None] = None) -> bool:
    """Whether staging from ``device`` can use page-locked host memory:
    True for a CUDA device (``None``: the current one) while CUDA is
    available, False on the CPU or any other device.  The reference asks
    its backend for a ``pinned_host`` memory space; here pinned host
    memory is what CUDA's asynchronous copies need."""
    kind = "cuda" if device is None else torch.device(device).type
    return kind == "cuda" and torch.cuda.is_available()


@dataclass
class KVCachePoolConfig:
    num_layers: int
    num_blocks: int
    block_size: int
    num_kv_heads: int
    head_dim: int
    dtype: str = "bfloat16"


class KVCachePool:
    def __init__(
        self,
        config: KVCachePoolConfig,
        device: Union[str, torch.device] = "cuda",
        sharding: Optional[NamedSharding] = None,
    ) -> None:
        """A pool of zeros on ``device``, or, with ``sharding``, cut over
        its mesh (whose devices it lies on; ``device`` is then unused)."""
        self.config = config
        shape = (
            config.num_layers,
            config.num_blocks,
            2,
            config.block_size,
            config.num_kv_heads,
            config.head_dim,
        )
        dtype = torch_dtype(config.dtype)
        if sharding is not None:
            self.kv = zeros(shape, dtype, sharding.mesh, sharding.spec)
        else:
            self.kv = torch.zeros(shape, dtype=dtype, device=resolve_device(device))

    @property
    def sharded(self) -> bool:
        return not isinstance(self.kv, torch.Tensor)

    @property
    def pinned_host(self) -> bool:
        """Whether gathers can stage through pinned host memory: True on
        an unsharded CUDA pool, False on the CPU or a sharded pool (the
        staging engine's fast-path gate, as in the reference)."""
        return not self.sharded and supports_pinned_host(self.kv.device)

    @property
    def block_nbytes(self) -> int:
        """Bytes of one block across all layers (the offload unit)."""
        c = self.config
        return (
            c.num_layers
            * 2
            * c.block_size
            * c.num_kv_heads
            * c.head_dim
            * torch_dtype(c.dtype).itemsize
        )

    def _ids(self, block_ids: Sequence[int]) -> torch.Tensor:
        if self.sharded:
            raise TypeError("block gathers and scatters take an unsharded pool; this one is "
                            f"{self.kv!r}")
        return torch.as_tensor(
            np.asarray(block_ids, dtype=np.int64), device=self.kv.device
        )

    def gather_to_host(self, block_ids: Sequence[int]) -> np.ndarray:
        """Blocks as a host array ``[num_layers, n, 2, block_size, heads,
        dim]``: one device gather, one copy to the host."""
        return to_numpy(self.kv[:, self._ids(block_ids)])

    def gather_block_major(self, block_ids: Sequence[int]) -> np.ndarray:
        """Block-major host gather ``[n, L, 2, bs, h, d]`` — the file byte
        layout, transposed on the device before the copy."""
        return to_numpy(self.kv[:, self._ids(block_ids)].movedim(1, 0))

    def stage_gather_pinned(
        self, block_ids: Sequence[int]
    ) -> Tuple[torch.Tensor, torch.cuda.Event]:
        """Device gather + transpose, then an ASYNC copy into pinned host
        memory on a side stream.

        Returns ``(host, event)``: the pinned ``[n, L, 2, bs, h, d]``
        tensor and the CUDA event recorded after its copy.  The caller
        synchronizes the event before reading ``host``, so this slot's
        copy overlaps other work until then.  Raises on a CPU or sharded pool;
        callers gate on :attr:`pinned_host` and use
        :meth:`gather_block_major` instead.
        """
        if not self.pinned_host:
            kind = "sharded" if self.sharded else "CPU"
            raise RuntimeError(f"{kind} pool: no pinned host staging")
        gathered = self.kv[:, self._ids(block_ids)].movedim(1, 0).contiguous()
        host = torch.empty(
            gathered.shape, dtype=gathered.dtype, pin_memory=True
        )
        side = torch.cuda.Stream(device=self.kv.device)
        side.wait_stream(torch.cuda.current_stream(self.kv.device))
        with torch.cuda.stream(side):
            host.copy_(gathered, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        # The gathered tensor was allocated on the compute stream; keep
        # its memory from being reused before the side stream is done.
        gathered.record_stream(side)
        return host, event

    def scatter_block_major(
        self, block_ids: Sequence[int], group: np.ndarray
    ) -> None:
        """Scatter a block-major ``[n, L, 2, bs, h, d]`` host group (the
        staging engine's slot/file layout) into the pool."""
        self.scatter_from_host(block_ids, np.moveaxis(group, 0, 1))

    def scatter_from_host(
        self, block_ids: Sequence[int], blocks: np.ndarray
    ) -> None:
        """Upload a host block batch ``[L, n, 2, bs, h, d]`` and write it
        into the pool in place."""
        ids = self._ids(block_ids)
        self.kv[:, ids] = from_numpy(blocks, self.kv.dtype).to(self.kv.device)

    def write_block(self, block_id: int, block: np.ndarray) -> None:
        """Test/demo helper: set one block's contents."""
        self.scatter_from_host([block_id], block[:, None])
