"""Attention ops: plain PyTorch versions and the Hopper kernels.

- ``attention``, ``flash_attention``, ``paged_attention``: plain PyTorch
  ports of the reference's dense, tiled and gather ops (the CPU path and
  the kernels' oracles).
- ``flash_cuda``: prefill attention kernel (``csrc/flash_prefill.cu``).
- ``paged_decode_cuda``: decode attention kernel (``csrc/paged_decode.cu``).
- ``ring_flash``: the ring partial's plain version and the log-sum-exp
  merge of partials; ``ring_flash_cuda``: the partial kernel
  (``csrc/ring_partial.cu``); ``ring_attention``: the ring over a mesh's
  ``sp`` axis.
- ``tile_plan``: the work list that the bf16 prefill and ring partial
  kernels walk (q tiles, key ranges, masked tiles, key splits).
- ``_build``: nvcc build and ctypes loading of ``csrc/``.

The package exports the reference's names (its ``ops/__init__.py``):
``causal_gqa_attention``, ``paged_attention``, ``ring_attention``,
``ring_attention_sharded``, ``stripe`` and ``unstripe``, here the port's
functions.  Importing builds no kernel: the CUDA wrappers build at their
first launch.
"""

from llm_d_kv_cache_manager_tpu_torch.ops.attention import causal_gqa_attention
from llm_d_kv_cache_manager_tpu_torch.ops.paged_attention import paged_attention
from llm_d_kv_cache_manager_tpu_torch.ops.ring_attention import (
    ring_attention,
    ring_attention_sharded,
    stripe,
    unstripe,
)

__all__ = [
    "causal_gqa_attention",
    "ring_attention",
    "ring_attention_sharded",
    "stripe",
    "unstripe",
    "paged_attention",
]
