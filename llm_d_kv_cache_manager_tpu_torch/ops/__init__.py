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
"""
