"""Attention ops: plain PyTorch versions and the Hopper kernels.

- ``attention``, ``flash_attention``, ``paged_attention``: plain PyTorch
  ports of the reference's dense, tiled and gather ops (the CPU path and
  the kernels' oracles).
- ``flash_cuda``: prefill attention kernel (``csrc/flash_prefill.cu``).
- ``paged_decode_cuda``: decode attention kernel (``csrc/paged_decode.cu``).
- ``_build``: nvcc build and ctypes loading of ``csrc/``.
"""
