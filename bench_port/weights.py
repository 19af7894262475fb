"""Weights made from the seed.

The benchmark makes the weights itself, on the device, in the type they
are served in, and hands the same tensors to the program and to the
reference.  A family's ``weights`` (``families/<family>.py``) names its
leaves and draws each through ``Draw``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Draw:
    """Draws from ``seed`` on ``device`` by a generator there, directly in
    the configuration's served type, one call a leaf: ``normal(shape,
    scale)`` is normal(0, scale), ``norm(shape)`` is 1 + normal(0, 0.1)."""

    def __init__(self, config: Dict[str, Any], seed: int, device: torch.device) -> None:
        self.dtype = DTYPES[config["torch_dtype"]]
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % (1 << 63))

    def normal(self, shape, scale: float) -> torch.Tensor:
        out = torch.randn(shape, generator=self.gen, device=self.device, dtype=self.dtype)
        return out.mul_(scale)

    def norm(self, shape) -> torch.Tensor:
        return self.normal(shape, 0.1).add_(1.0)
