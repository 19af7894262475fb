"""Device, dtype and host-array conversion shared by the port.

numpy has no bfloat16: the JAX reference hands bf16 arrays around as
``ml_dtypes.bfloat16``, which the port reads through its ``uint16`` bit
view (the idea of the reference's ``offload/vllm_spec.py`` host copies)
and hands back as ``uint16`` bit patterns, so no ``ml_dtypes`` import is
needed on the GPU machine.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point works on.

    Entry points default to ``"cuda"``; asking for CUDA on a machine
    without a GPU raises instead of carrying on quietly on the CPU.
    Tests and CPU callers pass ``"cpu"`` explicitly.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Map the reference's dtype names (``"bfloat16"``, ...) to torch."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype name: {name!r}") from None


def from_numpy(array: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host array as a CPU tensor of ``dtype``.

    An ``ml_dtypes.bfloat16`` array, or a ``uint16`` array going to a
    bf16 tensor, is taken bit for bit; any other array is converted by
    value (round to nearest even, as ``jnp.asarray(x, dtype)`` does).
    """
    array = np.ascontiguousarray(array)
    if not array.flags.writeable:  # e.g. a view of a JAX array
        array = array.copy()
    if array.dtype.name == "bfloat16" or (
        dtype == torch.bfloat16 and array.dtype == np.uint16
    ):
        if dtype != torch.bfloat16:
            raise ValueError(f"bf16 bits cannot fill a {dtype} tensor")
        return torch.from_numpy(array.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(array).to(dtype)


def to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a host array; bf16 comes back as ``uint16``
    bit patterns (numpy has no bfloat16)."""
    host = tensor.detach().cpu().contiguous()
    if host.dtype == torch.bfloat16:
        host = host.view(torch.uint16)
    return host.numpy()
