"""Mesh construction and axis conventions.

Port of the reference's ``parallel/mesh.py``: the same axis names, the
same outermost-to-innermost order and the same ``MeshPlan.resolve``.

- ``dp``: data parallel — batch axis.
- ``pp``: pipeline/stage axis.
- ``tp``: tensor parallel — attention heads and MLP hidden dim.
- ``sp``: sequence/context parallel — long-context prefill shards the
  sequence axis and runs ring attention over ``sp``
  (``ops/ring_attention.py``).
- ``ep``: expert parallel — reserved for MoE model families; meshes are
  always built with the axis present (size 1 unless requested).

The reference is single-controller: one process drives every device of
a JAX ``Mesh``.  So is the port.  A :class:`Mesh` is an array of
``torch.device`` entries shaped by ``AXIS_ORDER``; an entry is a rank,
and several entries may name the same device.  On one GPU,
``make_mesh(MeshPlan(dp=1, sp=4), ["cuda:0"] * 4)`` is a 4-rank ring
whose ranks take turns on the card; on the CPU, ``["cpu"] * 8`` plays
the part of the reference tests' eight virtual host devices.

:func:`activate` (or ``with mesh:``) makes a mesh the active one, as the
reference's ``jax.set_mesh`` does, so that ``moe._constrain`` can place
a tensor on its ranks; :func:`mesh_is_active` says whether one is.  A
transport over ``torch.distributed`` process groups, and the
reference's ``make_hybrid_mesh``, are not ported yet.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from llm_d_kv_cache_manager_tpu_torch.utils.device import resolve_device

AXIS_DP = "dp"
AXIS_PP = "pp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_EP = "ep"

# Outermost-to-innermost device ordering, as in the reference.
AXIS_ORDER: Tuple[str, ...] = (AXIS_DP, AXIS_PP, AXIS_EP, AXIS_SP, AXIS_TP)


@dataclass
class MeshPlan:
    """Requested parallelism degrees; -1 on ``dp`` means "absorb the
    remaining devices" (the common fleet configuration)."""

    dp: int = -1
    pp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {
            AXIS_DP: self.dp,
            AXIS_PP: self.pp,
            AXIS_TP: self.tp,
            AXIS_SP: self.sp,
            AXIS_EP: self.ep,
        }
        fixed = 1
        free_axes = [a for a, s in sizes.items() if s == -1]
        for a, s in sizes.items():
            if s != -1:
                if s <= 0:
                    raise ValueError(f"axis {a} has invalid size {s}")
                fixed *= s
        if len(free_axes) > 1:
            raise ValueError("at most one axis may be -1")
        if free_axes:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed product {fixed}"
                )
            sizes[free_axes[0]] = n_devices // fixed
        else:
            if fixed != n_devices:
                raise ValueError(
                    f"mesh plan wants {fixed} devices, have {n_devices}"
                )
        return sizes


class Mesh:
    """A device array with named axes: ``devices`` is an ndarray of
    ``torch.device`` (object dtype), one axis per name of
    ``axis_names``; ``shape`` maps each name to its size, as JAX's
    ``mesh.shape["sp"]`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"{devices.ndim}-d device array for axes {tuple(axis_names)}"
            )
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    def size(self, axis: str) -> int:
        """The degree of ``axis``; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def coord(self, **index: int) -> Tuple[int, ...]:
        """The coordinate of the rank at ``index`` (``dp=1, tp=0``, ...),
        0 on every axis not named."""
        unknown = set(index) - set(self.axis_names)
        if unknown:
            raise ValueError(f"mesh has no axes {sorted(unknown)} (axes {self.axis_names})")
        return tuple(index.get(a, 0) for a in self.axis_names)

    def __enter__(self) -> "Mesh":
        _ACTIVE.stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.stack.pop()

    def __repr__(self) -> str:
        sizes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({sizes}; {sorted({str(d) for d in self.devices.flat})})"


class _Active(threading.local):
    """The meshes entered on this thread, innermost last."""

    def __init__(self) -> None:
        self.stack = []


_ACTIVE = _Active()


@contextmanager
def activate(mesh: Mesh) -> Iterator[Mesh]:
    """Enter ``mesh`` as the active mesh for the block, as the
    reference's ``activate`` (``jax.set_mesh``) does; ``with mesh:`` is
    the same.  Contexts nest; the innermost is the active one."""
    with mesh:
        yield mesh


def mesh_is_active() -> bool:
    """Whether a mesh is active on this thread (:func:`activate` or
    ``with mesh:``).  Model code makes its placement constraints a no-op
    outside any mesh, as the reference does."""
    return bool(_ACTIVE.stack)


def active_mesh() -> Optional[Mesh]:
    """The innermost active mesh, or None."""
    return _ACTIVE.stack[-1] if _ACTIVE.stack else None


def make_mesh(
    plan: Optional[MeshPlan] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Mesh:
    """Build a Mesh with the framework's canonical axis order.

    ``devices`` defaults to every CUDA device (and raises when there is
    no GPU); the CPU, or one device named several times, is used only
    when the caller passes it."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    plan = plan or MeshPlan()
    sizes = plan.resolve(len(devices))
    shape = tuple(sizes[a] for a in AXIS_ORDER)
    dev_array = np.empty(len(devices), dtype=object)
    dev_array[:] = devices
    return Mesh(dev_array.reshape(shape), AXIS_ORDER)
