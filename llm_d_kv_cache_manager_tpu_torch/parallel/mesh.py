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

Inside one process the reference is single-controller: one process
drives every device of a JAX ``Mesh``.  So is the port.  A :class:`Mesh`
is an array of ``torch.device`` entries shaped by ``AXIS_ORDER``; an
entry is a rank, and several entries may name the same device.  On one
GPU, ``make_mesh(MeshPlan(dp=1, sp=4), ["cuda:0"] * 4)`` is a 4-rank
ring whose ranks take turns on the card; on the CPU, ``["cpu"] * 8``
plays the part of the reference tests' eight virtual host devices.

Across hosts the reference runs one process a host
(``jax.distributed.initialize()``), and :func:`make_hybrid_mesh` lays
the devices of every process out in one mesh.  So does the port, over
``torch.distributed``: each entry also names its process (its rank in
the default group, ``Mesh.processes``), and a process computes only for
its own entries (:meth:`Mesh.is_local`).  A move between two entries of
one process is a ``.to(device)``; a move between entries of two
processes goes through the process group (``parallel/process_group.py``).

:func:`activate` (or ``with mesh:``) makes a mesh the active one, as the
reference's ``jax.set_mesh`` does, so that ``moe._constrain`` can place
a tensor on its ranks; :func:`mesh_is_active` says whether one is.
"""

from __future__ import annotations

import math
import os
import threading
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

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


def world() -> Tuple[int, int]:
    """(this process's rank, the number of processes) of the default
    ``torch.distributed`` group; (0, 1) where none is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A device array with named axes: ``devices`` is an ndarray of
    ``torch.device`` (object dtype), one axis per name of
    ``axis_names``; ``shape`` maps each name to its size, as JAX's
    ``mesh.shape["sp"]`` does.  ``processes`` (int, the same shape) is
    the rank of the process that owns each entry, by default this
    process's for every entry; ``process`` is this process's rank."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 processes: Optional[np.ndarray] = None,
                 process: Optional[int] = None) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"{devices.ndim}-d device array for axes {tuple(axis_names)}"
            )
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.process = world()[0] if process is None else process
        if processes is None:
            processes = np.full(devices.shape, self.process, dtype=np.int64)
        if processes.shape != devices.shape:
            raise ValueError(f"processes {processes.shape} for devices {devices.shape}")
        self.processes = processes
        self._crossing = tuple(a for i, a in enumerate(self.axis_names)
                               if (np.diff(processes, axis=i) != 0).any())
        # parallel.process_group.transport(mesh) keeps the mesh's transport
        # (its sub-groups) here, made on first use.
        self._transport = None

    @property
    def multi_process(self) -> bool:
        """Whether the mesh's entries belong to more than one process."""
        return bool((self.processes != self.processes.flat[0]).any())

    def process_of(self, coord: Tuple[int, ...]) -> int:
        """The rank of the process that owns the entry at ``coord``."""
        return int(self.processes[coord])

    def is_local(self, coord: Tuple[int, ...]) -> bool:
        """Whether this process owns the entry at ``coord``."""
        return self.process_of(coord) == self.process

    def crossing_axes(self) -> Tuple[str, ...]:
        """The axes along which the owning process changes: the axes
        whose collectives cross processes."""
        return self._crossing

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
        where = f"{sorted({str(d) for d in self.devices.flat})}"
        if self.multi_process:
            where += f" over processes {sorted(set(self.processes.ravel().tolist()))}"
        return f"Mesh({sizes}; {where})"


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


def _local_devices(devices: Optional[Sequence[Union[str, torch.device]]]) -> list:
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def hybrid_layout(ici_sizes: Dict[str, int], dcn_sizes: Dict[str, int],
                  process_devices: Sequence[Sequence[Union[str, torch.device]]]):
    """(devices, processes) of the hybrid mesh over ``process_devices``
    (each process's own devices, in rank order): the order of the
    reference's ``mesh_utils.create_hybrid_device_mesh(...,
    process_is_granule=True)``.  Along each axis, index ``c`` is the
    ICI index ``c % ici`` inside the process at DCN index ``c // ici``;
    processes fill the DCN grid and each process's devices its ICI grid,
    both in row-major order."""
    ici = tuple(ici_sizes[a] for a in AXIS_ORDER)
    dcn = tuple(dcn_sizes[a] for a in AXIS_ORDER)
    if math.prod(dcn) != len(process_devices):
        raise ValueError(f"DCN degrees {dcn} want {math.prod(dcn)} processes, "
                         f"have {len(process_devices)}")
    for p, local in enumerate(process_devices):
        if len(local) != math.prod(ici):
            raise ValueError(f"ICI degrees {ici} want {math.prod(ici)} devices a process, "
                             f"process {p} has {len(local)}")
    shape = tuple(i * d for i, d in zip(ici, dcn))
    devices = np.empty(shape, dtype=object)
    processes = np.empty(shape, dtype=np.int64)
    for coord in np.ndindex(shape):
        p = int(np.ravel_multi_index(tuple(c // i for c, i in zip(coord, ici)), dcn))
        j = int(np.ravel_multi_index(tuple(c % i for c, i in zip(coord, ici)), ici))
        devices[coord] = torch.device(process_devices[p][j])
        processes[coord] = p
    return devices, processes


def make_hybrid_mesh(
    ici_plan: Optional[MeshPlan] = None,
    dcn_plan: Optional[MeshPlan] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Mesh:
    """Multi-process mesh: per-axis ICI (inside a process) x DCN
    (across processes) degrees, the same canonical axis names.

    The scaling recipe of the reference, whose counterpart of
    ``jax.distributed.initialize()`` is
    ``torch.distributed.init_process_group``: call it in every process
    (one a host, or one a GPU), then build the mesh here in every
    process.  The world size comes from the default group, and each
    process's devices from an all-gather of their names.  Each axis's
    DCN factor crosses processes while its ICI factor stays inside one,
    in the order of ``create_hybrid_device_mesh(...,
    process_is_granule=True)`` (:func:`hybrid_layout`).

    ``ici_plan`` defaults to tensor parallel over a process's devices
    (``dp=1, tp=per_process``) and ``dcn_plan`` to data parallel over
    the processes (``dp=n_processes``), as in the reference.  With one
    process (no group, or a world of 1) the degrees merge per axis into
    ``make_mesh``'s flat mesh.  ``devices``: this process's devices
    (default every CUDA device; the CPU only when the caller names it).
    Raises where ``WORLD_SIZE`` says several processes run and no group
    is initialized."""
    rank, n_processes = world()
    # WORLD_SIZE is the launcher's (torchrun's), read only to refuse a
    # missing group: not a knob of this package.
    if n_processes == 1 and int(os.environ.get("WORLD_SIZE", "1")) > 1:  # kvlint: disable=KV007
        raise RuntimeError(
            f"WORLD_SIZE={os.environ['WORLD_SIZE']} but no torch.distributed group is "
            "initialized: call torch.distributed.init_process_group in every process first")
    local = _local_devices(devices)
    per_process = len(local)
    ici_plan = ici_plan or MeshPlan(dp=1, tp=per_process)
    dcn_plan = dcn_plan or MeshPlan(dp=n_processes)
    ici_sizes = ici_plan.resolve(per_process)
    dcn_sizes = dcn_plan.resolve(n_processes)
    if n_processes == 1:
        # One process: hybrid degenerates to the flat ICI mesh.
        merged = MeshPlan(**{a: ici_sizes[a] * dcn_sizes[a] for a in AXIS_ORDER})
        return make_mesh(merged, local)
    gathered = [None] * n_processes
    dist.all_gather_object(gathered, [str(d) for d in local])
    dev_array, processes = hybrid_layout(ici_sizes, dcn_sizes, gathered)
    for coord in np.ndindex(dev_array.shape):
        if processes[coord] == rank:
            dev_array[coord] = resolve_device(dev_array[coord])
    return Mesh(dev_array, AXIS_ORDER, processes=processes, process=rank)
