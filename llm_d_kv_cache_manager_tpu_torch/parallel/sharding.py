"""Tensors cut over a mesh: the port's counterpart of JAX's
``PartitionSpec``, ``NamedSharding`` and ``jax.device_put``.

In JAX a sharding is a placement annotation and the compiler inserts the
collectives.  Here it is explicit.  :func:`shard` cuts a tensor by a
spec :class:`P` over a :class:`~.mesh.Mesh` into a :class:`Sharded`: one
local tensor per mesh coordinate, each a contiguous copy on its rank's
device (the kernels take contiguous, 16-byte-aligned inputs, and a head
slice is a strided view).  Ranks that share a device and hold the same
slice share one tensor, so a tp 2 x sp 4 mesh on one card holds the tp
shards once, not four times.  :func:`share_tree` cuts a plain tree the
same way but views each slice that is contiguous in place of copying it
(how plain params run the sharded path over a mesh of several
processes).  A spec names, for each tensor axis, the
mesh axis that cuts it or None; missing trailing entries are None, as in
JAX.  A tensor axis cut over a mesh axis of degree n must divide by n.

The collectives of the sharded model paths are single-controller:
:func:`all_reduce` and :func:`all_gather` move each rank's part with
``.to(device)`` (a no-op where ranks share a device) and sum or join
them in rank order, so every result is deterministic.  All of them keep
autograd's graph.  A tensor replicated over ranks on different devices
is one tensor per device; :func:`sync_replica_grads` sums the gradients
of those copies, each of which holds only its own ranks' share.

On a mesh of several processes (``mesh.make_hybrid_mesh``) a process
makes and holds only its own entries' slices: ``locals`` is None at
another process's entries.  :func:`sync_replica_grads` then sums each
slice's gradient inside the process, as above, and across the processes
that hold copies of it through ``parallel/process_group.py``.
:func:`ranks_over`, :func:`all_gather_over` and :func:`all_reduce_over`
are the collectives of one mesh axis that take this process's ranks'
parts: inside a process they are :func:`all_gather` and
:func:`all_reduce`; along an axis that crosses processes every process
gets every rank's part through the process group, joined or summed in
rank order, the same bits as the single controller's.  Across processes
they carry the gradient back through the adjoint transfers of
``parallel/process_group.py``, so that each process's gradient of a
replicated leaf is its own ranks' share, which
:func:`sync_replica_grads` then sums.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from llm_d_kv_cache_manager_tpu_torch.parallel.mesh import Mesh
from llm_d_kv_cache_manager_tpu_torch.parallel.process_group import transport


class P(tuple):
    """A partition spec: ``P("pp", None, "tp")`` cuts axis 0 over ``pp``
    and axis 2 over ``tp`` and replicates the rest."""

    def __new__(cls, *axes: Optional[str]) -> "P":
        for axis in axes:
            if axis is not None and not isinstance(axis, str):
                raise TypeError(f"a spec entry is a mesh axis name or None, not {axis!r}")
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(a) for a in self) + ")"


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where each slice of a tensor lives."""

    mesh: Mesh
    spec: P


def _full_spec(spec: Sequence[Optional[str]], ndim: int, mesh: Mesh) -> P:
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} axes")
    full = P(*spec, *([None] * (ndim - len(spec))))
    named = [a for a in full if a is not None]
    for axis in named:
        if axis not in mesh.axis_names:
            raise ValueError(f"spec {full} names {axis!r}, not an axis of {mesh.axis_names}")
    if len(set(named)) != len(named):
        raise ValueError(f"spec {full} names a mesh axis twice")
    return full


class Sharded:
    """A tensor of global ``shape`` cut over ``mesh`` by ``spec``:
    ``locals[coord]`` is the slice the rank at ``coord`` holds, on its
    device (None where another process owns the rank).  Made by
    :func:`shard` or :func:`zeros`."""

    def __init__(self, mesh: Mesh, spec: P, shape: Tuple[int, ...], dtype: torch.dtype,
                 locals_: np.ndarray) -> None:
        self.mesh, self.spec, self.shape, self.dtype = mesh, spec, tuple(shape), dtype
        self.locals = locals_

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec)

    @property
    def local_shape(self) -> Tuple[int, ...]:
        return tuple(n // self.mesh.size(a) if a else n for n, a in zip(self.shape, self.spec))

    def local(self, **index: int) -> torch.Tensor:
        """The slice of the rank at ``index`` (``pp=1, tp=0``; axes not
        named are 0)."""
        return self.locals[self.mesh.coord(**index)]

    def shard_index(self, coord: Tuple[int, ...]) -> Tuple[int, ...]:
        """Which slice the rank at ``coord`` holds: per tensor axis, its
        index along the mesh axis that cuts it (0 where replicated)."""
        return tuple(coord[self.mesh.axis_names.index(a)] if a else 0 for a in self.spec)

    def slices(self, index: Tuple[int, ...]) -> Tuple[slice, ...]:
        """The global slices of shard ``index``."""
        return tuple(slice(i * n, (i + 1) * n) for i, n in zip(index, self.local_shape))

    def distinct(self) -> List[Tuple[Tuple[int, ...], torch.Tensor]]:
        """(first coordinate, tensor) of each distinct local tensor, in
        coordinate order."""
        seen, out = set(), []
        for coord in np.ndindex(self.locals.shape):
            tensor = self.locals[coord]
            if tensor is not None and id(tensor) not in seen:
                seen.add(id(tensor))
                out.append((coord, tensor))
        return out

    def replicas(self, **index: int) -> List[torch.Tensor]:
        """The distinct tensors that hold the same slice as the rank at
        ``index``: what a write to that slice must update."""
        want = self.shard_index(self.mesh.coord(**index))
        return [t for coord, t in self.distinct() if self.shard_index(coord) == want]

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, dtype={self.dtype}, spec={self.spec}, "
                f"{len(self.distinct())} local tensors over {self.mesh})")


def _place(shape, dtype, mesh: Mesh, spec, make: Callable[[Tuple[int, ...],
           Tuple[slice, ...], torch.device], torch.Tensor]) -> Sharded:
    spec = _full_spec(spec, len(shape), mesh)
    for n, axis in zip(shape, spec):
        if axis and n % mesh.size(axis):
            raise ValueError(f"axis of {n} does not divide over {axis}={mesh.size(axis)} "
                             f"(shape {tuple(shape)}, spec {spec})")
    out = Sharded(mesh, spec, tuple(shape), dtype, np.empty(mesh.devices.shape, dtype=object))
    made: Dict[Tuple[torch.device, Tuple[int, ...]], torch.Tensor] = {}
    for coord in np.ndindex(mesh.devices.shape):
        if not mesh.is_local(coord):
            continue
        device, index = mesh.devices[coord], out.shard_index(coord)
        if (device, index) not in made:
            made[device, index] = make(out.local_shape, out.slices(index), device)
        out.locals[coord] = made[device, index]
    return out


def shard(x: torch.Tensor, mesh: Mesh, spec: Sequence[Optional[str]]) -> Sharded:
    """``x`` cut by ``spec`` over ``mesh``: each distinct local a fresh
    contiguous copy on its device (never a view of ``x``).  The copies
    keep autograd's graph to ``x``; pass ``x.detach()`` for new leaves."""

    def make(shape, slices, device):
        return torch.empty(shape, dtype=x.dtype, device=device).copy_(x[slices])

    return _place(tuple(x.shape), x.dtype, mesh, spec, make)


def zeros(shape: Sequence[int], dtype: torch.dtype, mesh: Mesh,
          spec: Sequence[Optional[str]]) -> Sharded:
    """A sharded tensor of zeros."""
    return _place(tuple(shape), dtype, mesh, spec,
                  lambda s, _, device: torch.zeros(s, dtype=dtype, device=device))


def empty(shape: Sequence[int], dtype: torch.dtype, mesh: Mesh,
          spec: Sequence[Optional[str]]) -> Sharded:
    """A sharded tensor whose locals are uninitialized (a restore target)."""
    return _place(tuple(shape), dtype, mesh, spec,
                  lambda s, _, device: torch.empty(s, dtype=dtype, device=device))


def unshard(x: Sharded, device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """The global tensor, assembled from one copy of each slice on
    ``device`` (default: the first rank's).  A process of a mesh over
    several processes holds only its own slices and raises."""
    if x.mesh.multi_process:
        raise ValueError("this process holds only its own slices of a tensor sharded over "
                         f"{x.mesh}: gather them through parallel.process_group")
    device = torch.device(device) if device is not None else x.mesh.devices.flat[0]
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    done = set()
    with torch.no_grad():
        for coord, tensor in x.distinct():
            index = x.shard_index(coord)
            if index not in done:
                done.add(index)
                out[x.slices(index)] = tensor.to(device)
    return out


def shard_tree(tree: Any, mesh: Mesh, specs: Any) -> Any:
    """A params tree cut leaf by leaf by the matching spec tree (e.g.
    ``llama.param_pspecs(cfg)``): new leaves, detached from ``tree``'s."""
    if isinstance(tree, dict):
        if not isinstance(specs, dict) or specs.keys() != tree.keys():
            raise ValueError(f"spec tree keys {list(specs)} do not match {list(tree)}")
        return {k: shard_tree(v, mesh, specs[k]) for k, v in tree.items()}
    return shard(tree.detach(), mesh, specs)


def share_tree(tree: Any, mesh: Mesh, specs: Any) -> Any:
    """A params tree cut as :func:`shard_tree` cuts it, copying only what
    it must: each distinct local is a view of ``tree``'s leaf where the
    rank's slice is contiguous and on the leaf's device (a stage's
    layers, a leaf that is not cut), and a contiguous copy where it is
    not (a tp slice), so that the processes that share one card hold one
    copy of the weights between them.  Only this process's entries are
    filled.  The leaves are not detached: the locals keep autograd's
    graph to ``tree``'s leaves."""
    if isinstance(tree, dict):
        if not isinstance(specs, dict) or specs.keys() != tree.keys():
            raise ValueError(f"spec tree keys {list(specs)} do not match {list(tree)}")
        return {k: share_tree(v, mesh, specs[k]) for k, v in tree.items()}

    def make(shape, slices, device):
        piece = tree[slices].to(device)
        return piece if piece.is_contiguous() else piece.contiguous()

    return _place(tuple(tree.shape), tree.dtype, mesh, specs, make)


def unshard_tree(tree: Any, device: Optional[Union[str, torch.device]] = None) -> Any:
    """A tree of :class:`Sharded` leaves as global tensors."""
    if isinstance(tree, dict):
        return {k: unshard_tree(v, device) for k, v in tree.items()}
    return unshard(tree, device) if isinstance(tree, Sharded) else tree


def tree_leaves(tree: Any) -> Iterator[Any]:
    """The leaves of a nested dict, depth first in dict order."""
    if isinstance(tree, dict):
        for value in tree.values():
            yield from tree_leaves(value)
    else:
        yield tree


def grad_tree(tree: Any) -> Any:
    """The gradients of a params tree, laid out as the tree: a
    :class:`Sharded` leaf's are a ``Sharded`` of its locals' ``.grad``
    (None where a local has none), a plain leaf's its ``.grad``."""
    if isinstance(tree, dict):
        return {k: grad_tree(v) for k, v in tree.items()}
    if not isinstance(tree, Sharded):
        return tree.grad
    grads = np.empty(tree.locals.shape, dtype=object)
    for coord in np.ndindex(grads.shape):
        grads[coord] = tree.locals[coord].grad
    return Sharded(tree.mesh, tree.spec, tree.shape, tree.dtype, grads)


def tree_mesh(tree: Any) -> Optional[Mesh]:
    """The mesh of a tree's sharded leaves (None for a plain tree);
    every sharded leaf must lie on that one mesh."""
    meshes = {id(leaf.mesh): leaf.mesh for leaf in tree_leaves(tree) if isinstance(leaf, Sharded)}
    if len(meshes) > 1:
        raise ValueError("the tree's leaves lie on different meshes")
    return next(iter(meshes.values()), None)


def distinct_locals(tree: Any) -> List[torch.Tensor]:
    """Every distinct tensor of a tree: each :class:`Sharded` leaf's
    distinct locals in coordinate order, plain tensors as they are.
    What an optimizer steps, each once."""
    seen, out = set(), []
    for leaf in tree_leaves(tree):
        tensors = [t for _, t in leaf.distinct()] if isinstance(leaf, Sharded) else [leaf]
        for tensor in tensors:
            if id(tensor) not in seen:
                seen.add(id(tensor))
                out.append(tensor)
    return out


def all_reduce(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum of ``parts`` in their order, on ``device``, in their dtype."""
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def all_gather(parts: Sequence[torch.Tensor], device: torch.device, dim: int) -> torch.Tensor:
    """``parts`` joined along ``dim`` in their order, on ``device``."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([part.to(device) for part in parts], dim=dim)


def ranks_over(parts: Sequence[torch.Tensor], mesh: Mesh, axis: str,
               coord: Tuple[int, ...]) -> List[torch.Tensor]:
    """Every rank's part along ``axis``, in rank order: ``parts`` are
    those of this process's ranks along the axis through the local
    ``coord``, in order (every rank's, where the axis stays inside the
    process).  Every process along the axis calls it alike."""
    if axis not in mesh.crossing_axes():
        return list(parts)
    return transport(mesh).all_gather_ranks(parts, axis, coord)


def all_gather_over(parts: Sequence[torch.Tensor], mesh: Mesh, axis: str,
                    coord: Tuple[int, ...], device: torch.device, dim: int) -> torch.Tensor:
    """:func:`all_gather` of every rank's part along ``axis`` (see
    :func:`ranks_over`)."""
    return all_gather(ranks_over(parts, mesh, axis, coord), device, dim)


def all_reduce_over(parts: Sequence[torch.Tensor], mesh: Mesh, axis: str,
                    coord: Tuple[int, ...], device: torch.device,
                    grad: str = "sum") -> torch.Tensor:
    """:func:`all_reduce` of every rank's part along ``axis`` (see
    :func:`ranks_over`), summed in rank order; across processes a chunk
    at a time (``MeshTransport.all_reduce_ranks``, whose ``grad`` says
    how the gradient of the processes' copies of the sum comes back)."""
    if axis not in mesh.crossing_axes():
        return all_reduce(parts, device)
    return transport(mesh).all_reduce_ranks(parts, axis, coord, grad=grad).to(device)


def sum_over_processes(value: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``value`` summed over the processes along each axis of ``mesh``
    that crosses processes, in the axes' order (itself on a mesh of one
    process).  Every process of the mesh calls it."""
    if not mesh.multi_process:
        return value
    coord = next(c for c in np.ndindex(mesh.devices.shape) if mesh.is_local(c))
    for axis in mesh.crossing_axes():
        value = transport(mesh).all_reduce(value, axis, coord)
    return value


def sync_replica_grads(tree: Any) -> None:
    """Make every copy of a slice hold the slice's whole gradient.

    Ranks that share a device and a slice share one tensor, and autograd
    already sums their uses into its gradient.  Where one slice has
    copies on several devices, each copy's gradient holds its own ranks'
    share of the loss (a dp replica's: its batch's share of the global
    mean), so the copies' gradients are summed in coordinate order and
    the sum is given to each copy: the mean over dp of every rank's own
    mean-loss gradient.  A copy no rank used counts as zero.

    On a mesh of several processes, the sum inside the process is then
    summed over the processes along each crossing axis that the leaf is
    not cut over (``all_reduce`` of ``parallel/process_group.py``, in
    the axis's order), and every copy gets it; a process whose copies
    have no gradient adds zeros.  That sum is the slice's gradient
    because the training losses (``llama.loss_fn``, ``moe.loss_fn``)
    count each loss term once over the processes and the transfers carry
    each process's share back to the ranks that made it.  Every process
    walks its slices in shard order and calls the collective for each."""
    for leaf in tree_leaves(tree):
        if not isinstance(leaf, Sharded):
            continue
        groups: "OrderedDict[Tuple[int, ...], List[Tuple[Tuple[int, ...], torch.Tensor]]]" = (
            OrderedDict())
        for coord, tensor in leaf.distinct():
            groups.setdefault(leaf.shard_index(coord), []).append((coord, tensor))
        across = [a for a in leaf.mesh.crossing_axes() if a not in leaf.spec]
        for index in sorted(groups) if across else groups:
            copies = [t for _, t in groups[index]]
            grads = [t.grad for t in copies if t.grad is not None]
            if across:
                total = (all_reduce(grads, copies[0].device) if grads
                         else torch.zeros_like(copies[0]))
                for axis in across:
                    total = transport(leaf.mesh).all_reduce(total, axis, groups[index][0][0])
            elif len(copies) < 2 or not grads:
                continue
            else:
                total = all_reduce(grads, copies[0].device)
            for tensor in copies:
                tensor.grad = total if tensor.device == total.device else total.to(tensor.device)
