"""Transfers between the processes of a mesh, over ``torch.distributed``.

The port's own module: in the reference, XLA inserts the transfers
between hosts of a multi-process mesh.  Here they are explicit, and
where a tensor moves decides how it moves.  Between two entries of one
process it is a ``.to(device)`` (the callers do that).  Between entries
of two processes it goes through the default process group, which every
process has initialized (``torch.distributed.init_process_group``)
before it built the mesh (``parallel.mesh.make_hybrid_mesh``):

- :meth:`MeshTransport.post` starts point-to-point sends and receives
  (``batch_isend_irecv``) and returns a :class:`Pending` whose
  ``wait()`` gives the received tensors: the ring rotation, posted
  before a step's compute and waited on after it;
- :meth:`MeshTransport.all_gather` and :meth:`MeshTransport.all_reduce`
  run over the processes of one mesh axis, in sub-groups made once per
  mesh and axis.  The reduce gathers and sums in the axis's order, so
  every process gets the same bits and a result does not depend on the
  backend's reduction order.

The backend decides how a tensor travels.  NCCL sends CUDA tensors as
they are.  gloo sends CPU tensors; a CUDA tensor is staged through a
pinned host buffer: a device-to-host copy, the transfer, a host-to-device
copy, each copy timed by CUDA events into :class:`TransferLog`.  Any
other pairing (a CPU tensor under NCCL, another backend) raises: nothing
moves over a path the caller did not choose.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from llm_d_kv_cache_manager_tpu_torch.parallel.mesh import Mesh


@dataclass
class TransferLog:
    """What the transport did, one record a transfer: its kind, the
    bytes it moved out and in, the host time from posting to the end of
    its wait (``span_ms``) and of the wait alone (``wait_ms``), and the
    staging copies' CUDA events (gloo over CUDA tensors), read by
    :meth:`records` once the device has run them."""

    entries: List[dict] = field(default_factory=list)

    def clear(self) -> None:
        self.entries.clear()

    def records(self) -> List[dict]:
        """Every record, the staging copies' device times resolved
        (``d2h_ms``, ``h2d_ms``; 0 where nothing was staged)."""
        out = []
        for entry in self.entries:
            row = {k: v for k, v in entry.items() if k not in ("d2h", "h2d")}
            for key in ("d2h", "h2d"):
                row[f"{key}_ms"] = sum(a.elapsed_time(b) for a, b in entry[key])
            out.append(row)
        return out


class Pending:
    """Posted sends and receives.  :meth:`wait` waits for all of them
    and returns the received tensors on their devices, in the order of
    the ``recvs`` that :meth:`MeshTransport.post` was given."""

    def __init__(self, transport: "MeshTransport", works, recvs, entry: dict,
                 started: float, keep) -> None:
        self._transport, self._works, self._recvs = transport, works, recvs
        self._entry, self._started, self._keep = entry, started, keep

    def wait(self) -> List[torch.Tensor]:
        t0 = time.perf_counter()
        for work in self._works:
            work.wait()
        done = time.perf_counter()
        out = []
        for buf, device in self._recvs:
            out.append(buf if buf.device == device else self._transport._unstage(
                buf, device, self._entry))
        self._entry["wait_ms"] = (done - t0) * 1e3
        self._entry["span_ms"] = (done - self._started) * 1e3
        self._keep = None  # the sent buffers may go now
        return out


def _backend() -> str:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed group is initialized "
                           "(torch.distributed.init_process_group)")
    return str(dist.get_backend())


class MeshTransport:
    """The transfers of one multi-process mesh: its sub-groups, made
    once per axis, and a :class:`TransferLog` (``log``)."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self.backend = _backend()
        self.log = TransferLog()
        self._groups: Dict[str, Dict[Tuple[int, ...], Optional[object]]] = {}

    # -- how a tensor travels --

    def _staged(self, device: torch.device) -> bool:
        """Whether a tensor on ``device`` goes through a pinned host
        buffer; raises for a pairing of backend and device this module
        does not move."""
        kind = device.type
        if self.backend == "gloo" and kind in ("cpu", "cuda"):
            return kind == "cuda"
        if self.backend == "nccl" and kind == "cuda":
            return False
        raise RuntimeError(f"the {self.backend} backend does not move a {kind} tensor here "
                           "(gloo: CPU tensors, CUDA ones staged through pinned host "
                           "buffers; nccl: CUDA tensors)")

    def _stage(self, tensor: torch.Tensor, entry: dict) -> torch.Tensor:
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        stream = torch.cuda.current_stream(tensor.device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
        host.copy_(tensor, non_blocking=True)
        end.record(stream)
        end.synchronize()
        entry["d2h"].append((start, end))
        return host

    def _unstage(self, host: torch.Tensor, device: torch.device, entry: dict) -> torch.Tensor:
        stream = torch.cuda.current_stream(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
        out = host.to(device, non_blocking=True)
        end.record(stream)
        entry["h2d"].append((start, end))
        return out

    def _entry(self, kind: str) -> dict:
        entry = {"kind": kind, "bytes_out": 0, "bytes_in": 0, "d2h": [], "h2d": []}
        self.log.entries.append(entry)
        return entry

    # -- point to point --

    def post(self, sends: Sequence[Tuple[int, torch.Tensor, int]],
             recvs: Sequence[Tuple[int, Tuple[int, ...], torch.dtype, torch.device, int]]
             ) -> Pending:
        """Start ``sends`` (``(process, tensor, tag)``) and ``recvs``
        (``(process, shape, dtype, device, tag)``) at once.  Between one
        pair of processes the sends and the receives match in the order
        given (NCCL ignores tags), so both sides list them in one order."""
        started = time.perf_counter()
        entry = self._entry("p2p")
        ops, keep, landing = [], [], []
        for process, tensor, tag in sends:
            buf = self._stage(tensor, entry) if self._staged(tensor.device) else tensor.contiguous()
            keep.append(buf)
            entry["bytes_out"] += buf.numel() * buf.element_size()
            ops.append(dist.P2POp(dist.isend, buf, process, tag=tag))
        for process, shape, dtype, device, tag in recvs:
            if self._staged(device):
                buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            else:
                buf = torch.empty(shape, dtype=dtype, device=device)
            landing.append((buf, device))
            entry["bytes_in"] += buf.numel() * buf.element_size()
            ops.append(dist.P2POp(dist.irecv, buf, process, tag=tag))
        works = dist.batch_isend_irecv(ops) if ops else []
        return Pending(self, works, landing, entry, started, keep)

    # -- collectives over one axis --

    def _axis_groups(self, axis: str) -> Dict[Tuple[int, ...], Optional[object]]:
        """{processes along ``axis``: their group (None for one
        process)}, made on first use.  Every process makes every group,
        in one order, as ``new_group`` requires."""
        if axis not in self._groups:
            i = self.mesh.axis_names.index(axis)
            members = sorted({tuple(dict.fromkeys(np.moveaxis(self.mesh.processes, i, -1)
                                                  [rest].tolist()))
                              for rest in np.ndindex(tuple(
                                  n for j, n in enumerate(self.mesh.processes.shape)
                                  if j != i))})
            self._groups[axis] = {
                ranks: dist.new_group(sorted(ranks)) if len(ranks) > 1 else None
                for ranks in members}
        return self._groups[axis]

    def _along(self, axis: str, coord: Tuple[int, ...]) -> Tuple[int, ...]:
        """The processes along ``axis`` through ``coord``, in the axis's
        order, each once."""
        i = self.mesh.axis_names.index(axis)
        line = [self.mesh.process_of(coord[:i] + (j,) + coord[i + 1:])
                for j in range(self.mesh.devices.shape[i])]
        return tuple(dict.fromkeys(line))

    def all_gather(self, tensor: torch.Tensor, axis: str,
                   coord: Tuple[int, ...]) -> List[torch.Tensor]:
        """Each process's ``tensor`` along ``axis`` through ``coord`` (a
        local coordinate), in the axis's order, on ``tensor``'s device.
        Every process along the axis calls it with a tensor of one shape
        and dtype."""
        processes = self._along(axis, coord)
        group = self._axis_groups(axis)[processes]
        if group is None:
            return [tensor]
        entry = self._entry(f"all_gather:{axis}")
        t0 = time.perf_counter()
        staged = self._staged(tensor.device)
        send = self._stage(tensor, entry) if staged else tensor.contiguous()
        parts = [torch.empty_like(send) for _ in processes]
        dist.all_gather(parts, send, group=group)
        entry["bytes_out"] = send.numel() * send.element_size()
        entry["bytes_in"] = entry["bytes_out"] * len(processes)
        by_rank = dict(zip(sorted(processes), parts))
        out = [by_rank[p] for p in processes]
        if staged:
            out = [self._unstage(part, tensor.device, entry) for part in out]
        entry["wait_ms"] = entry["span_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def all_reduce(self, tensor: torch.Tensor, axis: str, coord: Tuple[int, ...]) -> torch.Tensor:
        """The sum over the processes along ``axis`` through ``coord``,
        taken in the axis's order: the same bits on every process."""
        parts = self.all_gather(tensor, axis, coord)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total


def transport(mesh: Mesh) -> MeshTransport:
    """The mesh's transport, made on first use and kept on the mesh (its
    sub-groups are made once per mesh and axis)."""
    if mesh._transport is None:
        mesh._transport = MeshTransport(mesh)
    return mesh._transport
