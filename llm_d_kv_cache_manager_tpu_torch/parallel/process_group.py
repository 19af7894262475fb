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
- :meth:`MeshTransport.hop` moves one tensor from the process at one
  index of an axis to the process at another (the stage hop along
  ``pp``), over :meth:`post`;
- :meth:`MeshTransport.all_gather` and :meth:`MeshTransport.all_reduce`
  run over the processes of one mesh axis, one tensor a process, in
  sub-groups made once per mesh and axis; :meth:`all_gather_ranks` and
  :meth:`all_reduce_ranks` take this process's part of every rank it
  holds along the axis and give every rank's part, or their sum, in
  the axis's rank order; :meth:`broadcast` sends one process's tensor
  to every process along an axis.  The reduces gather and sum in rank
  order, so every process gets the same bits, which are the single
  controller's (``parallel.sharding.all_reduce`` sums in rank order
  too), and a result does not depend on the backend's reduction order.

The backend decides how a tensor travels.  NCCL sends CUDA tensors as
they are.  gloo sends CPU tensors; a CUDA tensor is staged through a
pinned host buffer: a device-to-host copy, the transfer, a host-to-device
copy, each copy timed by CUDA events into :class:`TransferLog`.  The
collectives move their tensors as bytes, in chunks of at most
``CHUNK_BYTES`` through pinned buffers that the transport keeps and
reuses (a tensor of gigabytes, such as a logits partial, needs no
pinned copy of its size).  Any other pairing (a CPU tensor under NCCL,
another backend) raises: nothing moves over a path the caller did not
choose.

Every process along an axis calls its collectives in one order: with
gloo, a process that calls them in another order than its peers waits
for ever rather than failing.

Gradients.  Under autograd, :meth:`~MeshTransport.hop`,
:meth:`~MeshTransport.all_gather_ranks`,
:meth:`~MeshTransport.all_reduce_ranks` and
:meth:`~MeshTransport.broadcast` are ``torch.autograd.Function`` classes whose
backward is the adjoint transfer over the same processes: the reverse
hop; each rank's part gets the sum, over the processes, of the gradients
of its copies of the gathered whole; the sum's gradient summed over the
processes (``grad="sum"``, where each process's share of the loss flows
through its own copy) or passed to each part as it is (``grad="same"``,
Megatron's identity, where every process seeds the same loss downstream
of the copies it holds); the broadcast's gradients summed at the root.
Sums run in process order, so every process gets the same bits.
Backward transfers are logged under the forward's kind with ``:bwd``.

Autograd runs a process's backward in an order of its own graph, which
differs between the stages and shards that processes hold.  Inside
:meth:`~MeshTransport.chained` every such call takes a token from the
call before it and gives one to the call after it, so the backward runs
them in exactly the reverse of the forward's order on every process
(the caller adds the last token, a zero, to its loss); each carries a
sequence number a sub-group, and its backward first checks, over the
sub-group (``order:<axis>``), that every process is at the same call,
raising :class:`CollectiveOrderError` where one is not.
"""

from __future__ import annotations

import time
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from llm_d_kv_cache_manager_tpu_torch.parallel.mesh import Mesh

# The largest piece a collective moves at once, and the size of each of
# the transport's reused pinned buffers.
CHUNK_BYTES = 64 << 20


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
        # Pinned byte buffers the collectives stage through, by role, and
        # the event after the last host-to-device copy out of them.
        self._pinned: Dict[object, torch.Tensor] = {}
        self._unstaged: Optional[torch.cuda.Event] = None
        # The calls that carry a gradient: the next sequence number of
        # each sub-group (or pair of processes), the token the next call
        # takes inside ``chained``, and the kinds by their header code.
        self._seq: Dict[tuple, int] = {}
        self._tail: Optional[torch.Tensor] = None
        self._kinds = {zlib.crc32(kind.encode()): kind for kind in (
            f"{op}:{axis}:bwd" for op in ("hop", "all_gather", "all_reduce", "broadcast")
            for axis in mesh.axis_names)}

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
             recvs: Sequence[Tuple[int, Tuple[int, ...], torch.dtype, torch.device, int]],
             kind: str = "p2p") -> Pending:
        """Start ``sends`` (``(process, tensor, tag)``) and ``recvs``
        (``(process, shape, dtype, device, tag)``) at once, logged under
        ``kind``.  Between one pair of processes the sends and the
        receives match in the order given (NCCL ignores tags), so both
        sides list them in one order."""
        started = time.perf_counter()
        entry = self._entry(kind)
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

    def hop(self, tensor: Optional[torch.Tensor], axis: str, coord: Tuple[int, ...], src: int,
            dst: int, like: Tuple[Tuple[int, ...], torch.dtype, torch.device]
            ) -> Optional[torch.Tensor]:
        """Move a tensor along ``axis`` (through the local ``coord``) from
        the process at index ``src`` to the process at index ``dst``:
        the sender passes it and gets None; the receiver passes None and
        gets it on ``like``'s device (``like``: its shape, dtype and
        device).  Both call; a process that is both gets ``tensor`` moved
        to that device.  Under autograd the gradient hops back."""
        line = self._line(axis, coord)
        sender, receiver = line[src], line[dst]
        if sender == receiver:
            return tensor.to(like[2])
        if not self._carries_grad(tensor):
            return self._hop(tensor, axis, sender, receiver, like)
        out = _Hop.apply(self, axis, (sender, receiver), like, self._token(like[2]), tensor)
        if self.mesh.process == sender:
            self._advance(out)
            return None
        self._advance(out[0])
        return out[1]

    def _hop(self, tensor, axis: str, sender: int, receiver: int, like, kind: str = None):
        me = self.mesh.process
        kind = kind or f"hop:{axis}"
        if me == sender:
            self.post([(receiver, tensor, 0)], [], kind=kind).wait()
            return None
        if me == receiver:
            return self.post([], [(sender, like[0], like[1], like[2], 0)], kind=kind).wait()[0]
        raise ValueError(f"process {me} is neither end of the {axis} hop {src} -> {dst}")

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

    def _line(self, axis: str, coord: Tuple[int, ...]) -> List[int]:
        """The process of each rank along ``axis`` through ``coord``."""
        i = self.mesh.axis_names.index(axis)
        return [self.mesh.process_of(coord[:i] + (j,) + coord[i + 1:])
                for j in range(self.mesh.devices.shape[i])]

    def _along(self, axis: str, coord: Tuple[int, ...]) -> Tuple[int, ...]:
        """The processes along ``axis`` through ``coord``, in the axis's
        order, each once."""
        return tuple(dict.fromkeys(self._line(axis, coord)))

    def _blocks(self, axis: str, coord: Tuple[int, ...]) -> Tuple[int, ...]:
        """:meth:`_along`, checking that each process holds one run of
        the axis's ranks, all runs of one length (a hybrid mesh's
        layout): then rank order is process order, then local order."""
        line = self._line(axis, coord)
        processes = tuple(dict.fromkeys(line))
        run = len(line) // len(processes)
        if line != [p for p in processes for _ in range(run)]:
            raise ValueError(f"the processes along {axis} ({line}) do not each hold one run "
                             "of its ranks")
        return processes

    def _buffer(self, role, nbytes: int) -> torch.Tensor:
        """A pinned byte buffer of ``nbytes`` for ``role``, kept and
        reused; a copy out of it may still run, so wait for that first."""
        if self._unstaged is not None:
            self._unstaged.synchronize()
            self._unstaged = None
        buf = self._pinned.get(role)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
            self._pinned[role] = buf
        return buf[:nbytes]

    def _to_host(self, piece: torch.Tensor, role, entry: dict) -> torch.Tensor:
        host = self._buffer(role, piece.numel())
        stream = torch.cuda.current_stream(piece.device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
        host.copy_(piece, non_blocking=True)
        end.record(stream)
        end.synchronize()
        entry["d2h"].append((start, end))
        return host

    def _to_device(self, host: torch.Tensor, out: torch.Tensor, entry: dict) -> None:
        stream = torch.cuda.current_stream(out.device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
        out.copy_(host, non_blocking=True)
        end.record(stream)
        entry["h2d"].append((start, end))
        self._unstaged = end

    def _gather_bytes(self, piece: torch.Tensor, group, processes, entry: dict
                      ) -> List[torch.Tensor]:
        """One ``all_gather`` of a 1-D byte tensor of at most
        ``CHUNK_BYTES``: every process's, in ``processes`` order, on
        ``piece``'s device (staged through the reused buffers)."""
        n = piece.numel()
        entry["bytes_out"] += n
        entry["bytes_in"] += n * (len(processes) - 1)
        if not self._staged(piece.device):
            parts = [torch.empty_like(piece) for _ in processes]
            dist.all_gather(parts, piece, group=group)
        else:
            send = self._to_host(piece, "send", entry)
            landing = [self._buffer(("recv", j), n) for j in range(len(processes))]
            dist.all_gather(landing, send, group=group)
            parts = [torch.empty(n, dtype=torch.uint8, device=piece.device) for _ in processes]
            for host, out in zip(landing, parts):
                self._to_device(host, out, entry)
        by_rank = dict(zip(sorted(processes), parts))
        return [by_rank[p] for p in processes]

    def _gathered(self, tensor: torch.Tensor, group, processes, entry: dict
                  ) -> List[torch.Tensor]:
        """Each process's ``tensor`` (one shape and dtype on every
        process), in ``processes`` order, chunk by chunk."""
        flat = tensor.contiguous().view(-1).view(torch.uint8)
        outs = [torch.empty_like(flat) for _ in processes]
        for a in range(0, flat.numel(), CHUNK_BYTES):
            b = min(flat.numel(), a + CHUNK_BYTES)
            for out, part in zip(outs, self._gather_bytes(flat[a:b], group, processes, entry)):
                out[a:b] = part
        return [out.view(tensor.dtype).view(tensor.shape) for out in outs]

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
        out = self._gathered(tensor, group, processes, entry)
        entry["wait_ms"] = entry["span_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def all_reduce(self, tensor: torch.Tensor, axis: str, coord: Tuple[int, ...]) -> torch.Tensor:
        """The sum over the processes along ``axis`` through ``coord``,
        taken in the axis's order, a chunk of elements at a time: the
        same bits on every process (logged as ``sum:<axis>``).  It
        carries no gradient: it sums gradients and loss values."""
        processes = self._along(axis, coord)
        group = self._axis_groups(axis)[processes]
        if group is None:
            return tensor
        return self._summed(tensor, group, processes, f"sum:{axis}")

    def all_gather_ranks(self, parts: Sequence[torch.Tensor], axis: str,
                         coord: Tuple[int, ...]) -> List[torch.Tensor]:
        """Every rank's part along ``axis`` through the local ``coord``,
        in rank order, on ``parts[0]``'s device: ``parts`` are this
        process's ranks' along the axis, in order, all of one shape and
        dtype (every process passes as many).  Under autograd each part's
        gradient is the sum, over the processes in order, of the
        gradients of its copies."""
        processes = self._blocks(axis, coord)
        if self._axis_groups(axis)[processes] is None:
            return list(parts)
        if not self._carries_grad(*parts):
            return self._all_gather_ranks(parts, axis, processes)
        out = _GatherRanks.apply(self, axis, processes, self._token(parts[0].device), *parts)
        self._advance(out[0])
        return list(out[1:])

    def _all_gather_ranks(self, parts, axis: str, processes) -> List[torch.Tensor]:
        group = self._axis_groups(axis)[processes]
        entry = self._entry(f"all_gather:{axis}")
        t0 = time.perf_counter()
        got = self._gathered(torch.stack(list(parts)), group, processes, entry)
        entry["wait_ms"] = entry["span_ms"] = (time.perf_counter() - t0) * 1e3
        return [rank for block in got for rank in block.unbind(0)]

    def all_reduce_ranks(self, parts: Sequence[torch.Tensor], axis: str,
                         coord: Tuple[int, ...], grad: str = "sum") -> torch.Tensor:
        """The sum of every rank's part along ``axis`` through the local
        ``coord``, taken in rank order (``((r0 + r1) + r2) + ...``, the
        single controller's order), on ``parts[0]``'s device: the same
        bits on every process.  ``parts`` as for
        :meth:`all_gather_ranks`; the parts travel and are summed a
        chunk of elements at a time, so no process holds every rank's
        whole part.  Under autograd each part's gradient is the sum's
        gradient summed over the processes (``grad="sum"``) or this
        process's own (``grad="same"``: every process along the axis
        seeds the same loss downstream, Megatron's identity)."""
        if grad not in ("sum", "same"):
            raise ValueError(f"grad is 'sum' or 'same', not {grad!r}")
        processes = self._blocks(axis, coord)
        if self._axis_groups(axis)[processes] is None:
            total = parts[0]
            for part in parts[1:]:
                total = total + part
            return total
        if not self._carries_grad(*parts):
            return self._all_reduce_ranks(parts, axis, processes)
        token, total = _ReduceRanks.apply(self, axis, processes, grad,
                                          self._token(parts[0].device), *parts)
        self._advance(token)
        return total

    def _all_reduce_ranks(self, parts, axis: str, processes) -> torch.Tensor:
        group = self._axis_groups(axis)[processes]
        first = parts[0]
        entry = self._entry(f"all_reduce:{axis}")
        t0 = time.perf_counter()
        flats = [p.contiguous().view(-1) for p in parts]
        n = flats[0].numel()
        total = torch.empty(n, dtype=first.dtype, device=first.device)
        step = max(1, CHUNK_BYTES // (first.element_size() * len(parts)))
        for a in range(0, n, step):
            b = min(n, a + step)
            piece = torch.stack([f[a:b] for f in flats])
            ranks = [r for block in self._gathered(piece, group, processes, entry)
                     for r in block.unbind(0)]
            acc = ranks[0]
            for r in ranks[1:]:
                acc = acc + r
            total[a:b] = acc
        entry["wait_ms"] = entry["span_ms"] = (time.perf_counter() - t0) * 1e3
        return total.view(first.shape)

    def _summed(self, tensor: torch.Tensor, group, processes, kind: str) -> torch.Tensor:
        """``tensor`` summed over ``processes`` in their order, a chunk
        of elements at a time, logged under ``kind``."""
        entry = self._entry(kind)
        t0 = time.perf_counter()
        flat = tensor.contiguous().view(-1)
        total = torch.empty_like(flat)
        step = max(1, CHUNK_BYTES // flat.element_size())
        for a in range(0, flat.numel(), step):
            b = min(flat.numel(), a + step)
            parts = self._gathered(flat[a:b], group, processes, entry)
            acc = parts[0]
            for part in parts[1:]:
                acc = acc + part
            total[a:b] = acc
        entry["wait_ms"] = entry["span_ms"] = (time.perf_counter() - t0) * 1e3
        return total.view(tensor.shape)

    def broadcast(self, tensor: Optional[torch.Tensor], axis: str, coord: Tuple[int, ...],
                  src: int, like: Tuple[Tuple[int, ...], torch.dtype, torch.device]
                  ) -> torch.Tensor:
        """The tensor of the process at index ``src`` along ``axis``
        (through the local ``coord``), in every process along the axis,
        on ``like``'s device (its shape, dtype, device).  The sender
        passes it, the others None.  Under autograd the gradients of the
        copies are summed, in process order, at the sender."""
        line = self._line(axis, coord)
        root = line[src]
        processes = tuple(dict.fromkeys(line))
        if self._axis_groups(axis)[processes] is None:
            return tensor.to(like[2])
        if not self._carries_grad(tensor):
            return self._broadcast(tensor, axis, processes, root, like)
        token, out = _Broadcast.apply(self, axis, processes, root, like,
                                      self._token(like[2]), tensor)
        self._advance(token)
        return out

    def _broadcast(self, tensor, axis: str, processes, root: int, like) -> torch.Tensor:
        group = self._axis_groups(axis)[processes]
        shape, dtype, device = like
        entry = self._entry(f"broadcast:{axis}")
        t0 = time.perf_counter()
        mine = self.mesh.process == root
        if mine:
            flat = tensor.contiguous().view(-1).view(torch.uint8)
        else:
            out = torch.empty(shape, dtype=dtype, device=device)
            flat = out.view(-1).view(torch.uint8)
        staged = self._staged(flat.device)
        for a in range(0, flat.numel(), CHUNK_BYTES):
            b = min(flat.numel(), a + CHUNK_BYTES)
            n = b - a
            if mine:
                entry["bytes_out"] += n * (len(processes) - 1)
                buf = self._to_host(flat[a:b], "send", entry) if staged else flat[a:b]
                dist.broadcast(buf, src=root, group=group)
            else:
                entry["bytes_in"] += n
                buf = self._buffer("recv", n) if staged else flat[a:b]
                dist.broadcast(buf, src=root, group=group)
                if staged:
                    self._to_device(buf, flat[a:b], entry)
        entry["wait_ms"] = entry["span_ms"] = (time.perf_counter() - t0) * 1e3
        return tensor.to(device) if mine else out

    # -- gradients --

    @contextmanager
    def chained(self, device: torch.device) -> Iterator["MeshTransport"]:
        """Chain the calls that carry a gradient inside the block (see
        the module's note); :meth:`tail` is the last call's token, which
        the caller adds to its loss.  Every process of the mesh enters
        it around the same calls."""
        if self._tail is not None:
            raise RuntimeError("the transport's calls are already chained")
        self._tail = torch.zeros((), device=device, requires_grad=True)
        try:
            yield self
        finally:
            self._tail = None

    def tail(self) -> torch.Tensor:
        """The token of the last chained call: a zero whose backward runs
        every chained call's backward, last first."""
        return self._tail

    def _carries_grad(self, *tensors) -> bool:
        return torch.is_grad_enabled() and (self._tail is not None or any(
            t is not None and t.requires_grad for t in tensors))

    def _token(self, device: torch.device) -> torch.Tensor:
        return self._tail if self._tail is not None else torch.zeros((), device=device)

    def _advance(self, token: torch.Tensor) -> None:
        if self._tail is not None:
            self._tail = token

    def _number(self, key: tuple) -> int:
        """The next sequence number of ``key``'s calls that carry a
        gradient (a sub-group, or a pair of processes)."""
        seq = self._seq.get(key, 0)
        self._seq[key] = seq + 1
        return seq

    def _header(self, seq: int, kind: str, device: torch.device) -> torch.Tensor:
        return torch.tensor([seq, zlib.crc32(kind.encode())], dtype=torch.int64, device=device)

    def _order_error(self, where: str, mine, theirs) -> "CollectiveOrderError":
        def name(header):
            seq, code = (int(v) for v in header)
            return f"{self._kinds.get(code, 'an unknown call')} #{seq}"
        return CollectiveOrderError(
            f"collective order mismatch {where}: this process (process {self.mesh.process}) is "
            f"at the backward of {name(mine)}, "
            + ", ".join(f"process {p} at {name(h)}" for p, h in theirs))

    def _check_order(self, axis: str, processes, seq: int, kind: str,
                     device: torch.device) -> None:
        """Every process of the sub-group is at the backward of the same
        call (its sequence number and kind), or raise."""
        header = self._header(seq, kind, device)
        group = self._axis_groups(axis)[processes]
        entry = self._entry(f"order:{axis}")
        t0 = time.perf_counter()
        got = self._gathered(header, group, processes, entry)
        entry["wait_ms"] = entry["span_ms"] = (time.perf_counter() - t0) * 1e3
        theirs = [(p, h.tolist()) for p, h in zip(processes, got)]
        if any(h != header.tolist() for _, h in theirs):
            raise self._order_error(f"along {axis} over processes {list(processes)}",
                                    header.tolist(), theirs)


class CollectiveOrderError(RuntimeError):
    """The processes of a sub-group reached the backwards of different
    collectives: with gloo they would wait on each other for ever."""


def _new_token(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), device=like.device)


class _GatherRanks(torch.autograd.Function):
    """``all_gather_ranks``; backward: each local part's gradient summed
    over the processes (every process sends its gradients of the whole,
    each keeps its own parts' sums)."""

    @staticmethod
    def forward(ctx, tr, axis, processes, token, *parts):
        ctx.tr, ctx.axis, ctx.processes, ctx.n = tr, axis, processes, len(parts)
        ctx.devices = [p.device for p in parts]
        ctx.seq = tr._number(("group", axis, processes))
        return (_new_token(token), *tr._all_gather_ranks(parts, axis, processes))

    @staticmethod
    def backward(ctx, g_token, *grads):
        tr, axis, processes = ctx.tr, ctx.axis, ctx.processes
        kind = f"all_gather:{axis}:bwd"
        tr._check_order(axis, processes, ctx.seq, kind, grads[0].device)
        group = tr._axis_groups(axis)[processes]
        entry = tr._entry(kind)
        t0 = time.perf_counter()
        got = tr._gathered(torch.stack(grads), group, processes, entry)
        entry["wait_ms"] = entry["span_ms"] = (time.perf_counter() - t0) * 1e3
        me = processes.index(tr.mesh.process)
        mine = slice(me * ctx.n, (me + 1) * ctx.n)
        total = got[0][mine]
        for g in got[1:]:
            total = total + g[mine]
        return (None, None, None, torch.zeros_like(g_token),
                *(g.to(d) for g, d in zip(total.unbind(0), ctx.devices)))


class _ReduceRanks(torch.autograd.Function):
    """``all_reduce_ranks``; backward: the sum's gradient summed over the
    processes (``"sum"``) or as it is (``"same"``), to every part."""

    @staticmethod
    def forward(ctx, tr, axis, processes, grad, token, *parts):
        ctx.tr, ctx.axis, ctx.processes, ctx.grad = tr, axis, processes, grad
        ctx.devices = [p.device for p in parts]
        ctx.seq = tr._number(("group", axis, processes))
        return _new_token(token), tr._all_reduce_ranks(parts, axis, processes)

    @staticmethod
    def backward(ctx, g_token, grad):
        tr, axis, processes = ctx.tr, ctx.axis, ctx.processes
        if ctx.grad == "sum":
            kind = f"all_reduce:{axis}:bwd"
            tr._check_order(axis, processes, ctx.seq, kind, grad.device)
            grad = tr._summed(grad, tr._axis_groups(axis)[processes], processes, kind)
        return (None, None, None, None, torch.zeros_like(g_token),
                *(grad.to(d) for d in ctx.devices))


class _Hop(torch.autograd.Function):
    """``hop``; backward: the receiver sends the gradient back, behind a
    header with the call's sequence number and kind, which the sender
    checks.  The sender's output is a token only."""

    @staticmethod
    def forward(ctx, tr, axis, ends, like, token, tensor):
        sender, receiver = ends
        ctx.tr, ctx.axis, ctx.ends = tr, axis, ends
        ctx.seq = tr._number(("pair", min(ends), max(ends)))
        if tr.mesh.process == sender:
            ctx.like = (tuple(tensor.shape), tensor.dtype, tensor.device)
            tr._hop(tensor, axis, sender, receiver, like)
            return _new_token(token)
        ctx.like = None
        return _new_token(token), tr._hop(None, axis, sender, receiver, like)

    @staticmethod
    def backward(ctx, g_token, *grads):
        tr, (sender, receiver) = ctx.tr, ctx.ends
        kind = f"hop:{ctx.axis}:bwd"
        if ctx.like is None:  # the receiver: its gradient goes back
            (grad,) = grads
            tr.post([(sender, tr._header(ctx.seq, kind, grad.device), 1), (sender, grad, 2)], [],
                    kind=kind).wait()
            return None, None, None, None, torch.zeros_like(g_token), None
        shape, dtype, device = ctx.like
        header, grad = tr.post([], [(receiver, (2,), torch.int64, device, 1),
                                    (receiver, shape, dtype, device, 2)], kind=kind).wait()
        mine = tr._header(ctx.seq, kind, device)
        if not torch.equal(header, mine):
            raise tr._order_error(f"on the {ctx.axis} hop from process {sender} to {receiver}",
                                  mine.tolist(), [(receiver, header.tolist())])
        return None, None, None, None, torch.zeros_like(g_token), grad


class _Broadcast(torch.autograd.Function):
    """``broadcast``; backward: every process's gradient of its copy
    summed at the root, in process order."""

    @staticmethod
    def forward(ctx, tr, axis, processes, root, like, token, tensor):
        ctx.tr, ctx.axis, ctx.processes, ctx.root = tr, axis, processes, root
        ctx.device = tensor.device if tensor is not None else None
        ctx.seq = tr._number(("group", axis, processes))
        return _new_token(token), tr._broadcast(tensor, axis, processes, root, like)

    @staticmethod
    def backward(ctx, g_token, grad):
        tr, axis, processes = ctx.tr, ctx.axis, ctx.processes
        kind = f"broadcast:{axis}:bwd"
        tr._check_order(axis, processes, ctx.seq, kind, grad.device)
        total = tr._summed(grad, tr._axis_groups(axis)[processes], processes, kind)
        mine = total.to(ctx.device) if tr.mesh.process == ctx.root else None
        return None, None, None, None, None, torch.zeros_like(g_token), mine


def transport(mesh: Mesh) -> MeshTransport:
    """The mesh's transport, made on first use and kept on the mesh (its
    sub-groups are made once per mesh and axis)."""
    if mesh._transport is None:
        mesh._transport = MeshTransport(mesh)
    return mesh._transport
