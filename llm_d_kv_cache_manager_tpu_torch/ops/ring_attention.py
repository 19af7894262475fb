"""Ring attention: sequence-parallel causal attention over an ``sp``
mesh axis.

Port of the reference's ``ops/ring_attention.py``.  Long-context
prefill cuts the sequence into ``sp`` chunks, one per ring rank; K/V
chunks rotate around the ring while each rank keeps an online-softmax
state for its local queries.  The reference runs that under
``shard_map`` with ``lax.ppermute``.  Here :func:`_ring_driver` holds
the states of this process's ranks (every rank, on a mesh of one
process) and a step moves each K/V chunk one rank on (:class:`Ring`):
with ``.to(next rank's device)`` where the next rank is this process's
own (a no-op where ranks share a device, as in ``make_mesh(MeshPlan(
dp=1, sp=4), ["cuda:0"] * 4)``), through the process group
(``parallel/process_group.py``) where it is another process's.  The
moves of step i+1 are posted before step i's partials run and waited on
after them, so a transfer between processes overlaps the compute.

``striped=True`` selects the load-balanced layout (tokens interleave
across ranks via :func:`stripe`/:func:`unstripe`; every step's causal
mask is a near-uniform band).  Two step bodies:

* ``impl="einsum"``: the full Tq x Tk product plus a ``where`` mask,
  in float32 (:func:`_ring_attention_local`);
* ``impl="flash"``: each step is the mask-aware partial of
  ``ops/ring_flash_cuda.py`` — the kernel ``csrc/ring_partial.cu`` on
  CUDA tensors, its plain version on CPU tensors — merged across steps
  by log-sum-exp (:func:`_ring_attention_local_flash`).  A contiguous
  step whose keys all lie in the future launches nothing.

``impl="auto"`` follows the device of the mesh, not a backend probe:
the flash body (the kernel) on CUDA, the einsum body on the CPU, as
the reference's ``auto`` picks einsum off the TPU
(:func:`resolve_auto_impl`).  There is no VMEM-style length cap.  The
reference's ``interpret`` (Pallas interpret mode) and its kernel tiling
knobs ``q_block`` and ``kv_chunk`` have no counterpart.

``head_axis`` (``"tp"``) cuts the heads too, the reference's tp x sp
composition: H and Hkv divide by the same degree, which keeps the GQA
group, and each head shard runs its own ring over the ranks of its tp
index.  Ranks along an axis the ring does not use (``pp``, ``ep``, and
``tp`` without ``head_axis``) hold replicas and would compute the same
thing; the controller runs the ring once, on their index 0.  On a mesh
of several processes (``parallel.mesh.make_hybrid_mesh``) any axis may
cross processes: the ring, batch and head axes cut the work, and each
process along a replica axis runs the rings of its own replica.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from llm_d_kv_cache_manager_tpu_torch.ops.ring_flash import (
    NEG_INF,
    merge_partials,
    neutral_partial,
    normalize_partial,
)
from llm_d_kv_cache_manager_tpu_torch.ops.ring_flash_cuda import flash_partial_cuda
from llm_d_kv_cache_manager_tpu_torch.ops.tile_plan import check_head_dim
from llm_d_kv_cache_manager_tpu_torch.parallel.mesh import AXIS_DP, AXIS_SP, AXIS_TP, Mesh
from llm_d_kv_cache_manager_tpu_torch.parallel.process_group import MeshTransport, transport
from llm_d_kv_cache_manager_tpu_torch.parallel.sharding import P, Sharded

_IMPLS = ("auto", "einsum", "flash")

Chunks = Dict[int, torch.Tensor]


class Ring:
    """The ranks of one ring: ``devices[r]`` and ``processes[r]`` of
    ring rank r, and ``local``, the ranks of this process (``process``),
    in ring order.  ``transport`` moves a chunk between ranks of two
    processes; a ring of one process has none."""

    def __init__(self, devices: Sequence[torch.device],
                 processes: Optional[Sequence[int]] = None, process: int = 0,
                 transport: Optional[MeshTransport] = None) -> None:
        self.devices = list(devices)
        self.processes = [process] * len(self.devices) if processes is None else list(processes)
        self.process = process
        self.local = [r for r, p in enumerate(self.processes) if p == process]
        self.transport = transport
        if transport is None and len(self.local) != len(self.devices):
            raise ValueError("a ring over several processes needs their transport")

    @property
    def size(self) -> int:
        return len(self.devices)

    def rotate(self, k: Chunks, v: Chunks) -> Callable[[], Tuple[Chunks, Chunks]]:
        """Post the move of every local rank's K/V chunk one rank on
        (the reference's ``ppermute`` j -> j+1); the returned callable
        waits and gives the chunks each local rank holds next.  Sends
        and receives between two processes are listed in the order of
        the sending rank on both sides, and tagged by it."""
        R = self.size
        sends, recvs, keys = [], [], []
        for r in self.local:
            dst = (r + 1) % R
            if self.processes[dst] != self.process:
                for j, x in enumerate((k[r], v[r])):
                    sends.append((self.processes[dst], x, 2 * r + j))
        for r in sorted(self.local, key=lambda r: (r - 1) % R):
            src = (r - 1) % R
            if self.processes[src] != self.process:
                for j, x in enumerate((k[r], v[r])):
                    recvs.append((self.processes[src], tuple(x.shape), x.dtype,
                                  self.devices[r], 2 * src + j))
                    keys.append((r, j))
        pending = self.transport.post(sends, recvs) if sends or recvs else None

        def wait() -> Tuple[Chunks, Chunks]:
            received = dict(zip(keys, pending.wait() if pending is not None else []))
            k_next, v_next = {}, {}
            for r in self.local:
                src = (r - 1) % R
                if self.processes[src] == self.process:
                    k_next[r], v_next[r] = k[src].to(self.devices[r]), v[src].to(self.devices[r])
                else:
                    k_next[r], v_next[r] = received[r, 0], received[r, 1]
            return k_next, v_next

        return wait


def _ring_driver(states: Dict[int, object], k_chunks: Chunks, v_chunks: Chunks, ring: Ring,
                 accumulate: Callable) -> Dict[int, object]:
    """Ring skeleton shared by both step bodies.  ``states[r]`` is local
    rank r's state; at step i rank r holds the K/V chunk of rank
    ``(r - i) % R`` and folds it in with ``accumulate(r, state, src,
    k_cur, v_cur)``, while the moves that give it step i+1's chunk are
    in flight.  The last chunk accumulates outside the loop (no wasted
    final rotation)."""
    R = ring.size
    k_cur, v_cur = dict(k_chunks), dict(v_chunks)
    for i in range(R - 1):
        wait = ring.rotate(k_cur, v_cur)
        for r in ring.local:
            states[r] = accumulate(r, states[r], (r - i) % R, k_cur[r], v_cur[r])
        k_cur, v_cur = wait()
    for r in ring.local:
        states[r] = accumulate(r, states[r], (r - (R - 1)) % R, k_cur[r], v_cur[r])
    return states


def _ring_attention_local(q_chunks: Chunks, k_chunks: Chunks, v_chunks: Chunks, ring: Ring,
                          striped: bool = False) -> Chunks:
    """Einsum body.  Local rank r's chunks: q [B, T_local, H, D], k/v
    [B, T_local, Hkv, D] on ``ring.devices[r]``; causal over the global
    sequence.  Returns each local rank's output.

    ``striped=False``: chunk r holds positions [r*T_local, (r+1)*T_local).
    ``striped=True``: chunk r holds the stripe {t : t % R == r} in
    ascending order, so local row a on chunk c is global position
    a*R + c and the mask is the band ``b <= a - (src > my_idx)``."""
    first = ring.local[0]
    B, Tq, H, D = q_chunks[first].shape
    Tk, Hkv = k_chunks[first].shape[1], k_chunks[first].shape[2]
    groups = H // Hkv

    qfs = {r: q.float().reshape(B, Tq, Hkv, groups, D) * (D**-0.5) for r, q in q_chunks.items()}

    def init(qf):
        zero = torch.zeros((B, Hkv, groups, Tq), device=qf.device)
        return torch.zeros_like(qf), zero + NEG_INF, zero

    def accumulate(my_idx, state, src, k_cur, v_cur):
        o, m, l = state
        qf = qfs[my_idx]
        dev = qf.device
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_cur.float())
        rows = torch.arange(Tq, device=dev)[:, None]
        cols = torch.arange(Tk, device=dev)[None, :]
        if striped:
            # Query a*R + my_idx vs key b*R + src:
            # b*R + src <= a*R + my_idx  <=>  b <= a - (src > my_idx).
            mask = cols <= rows - int(src > my_idx)
        else:
            mask = src * Tk + cols <= my_idx * Tq + rows
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        # Keep exp() away from the sentinel when a chunk is fully masked.
        m_safe = torch.clamp(m_new, min=0.5 * NEG_INF)
        scale = torch.exp(torch.clamp(m, min=0.5 * NEG_INF) - m_safe)
        p = torch.where(mask, torch.exp(scores - m_safe[..., None]), 0.0)
        l = l * scale + p.sum(dim=-1)
        o = o * scale.permute(0, 3, 1, 2)[..., None] + torch.einsum(
            "bhgqk,bkhd->bqhgd", p, v_cur.float()
        )
        return o, m_new, l

    states = _ring_driver({r: init(qf) for r, qf in qfs.items()}, k_chunks, v_chunks, ring,
                          accumulate)
    outs = {}
    for r, (o, _, l) in states.items():
        l = torch.clamp(l, min=1e-20)
        o = o / l.permute(0, 3, 1, 2)[..., None]
        outs[r] = o.reshape(B, Tq, H, D).to(q_chunks[r].dtype)
    return outs


def _ring_attention_local_flash(q_chunks: Chunks, k_chunks: Chunks, v_chunks: Chunks,
                                ring: Ring, striped: bool = False) -> Chunks:
    """Mask-aware body: each ring step is one partial
    (:func:`flash_partial_cuda`) whose key loop stops at the causal
    diagonal, merged into the rank's state by log-sum-exp.

    * striped — every step is a causal band: offset 0 for keys from
      ranks at or before me, -1 for keys from behind me in the ring
      (one global position later at equal local rows);
    * contiguous — a step is fully visible (src < me, no mask),
      diagonal (src == me, offset 0) or fully masked (src > me), which
      launches nothing: merging the neutral partial is the identity.

    GQA: the partial reads KV head ``h // (H // Hkv)``, so q/k/v arrive
    as the model's ``_qkv`` makes them."""

    def accumulate(my_idx, state, src, k_cur, v_cur):
        q = q_chunks[my_idx]
        if striped:
            offset = -1 if src > my_idx else 0
        elif src > my_idx:
            return state
        else:
            offset = 0 if src == my_idx else None
        return merge_partials(
            state, flash_partial_cuda(q, k_cur, v_cur, causal_offset=offset)
        )

    states = _ring_driver({r: neutral_partial(q) for r, q in q_chunks.items()},
                          k_chunks, v_chunks, ring, accumulate)
    return {r: normalize_partial(acc, l, q_chunks[r].dtype) for r, (acc, _, l) in states.items()}


def stripe(x: torch.Tensor, ring_size: int, axis: int = 1) -> torch.Tensor:
    """Permute a sequence axis into the striped ring layout: global
    token t goes to chunk t % ring_size, slot t // ring_size — so that
    cutting the result contiguously over the ring gives each rank an
    interleaved stripe.  Static permutation."""
    T = x.shape[axis]
    if T % ring_size:
        raise ValueError(f"sequence {T} not divisible by ring {ring_size}")
    idx = np.arange(T).reshape(T // ring_size, ring_size).T.reshape(-1)
    return torch.index_select(x, axis, torch.as_tensor(idx, device=x.device))


def unstripe(x: torch.Tensor, ring_size: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`stripe` — which is itself a stripe with the
    complementary factor (the permutation t -> (t % R)*(T/R) + t//R is
    inverted by the same map with R' = T/R)."""
    T = x.shape[axis]
    if T % ring_size:
        raise ValueError(f"sequence {T} not divisible by ring {ring_size}")
    return stripe(x, T // ring_size, axis=axis)


def _rings(mesh: Mesh, axis_name: str, batch_axis: Optional[str],
           head_axis: Optional[str]) -> np.ndarray:
    """The mesh's coordinates as [batch shards, head shards, ring ranks],
    at this process's first index on every other axis (replicas of the
    same computation: index 0 on a mesh of one process; across processes
    each process along a replica axis runs its own replica's rings)."""
    names = mesh.axis_names
    used = [axis_name, batch_axis, head_axis]
    for a in used:
        if a is not None and a not in names:
            raise ValueError(f"mesh has no axis {a!r} (axes {names})")
    if len({a for a in used if a is not None}) != sum(a is not None for a in used):
        raise ValueError(f"ring, batch and head axes must differ, got {used}")
    first = next(c for c in np.ndindex(mesh.devices.shape) if mesh.is_local(c))
    coords = np.empty(mesh.devices.shape, dtype=object)
    for coord in np.ndindex(coords.shape):
        coords[coord] = coord
    index = tuple(slice(None) if a in used else first[k] for k, a in enumerate(names))
    kept = [a for a in names if a in used]
    order = [kept.index(a) for a in (batch_axis, head_axis, axis_name) if a is not None]
    return np.transpose(coords[index], order).reshape(
        mesh.size(batch_axis) if batch_axis else 1,
        mesh.size(head_axis) if head_axis else 1, mesh.shape[axis_name])


def ring_of(mesh: Mesh, coords: Sequence[Tuple[int, ...]]) -> Ring:
    """The :class:`Ring` over the mesh entries at ``coords``, in ring
    order, with the mesh's transport where they span processes."""
    processes = [mesh.process_of(c) for c in coords]
    return Ring([mesh.devices[c] for c in coords], processes, mesh.process,
                transport(mesh) if len(set(processes)) > 1 else None)


def resolve_auto_impl(mesh_platform: str, local_kv_tokens: int, head_dim: int,
                      dtype_bytes: int, interpret: bool = False) -> str:
    """The step body ``impl="auto"`` resolves to, as a pure function of
    the reference's arguments: ``"flash"`` where the partial kernel runs
    (a ``"cuda"`` mesh), the reference's ``"einsum"`` elsewhere.

    On CUDA a ``head_dim`` outside the kernel's ``HEAD_DIMS`` (a multiple
    of 16 from 32 to 256, ``ops/tile_plan.py``) raises, as
    the kernel does; it never gives way to the plain version.  The
    kernel streams K/V from device memory, so no chunk length or element
    width caps it: ``local_kv_tokens`` and ``dtype_bytes`` (the
    reference's VMEM bound) do not enter.  ``interpret=True`` asks for
    the flash body anywhere, as in the reference; on CPU tensors its
    partials run the kernel's plain version."""
    del local_kv_tokens, dtype_bytes
    if interpret:
        return "flash"
    if mesh_platform != "cuda":
        return "einsum"
    check_head_dim("the ring partial kernel", head_dim)
    return "flash"


_BODIES = {"einsum": _ring_attention_local, "flash": _ring_attention_local_flash}


def ring_body(impl: str, platform: str) -> Callable:
    """The step body ``(q_chunks, k_chunks, v_chunks, ring, striped)
    -> out_chunks`` that ``impl`` names on a mesh of ``platform``
    (``"auto"``: :func:`resolve_auto_impl` on the chunks' shape, the
    kernel's body on CUDA, the einsum body elsewhere); the chunks are
    {local ring rank: tensor}."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown ring impl {impl!r}")
    if impl != "auto":
        return _BODIES[impl]

    def auto(q_chunks: Chunks, k_chunks: Chunks, v_chunks: Chunks, ring: Ring,
             striped: bool = False) -> Chunks:
        k = k_chunks[ring.local[0]]
        resolved = resolve_auto_impl(platform, k.shape[1], k.shape[-1], k.element_size())
        return _BODIES[resolved](q_chunks, k_chunks, v_chunks, ring, striped=striped)

    return auto


def ring_attention_sharded(
    mesh: Mesh,
    axis_name: str = AXIS_SP,
    batch_axis: Optional[str] = AXIS_DP,
    head_axis: Optional[str] = None,
    striped: bool = False,
    impl: str = "auto",
):
    """Returns a callable ``(q, k, v) -> out`` over [B, T, H(kv), D]
    tensors: T is cut into one chunk per rank of ``axis_name``, B into
    one shard per index of ``batch_axis`` and, with ``head_axis``, H and
    Hkv into one shard per index of that axis; each chunk is made
    contiguous (the kernel requires it) and placed on its rank's device,
    and each (batch, head) shard runs its ring.

    On a mesh of one process the output comes back in one [B, T, H, D]
    tensor on q's device.  On a mesh of several processes every process
    passes the same q/k/v, cuts and places only its own ranks' chunks,
    and gets back only their outputs: a
    :class:`~llm_d_kv_cache_manager_tpu_torch.parallel.sharding.Sharded`
    of the [B, T, H, D] output, spec ``P(batch_axis, axis_name,
    head_axis)``, whose locals at other processes' entries are None.

    ``striped=True`` expects q/k/v already in the :func:`stripe` layout
    and returns output in it.  RoPE must be applied before striping (or
    with striped positions).  ``impl``: ``"auto"`` (the kernel on CUDA,
    einsum on the CPU), ``"flash"`` or ``"einsum"``."""
    rings = _rings(mesh, axis_name, batch_axis, head_axis)
    n_batch, n_heads, ring_size = rings.shape
    local = [c for c in np.ndindex(mesh.devices.shape) if mesh.is_local(c)]
    body = ring_body(impl, mesh.devices[local[0]].type)
    names = mesh.axis_names

    def run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Union[torch.Tensor, Sharded]:
        B, T, H = q.shape[:3]
        Hkv = k.shape[2]
        if B % n_batch or T % ring_size or H % n_heads or Hkv % n_heads:
            raise ValueError(
                f"[B={B}, T={T}, H={H}, Hkv={Hkv}] does not divide over {n_batch} batch "
                f"shards x {ring_size} ring ranks x {n_heads} head shards"
            )
        b_loc, t_loc, h_loc, hkv_loc = B // n_batch, T // ring_size, H // n_heads, Hkv // n_heads
        outs = {}
        for d in range(n_batch):
            for h in range(n_heads):
                ring = ring_of(mesh, list(rings[d, h]))

                def cut(x, width):
                    x = x[d * b_loc : (d + 1) * b_loc, :, h * width : (h + 1) * width]
                    return {r: x[:, r * t_loc : (r + 1) * t_loc].contiguous().to(ring.devices[r])
                            for r in ring.local}

                if ring.local:
                    for r, out in body(cut(q, h_loc), cut(k, hkv_loc), cut(v, hkv_loc), ring,
                                       striped=striped).items():
                        outs[d, h, r] = out
        if not mesh.multi_process:
            return torch.cat([torch.cat([torch.cat([outs[d, h, r].to(q.device)
                                                    for r in range(ring_size)], dim=1)
                                         for h in range(n_heads)], dim=2)
                              for d in range(n_batch)], dim=0)
        spec = P(batch_axis, axis_name, head_axis)
        locals_ = np.empty(mesh.devices.shape, dtype=object)
        for coord in local:
            at = {a: coord[names.index(a)] if a else 0 for a in (batch_axis, head_axis)}
            out = outs[at[batch_axis], at[head_axis], coord[names.index(axis_name)]]
            locals_[coord] = out.to(mesh.devices[coord])
        return Sharded(mesh, spec, (B, T, H, q.shape[3]), q.dtype, locals_)

    return run


def ring_for_mesh(sp_mesh: Mesh, striped: bool = False, impl: str = "auto"):
    """Model-layer convenience, gated as in the reference: the ring over
    ``sp``, with the batch on ``dp`` and the heads on ``tp`` where those
    axes have degree > 1.  On a mesh of several processes its callable
    returns this process's outputs (see :func:`ring_attention_sharded`)."""

    def axis_if_used(name):
        return name if sp_mesh.size(name) > 1 else None

    return ring_attention_sharded(sp_mesh, batch_axis=axis_if_used(AXIS_DP),
                                  head_axis=axis_if_used(AXIS_TP), striped=striped, impl=impl)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis_name: str = AXIS_SP,
    batch_axis: Optional[str] = AXIS_DP,
    striped: bool = False,
    impl: str = "auto",
) -> Union[torch.Tensor, Sharded]:
    """Eager convenience: run the ring over q/k/v ([B, T, H, D], T cut
    over ``axis_name``, B over ``batch_axis``).  With ``striped=True``
    the inputs and output are in PHYSICAL token order — this stripes
    them in, runs the balanced ring, and unstripes the output.  On a
    mesh of several processes it returns this process's outputs, as
    :func:`ring_attention_sharded` does, and takes only the contiguous
    layout (a rank's striped rows are not a block of the physical
    order)."""
    ring_size = mesh.shape[axis_name]
    if striped and mesh.multi_process:
        raise ValueError("on a mesh of several processes ring_attention returns each "
                         "process's chunks, which the striped layout leaves in stripe order: "
                         "use ring_attention_sharded over stripe()d inputs")
    if striped:
        q, k, v = (stripe(x, ring_size) for x in (q, k, v))
    out = ring_attention_sharded(mesh, axis_name, batch_axis, striped=striped,
                                 impl=impl)(q, k, v)
    if striped:
        out = unstripe(out, ring_size)
    return out
