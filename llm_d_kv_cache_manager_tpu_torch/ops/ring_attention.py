"""Ring attention: sequence-parallel causal attention over an ``sp``
mesh axis.

Port of the reference's ``ops/ring_attention.py``.  Long-context
prefill cuts the sequence into ``sp`` chunks, one per ring rank; K/V
chunks rotate around the ring while each rank keeps an online-softmax
state for its local queries.  The reference runs that under
``shard_map`` with ``lax.ppermute``; the port is single-controller like
the reference, so :func:`_ring_driver` holds every rank's state and a
step is a rotation of the K/V chunk list by one rank, each chunk moved
with ``.to(next rank's device)`` — a no-op where ranks share a device
(``make_mesh(MeshPlan(dp=1, sp=4), ["cuda:0"] * 4)``).

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
the reference's ``auto`` picks einsum off the TPU.  There is no
VMEM-style length cap.  The reference's ``interpret`` (Pallas
interpret mode) and its kernel tiling knobs ``q_block`` and
``kv_chunk`` have no counterpart.

``head_axis`` (``"tp"``) cuts the heads too, the reference's tp x sp
composition: H and Hkv divide by the same degree, which keeps the GQA
group, and each head shard runs its own ring over the ranks of its tp
index.  Ranks along an axis the ring does not use (``pp``, ``ep``, and
``tp`` without ``head_axis``) hold replicas and would compute the same
thing; the single controller runs the ring once, on their index 0.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from llm_d_kv_cache_manager_tpu_torch.ops.ring_flash import (
    NEG_INF,
    merge_partials,
    neutral_partial,
    normalize_partial,
)
from llm_d_kv_cache_manager_tpu_torch.ops.ring_flash_cuda import (
    flash_partial_cuda,
)
from llm_d_kv_cache_manager_tpu_torch.parallel.mesh import AXIS_DP, AXIS_SP, AXIS_TP, Mesh

_IMPLS = ("auto", "einsum", "flash")


def _ring_driver(states: List, k_chunks: Sequence[torch.Tensor],
                 v_chunks: Sequence[torch.Tensor], devices: Sequence[torch.device],
                 accumulate: Callable) -> List:
    """Ring skeleton shared by both step bodies.  ``states[r]`` is rank
    r's state; at step i rank r holds the K/V chunk of rank
    ``(r - i) % R`` and folds it in with ``accumulate(r, state, src,
    k_cur, v_cur)``; then every chunk moves one rank on (the reference's
    ``ppermute`` j -> j+1).  The last chunk accumulates outside the loop
    (no wasted final rotation)."""
    R = len(states)
    k_cur, v_cur = list(k_chunks), list(v_chunks)
    for i in range(R - 1):
        for r in range(R):
            states[r] = accumulate(r, states[r], (r - i) % R, k_cur[r], v_cur[r])
        k_cur = [k_cur[(r - 1) % R].to(devices[r]) for r in range(R)]
        v_cur = [v_cur[(r - 1) % R].to(devices[r]) for r in range(R)]
    for r in range(R):
        states[r] = accumulate(r, states[r], (r - (R - 1)) % R, k_cur[r], v_cur[r])
    return states


def _ring_attention_local(q_chunks, k_chunks, v_chunks, devices, striped=False):
    """Einsum body.  Chunk r: q [B, T_local, H, D], k/v [B, T_local,
    Hkv, D] on ``devices[r]``; causal over the global sequence.

    ``striped=False``: chunk r holds positions [r*T_local, (r+1)*T_local).
    ``striped=True``: chunk r holds the stripe {t : t % R == r} in
    ascending order, so local row a on chunk c is global position
    a*R + c and the mask is the band ``b <= a - (src > my_idx)``."""
    B, Tq, H, D = q_chunks[0].shape
    Tk, Hkv = k_chunks[0].shape[1], k_chunks[0].shape[2]
    groups = H // Hkv

    qfs = [q.float().reshape(B, Tq, Hkv, groups, D) * (D**-0.5) for q in q_chunks]

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

    states = _ring_driver([init(qf) for qf in qfs], k_chunks, v_chunks, devices, accumulate)
    outs = []
    for (o, _, l), q in zip(states, q_chunks):
        l = torch.clamp(l, min=1e-20)
        o = o / l.permute(0, 3, 1, 2)[..., None]
        outs.append(o.reshape(B, Tq, H, D).to(q.dtype))
    return outs


def _ring_attention_local_flash(q_chunks, k_chunks, v_chunks, devices, striped=False):
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

    states = _ring_driver([neutral_partial(q) for q in q_chunks],
                          k_chunks, v_chunks, devices, accumulate)
    return [normalize_partial(acc, l, q.dtype) for (acc, _, l), q in zip(states, q_chunks)]


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
    """The mesh's devices as [batch shards, head shards, ring ranks],
    index 0 on every other axis (replicas of the same computation)."""
    names = mesh.axis_names
    used = [axis_name, batch_axis, head_axis]
    for a in used:
        if a is not None and a not in names:
            raise ValueError(f"mesh has no axis {a!r} (axes {names})")
    if len({a for a in used if a is not None}) != sum(a is not None for a in used):
        raise ValueError(f"ring, batch and head axes must differ, got {used}")
    index = tuple(slice(None) if a in used else 0 for a in names)
    kept = [a for a in names if a in used]
    order = [kept.index(a) for a in (batch_axis, head_axis, axis_name) if a is not None]
    devices = np.transpose(mesh.devices[index], order)
    return devices.reshape(mesh.size(batch_axis) if batch_axis else 1,
                           mesh.size(head_axis) if head_axis else 1, mesh.shape[axis_name])


def ring_body(impl: str, platform: str) -> Callable:
    """The step body ``(q_chunks, k_chunks, v_chunks, devices, striped)
    -> out_chunks`` that ``impl`` names on a mesh of ``platform``
    (``"auto"``: the kernel's body on CUDA, the einsum body elsewhere)."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown ring impl {impl!r}")
    resolved = impl if impl != "auto" else ("flash" if platform == "cuda" else "einsum")
    return _ring_attention_local_flash if resolved == "flash" else _ring_attention_local


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
    each (batch, head) shard runs its ring, and the output comes back in
    one [B, T, H, D] tensor on q's device.

    ``striped=True`` expects q/k/v already in the :func:`stripe` layout
    and returns output in it.  RoPE must be applied before striping (or
    with striped positions).  ``impl``: ``"auto"`` (the kernel on CUDA,
    einsum on the CPU), ``"flash"`` or ``"einsum"``."""
    rings = _rings(mesh, axis_name, batch_axis, head_axis)
    n_batch, n_heads, ring_size = rings.shape
    body = ring_body(impl, rings[0, 0, 0].type)

    def run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        B, T, H = q.shape[:3]
        Hkv = k.shape[2]
        if B % n_batch or T % ring_size or H % n_heads or Hkv % n_heads:
            raise ValueError(
                f"[B={B}, T={T}, H={H}, Hkv={Hkv}] does not divide over {n_batch} batch "
                f"shards x {ring_size} ring ranks x {n_heads} head shards"
            )
        b_loc, t_loc, h_loc, hkv_loc = B // n_batch, T // ring_size, H // n_heads, Hkv // n_heads
        shards = []
        for d in range(n_batch):
            heads = []
            for h in range(n_heads):
                devices = list(rings[d, h])

                def cut(x, width):
                    x = x[d * b_loc : (d + 1) * b_loc, :, h * width : (h + 1) * width]
                    return [
                        x[:, r * t_loc : (r + 1) * t_loc].contiguous().to(devices[r])
                        for r in range(ring_size)
                    ]

                outs = body(cut(q, h_loc), cut(k, hkv_loc), cut(v, hkv_loc), devices,
                            striped=striped)
                heads.append(torch.cat([o.to(q.device) for o in outs], dim=1))
            shards.append(torch.cat(heads, dim=2))
        return torch.cat(shards, dim=0)

    return run


def ring_for_mesh(sp_mesh: Mesh, striped: bool = False, impl: str = "auto"):
    """Model-layer convenience, gated as in the reference: the ring over
    ``sp``, with the batch on ``dp`` and the heads on ``tp`` where those
    axes have degree > 1."""

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
) -> torch.Tensor:
    """Eager convenience: run the ring over q/k/v ([B, T, H, D], T cut
    over ``axis_name``, B over ``batch_axis``).  With ``striped=True``
    the inputs and output are in PHYSICAL token order — this stripes
    them in, runs the balanced ring, and unstripes the output."""
    ring_size = mesh.shape[axis_name]
    if striped:
        q, k, v = (stripe(x, ring_size) for x in (q, k, v))
    out = ring_attention_sharded(mesh, axis_name, batch_axis, striped=striped,
                                 impl=impl)(q, k, v)
    if striped:
        out = unstripe(out, ring_size)
    return out
