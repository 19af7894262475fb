"""The elementwise stages of a transformer layer, one launch each: the
Hopper kernels and their plain versions.

The inference paths of ``models/llama.py`` (``prefill_paged``,
``prefill_continue``, ``prefill_chunked``, ``decode_step``) take these
in place of the op-by-op chains that training keeps (``_rms_norm``,
``_rope`` with the pool scatter, the MLP's SiLU gate), which are this
module's plain versions (:func:`rms_norm_plain`, :func:`rope_plain`,
:func:`write_kv_slots`, :func:`silu_mul_plain`):

- :func:`rms_norm_fused`: RMSNorm with eps :data:`EPS`, float32 inside;
- :func:`rope_kv_fused`: RoPE of q and k, and k and v written into
  their pool slots (and, where asked, out contiguously for attention);
  its frequencies are :func:`rope_freqs`'s or, on a model's YaRN layers,
  :func:`yarn_freqs`', and ``scale`` multiplies cos and sin (YaRN's
  attention factor);
- :func:`silu_mul_fused`: ``silu(gate)`` rounded, times ``up``.

They replace no TPU kernel (the reference leaves these chains to XLA,
which fuses them); the kernels, ``csrc/layer_fused.cu``, are CUDA C++ for
``sm_90a``, and its header note says what bounds them and what their
design does about it.  Each wrapper launches its kernel for CUDA tensors
and takes its plain version only for CPU tensors; there is no fallback.
The kernels are forward-only: on any device but the CPU, grad mode with
an input that requires grad raises before the launch.  Every launch adds
one to the wrapper's ``launches``.  Nothing is built at import; a call
never waits for the device, so the decode step captures them in its CUDA
graph.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from llm_d_kv_cache_manager_tpu_torch.ops import _build
from llm_d_kv_cache_manager_tpu_torch.ops.tile_plan import check_head_dim

EPS = 1e-6  # the port's RMSNorm eps, as models/llama.py:_rms_norm has it
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The library, built on first use, its entry points declared once."""
    lib = _build.library("layer_fused")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.rms_norm.argtypes = [ptr] * 3 + [i64, i32, ctypes.c_float, i32, ptr]
    lib.rope_kv.argtypes = [ptr] * 10 + [i64] + [i32] * 5 + [i64, ctypes.c_float, i32, i32,
                                                               ptr]
    lib.silu_mul.argtypes = [ptr] * 3 + [i64, i32, ptr]
    for fn in (lib.rms_norm, lib.rope_kv, lib.silu_mul):
        fn.restype = ctypes.c_int
    return lib


def _launch_checks(what: str, *tensors: torch.Tensor) -> None:
    """Off the CPU: the grad guard first, then one CUDA device, a dtype
    the kernels take, contiguity."""
    _build.refuse_grad(what, *tensors)
    if tensors[0].device.type != "cuda":
        raise ValueError(f"unsupported device {tensors[0].device}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what}: all inputs must be on one device")
    for t in tensors:
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"{what}: the kernel takes bf16 or float32, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------------------------ RMSNorm


def rms_norm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``x * rsqrt(mean(x^2) + EPS) * w`` in
    float32, cast back to x's dtype."""
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + EPS)
    return (xf * r * w.float()).to(x.dtype)


def rms_norm_fused(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` ([..., D]) with weight ``w``
    ([D]) in x's dtype, float32 inside.  CUDA tensors (bf16 or float32,
    one dtype, contiguous) run one launch, one CTA a row, and add one to
    ``rms_norm_fused.launches``; CPU tensors run :func:`rms_norm_plain`."""
    if w.shape != x.shape[-1:]:
        raise ValueError(f"w {tuple(w.shape)} does not match x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return rms_norm_plain(x, w)
    _launch_checks("rms_norm_fused", x, w)
    if w.dtype != x.dtype:
        raise ValueError("rms_norm_fused: x and w must have one dtype")
    out = torch.empty_like(x)
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.rms_norm(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, D, EPS,
                          _DTYPE_CODES[x.dtype], _stream(x.device))
    _build.check(lib, "rms_norm launch", rc)
    rms_norm_fused.launches += 1
    return out


rms_norm_fused.launches = 0


# ------------------------------------------------------------------- RoPE


@functools.lru_cache(maxsize=64)
def rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """RoPE's float32 frequencies ``theta ** (-arange(D/2) / (D/2))`` on
    ``device``, made once per (head dim, theta, device)."""
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)


def yarn_freqs(head_dim: int, theta: float, factor: float, original_max_positions: int,
               beta_fast: float, beta_slow: float) -> torch.Tensor:
    """YaRN's float32 frequencies, as Hugging Face's
    ``_compute_yarn_parameters`` makes them: the interpolated frequencies
    (``rope_freqs`` / ``factor``) below the dims that turn fewer than
    ``beta_slow`` times over ``original_max_positions``, the original ones
    above the dims that turn more than ``beta_fast`` times, and a linear
    ramp between (the correction range, floor and ceiling).  On the CPU;
    callers move it once.  The attention factor is the caller's
    ``scale``."""

    def dim_of(turns: float) -> float:
        return (head_dim * math.log(original_max_positions / (turns * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(dim_of(beta_fast)), 0)
    high = min(math.ceil(dim_of(beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    half = head_dim // 2
    pos_freqs = theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim)
    extrapolation = 1.0 / pos_freqs
    interpolation = 1.0 / (factor * pos_freqs)
    ramp = torch.clamp((torch.arange(half, dtype=torch.float32) - low) / (high - low), 0, 1)
    keep = 1 - ramp  # the share of the original frequency
    return interpolation * (1 - keep) + extrapolation * keep


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1).to(x.dtype)


def rope_plain(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor,
               scale: float = 1.0) -> torch.Tensor:
    """RoPE of ``x`` ([B, T, H, D]) at ``positions`` ([B, T]): the angles
    ``float(position) * freqs`` in float32, cos and sin times ``scale``,
    x rotated in float32 and cast back to its dtype."""
    angles = positions[..., None].float() * freqs  # [B, T, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if scale != 1.0:
        cos, sin = cos * scale, sin * scale
    return _rotate(x, cos[:, :, None, :], sin[:, :, None, :])


def write_kv_slots(kv_layer: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   slots: torch.Tensor) -> None:
    """Write ``k`` and ``v`` ([B, T, Hkv, Dh]) IN PLACE into their pool
    slots (``slots`` [B, T], ``block id * block_size + offset``) of
    ``kv_layer`` ([num_blocks, 2, block_size, Hkv, Dh]), in its dtype."""
    bs = kv_layer.shape[2]
    flat = slots.reshape(-1).long()
    blk, at = flat // bs, flat % bs
    kv_layer[blk, 0, at] = k.reshape((-1,) + k.shape[2:]).to(kv_layer.dtype)
    kv_layer[blk, 1, at] = v.reshape((-1,) + v.shape[2:]).to(kv_layer.dtype)


def rope_kv_plain(q, k, v, positions, freqs, kv_layer, slots, k_out=None, v_out=None,
                  scale: float = 1.0):
    """The plain PyTorch version of :func:`rope_kv_fused`."""
    q_rot = rope_plain(q, positions, freqs, scale)
    k_rot = rope_plain(k, positions, freqs, scale)
    write_kv_slots(kv_layer, k_rot, v, slots)
    if k_out is not None:
        k_out.copy_(k_rot)
    if v_out is not None:
        v_out.copy_(v)
    return q_rot


def _check_rope(q, k, v, positions, freqs, kv_layer, slots, k_out, v_out):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,T,H,Dh] and k/v [B,T,Hkv,Dh], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, _, Dh = q.shape
    Hkv = k.shape[2]
    if k.shape[:2] != (B, T) or k.shape[3] != Dh or Dh % 2:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree, or Dh is odd")
    if tuple(positions.shape) != (B, T) or tuple(slots.shape) != (B, T):
        raise ValueError(f"positions and slots must be [B, T] = {(B, T)}, got "
                         f"{tuple(positions.shape)}, {tuple(slots.shape)}")
    if tuple(freqs.shape) != (Dh // 2,) or freqs.dtype != torch.float32:
        raise ValueError(f"freqs must be float32 [{Dh // 2}], got {freqs.dtype} "
                         f"{tuple(freqs.shape)}")
    if kv_layer.dim() != 5 or kv_layer.shape[1] != 2 or kv_layer.shape[3:] != (Hkv, Dh):
        raise ValueError(f"kv_layer must be [num_blocks, 2, block_size, {Hkv}, {Dh}], got "
                         f"{tuple(kv_layer.shape)}")
    for name, out in (("k_out", k_out), ("v_out", v_out)):
        if out is not None and (out.shape != k.shape or out.dtype != k.dtype):
            raise ValueError(f"{name} must be {k.dtype} {tuple(k.shape)}, got {out.dtype} "
                             f"{tuple(out.shape)}")


def _token_rows(out: torch.Tensor) -> Optional[int]:
    """The batch stride of ``out`` ([B, T, Hkv, Dh]) in elements where
    each sequence's rows are contiguous (a slice of a longer sequence
    axis, as a continuation's K/V tail is), else None."""
    B, T, Hkv, Dh = out.shape
    s = out.stride()
    if s[3] == 1 and s[2] == Dh and s[1] == Hkv * Dh and (B == 1 or s[0] >= T * Hkv * Dh):
        return s[0]
    return None


def rope_kv_fused(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    positions: torch.Tensor,
    freqs: torch.Tensor,
    kv_layer: torch.Tensor,
    slots: torch.Tensor,
    k_out: Optional[torch.Tensor] = None,
    v_out: Optional[torch.Tensor] = None,
    scale: float = 1.0,
) -> torch.Tensor:
    """RoPE of q and k and the pool write of k and v, in one launch.

    q: [B, T, H, Dh]; k, v: [B, T, Hkv, Dh], one dtype; positions: [B, T]
    integer; freqs: float32 [Dh / 2] (:func:`rope_freqs`); kv_layer: one
    layer of the pool, [num_blocks, 2, block_size, Hkv, Dh]; slots: [B, T]
    integer, each token's pool slot ``block id * block_size + offset``.
    Returns q rotated.  Writes rotated k and v IN PLACE into their slots
    of ``kv_layer`` (in its dtype), and, where given, into ``k_out`` and
    ``v_out`` ([B, T, Hkv, Dh] in q's dtype: each sequence's rows
    contiguous, so the tail of a longer K/V tensor will do).  The angles
    are ``float(position) * freqs`` in float32, rounded as the plain ops
    round them; cos and sin are multiplied by ``scale`` (1: exact).

    CUDA tensors run one launch (bf16 or float32, contiguous inputs, the
    attention kernels' head dims: a multiple of 16 from 32 to 256; any
    other raises ``ValueError``) and add one to ``rope_kv_fused.launches``;
    CPU tensors run :func:`rope_kv_plain`."""
    _check_rope(q, k, v, positions, freqs, kv_layer, slots, k_out, v_out)
    if q.device.type == "cpu":
        return rope_kv_plain(q, k, v, positions, freqs, kv_layer, slots, k_out, v_out, scale)
    _launch_checks("rope_kv_fused", q, k, v, freqs, kv_layer)
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("rope_kv_fused: q, k and v must have one dtype")
    B, T, H, Dh = q.shape
    Hkv = k.shape[2]
    check_head_dim("rope_kv_fused", Dh)
    positions = positions.to(q.device, torch.long).contiguous()
    slots = slots.to(q.device, torch.long).contiguous()
    stride = T * Hkv * Dh
    for name, out in (("k_out", k_out), ("v_out", v_out)):
        if out is not None:
            if out.device != q.device:
                raise ValueError(f"rope_kv_fused: {name} is not on q's device")
            got = _token_rows(out)
            if got is None:
                raise ValueError(f"rope_kv_fused: {name}'s rows are not contiguous a sequence")
            stride = got
    if k_out is not None and v_out is not None and _token_rows(k_out) != _token_rows(v_out):
        raise ValueError("rope_kv_fused: k_out and v_out must have one layout")
    q_out = torch.empty_like(q)
    if B * T == 0:
        return q_out
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.rope_kv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(), freqs.data_ptr(),
            slots.data_ptr(), q_out.data_ptr(), kv_layer.data_ptr(),
            None if k_out is None else k_out.data_ptr(),
            None if v_out is None else v_out.data_ptr(),
            B * T, T, H, Hkv, Dh, kv_layer.shape[2], stride, float(scale),
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[kv_layer.dtype], _stream(q.device))
    _build.check(lib, "rope_kv launch", rc)
    rope_kv_fused.launches += 1
    return q_out


rope_kv_fused.launches = 0


# ------------------------------------------------------------------- SiLU


def silu_mul_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``silu(gate)`` in float32, cast to the
    dtype, times ``up``."""
    return F.silu(gate.float()).to(gate.dtype) * up


def silu_mul_fused(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(float(gate))`` rounded to gate's dtype, times ``up``, in one
    pass.  CUDA tensors (bf16 or float32, one dtype and shape,
    contiguous) run one launch and add one to ``silu_mul_fused.launches``;
    CPU tensors run :func:`silu_mul_plain`."""
    if gate.shape != up.shape:
        raise ValueError(f"gate {tuple(gate.shape)} and up {tuple(up.shape)} differ")
    if gate.device.type == "cpu":
        return silu_mul_plain(gate, up)
    _launch_checks("silu_mul_fused", gate, up)
    if gate.dtype != up.dtype:
        raise ValueError("silu_mul_fused: gate and up must have one dtype")
    out = torch.empty_like(gate)
    if gate.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(gate.device):
        rc = lib.silu_mul(gate.data_ptr(), up.data_ptr(), out.data_ptr(), gate.numel(),
                          _DTYPE_CODES[gate.dtype], _stream(gate.device))
    _build.check(lib, "silu_mul launch", rc)
    silu_mul_fused.launches += 1
    return out


silu_mul_fused.launches = 0
