"""The routed-expert MLP of a mixture-of-experts layer, dropless: the
Hopper kernels and their plain version.

``x + sum over each token's top-k experts e of (p_e / sum of its top-k
p) * W_down,e(SiLU(W_gate,e h) * W_up,e h)``, with ``p = softmax(W_router
h)`` in float32 over all experts (the weights divided by their sum where
``norm_topk`` is set, as Mixtral's and Mellum's ``norm_topk_prob``).
Every token's top-k experts are computed: no capacity, no token dropped.
``models/moe.py`` keeps the JAX reference's capacity routing for its
training forward; the serving path (``models/llama.py`` with
``n_experts``) takes this one.

:func:`routed_experts_fused` launches, for CUDA tensors,
``csrc/moe_experts.cu``: the route (router logits, softmax, top k), the
grouping of the routed rows expert by expert (offsets on the device, and
the counters below), the experts' products, and the combine with the
residual.  Up to :data:`GROUPED_MAX_ROWS` routed rows (decode, a short
prefill), and whatever the rows while a CUDA graph is being captured, the
experts run in the grouped kernels, with no host sync, so a graph captures
the whole layer; above it (a prefill's thousands of rows an expert) the
host reads the offsets and each expert's rows go through three matrix
products (``torch.mm`` over the grouped rows, gate and up out in float32)
and the fused SiLU·up of ``ops/layer_fused.py``.  The grouped kernels
multiply on CUDA cores, 8 rows a pass over an expert's weights: on an
H100 one Mellum layer's experts take 1.9 ms by them at 128 tokens (4.3 by
the products, host sync included) and 219 ms at 16,384 tokens (5.2 by the
products); ``chip_smoke.py`` phase 4c times both.  CPU tensors run
:func:`routed_experts_plain`.  There is no fallback.  The kernels are
forward-only.  Each launch adds one to its wrapper's ``launches``.
Nothing is built at import.

Device counters (int64, one set per path and device, made on first use
and added to by every grouping launch, inside a captured graph too):
:data:`COUNTER_FIELDS`.  :func:`read_counters` reads them (one sync).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from llm_d_kv_cache_manager_tpu_torch.obs.trace import profiler_range
from llm_d_kv_cache_manager_tpu_torch.ops import _build
from llm_d_kv_cache_manager_tpu_torch.ops.layer_fused import silu_mul_fused

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_EXPERTS = 256  # kMaxExperts in csrc/moe_experts.cu
# Routed rows (tokens x k) up to which the grouped kernels compute the
# experts; above, per-expert matrix products over the grouped rows
# (except under graph capture, which cannot wait for the offsets).
GROUPED_MAX_ROWS = 1024
# What the grouping kernel adds to a path's counters at each launch.
COUNTER_FIELDS = ("routed_rows", "distinct_experts", "dropped_rows", "calls")
_COUNTERS: Dict[Tuple[str, str], torch.Tensor] = {}


def counters(path: str, device: torch.device) -> torch.Tensor:
    """The int64 counters of ``path`` ("decode", "prefill") on ``device``,
    zeros when first asked for; the same tensor for the life of the
    process, so a captured graph adds to it at every replay."""
    key = (path, str(device))
    got = _COUNTERS.get(key)
    if got is None:
        got = _COUNTERS[key] = torch.zeros(len(COUNTER_FIELDS), dtype=torch.int64,
                                           device=device)
    return got


def read_counters(path: str) -> Optional[Dict[str, int]]:
    """``path``'s counters summed over devices, or None where no launch
    has made them (the CPU path keeps none)."""
    found = [t for (p, _), t in _COUNTERS.items() if p == path]
    if not found:
        return None
    total = sum(t.cpu() for t in found)
    return dict(zip(COUNTER_FIELDS, (int(v) for v in total.tolist())))


# ------------------------------------------------------------------ plain


def route_plain(h: torch.Tensor, w_router: torch.Tensor, top_k: int,
                norm_topk: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids int32 [N, k], weights float32 [N, k]): the top k of the
    float32 softmax of ``h @ w_router`` ([N, D] @ [D, E]), largest first,
    the weights divided by their sum where ``norm_topk``."""
    probs = torch.softmax(h.float() @ w_router.float(), dim=-1)
    wts, ids = torch.topk(probs, top_k, dim=-1)
    if norm_topk:
        wts = wts / wts.sum(dim=-1, keepdim=True)
    return ids.to(torch.int32), wts


def combine_plain(x: torch.Tensor, y: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """x [N, D] plus, slot by slot in order, wts [N, k] times y [N, k, D],
    in float32, rounded once to x's dtype."""
    acc = x.float()
    for s in range(wts.shape[1]):
        acc = acc + wts[:, s:s + 1] * y[:, s].float()
    return acc.to(x.dtype)


def routed_experts_plain(x, h, w_router, w_gate, w_up, w_down, top_k: int,
                         norm_topk: bool) -> torch.Tensor:
    """The plain PyTorch version the kernels are held against, with their
    roundings: each routed row's SiLU(gate) * up in float32 rounded once
    to the working type, its down product likewise, then the combine.
    x, h: [N, D]; w_router [D, E]; w_gate, w_up [E, D, F]; w_down [E, F,
    D].  Returns x + the layer's MLP output, [N, D] in x's dtype."""
    ids, wts = route_plain(h, w_router, top_k, norm_topk)
    N, D = h.shape
    y = torch.zeros((N, top_k, D), dtype=x.dtype, device=x.device)
    for e in torch.unique(ids).tolist():
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        rows = h[tok].float()
        hidden = (F.silu(rows @ w_gate[e].float()) * (rows @ w_up[e].float())).to(x.dtype)
        y[tok, slot] = (hidden.float() @ w_down[e].float()).to(x.dtype)
    return combine_plain(x, y, wts)


def routed_experts_exact(x, h, w_gate, w_up, w_down, ids: torch.Tensor,
                         wts: torch.Tensor) -> torch.Tensor:
    """x + the layer's MLP output for the routing ``ids`` / ``wts`` in
    float64, rounded nowhere: the second witness beside
    :func:`routed_experts_plain`.  The kernels and the plain version each
    round a routed row's SiLU(gate) * up to the working type once, from
    float32 sums taken in another order, so over millions of elements a
    few hidden elements land one ulp apart between them; against this
    value each is off by its own roundings alone."""
    out = x.double().clone()
    for e in torch.unique(ids).tolist():
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        rows = h[tok].double()
        hidden = F.silu(rows @ w_gate[e].double()) * (rows @ w_up[e].double())
        y = hidden @ w_down[e].double()
        out.index_add_(0, tok, wts[tok, slot].double()[:, None] * y)
    return out


# ---------------------------------------------------------------- kernels


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("moe_experts")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.moe_route.argtypes = [ptr] * 2 + [i32] * 5 + [ptr] * 2 + [i32, ptr]
    lib.moe_group.argtypes = [ptr, i32, i32] + [ptr] * 5
    lib.moe_experts.argtypes = [ptr] * 6 + [i32] * 4 + [ptr] * 2 + [i32, ptr]
    lib.moe_combine.argtypes = [ptr] * 4 + [i32] * 3 + [ptr, i32, ptr]
    for fn in (lib.moe_route, lib.moe_group, lib.moe_experts, lib.moe_combine):
        fn.restype = ctypes.c_int
    return lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def moe_route_cuda(h: torch.Tensor, w_router: torch.Tensor, top_k: int,
                   norm_topk: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`route_plain` in one launch (one CTA a token)."""
    N, D = h.shape
    E = w_router.shape[1]
    ids = torch.empty((N, top_k), dtype=torch.int32, device=h.device)
    wts = torch.empty((N, top_k), dtype=torch.float32, device=h.device)
    lib = _lib()
    with torch.cuda.device(h.device):
        rc = lib.moe_route(h.data_ptr(), w_router.data_ptr(), N, D, E, top_k, int(norm_topk),
                           ids.data_ptr(), wts.data_ptr(), _DTYPE_CODES[h.dtype],
                           _stream(h.device))
    _build.check(lib, "moe_route launch", rc)
    moe_route_cuda.launches += 1
    return ids, wts


moe_route_cuda.launches = 0


def moe_group_cuda(ids: torch.Tensor, n_experts: int, counts: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routed rows (``ids`` [N, k] flattened) laid out expert by
    expert, in one launch: (offsets int32 [E + 1], perm int32 [P]: the
    routed row at each position, pos int32 [P]: each routed row's
    position); adds to ``counts`` (:data:`COUNTER_FIELDS`) where given."""
    P = ids.numel()
    dev = ids.device
    offsets = torch.empty((n_experts + 1,), dtype=torch.int32, device=dev)
    perm = torch.empty((P,), dtype=torch.int32, device=dev)
    pos = torch.empty((P,), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.moe_group(ids.data_ptr(), P, n_experts, offsets.data_ptr(), perm.data_ptr(),
                           pos.data_ptr(), None if counts is None else counts.data_ptr(),
                           _stream(dev))
    _build.check(lib, "moe_group launch", rc)
    moe_group_cuda.launches += 1
    return offsets, perm, pos


moe_group_cuda.launches = 0


def moe_experts_cuda(h: torch.Tensor, w_gate, w_up, w_down, offsets, perm,
                     top_k: int) -> torch.Tensor:
    """Every routed row's expert MLP, grouped: y [P, D] in h's dtype, row
    ``j`` being position ``j`` of ``perm``'s layout (two launches: gate
    and up with SiLU·up, then down)."""
    E, D, Fw = w_gate.shape
    P = perm.shape[0]
    hidden = torch.empty((P, Fw), dtype=h.dtype, device=h.device)
    y = torch.empty((P, D), dtype=h.dtype, device=h.device)
    lib = _lib()
    with torch.cuda.device(h.device):
        rc = lib.moe_experts(h.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                             w_down.data_ptr(), offsets.data_ptr(), perm.data_ptr(), top_k, E,
                             D, Fw, hidden.data_ptr(), y.data_ptr(), _DTYPE_CODES[h.dtype],
                             _stream(h.device))
    _build.check(lib, "moe_experts launch", rc)
    moe_experts_cuda.launches += 1
    return y


moe_experts_cuda.launches = 0


def moe_combine_cuda(x: torch.Tensor, y: torch.Tensor, pos: torch.Tensor,
                     wts: torch.Tensor) -> torch.Tensor:
    """x + the weighted sum of each token's rows of y (at ``pos``), in
    one launch (:func:`combine_plain`'s order and roundings)."""
    N, D = x.shape
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.moe_combine(x.data_ptr(), y.data_ptr(), pos.data_ptr(), wts.data_ptr(), N,
                             wts.shape[1], D, out.data_ptr(), _DTYPE_CODES[x.dtype],
                             _stream(x.device))
    _build.check(lib, "moe_combine launch", rc)
    moe_combine_cuda.launches += 1
    return out


moe_combine_cuda.launches = 0


def _experts_by_products(h, w_gate, w_up, w_down, offsets, perm, top_k: int) -> torch.Tensor:
    """:func:`moe_experts_cuda`'s y by three matrix products an expert
    over its grouped rows, with the kernels' roundings: each product out
    in float32 (``out_dtype``: no reduction in bf16), SiLU·up and the down
    product each rounded once.  The host waits for the offsets."""
    bounds = offsets.tolist()
    rows = h[perm.long() // top_k]  # [P, D], expert by expert
    P, Fw, D = rows.shape[0], w_gate.shape[2], h.shape[1]
    gate = torch.empty((P, Fw), dtype=torch.float32, device=h.device)
    up = torch.empty_like(gate)
    live = [(e, a, b) for e, (a, b) in enumerate(zip(bounds, bounds[1:])) if b > a]
    wide = {} if h.dtype == torch.float32 else {"out_dtype": torch.float32}
    for e, a, b in live:
        torch.mm(rows[a:b], w_gate[e], out=gate[a:b], **wide)
        torch.mm(rows[a:b], w_up[e], out=up[a:b], **wide)
    del rows
    hidden = silu_mul_fused(gate, up).to(h.dtype)
    del gate, up
    y = torch.empty((P, D), dtype=h.dtype, device=h.device)
    for e, a, b in live:
        y[a:b] = torch.mm(hidden[a:b], w_down[e], **wide)
    return y


def _check(x, h, w_router, w_gate, w_up, w_down, top_k):
    N, D = h.shape
    if x.shape != h.shape or w_router.dim() != 2 or w_router.shape[0] != D:
        raise ValueError(f"x {tuple(x.shape)}, h {tuple(h.shape)} and w_router "
                         f"{tuple(w_router.shape)} disagree")
    E = w_router.shape[1]
    if (w_gate.dim() != 3 or w_gate.shape[:2] != (E, D) or w_up.shape != w_gate.shape
            or tuple(w_down.shape) != (E, w_gate.shape[2], D)):
        raise ValueError(f"expert weights {tuple(w_gate.shape)}, {tuple(w_up.shape)}, "
                         f"{tuple(w_down.shape)} do not match E {E}, D {D}")
    if not 1 <= top_k <= E:
        raise ValueError(f"top_k {top_k} must lie in 1..{E}")


def routed_experts_fused(x: torch.Tensor, h: torch.Tensor, w_router: torch.Tensor,
                         w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                         top_k: int, norm_topk: bool,
                         counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [N, D] plus the routed-expert MLP of h [N, D] (the layer's norm
    of x), every token's ``top_k`` experts computed.  w_router [D, E];
    w_gate, w_up [E, D, F]; w_down [E, F, D]; one dtype (bf16 or float32),
    contiguous; E up to 256, D and F multiples of 4.  ``counts``: the
    int64 counters (:func:`counters`) the grouping adds to.  The grouped
    kernels compute the experts up to :data:`GROUPED_MAX_ROWS` routed rows
    and under graph capture; above, the per-expert products.  CUDA tensors
    run the kernels (``model.moe.route`` and ``model.moe.experts``
    profiler ranges); CPU tensors :func:`routed_experts_plain`."""
    _check(x, h, w_router, w_gate, w_up, w_down, top_k)
    if x.device.type == "cpu":
        return routed_experts_plain(x, h, w_router, w_gate, w_up, w_down, top_k, norm_topk)
    tensors = (x, h, w_router, w_gate, w_up, w_down)
    _build.refuse_grad("routed_experts_fused", *tensors)
    if x.device.type != "cuda" or len({t.device for t in tensors}) != 1:
        raise ValueError("routed_experts_fused: all inputs must be on one CUDA device")
    if len({t.dtype for t in tensors}) != 1 or x.dtype not in _DTYPE_CODES:
        raise ValueError("routed_experts_fused: one dtype, bf16 or float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("routed_experts_fused: inputs must be contiguous")
    E = w_router.shape[1]
    if E > MAX_EXPERTS or h.shape[1] % 4 or w_gate.shape[2] % 4:
        raise ValueError(f"routed_experts_fused takes up to {MAX_EXPERTS} experts and widths "
                         "that are multiples of 4")
    with profiler_range("model.moe.route", {"tokens": x.shape[0], "experts": E}):
        ids, wts = moe_route_cuda(h, w_router, top_k, norm_topk)
        offsets, perm, pos = moe_group_cuda(ids, E, counts)
    with profiler_range("model.moe.experts", {"rows": ids.numel()}):
        if ids.numel() <= GROUPED_MAX_ROWS or torch.cuda.is_current_stream_capturing():
            y = moe_experts_cuda(h, w_gate, w_up, w_down, offsets, perm, top_k)
        else:
            y = _experts_by_products(h, w_gate, w_up, w_down, offsets, perm, top_k)
        return moe_combine_cuda(x, y, pos, wts)
