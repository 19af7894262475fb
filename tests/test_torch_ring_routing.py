"""``resolve_auto_impl`` of the port's ring against the reference's.

Each case of tests/test_ring_routing.py runs on both packages, the
platform mapped: the reference's ``"tpu"`` (where its Pallas kernel runs)
is the port's ``"cuda"`` (where its CUDA partial runs), ``"cpu"`` is
``"cpu"``.  They agree on the platform and on ``interpret``; they differ
where the reference's VMEM bound sends a long or wide chunk to the einsum
body, since the port's kernel streams K/V from device memory and has no
such bound.  On CUDA the port refuses a head_dim its kernel does not
take, and ``ring_body("auto", ...)`` resolves through the same function.
"""

import numpy as np
import pytest
import torch

from llm_d_kv_cache_manager_tpu.ops.flash_pallas import VMEM_KV_BUDGET_BYTES, fits_vmem
from llm_d_kv_cache_manager_tpu.ops.ring_attention import resolve_auto_impl as ref_resolve
from tests.helpers.torch_port import port

ring = port("ops.ring_attention")
HEAD_DIM = 128
BF16 = 2
PLATFORM = {"tpu": "cuda", "cpu": "cpu"}


def max_fitting_tokens() -> int:
    tokens = VMEM_KV_BUDGET_BYTES // (2 * HEAD_DIM * BF16)
    assert fits_vmem(tokens, HEAD_DIM, BF16) and not fits_vmem(tokens + 1, HEAD_DIM, BF16)
    return tokens


# (reference case, platform, tokens, dtype bytes, interpret, reference's pick, port's pick)
CASES = [
    ("tpu_within_budget_picks_flash", "tpu", lambda: 4096, BF16, False, "flash", "flash"),
    ("tpu_over_budget_falls_back_to_einsum", "tpu", lambda: max_fitting_tokens() + 1, BF16,
     False, "einsum", "flash"),
    ("boundary_is_the_fits_vmem_bound", "tpu", max_fitting_tokens, BF16, False, "flash",
     "flash"),
    ("cpu_mesh_always_einsum", "cpu", lambda: 128, BF16, False, "einsum", "einsum"),
    ("interpret_forces_flash_regardless_of_budget", "cpu", lambda: max_fitting_tokens() + 1,
     BF16, True, "flash", "flash"),
    ("wider_dtype_tightens_the_bound", "tpu", max_fitting_tokens, 4, False, "einsum", "flash"),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_the_reference_cases_with_the_platform_mapped(case):
    _, platform, tokens, dtype_bytes, interpret, ref_pick, port_pick = case
    n = tokens()
    assert ref_resolve(platform, n, HEAD_DIM, dtype_bytes, interpret=interpret) == ref_pick
    assert ring.resolve_auto_impl(PLATFORM[platform], n, HEAD_DIM, dtype_bytes,
                                  interpret=interpret) == port_pick
    if ref_pick != port_pick:  # only the VMEM bound tells them apart
        assert not fits_vmem(n, HEAD_DIM, dtype_bytes)


@pytest.mark.parametrize("head_dim", [16, 24, 264])
def test_cuda_refuses_a_head_dim_the_kernel_does_not_take(head_dim):
    with pytest.raises(ValueError, match="head_dim"):
        ring.resolve_auto_impl("cuda", 1024, head_dim, BF16)
    # Off CUDA the einsum body takes any head_dim, as the reference's does.
    assert ring.resolve_auto_impl("cpu", 1024, head_dim, BF16) == "einsum"


@pytest.mark.parametrize("head_dim", [32, 64, 80, 96, 128, 144, 256])
def test_cuda_takes_the_kernels_head_dims_at_any_length_and_width(head_dim):
    for tokens, width in ((1, 2), (1 << 20, 2), (1 << 20, 4)):
        assert ring.resolve_auto_impl("cuda", tokens, head_dim, width) == "flash"


def _chunks(head_dim, R=2, T=8, H=4, Hkv=2):
    """q, k and v chunks {rank: [1, T, heads, head_dim]} of a CPU ring of
    R ranks, from a seed, and the ring."""
    rng = np.random.default_rng(0)

    def make(heads):
        return {r: torch.from_numpy(rng.standard_normal((1, T, heads, head_dim),
                                                        dtype=np.float32))
                for r in range(R)}

    return make(H), make(Hkv), make(Hkv), ring.Ring([torch.device("cpu")] * R)


def test_ring_body_auto_on_the_cpu_is_the_einsum_body():
    q, k, v, r = _chunks(16)
    got = ring.ring_body("auto", "cpu")(q, k, v, r)
    want = ring.ring_body("einsum", "cpu")(q, k, v, r)
    for rank in want:
        assert torch.equal(got[rank], want[rank])


def test_ring_body_auto_on_cuda_resolves_before_any_launch():
    """A CUDA mesh with a head_dim outside the kernel's raises from the
    resolution, before a partial runs; it never gives way to the plain
    version."""
    q, k, v, r = _chunks(24)
    with pytest.raises(ValueError, match="ring partial kernel takes head_dim"):
        ring.ring_body("auto", "cuda")(q, k, v, r)


def test_ring_body_rejects_an_unknown_impl():
    with pytest.raises(ValueError, match="unknown ring impl"):
        ring.ring_body("pallas", "cuda")
