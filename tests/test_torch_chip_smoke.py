"""The host-side helpers of ``chip_smoke.py``, on the CPU: the parser of
``nvcc -Xptxas -v`` logs that phase 1 prints, the derived kernel rates,
and the tie-aware next-token check of the prefix-hit contract."""

import pathlib
import runpy

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
smoke = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke_helpers")

FLASH = ("_ZN49_GLOBAL__N__571e0d79_16_flash_prefill_cu_3b2fb43b17flash_bf16_kernel"
         "ILi128EEEv14CUtensorMap_stS1_S1_PKiiP13__nv_bfloat16PfS6_iiiiiif")
MERGE = "_ZN49_GLOBAL__N__571e0d79_16_flash_prefill_cu_3b2fb43b18flash_merge_kernelILi64EEEvPKfS2_P13__nv_bfloat16li"

LOG = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{MERGE}' for 'sm_90a'
ptxas info    : Function properties for {MERGE}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : Compiling entry function '{FLASH}' for 'sm_90a'
ptxas info    : Function properties for {FLASH}
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compile time = 47.448 ms
"""


@pytest.mark.parametrize(
    "mangled,name",
    [
        (FLASH, "flash_bf16_kernel<128>"),
        (MERGE, "flash_merge_kernel<64>"),
        ("_Z21decode_partial_kernelILi128ELi8EEvPKf", "decode_partial_kernel<128,8>"),
        ("_Z10not_a_kernelPf", "_Z10not_a_kernelPf"),
    ],
)
def test_kernel_name_reads_the_mangled_identifier(mangled, name):
    assert smoke["kernel_name"](mangled) == name


def test_ptxas_lines_pair_registers_with_spills():
    assert smoke["ptxas_lines"](LOG) == [
        ("flash_merge_kernel<64>", "Used 32 registers, used 0 barriers; "
         "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
        ("flash_bf16_kernel<128>", "Used 168 registers, used 16 barriers; "
         "8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads"),
    ]


def test_add_rates():
    row = smoke["add_rates"](dict(ms=2.0, library_ms=1.0, bound_ms=0.5), 4e12)
    assert row["tflops"] == pytest.approx(2000.0)
    assert row["library_ratio"] == pytest.approx(2.0)
    assert row["bound_share"] == pytest.approx(0.25)
    assert smoke["add_rates"](dict(ms=1.0, library_ms=None, bound_ms=0.5), 1e9)[
        "library_ratio"] is None


def test_next_token_check_allows_only_ties_within_the_error():
    ref = torch.tensor([0.0, 4.4273, 4.4197, 1.0])
    check = smoke["check_next_token"]
    assert check("same", 1, ref, 0.1) == 0.0
    # The top two lie 0.0076 apart, far inside a 0.105 disagreement.
    assert check("tie", 2, ref, 0.105) == pytest.approx(0.0076, abs=1e-4)
    with pytest.raises(AssertionError):
        check("tie past the error", 2, ref, 0.005)
    with pytest.raises(AssertionError):
        check("another token", 3, ref, 0.105)
