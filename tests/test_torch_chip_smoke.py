"""The host-side helpers of ``chip_smoke.py``, on the CPU: the parser of
``nvcc -Xptxas -v`` logs that phase 1 prints, the derived kernel rates,
the tie-aware next-token check of the prefix-hit contract, and the two
counts of decode kernel launches (a profiler window's rows, a captured
graph's kernel nodes)."""

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
        ("_ZN48_GLOBAL__N__1c4b2f5e_15_paged_decode_cu_0a6f1d2224paged_decode_bf16_kernelILi128ELi8EEEvNS_4ArgsE",
         "paged_decode_bf16_kernel<128,8>"),
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


def test_kernel_rows_per_step_counts_what_ran_on_the_device():
    """Launches a step from a profiler window's (kernel, count) rows:
    what a replayed graph launches counts though no Python call made it."""
    rows = [("void (anonymous namespace)::paged_decode_bf16_kernel<128, 8>(Args)", 64),
            ("void (anonymous namespace)::flash_bf16_kernel<128>(CUtensorMap_st)", 3),
            ("nvjet_tst_64x8_64x16_4x1_v_bz_TNT", 448), ("Memset (Device)", 64)]
    count = smoke["kernel_rows_per_step"]
    assert count(rows, ("paged_decode_bf16_kernel", "paged_decode_f32_kernel"), 2) == 32
    assert count(rows, ("ring_partial_bf16_kernel",), 2) == 0
    with pytest.raises(AssertionError):
        count(rows, ("flash_bf16_kernel",), 2)  # 3 launches over 2 steps


DECODE = ("_ZN48_GLOBAL__N__1c4b2f5e_15_paged_decode_cu_0a6f1d2224paged_decode_bf16_kernel"
          "ILi128ELi8EEEvNS_4ArgsE")


def _dot_node(i: int, kind: str, what: str) -> str:
    return (f'"graph_1_node_{i}"[style="bold" shape="record" label="{{{kind}\n'
            f'| {{ID | {i} (topoId: {9 - i}) | {what}}}\n'
            '| {{node handle | func handle} | {0x000000000D469280 | 0x000000000B964270}}\n'
            '| {cooperative | 0}\n}"];\n\n')


def test_graph_kernel_nodes_counts_the_kernels_a_replay_launches():
    """The decode kernel nodes of a captured graph, from its DOT dump: a
    node's statement holds its kernel's mangled name once, an edge or a
    memset node none."""
    launch = "\\<\\<\\<132,256,131072\\>\\>\\>"
    nodes = [("KERNEL", "nvjet_tst_64x8_64x16_2x1_v_bz_NNT\\<\\<\\<2,384,164308\\>\\>\\>"),
             ("MEMSET", "paged_decode counters"), ("KERNEL", DECODE + launch),
             ("KERNEL", "_ZN2at6native13reduce_kernelILi512EEEvT1_\\<\\<\\<1,128,512\\>\\>\\>"),
             ("MEMSET", "0"), ("KERNEL", DECODE + launch)]
    dot = ('digraph dot {\nsubgraph cluster_1 {\nlabel="graph_1" graph[style="dashed"];\n'
           + "".join(_dot_node(i, kind, what) for i, (kind, what) in enumerate(nodes))
           + "".join(f'"graph_1_node_{i}" -> "graph_1_node_{i + 1}" [headlabel=0];\n'
                     for i in range(len(nodes) - 1)) + "}\n}\n")
    count = smoke["graph_kernel_nodes"]
    assert count(dot, ("paged_decode_bf16_kernel", "paged_decode_f32_kernel")) == 2
    assert count(dot, ("nvjet",)) == 1
    assert count(dot, ("paged_decode",)) == 2  # not the memset node that names it
    assert count(dot, ("ring_partial_bf16_kernel",)) == 0
    assert count("digraph dot {\n}\n", ("paged_decode_bf16_kernel",)) == 0
