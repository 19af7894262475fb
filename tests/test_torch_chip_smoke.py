"""The host-side helpers of ``chip_smoke.py``, on the CPU: the parser of
``nvcc -Xptxas -v`` logs that phase 1 prints, the derived kernel rates,
the tie-aware next-token check of the prefix-hit contract, the two
counts of decode kernel launches (a profiler window's rows, a captured
graph's kernel nodes), phase 7's file-hash choice per group, tree
comparison, rate and bound arithmetic, mount lookup and file helpers,
phases 8-11's model FLOP count of a train step, expert-pick
comparison, nested-state walks, byte totals and comparisons, and phase
12's launch counts per shard, shard-slice comparison and the planted
faults of the sharded training check; phase 7b's helpers and the whole
phase on CPU pools at a small configuration; phases 5c and 14d (the HTTP
service) whole at a small size, with a planted fault for 14d; phase 6b's
per-step transfer summary and its hold of a process's partial launches,
which a planted fault must fail; phase 12f's plain blocks' launch
split, layer cut and gates, each with planted faults; phase 7d (the
offload smoke) whole on a CPU pool, with a byte flipped after the load
as its planted fault; phase 7e (the chart's connector) whole on CPU
tensors at a tiny geometry, with the same planted fault; phases 2-4's
shape cases against the kernels' set, the decode fault's repacked
reference, and phases 5d and 5e whole on CPU params, each with a
planted fault."""

import inspect
import json
import os
import pathlib
import runpy
import threading
import time

import numpy as np
import pytest
import torch

from tests.helpers.torch_port import port

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


# ------------------------------------------------------------ phase 7


@pytest.mark.parametrize("n,per_file,want", [
    (8, 4, [3, 7]),
    (10, 4, [3, 7, 9]),  # a partial tail group ends on the last key
    (3, 4, [2]),
    (4, 1, [0, 1, 2, 3]),
    (0, 4, []),
])
def test_group_file_hashes_take_each_groups_last_key(n, per_file, want):
    keys = [1000 + i for i in range(n)]
    assert smoke["group_file_hashes"](keys, per_file) == [1000 + i for i in want]


def test_file_hashes_name_the_connectors_groups():
    """The chosen hashes and the connector's grouping give one file per
    group, named by the key covering the prefix up to its last block."""
    from tests.helpers.torch_port import port

    group = port("offload.worker").group_blocks_per_file
    keys = [0x10 + i for i in range(10)]
    hashes = smoke["group_file_hashes"](keys, 4)
    groups = group(hashes, list(range(100, 110)), 4)
    assert [(h, ids[-1] - 100) for h, ids in groups] == [(keys[3], 3), (keys[7], 7), (keys[9], 9)]


def test_tree_comparison_finds_every_difference(tmp_path):
    for root, files in ((tmp_path / "a", {"x/1.bin": b"ab", "x/2.bin": b"cd", "3.bin": b""}),
                        (tmp_path / "b", {"x/1.bin": b"ab", "x/2.bin": b"ce", "4.bin": b""})):
        for name, data in files.items():
            (root / name).parent.mkdir(parents=True, exist_ok=True)
            (root / name).write_bytes(data)
    a, b = smoke["read_tree"](str(tmp_path / "a")), smoke["read_tree"](str(tmp_path / "b"))
    assert a == {"x/1.bin": b"ab", "x/2.bin": b"cd", "3.bin": b""}
    assert smoke["tree_mismatches"](a, b) == ["3.bin", "4.bin", "x/2.bin"]
    assert smoke["tree_mismatches"](a, dict(a)) == []


def test_rate_against_its_bound():
    row = smoke["rate"](2**30, 0.02, 64e9)
    assert row["ms"] == pytest.approx(20.0)
    assert row["gbps"] == pytest.approx(2**30 / 0.02 / 1e9)
    assert row["bound_ms"] == pytest.approx(2**30 / 64e9 * 1e3)
    assert row["share_of_bound"] == pytest.approx(row["bound_ms"] / row["ms"])
    hbm = smoke["rate"](2 * 2**30, 0.00128, smoke["H100_SXM_PEAKS"][2])
    assert hbm["bound_ms"] == pytest.approx(0.641, abs=1e-3)


MOUNTS = """overlay / overlay rw,relatime 0 0
tmpfs /tmp tmpfs rw 0 0
/dev/vdb /tmp/data ext4 rw 0 0
/dev/vdc /tmp/data\\040two xfs rw 0 0
"""


@pytest.mark.parametrize("path,want", [
    ("/tmp/kv-offload-x", ("/tmp", "tmpfs", "tmpfs")),
    ("/tmp/data/a/b", ("/tmp/data", "ext4", "/dev/vdb")),
    ("/tmp/database", ("/tmp", "tmpfs", "tmpfs")),
    ("/tmp/data two/f", ("/tmp/data two", "xfs", "/dev/vdc")),
    ("/home/user/repo", ("/", "overlay", "overlay")),
])
def test_mount_of_takes_the_longest_mount_point(path, want):
    assert smoke["mount_of"](path, MOUNTS) == want


def test_clear_dir_and_drop_page_cache(tmp_path):
    (tmp_path / "a" / "b").mkdir(parents=True)
    (tmp_path / "a" / "b" / "f.bin").write_bytes(b"x" * 4096)
    (tmp_path / "g.bin").write_bytes(b"y")
    assert smoke["drop_page_cache"](str(tmp_path)) == 2
    assert (tmp_path / "g.bin").read_bytes() == b"y"
    smoke["clear_dir"](str(tmp_path))
    assert tmp_path.exists() and list(tmp_path.iterdir()) == []


def test_ms_median_over_rounds():
    rounds = [{"ms": 5.0}, {"ms": 1.0}, {"ms": 3.0}]
    assert smoke["ms_median"](rounds, "ms") == 3.0


# ------------------------------------------------ phases 8-11 helpers


def test_train_step_flops_at_the_training_cut():
    """Three forwards' worth: 2 FLOPs a weight a token over every matmul
    (the logits product included), 4 * H * Dh a causal pair."""
    llama = port("models.llama")
    cfg = llama.LlamaConfig.llama3_8b()
    cfg.n_layers = 8
    per_layer = 4096 * 4096 + 2 * 4096 * 1024 + 4096 * 4096 + 3 * 4096 * 14336
    assert per_layer == 218_103_808
    matmul = 2 * 2048 * (8 * per_layer + 128256 * 4096)
    attention = 4 * 32 * 128 * 8 * 2048 * 2049 // 2
    assert smoke["train_step_flops"](cfg, 1, 2048) == 3.0 * (matmul + attention)
    assert smoke["train_step_flops"](cfg, 2, 2048) == 2 * smoke["train_step_flops"](cfg, 1, 2048)
    tiny = llama.LlamaConfig(vocab_size=10, d_model=4, n_layers=1, n_heads=2, n_kv_heads=1,
                             d_ff=8)
    # per layer 4*4 + 2*4*2 + 4*4 + 3*4*8 = 144; T=3 has 6 causal pairs.
    assert smoke["train_step_flops"](tiny, 1, 3) == 3.0 * (2 * 3 * (144 + 40) + 4 * 2 * 2 * 6)


def test_routed_experts_and_differing_tokens():
    dispatch = torch.zeros(4, 3, 2)
    dispatch[0, 1, 0] = dispatch[1, 1, 1] = dispatch[1, 2, 0] = 1  # token 2: dropped
    routed = smoke["routed_experts"](dispatch)
    assert routed.tolist() == [[False, True, False], [False, True, True],
                               [False, False, False], [False, False, False]]
    other = routed.clone()
    other[3, 0] = True
    layers = [routed, routed]
    assert smoke["differing_tokens"](layers, layers).tolist() == [False] * 4
    assert smoke["differing_tokens"](layers, [routed, other]).tolist() == [False, False, False,
                                                                           True]
    with pytest.raises(ValueError, match="2 layers against 1"):
        smoke["differing_tokens"](layers, [routed])


def _state():
    return {"params": {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
                       "b": torch.ones(4)},
            "opt": {"state": {0: {"step": torch.tensor(2.0)}},
                    "param_groups": [{"lr": 3e-4, "betas": (0.9, 0.95), "params": [0, 1]}]}}


def test_leaf_paths_and_state_bytes():
    paths = dict(smoke["leaf_paths"](_state()))
    assert sorted(paths) == ["opt.param_groups.0.betas", "opt.param_groups.0.lr",
                             "opt.param_groups.0.params.0", "opt.param_groups.0.params.1",
                             "opt.state.0.step", "params.b", "params.w"]
    assert paths["opt.param_groups.0.betas"] == (0.9, 0.95)  # a tuple is a leaf
    assert smoke["state_bytes"](torch, _state()) == 6 * 2 + 4 * 4 + 4


def test_state_mismatches_finds_every_difference():
    want = _state()
    assert smoke["state_mismatches"](torch, smoke["map_state"](torch, want, torch.clone),
                                     want) == []
    got = smoke["map_state"](torch, want, torch.clone)
    got["params"]["w"][1, 2] = 0.0
    got["params"]["b"] = got["params"]["b"].double()
    got["opt"]["param_groups"][0]["betas"] = [0.9, 0.95]  # a list is not the tuple
    got["opt"]["state"][0]["extra"] = torch.zeros(1)
    assert set(smoke["state_mismatches"](torch, got, want)) == {
        "opt.state.0.extra", "opt.param_groups.0.betas", "opt.param_groups.0.betas.0",
        "opt.param_groups.0.betas.1", "params.b", "params.w"}
    zero = {"x": torch.zeros(2)}  # bytes, not values: -0.0 is not 0.0
    assert smoke["state_mismatches"](torch, {"x": -torch.zeros(2)}, zero) == ["x"]


def test_map_state_copies_structure():
    state = _state()
    copy = smoke["map_state"](torch, state, lambda t: t + 1)
    assert copy["opt"]["param_groups"] == state["opt"]["param_groups"]
    assert copy["opt"]["param_groups"][0] is not state["opt"]["param_groups"][0]
    assert float(copy["opt"]["state"][0]["step"]) == 3.0


def test_leaves_close_measures_outside_the_free_elements():
    want = {"a": torch.tensor([1.0, 2.0, 0.0]), "b": torch.tensor([[10.0]])}
    got = {"a": torch.tensor([1.0, 2.0002, 0.5]), "b": torch.tensor([[10.0]])}
    err, worst, n_free, free_err = smoke["leaves_close"](torch, got, want, 1e-6, 1e-4)
    assert err == pytest.approx(0.5) and worst == pytest.approx(0.5 / 1e-6)
    free = {"a": torch.tensor([False, False, True]), "b": torch.tensor([[False]])}
    err, worst, n_free, free_err = smoke["leaves_close"](torch, got, want, 1e-6, 1e-4, free)
    assert (n_free, free_err) == (1, pytest.approx(0.5))
    assert worst == pytest.approx(0.0002 / (1e-6 + 2e-4), rel=1e-3)
    with pytest.raises(AssertionError, match="trees differ"):
        smoke["leaves_close"](torch, {"a": got["a"]}, want, 1e-6, 1e-4)


def test_sharded_launch_counts():
    """Phase 12's expected launches: a head shard's ring launches every
    (rank, step) pair striped and sp(sp+1)/2 contiguous; each shard
    launches per layer."""
    assert smoke["ring_steps"](4, True) == 16 and smoke["ring_steps"](4, False) == 10
    assert smoke["ring_steps"](1, False) == 1
    assert smoke["shard_launches"](16, 2, 32) == 1024
    assert smoke["shard_launches"](1, 2, 32) == 64


def test_shard_mismatches_find_the_bad_slice():
    mesh_mod, sharding = port("parallel.mesh"), port("parallel.sharding")
    tmesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(dp=1, pp=2, tp=2), ["cpu"] * 4)
    full = torch.arange(32, dtype=torch.float32).reshape(4, 8).to(torch.bfloat16)
    x = sharding.shard(full, tmesh, sharding.P("pp", "tp"))
    assert smoke["shard_mismatches"](torch, x, full) == []
    x.local(pp=1, tp=0)[0, 0] += 1
    assert smoke["shard_mismatches"](torch, x, full) == [(0, 1, 0, 0, 0)]
    tree = {"a": x, "b": {"c": sharding.shard(full, tmesh, sharding.P(None))}}
    assert smoke["tree_shard_mismatches"](torch, tree, {"a": full, "b": {"c": full}}) == {
        "a": [(0, 1, 0, 0, 0)]}


def test_sharded_grads_and_pool_copies():
    mesh_mod, sharding = port("parallel.mesh"), port("parallel.sharding")
    tmesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(dp=2, tp=2), ["cpu"] * 4)
    x = sharding.shard(torch.arange(8.0).reshape(2, 4), tmesh, sharding.P(None, "tp"))
    for _, t in x.distinct():
        t.requires_grad_()
        t.grad = t.detach() * 2
    grads = sharding.grad_tree({"x": x, "plain": x.local()})
    assert torch.equal(sharding.unshard(grads["x"]), torch.arange(8.0).reshape(2, 4) * 2)
    assert grads["plain"] is x.local().grad
    y = sharding.zeros((2, 4), torch.float32, tmesh, sharding.P(None, "tp"))
    assert not smoke["pools_equal"](torch, y, x)
    with torch.no_grad():
        smoke["pool_copy"](torch, y, x)
    assert smoke["pools_equal"](torch, y, x)


def test_tp_rank_faults_zero_one_rank_and_leave_the_rest():
    """12c's planted-fault helpers: the tp rank's distinct locals, and a
    copy of a leaf whose slices on that rank are zeros while the other
    rank's tensor (and the leaf itself) is untouched."""
    mesh_mod, sharding = port("parallel.mesh"), port("parallel.sharding")
    tmesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(dp=1, pp=2, tp=2, sp=2), ["cpu"] * 8)
    full = torch.arange(1.0, 17.0).reshape(2, 8)
    cut = sharding.shard(full, tmesh, sharding.P("pp", "tp"))
    whole = sharding.shard(full, tmesh, sharding.P("pp", None))
    assert smoke["tp_rank_locals"](whole, 1) == []
    ones = smoke["tp_rank_locals"](cut, 1)
    assert [t.data_ptr() for t in ones] == [cut.local(pp=0, tp=1).data_ptr(),
                                            cut.local(pp=1, tp=1).data_ptr()]
    faulted = smoke["zero_tp_rank"](torch, sharding, cut, 1)
    want = full.clone()
    want[:, 4:] = 0
    assert torch.equal(sharding.unshard(faulted), want)
    assert faulted.local(pp=1, tp=0) is cut.local(pp=1, tp=0)
    assert faulted.local(pp=1, sp=1, tp=1) is faulted.local(pp=1, tp=1)
    assert torch.equal(sharding.unshard(cut), full)
    assert smoke["rel_gap"](9.0, 10.0) == pytest.approx(0.1)


def test_sharded_training_faults_move_the_losses():
    """12c's faults at a small width on the CPU: dropping tp rank 1's wo
    slices changes the first loss, and losing its gradients changes the
    later losses against the clean sharded steps, while the first loss
    of that run (before any update) is the clean one."""
    llama, mesh_mod, sharding = port("models.llama"), port("parallel.mesh"), port(
        "parallel.sharding")
    cfg = llama.LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=128, dtype="float32")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tmesh = mesh_mod.make_mesh(mesh_mod.MeshPlan(dp=1, pp=2, tp=2, sp=2), ["cpu"] * 8)
    batches = smoke["train_batches"](torch, cfg.vocab_size, 32, 2, 1)
    faults = smoke["sharded_training_faults"](torch, cfg, params, tmesh, batches)
    sharded = sharding.shard_tree(params, tmesh, llama.param_pspecs(cfg))
    opt = llama.make_optimizer(sharded)
    clean = [float(llama.train_step(sharded, opt, b, cfg)) for b in batches]
    with torch.no_grad():
        clean.append(float(llama.loss_fn(sharded, batches[0], cfg)))
    lost = faults["grads_lost_losses"]
    assert len(lost) == len(clean) == 3
    assert abs(faults["wo_dropped_first_loss"] - clean[0]) > 1e-4 * clean[0]
    assert lost[0] == pytest.approx(clean[0], rel=1e-6)
    assert all(abs(a - b) > 1e-5 * b for a, b in zip(lost[1:], clean[1:]))


# ---------------------------------------------- phase 13: the read path


def test_read_path_at_a_small_size():
    """Phase 13 end to end at a small size: the fleet seeding, the three
    lanes' scores equal on every request and equal to their expected
    value (the warm turns' from the tier weights), the native and Python
    chains, the traced request's spans and the exposition's lookups."""
    out = smoke["read_path"]("cpu", pods_n=3, convs=2, conv_tokens=256, turns=3,
                             turn_tokens=32, cold=2, min_requests=10)
    assert out["keys_per_index"] == 3 * 2 * 256 // 16
    # each workload's prompts once to warm, then repeated to >= 10 timed
    assert out["requests_checked"] == (3 + 3 * 4) + (2 + 2 * 5) + (4 + 4 * 3)
    assert out["lookups"] == 3 * out["requests_checked"] + 1
    assert set(out["cells"]) == {"warm_multi_turn", "cold", "mixed"}
    for cells in out["cells"].values():
        assert set(cells) == {"fast", "fast_no_memo", "straight"}
        assert all(c["requests"] >= 10 and 0 < c["p50_ms"] <= c["p99_ms"]
                   for c in cells.values())


def test_seed_fleet_puts_each_conversation_on_its_pod_and_tier():
    index_mod = port("kvcache.kvblock.index")
    indexers = [smoke["read_path_indexer"](fast, block_size=4) for fast in (True, False)]
    try:
        rng = np.random.default_rng(1)
        fleet = smoke["event_fleet"](rng, ["p0", "p1"], 3, 40, 4)
        seconds = smoke["seed_by_events"](indexers, fleet["frames"])
        assert fleet["blocks"] == 2 * 3 * 10 and seconds > 0
        rng = np.random.default_rng(1)
        for pod in ("p0", "p1"):
            for j in range(3):
                ids = rng.integers(1, smoke["READ_VOCAB"], 40).tolist()
                keys = indexers[0].token_processor.tokens_to_kv_block_keys(0, ids,
                                                                             smoke["MODEL_NAME"])
                for indexer in indexers:
                    found = indexer.kv_block_index.lookup(keys)
                    assert sorted(found) == sorted(keys)
                    assert {(e.pod_identifier, e.device_tier) for pods in found.values()
                            for e in pods} == {(pod, ("hbm", "host")[j % 2])}
    finally:
        for indexer in indexers:
            indexer.shutdown()


def test_prefix_store_model_predicts_the_pools_tokens():
    """``PrefixStoreModel`` (the independent count behind the expected
    scores of phases 5 and 13) against the tokenization pool itself over
    a growing conversation and unrelated prompts."""
    indexer = smoke["read_path_indexer"](True, block_size=4)
    model = smoke["PrefixStoreModel"]()
    rng = np.random.default_rng(2)
    words = smoke["words"]
    try:
        convo = rng.integers(1, 128256, 600).tolist()
        prompts = [words(convo[:n]) for n in (300, 340, 380, 420, 600, 300)]
        prompts += [words(rng.integers(1, 128256, 200).tolist()), prompts[2], "t5"]
        for prompt in prompts:
            got = indexer.tokenization_pool.tokenize(prompt, smoke["MODEL_NAME"])
            assert model.served(prompt) == got, prompt[:40]
        served, in_full = smoke["store_served_tokens"](prompts[1], prompts[0])
        assert not in_full and len(served) < 300
        assert smoke["store_served_tokens"](prompts[0]) == (convo[:300], True)
    finally:
        indexer.shutdown()


def test_expected_scores_use_the_scorers_tier_weights():
    got = smoke["expected_read_scores"](5, ["a", "b", "c"], [("a", "hbm"), ("b", "host")])
    assert got == {"a": 5.0, "b": 0.8 + 0.8 + 0.8 + 0.8 + 0.8, "c": 0.0}
    assert smoke["tier_score"](0, 0.8) == 0.0


def _spans():
    return [{"name": n, "parent": p} for n, p in [
        ("tokenize.prefix_probe", "tokenize"), ("tokenize.queue_wait", "tokenize"),
        ("tokenize.encode", "tokenize"), ("tokenize", None), ("hash_blocks", None),
        ("index_lookup", None), ("score", None)]]


@pytest.mark.parametrize("fault", [None, "rename", "reparent", "drop", "twice"])
def test_check_spans_rejects_a_changed_tree(fault):
    spans = _spans()
    if fault == "rename":
        spans[4]["name"] = "hash"
    elif fault == "reparent":
        spans[2]["parent"] = None
    elif fault == "drop":
        del spans[5]
    elif fault == "twice":
        spans.append({"name": "score", "parent": None})
    if fault is None:
        assert smoke["check_spans"](spans)["tokenize.encode"] == "tokenize"
    else:
        with pytest.raises(AssertionError, match="span"):
            smoke["check_spans"](spans)


def test_lookup_counter_reads_the_exposition():
    text = ("# TYPE kvtpu_kvcache_index_lookup_requests_total counter\n"
            "kvtpu_kvcache_index_lookup_requests_total 17.0\n")
    assert smoke["lookup_counter"](text) == 17.0
    with pytest.raises(AssertionError):
        smoke["lookup_counter"]("kvtpu_other_total 1.0\n")
    assert smoke["percentile_ms"]([0.001, 0.002, 0.003], 50) == 2.0


def test_word_tokenizer_offsets_index_the_prompt_bytes():
    enc = smoke["WordTokenizer"]().encode("t12 t7 t300", "m", True)
    assert enc.tokens == [12, 7, 300]
    assert ["t12 t7 t300"[a:b] for a, b in enc.offsets] == ["t12", "t7", "t300"]


# -------------------------------------------- phases 5 and 14: KV events


def _direct_entries(chains, block=4):
    """What direct ``kv_block_index.add`` calls of each chain leave: the
    reference's index seeded without events."""
    from llm_d_kv_cache_manager_tpu.kvcache.kvblock import (
        ChunkedTokenDatabase, TokenProcessorConfig)
    from llm_d_kv_cache_manager_tpu.kvcache.kvblock.in_memory import InMemoryIndex
    from llm_d_kv_cache_manager_tpu.kvcache.kvblock.index import PodEntry

    index = InMemoryIndex()
    db = ChunkedTokenDatabase(TokenProcessorConfig(block_size=block, hash_seed="0"))
    for pod, tier, ids in chains:
        keys = db.tokens_to_kv_block_keys(0, ids, smoke["MODEL_NAME"])
        index.add(keys, keys, [PodEntry(pod, tier)])
    return smoke["index_entries"](index)


def test_fleet_seeded_by_events_equals_the_fleet_seeded_by_direct_adds(monkeypatch):
    """Phase 13's fleet at a small size (several 2048-token chunks cut to
    64 tokens), published as frames and applied by a pool: the same
    entries as direct adds of the same chains (in the reference's index),
    whatever the burst."""
    monkeypatch.setitem(smoke["event_fleet"].__globals__, "EVENT_CHUNK_TOKENS", 64)
    fleet = smoke["event_fleet"](np.random.default_rng(3), ["p0", "p1", "p2"], 3, 200, 4)
    assert fleet["blocks"] == 3 * 3 * 50 and fleet["chunks_per_conv"] == 4
    assert [len(f) for f in fleet["frames"].values()] == [12, 12, 12]
    want = _direct_entries(fleet["chains"])
    indexer = smoke["read_path_indexer"](True, block_size=4)
    try:
        for burst in (1, 5, 64):
            im, index_mod = port("kvcache.kvblock.in_memory"), port("kvcache.kvblock.index")
            index = im.InMemoryIndex(index_mod.InMemoryIndexConfig())
            pool = smoke["event_pool"](index, indexer.token_processor)
            try:
                sink = smoke["EventSink"](pool)
                assert smoke["feed"]([sink], fleet["frames"], burst) == 36
                pool.drain()
            finally:
                pool.shutdown()
            assert smoke["index_entries"](index) == want
            assert smoke["expected_entries"](indexer.token_processor, fleet["chains"]) == want
            assert {t.gap_count for t in sink.trackers.values()} == {0}
    finally:
        indexer.shutdown()


def test_engine_hashes_are_sha256_over_canonical_cbor_and_frames_the_publishers():
    import hashlib
    import struct

    from llm_d_kv_cache_manager_tpu.kvcache.kvblock.cbor_canonical import encode_canonical

    tokens = list(range(1, 13))
    hashes = smoke["engine_hashes"](None, tokens, 4)
    parent = None
    for i, h in enumerate(hashes):
        parent = hashlib.sha256(encode_canonical([parent, tokens[4 * i:4 * i + 4], None])).digest()
        assert h == parent
    assert smoke["engine_hashes"](hashes[0], tokens[4:], 4) == hashes[1:]
    assert smoke["engine_hashes"](None, tokens[:3], 4) == []
    stream = smoke["EventStream"]("pod-x")
    stream.skip(2)
    topic, seq, payload = stream.frame(payload=b"p")
    assert (topic, seq, payload) == (b"kv@pod-x@" + smoke["MODEL_NAME"].encode(),
                                     struct.pack(">Q", 3), b"p")


def test_engine_events_publish_what_the_pod_wrote():
    """Phase 5's publishing at a small size: A's miss as one
    ``BlockStored`` from the root, B's hit chained to A's last prefix
    block, an eviction as ``BlockRemoved``; through the scorer's pool the
    index then routes B to pod-a and the scheduler scores 1.0 / 0.0."""
    tp = port("kvcache.kvblock.token_processor")
    im, sched = port("kvcache.indexer"), port("scheduler")
    indexer = im.Indexer(im.IndexerConfig(token_processor_config=tp.TokenProcessorConfig(
        block_size=4, hash_seed="0")), tokenizer=smoke["WordTokenizer"]())
    scorer = sched.PrecisePrefixCacheScorer(
        sched.PrecisePrefixCacheScorerConfig(discover_pods=False), indexer=indexer)
    model = smoke["MODEL_NAME"]
    try:
        sink = smoke["EventSink"](scorer.events_pool)
        pod = smoke["EngineEvents"]("pod-a")
        prefix = list(range(1, 33))
        a, b = prefix + [50, 51, 52, 53], prefix + [60, 61, 62, 63]
        keys_a = indexer.token_processor.tokens_to_kv_block_keys(0, a, model)
        keys_b = indexer.token_processor.tokens_to_kv_block_keys(0, b, model)
        sink.deliver("pod-a", [pod.publish(keys_a, a, 0, [], 4)])
        scorer.events_pool.drain()
        frame = pod.publish(keys_b, b, 8, [keys_a[-1]], 4)
        batch = port("kvevents.events").decode_event_batch(frame[2])
        assert [e[0] for e in batch.events] == ["BlockRemoved", "BlockStored"]
        sink.deliver("pod-a", [frame])
        scorer.events_pool.drain()
        index = indexer.kv_block_index
        for key in keys_b:
            assert index.get_request_key(tp.engine_hash_to_uint64(pod.engine[key])) == key
        assert keys_a[-1] not in pod.engine
        pods = [sched.Pod("ns/a", "pod-a"), sched.Pod("ns/b", "pod-b")]
        got = scorer.score(sched.LLMRequest(target_model=model, completions=sched.CompletionsBody(
            prompt=smoke["words"](b))), pods)
        assert {p.address: s for p, s in got.items()} == {"pod-a": 1.0, "pod-b": 0.0}
        assert sink.trackers["pod-a"].gap_count == 0
    finally:
        scorer.shutdown()


@pytest.mark.parametrize("rate", [3000.0, None])
def test_storm_feeder_counts(rate):
    """The storm at a small size: what was offered equals the storm
    pods' bursts plus the quiet pod's messages; every offered message is
    applied or shed; the quiet pod (fewer messages than its fair share)
    is never shed and all of its chains reach the index."""
    im, index_mod = port("kvcache.kvblock.in_memory"), port("kvcache.kvblock.index")
    tp = port("kvcache.kvblock.token_processor")
    index = im.InMemoryIndex(index_mod.InMemoryIndexConfig())
    hasher = tp.ChunkedTokenDatabase(tp.TokenProcessorConfig(block_size=smoke["STORM_BLOCK"]))
    pool = smoke["event_pool"](index, hasher, max_queue_depth=64)
    try:
        before = pool.stage_stats()["apply_msgs"]
        cell = smoke["storm"](pool, index, hasher, 20, 0.3, rate, tag=f"t{rate}",
                              quiet_every=0.1)
        applied = pool.stage_stats()["apply_msgs"] - before
    finally:
        pool.shutdown()
    assert 1 <= cell["quiet_sent"] <= 3 and cell["quiet_shed"] == 0
    assert cell["quiet_in_index"] == cell["quiet_sent"]
    assert applied + cell["sheds"] == cell["offered"]
    assert sum(cell["dropped"].values()) == cell["sheds"]
    if rate is not None:  # never ahead of the asked rate
        assert cell["offered"] - cell["quiet_sent"] <= rate * cell["window_s"]


@pytest.mark.parametrize("phantom,wrong_tier", [(3, 2), (5, 7)])
def test_planted_divergence_counts_exactly(phantom, wrong_tier, monkeypatch):
    """The auditor over a small event-seeded fleet: clean, then exactly
    ``phantom`` phantom and ``wrong_tier`` wrong-tier blocks on the pod
    whose inventory lost and moved them, nothing on the others."""
    monkeypatch.setitem(smoke["event_fleet"].__globals__, "EVENT_CHUNK_TOKENS", 64)
    fleet = smoke["event_fleet"](np.random.default_rng(4), ["p0", "p1", "p2"], 2, 128, 4)
    tp, im = port("kvcache.kvblock.token_processor"), port("kvcache.kvblock.in_memory")
    auditor_mod = port("analytics.auditor")
    hasher = tp.ChunkedTokenDatabase(tp.TokenProcessorConfig(block_size=4, hash_seed="0"))
    index = im.InMemoryIndex()
    pool = smoke["event_pool"](index, hasher)
    try:
        smoke["feed"]([smoke["EventSink"](pool)], fleet["frames"])
        pool.drain()
    finally:
        pool.shutdown()
    auditor = auditor_mod.IndexAuditor(index, hasher, smoke["pod_inventory"](fleet),
                                       auditor_mod.AuditorConfig(interval_s=0))
    assert all((r.outcome, r.inventory_blocks) == ("clean", 64) for r in auditor.run_cycle())
    fleet["inventory"]["p1"] = smoke["plant_divergence"](
        fleet["inventory"]["p1"], fleet["chunks_per_conv"], phantom, wrong_tier)
    got = {r.pod: (r.outcome, r.phantom, r.missing, r.wrong_tier, r.unresolvable)
           for r in auditor.run_cycle()}
    assert got == {"p0": ("clean", 0, 0, 0, 0), "p2": ("clean", 0, 0, 0, 0),
                   "p1": ("divergent", phantom, 0, wrong_tier, 0)}


def test_write_path_at_a_small_size(monkeypatch):
    """Phase 14 end to end at a small size, from phase 13's fleet: the
    seeding's entries, the storm's quiet pod, the gap of 5 and the resync
    restoring the pod, the audit's planted counts."""
    monkeypatch.setitem(smoke["event_fleet"].__globals__, "EVENT_CHUNK_TOKENS", 128)
    read = smoke["read_path"]("cpu", pods_n=3, convs=2, conv_tokens=256, turns=2,
                              turn_tokens=32, cold=1, min_requests=4)
    fleet = read.pop("fleet")
    out = smoke["write_path"]("cpu", fleet, storm_pods=10, storm_seconds=0.2, storm_rate=500.0,
                              phantom=3, wrong_tier=2)
    assert all(row["entries_equal"] for row in out["seeding"].values())
    assert out["frames"] == 3 * 2 * 2 and out["blocks"] == 3 * 2 * 16
    assert out["resync"]["gap"] == 5 and out["resync"]["entries_restored"]
    assert out["resync"]["stale_blocks"] == 128 // 16
    assert out["audit"]["planted"]["pod-1"] == ("divergent", 3, 0, 2)
    assert all(c["quiet_shed"] == 0 for c in out["storm"])


# --------------------------------------------------------------- phase 7b


def test_phase_7b_names_the_pods_device_medium_to_the_port():
    """The pods publish their device tier under ``DEVICE_MEDIUM``, and
    phase 7b hands that name to the port's demotion target and transfer
    executor, with no renaming of its own between them and the index."""
    events = port("kvevents.events")
    engine = smoke["EngineEvents"]("pod-x")
    engine.publish([1, 2], list(range(8)), 0, [], 4)
    frame = engine.publish([1, 2, 3], list(range(12)), 2, [1], 4)
    batch = events.decode_event_batch(bytes(frame[-1]))
    published = [events.decode_event(e) for e in batch.events]
    assert [type(e).__name__ for e in published] == ["BlockRemoved", "BlockStored"]
    assert {e.medium for e in published} == {smoke["DEVICE_MEDIUM"]}
    source = inspect.getsource(smoke["tiering_transfer"])
    assert source.count("device_medium=DEVICE_MEDIUM") == 2
    assert "engine_medium_sink" not in smoke


def test_timed_pool_and_cache_delegate_and_time():
    pool = port("models.kv_cache_pool").KVCachePool(
        port("models.kv_cache_pool").KVCachePoolConfig(1, 4, 2, 1, 4, "float32"), device="cpu")
    timed = smoke["TimedPool"](pool)
    assert timed.block_nbytes == pool.block_nbytes
    assert timed.gather_block_major([1, 2]).shape == (2, 1, 2, 2, 1, 4) and timed.gather_s > 0
    cache = smoke["TimedCache"](port("offload.host_tier").HostTierCache(1 << 10))
    assert cache.put(7, np.zeros(16, np.uint8)) and cache.put_s > 0
    assert cache.contains(7) and cache.stats()["entries"] == 1


def test_series_totals_reads_labeled_and_plain_counters():
    metrics = port("metrics.collector").KVCacheMetrics()
    metrics.tiering_advice.labels(action="load").inc(2)
    metrics.transfer_warmup_moves.inc()
    got = smoke["series_totals"](metrics, ("tiering_advice", "transfer_warmup_moves"))
    assert got == {"kvtpu_tiering_advice_total{action=load}": 2.0,
                   "kvtpu_transfer_warmup_moves_total": 1.0}


def _tiny_tiering_inputs(tmp_path, miss_ms):
    """Phases 5 and 7's state at a small size on the CPU: pod-a served A
    (a miss) and B (a hit) routed by an Indexer whose blocks arrive as
    the pods' events; pod-c and a one-shot tree of B's prefix."""
    llama, index_mod = port("models.llama"), port("kvcache.kvblock.index")
    im, tp, sched = (port("kvcache.indexer"), port("kvcache.kvblock.token_processor"),
                     port("scheduler.precise_scorer"))
    spec_mod, worker = port("offload.spec"), port("offload.worker")
    cfg = llama.LlamaConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=96, dtype="float32")
    bs, model = cfg.block_size, smoke["MODEL_NAME"]
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pods = [smoke["SimPod"](f"pod-{n}", cfg, 64, device="cpu") for n in "ab"]
    pod_a = pods[0]
    indexer = im.Indexer(im.IndexerConfig(token_processor_config=tp.TokenProcessorConfig(
        block_size=bs, hash_seed="0")), tokenizer=smoke["WordTokenizer"]())
    scorer = sched.PrecisePrefixCacheScorer(
        sched.PrecisePrefixCacheScorerConfig(discover_pods=False), indexer=indexer)
    sink = smoke["EventSink"](scorer.events_pool)
    rng = np.random.default_rng(0)
    draw = lambda n: [int(x) for x in rng.integers(1, cfg.vocab_size, n)]  # noqa: E731
    prefix = draw(16 * bs)
    prompt_a, prompt_b = prefix + draw(bs), prefix + draw(bs)
    out = {}
    for name, tokens in (("a", prompt_a), ("b", prompt_b)):
        indexer.get_pod_scores(smoke["words"](tokens), model, ["pod-a", "pod-b"])
        keys = indexer.token_processor.tokens_to_kv_block_keys(index_mod.EMPTY_BLOCK_HASH,
                                                               tokens, model)
        cached = pod_a.cached_prefix_blocks(keys)
        new_ids, evicted = pod_a.alloc(len(keys) - len(cached))
        ids = cached + new_ids
        if cached:
            logits, _ = llama.prefill_continue(
                params, torch.tensor([tokens[len(cached) * bs:]]), pod_a.pool.kv,
                torch.tensor([ids], dtype=torch.int32), len(cached) * bs, cfg)
        else:
            logits, _ = llama.prefill_paged(params, torch.tensor([tokens]), pod_a.pool.kv,
                                            torch.tensor([ids], dtype=torch.int32), cfg)
        pod_a.commit(keys[len(cached):], ids[len(cached):])
        sink.deliver(pod_a.name, [pod_a.events.publish(keys, tokens, len(cached), evicted, bs)])
        scorer.events_pool.drain()
        out[name] = dict(keys=keys, ids=ids, logits=logits)
    prefix_ids = out["b"]["ids"][:16]
    hashes = smoke["group_file_hashes"](out["b"]["keys"][:16], 4)
    root = tmp_path / "one_shot"
    conn = spec_mod.TPUOffloadConnector(spec_mod.TPUOffloadSpec(
        shared_storage_path=str(root), model_name=model, device_block_size=bs,
        offloaded_block_size=4 * bs, threads_per_chip=2, dtype=cfg.dtype), pod_a.pool)
    conn.store_handler.transfer_async(1, worker.group_blocks_per_file(hashes, prefix_ids, 4))
    assert conn.store_handler.wait(1).name == "SUCCEEDED"
    conn.close()
    ids_c = list(range(20, 36))
    return params, cfg, dict(
        scorer=scorer, indexer=indexer, pods=pods, prompt_a=prompt_a, prompt_b=prompt_b,
        keys_b=out["b"]["keys"], prefix_ids=prefix_ids, logits_b=out["b"]["logits"],
        first_b=int(out["b"]["logits"][0, -1].argmax()), ttft_miss_ms=miss_ms,
        route_miss_ms=1.0, pod_c=smoke["SimPod"]("pod-c", cfg, 64, device="cpu"),
        one_shot_root=str(root), hashes=hashes, ids_c=ids_c,
        table_c=torch.tensor([ids_c + [40]], dtype=torch.int32), suffix=prompt_b[16 * bs:],
        bpf=4)


@pytest.mark.parametrize("miss_ms,planned", [(1e4, True), (1.5, False)],
                         ids=["slow_prefill_plans", "fast_prefill_recomputes"])
def test_tiering_transfer_at_a_small_size(tmp_path, miss_ms, planned):
    """Phase 7b end to end on CPU pools: both rungs move the bytes and the
    score (1.0 -> 0.8 -> 0.5 a block), the advisor counts the load and
    the stores, B goes to pod-c through a priced directive (a slow
    prefill) or the pre-placement plan (a prefill so fast that the price
    says recompute), continues there as on pod-a, and a cold pod warms."""
    params, cfg, t = _tiny_tiering_inputs(tmp_path, miss_ms)
    try:
        out = smoke["tiering_transfer"](torch, params, cfg, t)
    finally:
        t["scorer"].shutdown()
    assert out["directive"]["planned"] is planned
    assert out["directive"]["outcome"] == ("planned" if planned else "recompute-cheaper")
    assert out["routed"] == "pod-c" and out["continuation_max_abs_err"] == 0.0
    assert [r["moves"] for r in out["rungs"].values()] == [4, 4]
    assert out["advisor"]["rtt"]["observations"] == 2
    assert out["advisor"]["rtt_store"]["observations"] == 4
    assert out["warmup"]["moves"] == 1 and out["scored_blocks"] == 16
    assert not (tmp_path / "one_shot").exists()
    series = out["series"]
    assert series["kvtpu_tiering_demotions_total{transition=hbm_to_host}"] == 4
    assert series["kvtpu_tiering_demotions_total{transition=host_to_storage}"] == 4
    assert series["kvtpu_transfer_warmup_moves_total"] == 1


# --------------------------------------------------------- phases 14b-14c


def small_fleet(monkeypatch):
    """Phase 13 at a small size, for its fleet and its traffic."""
    monkeypatch.setitem(smoke["event_fleet"].__globals__, "EVENT_CHUNK_TOKENS", 128)
    read = smoke["read_path"]("cpu", pods_n=3, convs=2, conv_tokens=256, turns=2,
                              turn_tokens=32, cold=1, min_requests=4)
    return read.pop("fleet"), read.pop("traffic")


def test_persistence_phase_at_a_small_size(monkeypatch):
    """Phase 14b end to end at a small size: the journaled index's
    snapshot and tail recover to equal dumps and phase 13's scores, the
    warm second half hits where a fresh index does not, and the torn
    tail is named; a dropped journal record must fail the dump gate."""
    fleet, traffic = small_fleet(monkeypatch)
    out = smoke["persistence_phase"]("cpu", fleet, traffic)
    frames = sum(map(len, fleet["frames"].values())) + sum(
        map(len, traffic["convo_frames"].values()))
    assert out["frames"] == frames
    assert out["recovery"]["status"] == "warm" and out["recovery"]["records_replayed"] > 0
    assert out["snapshot"]["block_keys"] > 0 and out["snapshot"]["bytes"] > 0
    assert out["hit_rate"]["cold"] == 0.0 < out["hit_rate"]["warm"]
    assert out["torn"]["records_replayed"] == out["recovery"]["records_replayed"] - 1
    assert len(out["torn"]["torn_tails"]) == 1 and "torn record" in out["torn"]["torn_tails"][0]
    with pytest.raises(AssertionError, match="dump_entries"):
        smoke["persistence_phase"]("cpu", fleet, traffic, drop_record=True)


def test_cluster_phase_at_a_small_size(monkeypatch):
    """Phase 14c end to end at a small size: the cluster's entries and
    every score equal phase 13's across a replica killed half-way (ring
    version and failovers one up), and the purged pod never returns; one
    replica answering a stale entry must fail the score gate."""
    fleet, traffic = small_fleet(monkeypatch)
    out = smoke["cluster_phase"]("cpu", fleet, traffic, catch_up_s=60.0)
    assert out["failover"]["ring_version"] == [0, 1]
    assert out["failover"]["failovers"] == [0, 1]
    assert out["failover"]["hit_rate_dip"] == 0.0
    assert out["purge"]["removed"] > 0 and not out["purge"]["resurrected"]
    assert set(out["traffic"]) == {"warm_multi_turn", "cold", "mixed"}
    assert {"rpc_ewma_us", "armed"} <= set(out["rpc"]["fanout"])
    with pytest.raises(AssertionError, match="score unlike"):
        smoke["cluster_phase"]("cpu", fleet, traffic, stale=True, catch_up_s=60.0)


# ------------------------------------------------------ phases 5c and 14d


def test_padded_words_fill_whole_store_chunks_and_keep_the_ids():
    tokenizer = smoke["WordTokenizer"]()
    for tokens in ([7], [1, 22, 333], list(range(1, 500, 7))):
        text = smoke["padded_words"](tokens)
        assert len(text.encode()) % smoke["STORE_CHUNK_BYTES"] == 0
        assert tokenizer.encode(text, "m", False).tokens == tokens
        assert all(word[1] == "0" for word in text.split(" "))
        served, in_full = smoke["store_served_tokens"](text, text)
        assert served == tokens and not in_full


def _tiny_http_inputs():
    """Phase 5's state at a small size on the CPU: pod-a served A (a miss)
    routed by an Indexer whose blocks arrive as the pods' events."""
    llama, index_mod = port("models.llama"), port("kvcache.kvblock.index")
    im, tp, sched = (port("kvcache.indexer"), port("kvcache.kvblock.token_processor"),
                     port("scheduler.precise_scorer"))
    cfg = llama.LlamaConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=96, dtype="float32")
    bs, model = cfg.block_size, smoke["MODEL_NAME"]
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pods = [smoke["SimPod"](f"pod-{n}", cfg, 64, device="cpu") for n in "ab"]
    pod_a = pods[0]
    indexer = im.Indexer(im.IndexerConfig(
        token_processor_config=tp.TokenProcessorConfig(block_size=bs, hash_seed="0")),
        tokenizer=smoke["WordTokenizer"]())
    scorer = sched.PrecisePrefixCacheScorer(
        sched.PrecisePrefixCacheScorerConfig(discover_pods=False), indexer=indexer)
    sink = smoke["EventSink"](scorer.events_pool)
    rng = np.random.default_rng(0)
    prefix = [int(x) for x in rng.integers(1, cfg.vocab_size, 16 * bs)]
    prompt_a = prefix + [int(x) for x in rng.integers(1, cfg.vocab_size, bs)]
    indexer.get_pod_scores(smoke["words"](prompt_a), model, ["pod-a", "pod-b"])
    keys = indexer.token_processor.tokens_to_kv_block_keys(index_mod.EMPTY_BLOCK_HASH, prompt_a,
                                                           model)
    ids, evicted = pod_a.alloc(len(keys))
    llama.prefill_paged(params, torch.tensor([prompt_a]), pod_a.pool.kv,
                        torch.tensor([ids], dtype=torch.int32), cfg)
    pod_a.commit(keys, ids)
    sink.deliver(pod_a.name, [pod_a.events.publish(keys, prompt_a, 0, evicted, bs)])
    scorer.events_pool.drain()
    return params, cfg, dict(scorer=scorer, sink=sink, indexer=indexer, pods=pods, prefix=prefix,
                             route_hit_ms=1.0, ttft_hit_ms=2.0)


def test_serving_http_at_a_small_size():
    """Phase 5c end to end on CPU pools: C over HTTP scores as in-process
    (pod-a's 16 prefix blocks), pod-a continues and decodes it, and after
    its events C's second score over HTTP counts its 16 new blocks; the
    trace holds the reference's span tree and /metrics the three lookups;
    every decode call was held against the plain version."""
    params, cfg, t = _tiny_http_inputs()
    try:
        out = smoke["serving_http"](torch, params, cfg, t)
    finally:
        t["scorer"].shutdown()
    assert out["scores"] == {"pod-a": 16.0, "pod-b": 0.0}
    assert out["rescored"] == {"pod-a": 32.0, "pod-b": 0.0}
    assert out["lookups"] == 3 and len(out["decoded"]) == 5
    assert out["spans"]["tokenize.encode"] == "tokenize"
    # On CPU tensors the wrappers run their plain versions and count
    # nothing, and the prefill takes the tiled op, not the wrapper.
    assert out["launches"] == {"flash_prefill": 0, "paged_decode": 0}
    assert out["held"]["flash_prefill"] == {"calls": 0}
    assert out["held"]["paged_decode"]["calls"] == smoke["HTTP_DECODE_STEPS"] * cfg.n_layers
    assert out["held"]["paged_decode"]["max_abs_err"] == 0.0


def test_serving_http_rejects_a_decode_call_unlike_the_plain_version(monkeypatch):
    """A planted fault: the decode wrapper the model calls returns its
    output scaled by 1.05 at C's batch of one; 5c's hold must reject it,
    and the service's threads stop on the way out."""
    llama = port("models.llama")
    wrapper = llama.paged_decode_attention_cuda
    monkeypatch.setattr(llama, "paged_decode_attention_cuda",
                        lambda *args: wrapper(*args) * 1.05)
    params, cfg, t = _tiny_http_inputs()
    before = {thread.name for thread in threading.enumerate()}
    try:
        with pytest.raises(AssertionError, match="decode kernel: an output is past its limit"):
            smoke["serving_http"](torch, params, cfg, t)
    finally:
        t["scorer"].shutdown()
    time.sleep(0.5)
    left = {thread.name for thread in threading.enumerate() if thread.is_alive()} - before
    assert not [name for name in left if name.startswith("kvtpu-")], left


def test_service_phase_at_a_small_size(monkeypatch):
    """Phase 14d end to end at a small size: every response over HTTP (one
    connection, then four concurrent clients) equals phase 13's, the
    incident's capture holds every request and replays clean, the debug
    surfaces answer with the handler and event roles profiled, and the
    port's reference A/B gives WHATIF_r01.json's headlines."""
    fleet, traffic = small_fleet(monkeypatch)
    out = smoke["service_phase"]("cpu", fleet, traffic)
    n = sum(len(traffic["scores"][w]) for w in traffic["scores"])
    incident = out["incident"]
    assert incident["truncated"] == [] and incident["scores"] == n
    assert incident["replay"]["ok"] and incident["replay"]["state_compared"]
    assert incident["files"] == ["capture.cbor", "profile.json", "slo.json"]
    assert set(out["sequential"]) == set(traffic["scores"])
    for cell in out["sequential"].values():  # the server's time lies inside the round trip
        assert 0 < cell["server_p50_ms"] <= cell["p50_ms"] and cell["outside_p50_ms"] > 0
    assert set(out["clients"]) == {"1 process", "4 processes", "4 threads of this process"}
    assert all(row["requests"] == sum(c["requests"] for c in out["sequential"].values())
               for row in out["clients"].values())
    assert out["whatif"]["headlines"] == json.loads(
        (REPO / "WHATIF_r01.json").read_text())["headlines"]


def test_service_phase_rejects_an_answer_unlike_phase_13s(monkeypatch):
    """A planted fault: phase 13's recorded scores for one request changed;
    14d's gate must name the request over HTTP that now differs, and stop
    its server and threads on the way out."""
    fleet, traffic = small_fleet(monkeypatch)
    workload = next(iter(traffic["scores"]))
    traffic["scores"][workload][0] = dict.fromkeys(traffic["pods"], 9.0)
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(AssertionError, match="score unlike phase 13's"):
        smoke["service_phase"]("cpu", fleet, traffic)
    time.sleep(0.5)
    left = {t.name for t in threading.enumerate() if t.is_alive()} - before
    assert not [name for name in left if name.startswith("kvtpu-")], left


# ------------------------------------------------------------- phase 7c


def test_vllm_backends_give_the_pool_and_flash_layouts():
    """The stand-in backends: the pool's per-layer tensor is the standard
    layout, FlashAttention's the split-KV one, and the port's layout
    probe reads them so (one view a layer, two a layer)."""
    spec_mod = port("offload.vllm_spec")
    pool_layer = torch.zeros(6, 2, 16, 2, 8)
    views, kernel_bs = spec_mod.infer_kv_tensor_views(
        {"l0": pool_layer, "l1": pool_layer.clone()}, {"l0": smoke["PoolLayerBackend"],
                                                       "l1": smoke["PoolLayerBackend"]})
    assert (len(views), kernel_bs) == (2, 16)
    views, kernel_bs = spec_mod.infer_kv_tensor_views(
        {"l0": torch.zeros(2, 6, 16, 2, 8)}, {"l0": smoke["FlashAttentionBackend"]})
    assert [v.name for v in views] == ["l0.k", "l0.v"] and kernel_bs == 16


def test_vllm_config_reads_as_the_references_documented_settings(tmp_path):
    llama = port("models.llama")
    cfg = llama.LlamaConfig.llama3_8b()
    spec = port("offload.vllm_spec").TPUSharedStorageOffloadingSpec(
        smoke["vllm_config"](str(tmp_path), cfg), None)
    assert (spec.device_block_size, spec.offloaded_block_size, spec.blocks_per_file) == (16, 256,
                                                                                         16)
    assert (spec.threads_per_chip, spec.max_staging_memory_gb) == (8, 16.0)
    assert spec.shared_storage_path == str(tmp_path)


def test_view_copies_count_only_device_tensors():
    class Tensor:
        def __init__(self, is_cuda):
            self.is_cuda = is_cuda

    class View:
        def __init__(self, is_cuda):
            self.tensor = Tensor(is_cuda)

        def read(self, ids):
            return list(ids)

        def write(self, ids, data):
            return None

    with smoke["ViewCopies"](View) as copies:
        assert View(True).read([1, 2]) == [1, 2]
        View(False).read([3])
        View(True).write([1], None)
        View(True).write([2], None)
    assert copies.counts == {"d2h": 1, "h2d": 2}
    assert View.read.__name__ == "read"  # restored


def test_vllm_offload_at_a_small_size(tmp_path):
    """Phase 7c end to end on CPU pools: pod-a's 16 prefix blocks through
    the port's vLLM spec over the pools' own tensors (4 files), loaded
    into pod-c's zeroed blocks (equal to pod-a's), B continued there
    bit-equal to its hit and decoded with every decode call held; the
    split-KV layout's files and a host copy's equal the pool layout's."""
    params, cfg, t = _tiny_tiering_inputs(tmp_path, 1.5)
    try:
        out = smoke["vllm_offload"](torch, params, cfg, dict(t, pod_a=t["pods"][0]),
                                    file_tokens=4 * cfg.block_size)
    finally:
        t["scorer"].shutdown()
    assert (out["files"], out["blocks_per_file"]) == (4, 4)
    assert out["pool"]["lookup"] == out["split"]["lookup"] == 4
    assert out["pool"]["blocks_equal"] and out["split"]["blocks_equal"]
    assert out["files_equal"] == {"split": True, "host": True}
    assert out["pool"]["views"] == cfg.n_layers and out["split"]["views"] == 2 * cfg.n_layers
    assert out["continuation_bit_equal"] and len(out["decoded"]) == 1 + smoke["VLLM_DECODE_STEPS"]
    # CPU tensors: the wrappers run their plain versions and count nothing.
    assert out["launches"] == {"flash_prefill": 0, "paged_decode": 0}
    assert out["held"]["paged_decode"]["calls"] == smoke["VLLM_DECODE_STEPS"] * cfg.n_layers
    assert out["pool"]["copies"] == {"d2h": 0, "h2d": 0}


def test_vllm_offload_rejects_a_decode_call_unlike_the_plain_version(tmp_path, monkeypatch):
    llama = port("models.llama")
    wrapper = llama.paged_decode_attention_cuda
    monkeypatch.setattr(llama, "paged_decode_attention_cuda",
                        lambda *args: wrapper(*args) * 1.05)
    params, cfg, t = _tiny_tiering_inputs(tmp_path, 1.5)
    try:
        with pytest.raises(AssertionError, match="7c: .*decode kernel: an output is past"):
            smoke["vllm_offload"](torch, params, cfg, dict(t, pod_a=t["pods"][0]),
                                  file_tokens=4 * cfg.block_size)
    finally:
        t["scorer"].shutdown()


def test_vllm_offload_rejects_a_load_that_drops_a_view(tmp_path, monkeypatch):
    """A planted fault: the spec's scatter skips the last layer's view;
    the blocks of pod-c then differ from pod-a's and 7c must say so."""
    view_cls = port("offload.vllm_spec").KVTensorView
    write = view_cls.write

    def lossy(view, block_ids, data):
        if not view.name.endswith(".1.self_attn.attn"):
            write(view, block_ids, data)

    monkeypatch.setattr(view_cls, "write", lossy)
    params, cfg, t = _tiny_tiering_inputs(tmp_path, 1.5)
    try:
        with pytest.raises(AssertionError, match="7c: lookup 4 of 4, blocks equal False"):
            smoke["vllm_offload"](torch, params, cfg, dict(t, pod_a=t["pods"][0]),
                                  file_tokens=4 * cfg.block_size)
    finally:
        t["scorer"].shutdown()


# ------------------------------------------------------------- phase 14e


def test_hf_word_tokenizer_gives_the_sidecar_ids_and_char_offsets():
    text = "t5 t17 t0 t123"
    out = smoke["HfWordTokenizer"]()(text, add_special_tokens=False, return_offsets_mapping=True)
    assert out["input_ids"] == [5, 17, 0, 123]
    assert [text[a:b] for a, b in out["offset_mapping"]] == text.split(" ")


def test_library_versions_name_what_cannot_be_imported(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "no_such_library_here", None)
    versions = smoke["library_versions"](("json", "no_such_library_here"))
    assert versions["no_such_library_here"] is None and versions["json"] is not None


def test_grpc_phase_at_a_small_size(monkeypatch):
    """Phase 14e end to end at a small size: every answer over gRPC equals
    phase 13's, the traceparent comes back with its trace, and an
    Indexer on the tokenizer sidecar scores the sample as the word
    tokenizer's does; its servers and threads stop on the way out."""
    fleet, traffic = small_fleet(monkeypatch)
    before = {t.name for t in threading.enumerate()}
    out = smoke["grpc_phase"]("cpu", fleet, traffic, sample=4)
    assert out["ran"] and out["requests"] == sum(len(s) for s in traffic["scores"].values())
    assert set(out["sequential"]) == set(traffic["scores"])
    assert out["traceparent"]["trace"] == "grpc.get_pod_scores"
    assert out["sidecar"]["backends"] == ["uds", "transformers"]
    assert out["sidecar"]["requests"] == 4 and out["sidecar"]["differing"] == 0
    time.sleep(0.5)
    left = {t.name for t in threading.enumerate() if t.is_alive()} - before
    assert not [name for name in left if name.startswith("kvtpu-")], left


def test_grpc_phase_rejects_an_answer_unlike_phase_13s(monkeypatch):
    fleet, traffic = small_fleet(monkeypatch)
    workload = next(iter(traffic["scores"]))
    traffic["scores"][workload][0] = dict.fromkeys(traffic["pods"], 9.0)
    with pytest.raises(AssertionError, match="answers over gRPC differ from phase 13's"):
        smoke["grpc_phase"]("cpu", fleet, traffic, sample=4)


def test_grpc_phase_runs_nothing_without_its_libraries(monkeypatch):
    """Where ``grpc`` or ``google.protobuf`` cannot be imported (the
    phase's own check, patched), 14e says which and runs nothing."""
    monkeypatch.setitem(smoke["grpc_phase"].__globals__, "library_versions",
                        lambda: {"grpc": None, "google.protobuf": "6"})
    out = smoke["grpc_phase"]("cpu", {"frames": {}}, {"pods": [], "block": 16}, sample=4)
    assert out == {"libraries": {"grpc": None, "google.protobuf": "6"}, "ran": False}


# ------------------------------------------------------------- phase 6b


def test_transfer_summary_is_per_ring_step():
    records = [dict(d2h_ms=0.2, h2d_ms=0.3, wait_ms=5.0, span_ms=9.0, bytes_out=8, bytes_in=8),
               dict(d2h_ms=0.4, h2d_ms=0.1, wait_ms=3.0, span_ms=7.0, bytes_out=8, bytes_in=8)]
    got = smoke["transfer_summary"](records)
    assert got["steps"] == 2
    assert got["d2h_ms_per_step"] == pytest.approx(0.3)
    assert got["h2d_ms_per_step"] == pytest.approx(0.2)
    assert got["wait_ms_per_step"] == pytest.approx(4.0)
    assert got["span_ms_per_step"] == pytest.approx(8.0)
    assert got["bytes_out_per_step"] == got["bytes_in_per_step"] == 8
    assert got["staging_ms"] == pytest.approx(1.0) and got["wait_ms"] == pytest.approx(8.0)


def _held_ring(monkeypatch, fault: bool):
    """Phase 6b's hold of every partial launch, around a 4-rank flash ring
    on CPU ranks (the wrapper takes its plain version there)."""
    from types import SimpleNamespace

    ring, mesh = port("ops.ring_attention"), port("parallel.mesh")
    if fault:
        real = ring.flash_partial_cuda

        def skewed(q, k, v, *, causal_offset=0):
            acc, m, l = real(q, k, v, causal_offset=causal_offset)
            return acc * 1.1, m, l

        monkeypatch.setattr(ring, "flash_partial_cuda", skewed)
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
               for s in ((1, 32, 4, 64), (1, 32, 2, 64), (1, 32, 2, 64)))
    tmesh = mesh.make_mesh(mesh.MeshPlan(dp=1, sp=4), ["cpu"] * 4)
    fake_torch = SimpleNamespace(float32=torch.float32,
                                 cuda=SimpleNamespace(synchronize=lambda: None))
    return smoke["hold_partials"](fake_torch, lambda: ring.ring_attention(
        q, k, v, tmesh, striped=True, impl="flash"))


def test_hold_partials_holds_every_launch(monkeypatch):
    held = _held_ring(monkeypatch, fault=False)
    assert held["calls"] == 16 and held["offsets"] == {"0": 10, "-1": 6}
    assert held["worst_err_over_limit"] == 0.0 and held["exact_empty_rows"]


def test_hold_partials_rejects_a_planted_fault(monkeypatch):
    with pytest.raises(AssertionError, match="disagrees with the plain version"):
        _held_ring(monkeypatch, fault=True)


# ------------------------------------------------------------- phase 12f


def test_across_meshes_and_their_plans():
    """Phase 12f's meshes: tp across the processes, pp across them and
    the reference's default fleet (make_hybrid_mesh()'s defaults), the
    MoE over ici tp 2 x dcn ep 2, each over ACROSS_WORLD processes."""
    assert smoke["ACROSS_MESHES"] == {"tp": (dict(dp=1), dict(dp=1, tp=2)),
                                      "pp": (dict(dp=1), dict(dp=1, pp=2)), "dp": None}
    assert smoke["ACROSS_MOE"] == (dict(dp=1, tp=2), dict(dp=1, ep=2))
    mesh = port("parallel.mesh")
    world = smoke["ACROSS_WORLD"]
    for name, plans in smoke["ACROSS_MESHES"].items():
        ici, dcn = ((mesh.MeshPlan(dp=1, tp=1), mesh.MeshPlan(dp=world)) if plans is None
                    else (mesh.MeshPlan(**plans[0]), mesh.MeshPlan(**plans[1])))
        # One rank a process, the DCN degrees over the processes.
        assert ici.resolve(1) and dcn.resolve(world)[name] == world, name


@pytest.mark.parametrize("name,want", [
    ("tp", {"flash_prefill": 64, "paged_decode": 256}),
    ("pp", {"flash_prefill": 32, "paged_decode": 128}),
    ("dp", {"flash_prefill": 32, "paged_decode": 256}),
    ("moe", {"flash_prefill": 16}),
])
def test_across_launches_a_process(name, want):
    layers = 8 if name == "moe" else 32
    assert smoke["across_launches"](name, layers) == want
    with pytest.raises(ValueError):
        smoke["across_launches"]("sp", 32)


def test_across_launches_by_path_sums_the_processes():
    per = {"tp": [{"flash_prefill": 64, "paged_decode": 256}] * 2,
           "pp": [{"flash_prefill": 32, "paged_decode": 128}] * 2,
           "dp": [{"flash_prefill": 32, "paged_decode": 256}] * 2,
           "moe": [{"flash_prefill": 16}] * 2}
    got = smoke["across_launches_by_path"](per)
    assert got == {
        "flash_prefill": {"llama_serving_processes_tp": 128, "llama_serving_processes_pp": 64,
                          "llama_serving_processes_dp": 64, "moe_forward_processes_ep_tp": 32},
        "paged_decode": {"llama_serving_processes_tp": 512, "llama_serving_processes_pp": 256,
                         "llama_serving_processes_dp": 512}}


def test_logits_gap_and_its_gate():
    ref = torch.tensor([[1.0, -16.0, 3.0]])
    same = smoke["logits_gap"](torch, ref.clone(), ref)
    assert same == {"bit_equal": True, "max_abs_err": 0.0, "tol": 1.0, "finite": True}
    assert smoke["gap_held"](same, exact=True)
    near = smoke["logits_gap"](torch, ref + 0.5, ref)
    assert not near["bit_equal"] and near["max_abs_err"] == 0.5
    assert smoke["gap_held"](near, exact=False) and not smoke["gap_held"](near, exact=True)
    far = smoke["logits_gap"](torch, ref + 2.0, ref)
    assert not smoke["gap_held"](far, exact=False)
    bad = smoke["logits_gap"](torch, ref * float("nan"), ref)
    assert not smoke["gap_held"](bad, exact=False)
    pool = torch.zeros(3, 4, 2)
    other = pool.clone()
    other[2, 1, 0] = 0.25
    assert smoke["pool_gap"](torch, pool, pool.clone())["bit_equal"]
    gap = smoke["pool_gap"](torch, other, pool)
    assert not gap["bit_equal"] and gap["max_abs_err"] == 0.25 and gap["tol"] == 2.0**-4


def test_transfers_by_kind():
    records = [dict(kind="all_reduce:tp", bytes_out=8, bytes_in=8, span_ms=4.0, d2h_ms=1.0,
                    h2d_ms=0.5, wait_ms=4.0),
               dict(kind="all_reduce:tp", bytes_out=8, bytes_in=8, span_ms=2.0, d2h_ms=1.0,
                    h2d_ms=0.5, wait_ms=2.0),
               dict(kind="hop:pp", bytes_out=4, bytes_in=0, span_ms=1.0, d2h_ms=0.2, h2d_ms=0.0,
                    wait_ms=1.0)]
    got = smoke["transfers_by_kind"](records)
    assert got["all_reduce:tp"] == {"calls": 2, "bytes_out": 16, "bytes_in": 16, "span_ms": 6.0,
                                    "d2h_ms": 2.0, "h2d_ms": 1.0, "ms_per_call": 3.0}
    assert got["hop:pp"]["calls"] == 1 and got["hop:pp"]["ms_per_call"] == 1.0
    text = smoke["transfers_text"](got)
    assert text.startswith("all_reduce:tp 2 calls") and "hop:pp 1 calls" in text


def test_share_tree_views_contiguous_slices_and_copies_the_rest():
    """Phase 12f's share (``sharding.share_tree``): a stage's layers and a
    leaf that is not cut are views of the parent's tensor (no second
    copy on the card); a tp slice is a copy; every local bit-equal to its
    slice, as shard_tree's."""
    llama, mesh, sharding = port("models.llama"), port("parallel.mesh"), port("parallel.sharding")
    cfg = llama.LlamaConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=64, dtype="float32")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tmesh = mesh.make_mesh(mesh.MeshPlan(dp=1, pp=2, tp=2), ["cpu"] * 4)
    shared = sharding.share_tree(params, tmesh, llama.param_pspecs(cfg))
    copied = sharding.shard_tree(params, tmesh, llama.param_pspecs(cfg))
    assert smoke["tree_shard_mismatches"](torch, shared, params) == {}
    for path, leaf in smoke["leaf_paths"](shared):
        want = dict(smoke["leaf_paths"](copied))[path]
        for (coord, a), (_, b) in zip(leaf.distinct(), want.distinct()):
            assert torch.equal(a, b), (path, coord)
    full = params["layers"]["ln1"]
    ln1 = shared["layers"]["ln1"]
    assert ln1.local(pp=1).data_ptr() == full[1:].data_ptr()  # a view of stage 1's layer
    assert shared["ln_f"].local().data_ptr() == params["ln_f"].data_ptr()
    wq = shared["layers"]["wq"].local(pp=0, tp=1)
    assert wq.is_contiguous() and wq.data_ptr() != params["layers"]["wq"].data_ptr()


def _pool_rows(name, **over):
    row = {"pool_checksum": 7, "pool_copies_equal": True, "prefill_pool_equal": True,
           "pool_gap": {"bit_equal": True, "max_abs_err": 0.0, "tol": 1.0, "finite": True}}
    row.update(over)
    return [row, dict(row)]


@pytest.mark.parametrize("name,fault", [
    ("tp", None), ("pp", None), ("dp", None),
    ("tp", dict(pool_gap={"bit_equal": False, "max_abs_err": 1e-3, "tol": 1.0, "finite": True})),
    ("pp", dict(pool_copies_equal=False)), ("dp", dict(prefill_pool_equal=False)),
    ("dp", dict(pool_copies_equal=False)),
    ("dp", dict(pool_gap={"bit_equal": False, "max_abs_err": 2.0, "tol": 1.0, "finite": True})),
])
def test_check_pools_holds_each_mesh_to_its_gate(name, fault):
    """tp: each slice byte-equal to 12a's; pp: the copies alike; the
    fleet: copies alike, the prefill's blocks byte-equal to the parent's,
    after the decode steps within the model-level limit.  A planted
    difference fails the phase."""
    rows = _pool_rows(name, **(fault or {}))
    if fault is None:
        out = smoke["check_pools"](name, rows)
        assert out["checksums"] == [7, 7]
        return
    with pytest.raises(AssertionError, match=f"12f {name}: a process's pool is off"):
        smoke["check_pools"](name, rows)
    if name == "dp" and "pool_gap" in fault:
        near = _pool_rows(name, pool_gap={"bit_equal": False, "max_abs_err": 0.5, "tol": 1.0,
                                          "finite": True})
        assert smoke["check_pools"](name, near)["held"]


def test_plain_ring_launches_split_ring_steps_over_processes():
    """A process's partial launches are its ring ranks' share: contiguous
    rank s launches s + 1 times a layer, striped sp times; over the
    processes that is ``ring_steps`` a head shard."""
    launches = smoke["plain_ring_launches"]
    assert [launches(r, 4, False, 1, 8) for r in ([0, 1], [2, 3])] == [24, 56]
    assert [launches(r, 2, False, 2, 8) for r in ([0], [1])] == [16, 32]
    assert [launches(r, 2, True, 2, 8) for r in ([0], [1])] == [32, 32]
    for sp, striped in ((4, False), (4, True), (2, False), (2, True)):
        halves = (list(range(sp // 2)), list(range(sp // 2, sp)))
        assert sum(launches(r, sp, striped, 3, 5) for r in halves) == (
            smoke["ring_steps"](sp, striped) * 3 * 5)


def test_first_layers_views_the_stacked_leaves():
    llama = port("models.llama")
    cfg = llama.LlamaConfig(vocab_size=64, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2,
                            d_ff=64, dtype="float32")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cut = smoke["first_layers"](params, 2)
    for key, leaf in params["layers"].items():
        assert cut["layers"][key].shape[0] == 2
        assert cut["layers"][key].data_ptr() == leaf.data_ptr()
    assert cut["embed"] is params["embed"] and cut["ln_f"] is params["ln_f"]


def _gap(**over):
    gap = {"bit_equal": True, "max_abs_err": 0.0, "tol": 1.0, "finite": True}
    gap.update(over)
    return gap


def _plain_workers(fault=None):
    """Two workers' rows of 12f's plain blocks (a ring of 4 for the MoE,
    tp 2 x sp 2 for the Llama), with ``fault`` planted in process 1."""
    held = {"calls": 1, "offsets": {}, "max_abs_err": 0.0, "worst_err_over_limit": 0.0,
            "limit": "x"}
    workers = []
    for r in range(2):
        sp = [2 * r, 2 * r + 1]
        moe = {"mesh": "m", "crossing": ["sp"], "ranks": {"sp": sp, "tp": [0]},
               "share": {"plain_bytes": 8, "view_bytes": 8, "copied_bytes": 0,
                         "allocated_bytes": 0},
               "peak_bytes": 1, "wall_ms": 1.0, "logits": {s: _gap() for s in sp}, "aux": 1.0,
               "aux_equal": True, "routed_otherwise": 0, "first_layer_input_differs": None,
               "transfers": {}, "idle_share": 0.5, "device_ms": 1.0, "profiled_wall_ms": 2.0,
               "launches": [24, 56][r], "held": held}
        layouts = {}
        for name, launches in (("contiguous", [16, 32][r]), ("striped", 32)):
            layouts[name] = {"wall_ms": 1.0, "launches": launches, "transfers": {},
                             "chunks": {r: {"bit_equal": True, "dense": _gap()}},
                             "idle_share": 0.5, "device_ms": 1.0, "profiled_wall_ms": 2.0,
                             "held": held}
            if r == 1:
                layouts[name]["token"] = 3
        llama = {"mesh": "m", "crossing": ["sp"], "ranks": {"sp": [r], "tp": [0, 1]},
                 "share": {"plain_bytes": 8, "view_bytes": 0, "copied_bytes": 8,
                           "allocated_bytes": 8}, "peak_bytes": 1, "layouts": layouts}
        workers.append({"plain_moe": moe, "plain_llama": llama})
    if fault == "moe-bits":
        workers[1]["plain_moe"]["logits"][3] = _gap(bit_equal=False, max_abs_err=1e-3)
    elif fault == "moe-aux":
        workers[1]["plain_moe"]["aux_equal"] = False
    elif fault == "moe-routes":
        workers[1]["plain_moe"]["routed_otherwise"] = 1
    elif fault == "moe-copied":
        workers[1]["plain_moe"]["share"]["copied_bytes"] = 4
    elif fault == "moe-launches":
        workers[1]["plain_moe"]["launches"] = 55
    elif fault == "llama-bits":
        workers[1]["plain_llama"]["layouts"]["striped"]["chunks"][1]["bit_equal"] = False
    elif fault == "llama-dense":
        workers[1]["plain_llama"]["layouts"]["contiguous"]["chunks"][1]["dense"] = _gap(
            bit_equal=False, max_abs_err=2.0)
    elif fault == "llama-token":
        workers[1]["plain_llama"]["layouts"]["contiguous"]["token"] = 5
    elif fault == "llama-launches":
        workers[0]["plain_llama"]["layouts"]["contiguous"]["launches"] = 32
    return workers


PLAIN_FAULTS = {"moe-bits": "12f plain MoE, process 1: off the one-process plain ring",
                "moe-aux": "12f plain MoE, process 1: off the one-process plain ring",
                "moe-routes": "12f plain MoE, process 1: off the one-process plain ring",
                "moe-copied": "12f plain MoE, process 1: the share copied",
                "moe-launches": "12f plain MoE: launches",
                "llama-bits": "12f plain Llama striped: bit-equal",
                "llama-dense": "12f plain Llama contiguous: bit-equal",
                "llama-token": "12f plain Llama contiguous next token",
                "llama-launches": "12f plain Llama contiguous: launches"}


@pytest.mark.parametrize("fault", [None] + list(PLAIN_FAULTS))
def test_check_plain_holds_each_block_to_its_gate(fault):
    """The MoE block: every chunk and the aux bit for bit, no token routed
    otherwise, nothing copied by the share, launches a process its ring
    ranks' share; the Llama block: every chunk bit for bit (fingerprints)
    and within the model-level limit of the dense forward, its next
    token, launches likewise.  Each planted fault fails the phase."""
    dense = torch.zeros(1, 4, 8)
    dense[0, -1, 3] = 1.0
    plain_args = {"llama": {"ref": {"dense": dense}}}
    walls = {"moe_ring_ms": 1.0, "llama_contiguous_ms": 1.0, "llama_striped_ms": 1.0,
             "llama_dense_ms": 1.0}
    if fault is None:
        out = smoke["check_plain"](_plain_workers(), plain_args, walls)
        assert out["launches_by_path"] == {"moe_ring_processes_plain_sp": 80,
                                           "llama_ring_processes_plain_tp_sp_contiguous": 48,
                                           "llama_ring_processes_plain_tp_sp_striped": 64}
        assert out["moe"]["bit_equal"] and out["llama"]["layouts"]["striped"]["bit_equal"]
        return
    with pytest.raises(AssertionError, match=PLAIN_FAULTS[fault]):
        smoke["check_plain"](_plain_workers(fault), plain_args, walls)


def test_new_paths_import_without_a_gpu_and_build_nothing():
    """The modules phase 12f drives import in a fresh interpreter with no
    CUDA device and load no kernel library."""
    import subprocess
    import sys

    code = ("import importlib, json\n"
            "for name in ('parallel.process_group', 'parallel.sharding', 'models.llama',\n"
            "             'models.moe', 'models.kv_cache_pool', 'ops.ring_attention'):\n"
            "    importlib.import_module('llm_d_kv_cache_manager_tpu_torch.' + name)\n"
            "b = importlib.import_module('llm_d_kv_cache_manager_tpu_torch.ops._build')\n"
            "import torch\n"
            "print(json.dumps([len(b._LIBS), torch.cuda.is_available()]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [0, False]


def test_fingerprint_tells_one_changed_element_apart():
    """Phase 9b's and 12d-across's fingerprint: the same bits give the
    same value on any layout of the same elements; one changed element
    (one bit, or a sign of zero) always changes it; the element order
    counts."""
    fp = smoke["fingerprint"]
    x = torch.randn(3, 5, 7)
    assert fp(torch, x) == fp(torch, x.clone()) == fp(torch, x.transpose(0, 1).contiguous()
                                                      .transpose(0, 1))
    for flip in ((0, 0, 0), (2, 4, 6), (1, 2, 3)):
        y = x.clone()
        y.view(torch.int32)[flip] ^= 1
        assert fp(torch, y) != fp(torch, x), flip
    z = torch.zeros(4)
    negative = z.clone()
    negative[2] = -0.0
    assert fp(torch, negative) != fp(torch, z)
    assert fp(torch, x.flip(0)) != fp(torch, x)
    assert fp(torch, x.bfloat16()) != fp(torch, x.bfloat16().flip(1))


def test_fingerprint_mismatches_find_the_bad_slice():
    """Fingerprints of a state on a tp 2 mesh against the global tensors:
    a slice changed in the global tensor is named by its path and
    coordinate; a plain tensor by its path."""
    mesh, sharding = port("parallel.mesh"), port("parallel.sharding")
    tmesh = mesh.make_mesh(mesh.MeshPlan(dp=1, tp=2), ["cpu"] * 2)
    full = {"w": torch.randn(4, 6), "step": torch.tensor(3.0)}
    state = {"w": sharding.shard(full["w"], tmesh, sharding.P(None, "tp")), "step": full["step"]}
    prints = smoke["tree_fingerprints"](torch, state)
    specs = {"w": (None, "tp")}
    assert smoke["fingerprint_mismatches"](torch, sharding, tmesh, specs, prints, full,
                                           "cpu") == []
    changed = dict(full, w=full["w"].clone(), step=torch.tensor(4.0))
    changed["w"][1, 5] += 1
    bad = smoke["fingerprint_mismatches"](torch, sharding, tmesh, specs, prints, changed, "cpu")
    assert bad == [("w", tmesh.coord(tp=1)), ("step", None)]


def test_transfers_by_direction_and_own_bytes():
    """The forward's kinds, the backward's (``:bwd`` and their order
    checks) and the gradients' sync (``sum:``) apart; a state's bytes a
    restore must read: one copy of each slice, and its plain tensors."""
    by_kind = {
        "all_reduce:tp": {"calls": 2, "bytes_out": 16, "bytes_in": 16, "span_ms": 6.0,
                          "d2h_ms": 2.0, "h2d_ms": 1.0, "ms_per_call": 3.0},
        "all_reduce:tp:bwd": {"calls": 1, "bytes_out": 8, "bytes_in": 8, "span_ms": 1.0,
                              "d2h_ms": 0.5, "h2d_ms": 0.5, "ms_per_call": 1.0},
        "order:tp": {"calls": 1, "bytes_out": 16, "bytes_in": 16, "span_ms": 0.5,
                     "d2h_ms": 0.0, "h2d_ms": 0.0, "ms_per_call": 0.5},
        "sum:tp": {"calls": 3, "bytes_out": 12, "bytes_in": 12, "span_ms": 3.0,
                   "d2h_ms": 0.0, "h2d_ms": 0.0, "ms_per_call": 1.0}}
    got = smoke["transfers_by_direction"](by_kind)
    assert got["forward"]["calls"] == 2 and got["forward"]["bytes_out"] == 16
    assert got["backward"]["calls"] == 2 and got["backward"]["bytes_in"] == 24
    assert got["backward"]["span_ms"] == 1.5 and got["sync"]["calls"] == 3
    mesh, sharding = port("parallel.mesh"), port("parallel.sharding")
    tmesh = mesh.make_mesh(mesh.MeshPlan(dp=2, tp=2), ["cpu:0", "cpu:1", "cpu:2", "cpu:3"])
    state = {"w": sharding.shard(torch.zeros(4, 6), tmesh, sharding.P(None, "tp")),
             "b": sharding.shard(torch.zeros(8), tmesh, sharding.P(None)),
             "step": torch.zeros(())}
    # w: two tp halves of 12 floats; b: one copy of 8 floats; the step.
    assert smoke["own_bytes"](torch, state) == (2 * 12 + 8 + 1) * 4


def test_rss_peak_sees_what_the_block_held():
    """12d-across's sampled peak: 64 MiB touched and dropped inside the
    block lift the peak above the resident set before it."""
    before = smoke["host_rss_bytes"]()
    with smoke["RssPeak"]() as rss:
        held = np.ones(64 << 20, dtype=np.uint8)
        time.sleep(0.05)
        del held
    assert rss.peak >= before + (32 << 20)


def test_offload_smoke_phase_at_tiny_on_a_cpu_pool(capsys):
    """Phase 7d whole on a CPU pool at the reference's geometry: the
    smoke's round trip, ladder and walls (no pinned path on the CPU)."""
    out = smoke["offload_smoke_phase"]("cpu", device="cpu", geometry="tiny")
    assert out["round_trip"] == "bit-identical"
    assert out["score_ladder"] == pytest.approx([1.0, 0.8, 0.5], abs=1e-12)
    assert out["uses_pinned"] is False
    assert out["block_nbytes"] == 2 * 2 * 8 * 2 * 16 * 2
    assert out["round_trip_bytes"] == 4 * out["block_nbytes"]
    assert out["store_s"] > 0 and out["load_s"] > 0
    assert out["store_gbps"] == pytest.approx(out["round_trip_bytes"] / out["store_s"] / 1e9)
    assert out["plain_slots"] == {"files": 2, "bytes": 7 * out["block_nbytes"],
                                  "pool_path_pinned": False}
    printed = capsys.readouterr().out
    assert "offload smoke completed successfully" in printed
    assert "use_pinned=False on a pool on cpu: 2 files" in printed
    assert "bit-identical, store" in printed and "GB/s" in printed


def _tiny_pool_config():
    return runpy.run_path(smoke["OFFLOAD_SMOKE"], run_name="offload_smoke_torch")["geometry"]("tiny")


def test_plain_slots_check_against_a_pool_that_offers_the_pinned_path(monkeypatch):
    """Phase 7d's use_pinned check where the pool offers the pinned path
    (as a CUDA pool does; here its side-stream copy is a CPU gather):
    the engine that follows the pool takes it, the forced one never
    does, and their files agree with each other and with the pool."""
    pool_mod = port("models.kv_cache_pool")
    calls = []

    class Event:
        def synchronize(self):
            pass

    def stage_gather_pinned(self, ids):
        calls.append(list(ids))
        return self.kv[:, torch.as_tensor(ids)].movedim(1, 0).contiguous(), Event()

    monkeypatch.setattr(pool_mod.KVCachePool, "pinned_host", property(lambda self: True))
    monkeypatch.setattr(pool_mod.KVCachePool, "stage_gather_pinned", stage_gather_pinned)
    out = smoke["plain_slots_check"](torch, _tiny_pool_config(), "cpu")
    assert out == {"files": 2, "bytes": 7 * 2 * 2 * 8 * 2 * 16 * 2, "pool_path_pinned": True}
    assert calls == [[9, 2, 14, 5], [0, 11, 7]]  # the pinned engine's groups only


def test_plain_slots_check_fails_on_a_byte_flipped_in_a_plain_file():
    """A planted fault: one byte of a plain-slot file flipped before the
    comparison must fail the check."""
    def flip(root):
        path = next(os.path.join(d, f) for d, _, files in os.walk(root) for f in files)
        with open(path, "r+b") as handle:
            first = handle.read(1)
            handle.seek(0)
            handle.write(bytes([first[0] ^ 1]))

    with pytest.raises(AssertionError, match="plain slots' files are not byte-identical"):
        smoke["plain_slots_check"](torch, _tiny_pool_config(), "cpu", tamper=flip)


def test_offload_smoke_phase_fails_on_a_byte_flipped_after_the_load():
    """A planted fault: one byte of a loaded block flipped before the
    comparison must fail the phase."""
    def flip(pool):
        pool.kv.view(torch.uint8)[0, 3, 0, 0, 0, 0] ^= 1

    with pytest.raises(AssertionError, match="not equal"):
        smoke["offload_smoke_phase"]("cpu", device="cpu", geometry="tiny", after_load=flip)


def test_chart_connector_phase_at_a_tiny_geometry_on_a_cpu_pool(capsys):
    """Phase 7e whole on CPU tensors at a tiny KV geometry: the spec
    resolved from the chart's config, 64 blocks of 16 tokens stored as 4
    files of 256 tokens under the re-rooted ``<root>/kv-cache`` and loaded
    into a second pod's blocks byte for byte, the chart's threads and
    staging cap taken, the in-phase flipped byte caught."""
    out = smoke["chart_connector_phase"]("cpu", device="cpu", kv_geometry=(2, 2, 16),
                                         tokens=1024)
    assert out["spec"] == ("llm_d_kv_cache_manager_tpu_torch.offload.vllm_spec."
                           "TPUSharedStorageOffloadingSpec")
    assert out["config"]["shared_storage_path"] == "/mnt/shared-kv/kv-cache"
    assert out["shared_storage_path"].endswith("/kv-cache")
    assert not out["shared_storage_path"].startswith("/mnt/")
    assert (out["blocks"], out["files"], out["lookup"]) == (64, 4, 4)
    block_nbytes = 2 * 2 * 16 * 2 * 16 * 2  # layers x K/V x tokens x heads x dim x bf16
    assert out["bytes"] == 64 * block_nbytes and out["file_bytes"] == [16 * block_nbytes]
    assert (out["threads_per_chip"], out["max_staging_memory_gb"]) == (8, 16.0)
    assert out["staging_budget_bytes"] == 16 << 30
    assert out["layers_differing"] == [] and out["flip_caught"] is True
    assert out["store_rate"]["gbps"] == pytest.approx(
        out["bytes"] / out["store"]["wall_ms"] / 1e6)
    printed = capsys.readouterr().out
    assert "from the chart's --kv-transfer-config" in printed and "GB/s" in printed


def test_chart_connector_phase_fails_on_a_byte_flipped_after_the_load():
    """A planted fault: one byte of a loaded block flipped before the
    comparison must fail the phase."""
    def flip(tensors):
        next(iter(tensors.values())).view(torch.uint8)[0, 5, 0, 0, 0] ^= 1

    with pytest.raises(AssertionError, match="not byte-identical"):
        smoke["chart_connector_phase"]("cpu", device="cpu", kv_geometry=(2, 2, 16),
                                       tokens=1024, after_load=flip)


def test_shape_cases_cover_the_kernels_set():
    """Phases 2-4's shape cases stay inside the shapes the kernels
    take, and together reach what the issue names: every head dim of
    the set on each of the three kernels in bf16 (phases 2-4's own cases
    add 64 and 128 to each), groups 3, 5, 7 and 16, pool blocks 8-128,
    float32 at 32, 96, 256; the guard's head dim lies outside."""
    heads = port("ops.tile_plan").HEAD_DIMS
    earlier = {64, 128}  # phases 2-4's Llama-3-8B and older edge cases
    bf16 = {"prefill": set(earlier), "decode": set(earlier), "ring": set(earlier)}
    f32, groups, blocks = set(), set(), set()
    for H, Hkv, D in smoke["SHAPE_PREFILL"]:
        bf16["prefill"].add(D), bf16["ring"].add(D)
        groups.add(H // Hkv)
    for H, Hkv, D, bs in smoke["SHAPE_DECODE"]:
        bf16["decode"].add(D), groups.add(H // Hkv), blocks.add(bs)
    for kernel, cases in (("prefill", smoke["SHAPE_PREFILL_EDGE"]),
                          ("ring", smoke["SHAPE_RING_EDGE"])):
        for B, Tq, Tk, H, Hkv, D, _, dtype in cases:
            (f32 if dtype == "float32" else bf16[kernel]).add(D)
            groups.add(H // Hkv)
    for B, H, Hkv, D, mb, ctx, dtype, bs in smoke["SHAPE_DECODE_EDGE"]:
        (f32 if dtype == "float32" else bf16["decode"]).add(D)
        groups.add(H // Hkv), blocks.add(bs)
        assert len(ctx) == B and max(ctx) <= mb * bs
    for kernel, widths in bf16.items():
        assert widths == set(heads), kernel
    assert f32 <= set(heads) and {32, 96, 256} <= f32
    assert {3, 5, 7, 16} <= groups and groups <= set(range(1, 17))
    assert blocks == {8, 16, 32, 64, 128}
    # Phase 5e's decode shape (group 2 of 4 KV heads at head dim 32,
    # block 16) is held element by element beside its model-level check.
    cfg = smoke["GRAFT_CFG"]
    graft = (cfg["n_heads"], cfg["n_kv_heads"], cfg["d_model"] // cfg["n_heads"], "bfloat16", 16)
    assert graft in {(H, Hkv, D, dtype, bs)
                     for _, H, Hkv, D, _, _, dtype, bs in smoke["SHAPE_DECODE_EDGE"]}
    assert inspect.signature(smoke["shape_guard_case"]).parameters["head_dim"].default not in heads


def test_repacked_decode_drops_exactly_the_tokens_it_names():
    """The decode planted fault's reference on CPU tensors: a sequence's
    tokens repacked into 16-token blocks, less a token range, give the
    plain decode over those tokens alone, at any pool block size."""
    pc = port("ops.paged_decode_cuda")
    rng = np.random.default_rng(4)
    for bs in (8, 32):
        kv = torch.from_numpy(rng.standard_normal((6, 2, bs, 2, 32)).astype(np.float32))
        q = torch.from_numpy(rng.standard_normal((1, 4, 32)).astype(np.float32))
        row = torch.tensor([4, 1, 5, 0, 2, 3], dtype=torch.int32)
        tokens = 5 * bs - 3
        full = pc.paged_decode_attention_plain(q, kv, row[None], torch.tensor([tokens]))
        same = smoke["repacked_decode"](torch, pc, q, kv, row, tokens, (0, 0))
        torch.testing.assert_close(same, full)
        drop = (16, 40)
        seq = kv[row.long()].permute(1, 0, 2, 3, 4).reshape(2, -1, 2, 32)[:, :tokens]
        keep = torch.cat((seq[:, :drop[0]], seq[:, drop[1]:]), 1)
        k, v = keep[0], keep[1]
        scores = torch.einsum("hgd,thd->hgt", q[0].reshape(2, 2, 32), k) / 32 ** 0.5
        want = torch.einsum("hgt,thd->hgd", scores.softmax(-1), v).reshape(1, 4, 32)
        got = smoke["repacked_decode"](torch, pc, q, kv, row, tokens, drop)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _tiny_phase5(block_size=16):
    """Phase 5's requests at a small size on CPU params: A's miss, B's
    hit over A's prefix and three decode steps at batch 2 (the port's
    own path at block 16), as ``sharded_inputs`` carries them."""
    llama, pool_mod = port("models.llama"), port("models.kv_cache_pool")
    cfg = llama.LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=96, dtype="float32", block_size=block_size)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    prefix = [int(x) for x in rng.integers(1, 256, 64)]
    prompt_a = prefix + [int(x) for x in rng.integers(1, 256, 32)]
    prompt_b = prefix + [int(x) for x in rng.integers(1, 256, 32)]
    bs = block_size
    pool = pool_mod.KVCachePool(pool_mod.KVCachePoolConfig(2, 16, bs, 2, 16, "float32"),
                                device="cpu")
    ids_a = list(range(96 // bs))
    ids_b = ids_a[:64 // bs] + list(range(96 // bs, 128 // bs))
    logits_a, _ = llama.prefill_paged(params, torch.tensor([prompt_a]), pool.kv,
                                      torch.tensor([ids_a], dtype=torch.int32), cfg)
    logits_b, _ = llama.prefill_continue(params, torch.tensor([prompt_b[64:]]), pool.kv,
                                         torch.tensor([ids_b], dtype=torch.int32), 64, cfg)
    table = torch.tensor([ids_a + [14], ids_b + [15]], dtype=torch.int32)
    tokens = torch.tensor([int(logits_a[0, -1].argmax()), int(logits_b[0, -1].argmax())])
    inputs, steps = [], []
    for i in range(3):
        ctx = torch.full((2,), 97 + i, dtype=torch.int32)
        inputs.append((tokens, ctx))
        steps.append(llama.decode_step(params, tokens, pool.kv, table, ctx, cfg)[0])
        tokens = steps[-1].argmax(-1)
    ref = dict(prompt_a=prompt_a, prompt_b=prompt_b, miss_tail=logits_a[:, -16:].clone(),
               logits_b=logits_b, decode_inputs=inputs, step_logits=steps)
    return params, cfg, ref


def test_serving_block_at_a_small_size():
    """Phase 5d on CPU params: phase 5's requests over a pool of 32-token
    blocks give phase 5's tokens, and logits within the model-level
    limit (here equal to float32 rounding)."""
    params, cfg, ref = _tiny_phase5()
    out = smoke["serving_block"](torch, params, cfg, ref, block_size=32)
    assert out["tokens_equal"] and len(out["tokens"]) == 2 + 2 * 3
    assert out["launches"] == {"flash_prefill": 0, "paged_decode": 0}
    assert max(out["max_abs_err"].values()) < 1e-4


def test_serving_block_rejects_a_decode_that_drops_its_attention(monkeypatch):
    """A planted fault: the decode wrapper the model calls returns 100
    times its output; 5d's hold of the decode steps must reject it."""
    params, cfg, ref = _tiny_phase5()
    llama = port("models.llama")
    wrapper = llama.paged_decode_attention_cuda
    monkeypatch.setattr(llama, "paged_decode_attention_cuda", lambda *a: wrapper(*a) * 100)
    with pytest.raises(AssertionError, match="5d decode step 1"):
        smoke["serving_block"](torch, params, cfg, ref, block_size=32)


def test_serving_block_refuses_requests_off_its_blocks():
    params, cfg, ref = _tiny_phase5()
    with pytest.raises(AssertionError, match="do not fall on 64-token blocks"):
        smoke["serving_block"](torch, params, cfg, ref, block_size=64)


def test_graft_config_phase_on_the_cpu(capsys):
    """Phase 5e on CPU tensors, float32: the reference's small config
    (head dim 32, a group of 2) through forward, prefill_paged and the
    decode steps, each against the dense op; no launch counted."""
    assert smoke["GRAFT_CFG"]["d_model"] // smoke["GRAFT_CFG"]["n_heads"] == 32
    out = smoke["graft_config_phase"](torch, device="cpu", dtypes=("float32",))
    got = out["float32"]
    assert got["launches"] == {"flash_prefill": 0, "paged_decode": 0}
    assert len(got["tokens"]) == 2 and len(got["tokens"][0]) == smoke["GRAFT_DECODE_STEPS"]
    assert max(got["max_abs_err"].values()) < 1e-4
    assert "head_dim 32, group 2" in capsys.readouterr().out


def test_graft_config_phase_rejects_a_planted_fault(monkeypatch):
    llama = port("models.llama")
    wrapper = llama.paged_decode_attention_cuda
    monkeypatch.setattr(llama, "paged_decode_attention_cuda", lambda *a: wrapper(*a) * 100)
    with pytest.raises(AssertionError, match="5e float32: decode step 1"):
        smoke["graft_config_phase"](torch, device="cpu", dtypes=("float32",))
