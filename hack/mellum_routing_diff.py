#!/usr/bin/env python3
"""Count the routing picks that differ between the port and the float32
reference on the served tokens that ``mellum2.repo-agent`` judges.

For each seed: serve the cell once (``bench_port.run.serve_cell``), judge
it (``run.checks``: the served-logit gap), take the requests the check
samples, and run each one's prompt and served tokens once more through
the port's ``prefill_paged`` in bf16 and through the reference, each
recording its top-8 experts at every layer.  At the judged positions (the
prompt's last and every served token's), a (position, layer) whose sets
of 8 differ is a differing pick; it is counted by layer, and apart where
the reference's eighth and ninth router logits lie more than
``CLEAR_MARGIN`` apart (no rounding of a bf16 hidden state moves a logit
that far at once: such a flip follows from an earlier one).  The port's picks come from its prefill
path, whose route kernel is the decode step's (the decode graph's own
picks are not visible to the host); both see the same tokens.  Prints
one JSON line a seed, with the window's prefills and their share of it
(host clock, each prefill call to its first token), the decode path's
device counters (``ops/moe_experts.py``: a captured graph's replays add
to them, its launches do not) and the kernels' host-side launches.

Usage, from the repository root, on a machine with the GPU (the window
is 51 s unless given):
    python3 hack/mellum_routing_diff.py 2600000301,2600000302 [seconds]
"""
import importlib
import json
import sys
from pathlib import Path

sys.path.insert(0, ".")
import numpy as np  # noqa: E402
import torch  # noqa: E402


def harness(module: str):
    """A module of ``bench_port`` (found from the repository root)."""
    return importlib.import_module(f"bench_port.{module}")


check, spec, bench_run = harness("check"), harness("spec"), harness("run")
reference, port = harness("reference.mellum"), harness("serve").port

CELL = "mellum2.repo-agent"
CLEAR_MARGIN = 0.05  # router logits; ~50 x what a bf16 rounding of the hidden moves them


def picks_of(lm, params, seq, device):
    """The port's top-k expert sets [layers, positions, k] over ``seq``."""
    moe = port("ops.moe_experts")
    real, got = moe.moe_route_cuda, []

    def recording(h, w_router, top_k, norm_topk):
        ids, wts = real(h, w_router, top_k, norm_topk)
        got.append(ids.sort(-1).values.cpu())
        return ids, wts
    recording.launches = 0  # the wrapper counts its launches under its module name
    n = len(seq) // lm.block_size * lm.block_size
    pool = lm.pool(n // lm.block_size + 1, device)
    table = torch.arange(1, n // lm.block_size + 1, dtype=torch.int32)[None]
    moe.moe_route_cuda = recording
    try:
        lm.prefill_paged(params, torch.from_numpy(seq[None, :n].astype(np.int64)), pool.kv, table)
    finally:
        moe.moe_route_cuda = real
    return torch.stack(got), n


def reference_picks(params, config, seq, device):
    """The reference's top-k sets [layers, positions, k] over ``seq``, and
    the margin between its k-th and (k+1)-th router logits [layers,
    positions]."""
    real, got, margins = reference.experts, [], []

    def recording(h, lay, i, top_k, norm, quant):
        logits = reference._linear(h, lay["w_router"][i], quant)
        top = torch.topk(logits, top_k + 1, dim=-1).values
        margins.append((top[:, -2] - top[:, -1]).cpu())
        got.append(torch.topk(logits, top_k, dim=-1).indices.sort(-1).values.cpu())
        return real(h, lay, i, top_k, norm, quant)
    reference.experts = recording
    try:
        reference.logits(params, config, torch.from_numpy(seq.astype(np.int64)).to(device),
                         len(seq) - 1)
    finally:
        reference.experts = real
    return torch.stack(got), torch.stack(margins)


def main() -> int:
    cell = spec.load_cell(Path("BENCHMARK.json"), CELL)
    device = torch.device("cuda", 0)
    limits = cell.traffic["check"]
    seconds = float(sys.argv[2]) if len(sys.argv) > 2 else 51.0
    for seed in (int(s) for s in sys.argv[1].split(",")):
        run = bench_run.serve_cell(cell, seed, seconds, False, device)
        gap = bench_run.checks(run, device)["served_logit_gap"]["value"]
        moe = port("ops.moe_experts")  # the served run's counts, before this tool's prefills
        counters = moe.read_counters("decode")
        launches = {"moe_route": moe.moe_route_cuda.launches,
                    "moe_group": moe.moe_group_cuda.launches,
                    "moe_experts": moe.moe_experts_cuda.launches,
                    "paged_decode": port("ops.paged_decode_cuda").paged_decode_attention_cuda.launches,
                    "flash": port("ops.flash_cuda").flash_gqa_attention_cuda.launches}
        picked = check.sample(bench_run.judged(run), seed, int(limits["tokens"]),
                              int(limits["max_requests"]), bench_run.busiest_rows(run))
        lm = cell.family.model(cell.config, cell.traffic)
        differ = judged = clear = clear_differ = 0
        by_layer = torch.zeros(cell.config["num_hidden_layers"], dtype=torch.long)
        for lv in picked:
            seq = check.sequence(lv)
            mine, n = picks_of(lm, run.params, seq, device)
            ref, margin = reference_picks(run.params, cell.config, seq[:n], device)
            first = len(lv.req.prompt) - 1
            diff = (mine[:, first:n] != ref[:, first:n]).any(-1)  # [layers, positions]
            wide = margin[:, first:n] > CLEAR_MARGIN
            differ += int(diff.sum())
            judged += diff.numel()
            by_layer += diff.sum(-1)
            clear += int(wide.sum())
            clear_differ += int((diff & wide).sum())
        fills = [c for c in run.calls if c.kind == "prefill"]
        print(json.dumps({"seed": seed, "served_logit_gap": gap, "requests": len(picked),
                          "judged_layer_positions": judged, "differing_picks": differ,
                          "differing_by_layer": by_layer.tolist(),
                          "clear_margin_pairs": clear, "differing_at_clear_margin": clear_differ,
                          "prefills": len(fills),
                          "prefill_share": sum(c.t1 - c.t0 for c in fills) / run.seconds,
                          "window_decode_steps": sum(1 for c in run.calls if c.kind == "decode"),
                          "decode_counters": counters,
                          "launches": launches}),
              flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
