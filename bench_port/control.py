"""Read the comparison's two ends for a cell: the program's widest
served-token gap and the control's, on several seeds in one process.

    python3 -m bench_port.control --workload <cell> --seeds 1,2,3 --seconds 10

The control is the reference computed in float8 (e4m3) in the program's
place, the step below the configuration's bfloat16: at each position of
the same prompts and served tokens, the gap of the token it puts first.
A cell's limit lies between the program's readings and the control's.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from bench_port import check
from bench_port import run as bench_run
from bench_port import spec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    cell = spec.load_cell(Path("BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    limits = cell.traffic["check"]
    for seed in (int(s) for s in args.seeds.split(",")):
        run = bench_run.serve_cell(cell, seed, args.seconds, False, device)
        compared = bench_run.checks(run, device)
        picked = check.sample(bench_run.judged(run), seed, int(limits["tokens"]),
                              int(limits["max_requests"]), bench_run.busiest_rows(run))
        line = {"seed": seed, "program_gap": compared["served_logit_gap"]["value"],
                "checks": {k: v["value"] for k, v in compared.items()},
                "control_gap": check.control_gap(cell.family, run.params, cell.config, picked,
                                                 device)["gap"]}
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
