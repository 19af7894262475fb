"""Find an open-loop cell's knee: serve it at several offered rates, each
from a fresh set-up, and print what each rate did.

    python3 -m bench_port.sweep --workload <cell> --rates 1,2,3 --seconds 20 --seed <n>

A rate the system sustains admits its requests on time and drains them
soon after the window; above the knee the queue grows all through the
window.  The cell's rate is then set, in its mix file, at about four
fifths of the knee.  Judges nothing: ``run.py`` does that.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from bench_port import run as bench_run
from bench_port import spec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    cell = spec.load_cell(Path("BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(cell.traffic, rate_per_s=rate)
        run = bench_run.serve_cell(dataclasses.replace(cell, traffic=mix), args.seed,
                                   args.seconds, False, device)
        values = bench_run.end_to_end(run)
        win = run.win
        done = [lv for lv in win.lives if lv.done]
        hit = spec.metric_reader("prefix_hit_share").read(bench_run.record(run))
        half = len(win.late_s) // 2
        print(json.dumps({
            "rate_per_s": rate, "requests": len(win.lives), "finished": len(done),
            "drained_s": win.drained_s, "backlog_at_close": win.backlog,
            "late_p50_ms": [float(np.percentile(part, 50) * 1e3)
                            for part in (win.late_s[:half], win.late_s[half:])],
            "prefix_hit_share": hit, **{k: v for k, v in values.items() if k != "setup_s"},
        }), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
