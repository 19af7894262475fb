"""Closed-loop traffic: ``streams`` clients, each sending its next
request as soon as its previous one has finished.

Parameters (the mix's JSON file):

- ``streams``, ``requests_per_stream``: clients and the queue of each.
- ``prompt.unique_tokens`` [lo, hi], ``output_tokens`` [lo, hi],
  ``multiple``: lengths, uniform in multiples; a request's prompt plus
  output is cut to ``max_context``.
- Each client's first request starts mid-generation: at set-up its
  prompt and the tokens it has already generated (a stratified share of
  its output, drawn as random ids) are prefilled, so that the batch is
  full when the window opens.

Every seed gets the same sizes and starting points, stream by stream: a
closed loop's clients are alike, so the seed changes only the token ids.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from bench_port.traffic.plan import Plan, Request, strata


def generate(mix: Dict[str, Any], seed: int, seconds: float, vocab: int) -> Plan:
    del seconds  # the clients run until the window closes
    rng = np.random.default_rng(seed)
    sizes = np.random.default_rng(0)
    mult = int(mix["multiple"])
    streams, per = int(mix["streams"]), int(mix["requests_per_stream"])
    cap = int(mix["max_context"])
    prompts = strata(streams * per, *mix["prompt"]["unique_tokens"], mult, sizes)
    outputs = strata(streams * per, *mix["output_tokens"], mult, sizes)
    done = strata(streams, 0, 1000, 1, sizes) / 1000.0  # share of the first output already made
    plan = Plan(pods=int(mix["pods"]))
    for s in range(streams):
        queue = []
        for r in range(per):
            i = s * per + r
            prompt = rng.integers(1, vocab, int(prompts[i]), dtype=np.int32)
            output = min(int(outputs[i]), cap - len(prompt))
            if r == 0:
                made = int(done[s] * output) // mult * mult
                made = min(made, output - mult)
                prompt = np.concatenate([prompt, rng.integers(1, vocab, made, dtype=np.int32)])
                output -= made
            queue.append(Request(prompt=prompt, output=output, stream=s,
                                 running_at_start=r == 0))
        plan.setup.append(queue[0])
        plan.streams.append(queue[1:])
    plan.max_context = cap
    return plan
