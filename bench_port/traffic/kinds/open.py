"""Open-loop traffic: independent users send requests on a Poisson
schedule at a fixed rate, whether or not earlier ones have finished.

Parameters (the mix's JSON file):

- ``rate_per_s``: the offered load; ``round(rate_per_s * seconds)``
  requests are due in the window.
- ``prompt.shared_prefix`` (optional): ``groups`` prefixes (system
  prompts, documents) of ``tokens`` tokens each, chosen with Zipf
  popularity ``zipf_s``; set-up serves the ``warm_groups`` most popular
  once each, through the same path as the window.
- ``prompt.unique_tokens``: each request's own tokens, after its prefix
  where it has one.
- ``output_tokens``: tokens generated, greedy, no end token.
- ``multiple``: every length is a multiple of it.
- ``reorder_block``: how far the seed moves a request, in requests (1:
  nowhere).

A length is ``[lo, hi]`` (uniform over the multiples) or ``{"median",
"sigma", "range"}`` (a lognormal cut to its range): see
``plan.lengths``.

Every seed gets the same amount of work and its own schedule.  The sizes
are one set for every seed (the quantiles of each length's distribution,
the gaps the quantiles of the exponential, the requests of each group
the Zipf shares rounded by largest remainder, and the prefix length of
each popularity rank), put in one order by a generator of their own; the
seed then reorders them inside each run of ``reorder_block`` requests:
when each gap falls, which group each request belongs to, and which own
and output length it gets.  Each stretch of the window so holds the same
work in every seed, and only its order within the stretch is the seed's:
where the seed ordered the whole window, the shared-prefix cell's median
TTFT read 11-14% apart between seeds on an H100, and 1-4% apart between
two runs of one seed.  Within runs of 8 it still read 12.7-14.4% between
the quartiles of six seeds: one request queued behind a long miss or not
moves the median.  So ``reorder_block`` 1 keeps the one order for every
seed, a fixed trace.  The seed also draws every token id (and, in the run,
the weights).  A seed never puts a long document on the most popular group
where another seed puts a short one, which would change how much is
computed and not only when.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np

from bench_port.traffic.plan import Plan, Request, lengths


def zipf_counts(n: int, groups: int, s: float) -> np.ndarray:
    """Requests per popularity rank: ``n`` split by Zipf shares, largest
    remainder."""
    weights = 1.0 / np.arange(1, groups + 1) ** s
    exact = n * weights / weights.sum()
    counts = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - counts), kind="stable")[: n - counts.sum()]:
        counts[i] += 1
    return counts


def reorder(values: np.ndarray, block: int, rng: np.random.Generator) -> np.ndarray:
    """``values`` shuffled by ``rng`` inside each run of ``block``."""
    out = np.array(values)
    for start in range(0, len(out), block):
        rng.shuffle(out[start:start + block])
    return out


def generate(mix: Dict[str, Any], seed: int, seconds: float, vocab: int) -> Plan:
    rng = np.random.default_rng(int(seed) % (1 << 63))  # token ids
    base = np.random.default_rng(0)  # the sizes' one order
    order = np.random.default_rng([int(seed) % (1 << 63), 1])  # the seed's reordering
    mult = int(mix["multiple"])
    rate = float(mix["rate_per_s"])
    n = max(1, round(rate * seconds))
    block = int(mix["reorder_block"])
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    base.shuffle(gaps)
    gaps = reorder(gaps, block, order)
    arrivals = np.cumsum(gaps) - gaps
    unique = reorder(lengths(mix["prompt"]["unique_tokens"], n, mult, base), block, order)
    outputs = reorder(lengths(mix["output_tokens"], n, mult, base), block, order)

    plan = Plan(pods=int(mix["pods"]))
    prefixes = [np.zeros(0, dtype=np.int32)] * n
    shared = mix["prompt"].get("shared_prefix")
    if shared:
        groups = int(shared["groups"])
        # Prefix lengths by popularity rank: one order for every seed.
        by_rank = lengths(shared["tokens"], groups, mult, base)
        texts = [rng.integers(1, vocab, int(t), dtype=np.int32) for t in by_rank]
        members = np.repeat(np.arange(groups), zipf_counts(n, groups, float(shared["zipf_s"])))
        base.shuffle(members)
        members = reorder(members, block, order)
        prefixes = [texts[g] for g in members]
        for g in range(int(shared["warm_groups"])):
            tail = rng.integers(1, vocab, mult, dtype=np.int32)
            plan.setup.append(Request(prompt=np.concatenate([texts[g], tail]), output=1,
                                      group=g))
    for i in range(n):
        own = rng.integers(1, vocab, int(unique[i]), dtype=np.int32)
        plan.window.append(Request(
            prompt=np.concatenate([prefixes[i], own]), output=int(outputs[i]),
            arrival=float(arrivals[i]), group=int(members[i]) if shared else None))
    plan.max_context = max(len(r.prompt) + r.output for r in plan.window + plan.setup)
    plan.max_context = int(math.ceil(plan.max_context / mult) * mult)
    return plan
