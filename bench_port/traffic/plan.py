"""What a traffic kind generates: the requests of a run, and helpers the
kinds share."""

from __future__ import annotations

from dataclasses import dataclass, field
from statistics import NormalDist
from typing import List, Optional, Sequence, Union

import numpy as np


@dataclass(eq=False)
class Request:
    prompt: np.ndarray  # token ids, int32, a multiple of the block size long
    output: int  # tokens to generate, greedy
    arrival: Optional[float] = None  # seconds after the window opens (open loop)
    group: Optional[int] = None  # shared-prefix group, where there is one
    stream: Optional[int] = None  # closed-loop client
    running_at_start: bool = False  # prefilled at set-up, decoding when the window opens


@dataclass
class Plan:
    pods: int
    setup: List[Request] = field(default_factory=list)  # served before the window
    window: List[Request] = field(default_factory=list)  # open loop: due in the window
    streams: List[List[Request]] = field(default_factory=list)  # closed loop: each client's queue
    max_context: int = 0  # the longest prompt plus output, rounded up to the multiple


def lognormal_set(n: int, median: float, sigma: float, lo: int, hi: int,
                  multiple: int) -> np.ndarray:
    """``n`` lengths that stand for a lognormal of ``median`` and
    ``sigma``: its quantiles at the midpoints of ``n`` equal strata, cut to
    [lo, hi] and rounded to the multiple, smallest first."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    out = np.clip(float(median) * np.exp(float(sigma) * z), int(lo), int(hi))
    return np.clip(np.round(out / multiple).astype(int) * multiple, int(lo), int(hi))


def lengths(spec: Union[Sequence[int], dict], n: int, multiple: int,
            rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths as a mix states them, in ``rng``'s order: ``[lo, hi]``
    for the uniform over multiples (``strata``), or ``{"median", "sigma",
    "range": [lo, hi]}`` for a lognormal (``lognormal_set``).  Every
    generator gets the same set; only the order is its own."""
    if isinstance(spec, dict):
        out = lognormal_set(n, spec["median"], spec["sigma"], *spec["range"], multiple)
        rng.shuffle(out)
        return out
    return strata(n, *spec, multiple, rng)


def strata(n: int, lo: int, hi: int, multiple: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths from the uniform over ``lo, lo + multiple, ..., hi``:
    the midpoint of each of ``n`` equal strata, in ``rng``'s order."""
    levels = (int(hi) - int(lo)) // multiple + 1
    picks = np.minimum(((np.arange(n) + 0.5) / n * levels).astype(int), levels - 1)
    out = int(lo) + multiple * picks
    rng.shuffle(out)
    return out
