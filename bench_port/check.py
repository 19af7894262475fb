"""The comparison that decides ``correct``.

- Served tokens: a sample, drawn from the seed, of the requests the run
  served: the one with most served tokens among them, rows of the
  window's busiest decode step, each in a slot of its own, and at least
  one continued prefill and one whole prefill where the run had both.  The
  reference runs once over each prompt and its served tokens; at each
  served token, the gap by which that token's logit lies below the
  reference's best.  The widest gap is compared with its limit.
- Router: every score ``get_pod_scores`` returned, against the scores
  the reference works out from the text and the frames
  (``reference/router.py``): mismatches, limit 0.
- Write path: frames the event pool dropped, limit 0.
- Requests due in the window and never finished, limit 0.

The reference is the configuration's family's (``families/<family>.py``:
``reference_logits``).  The control (``control.py``) reads the same gap
for the token that the reference computed in float8 puts first.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def sample(lives, seed: int, tokens: int, max_requests: int,
           busiest: Sequence[int] = ()) -> List:
    """Requests to judge: the one with most served tokens; then, in the
    seed's order, up to half of ``max_requests`` of ``busiest`` (ids of
    the rows of one decode step, each in a slot of its own); one continued
    and one whole prefill where there are both; then others, until
    ``tokens`` served tokens or ``max_requests``."""
    pool = [lv for lv in lives if lv.tokens]
    if not pool:
        return []
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    order = [pool[i] for i in rng.permutation(len(pool))]
    picked = [max(pool, key=lambda lv: (len(lv.tokens), -lv.rid))]
    rows = set(busiest)
    for lv in [lv for lv in order if lv.rid in rows]:
        if len(picked) > max_requests // 2:
            break
        if lv not in picked:
            picked.append(lv)
    for want_hit in (True, False):
        extra = next((lv for lv in order if (lv.cached > 0) == want_hit), None)
        if extra is not None and extra not in picked and len(picked) < max_requests:
            picked.append(extra)
    for lv in order:
        if sum(len(p.tokens) for p in picked) >= tokens or len(picked) >= max_requests:
            break
        if lv not in picked:
            picked.append(lv)
    return picked


def sequence(lv) -> np.ndarray:
    """The prompt and the served tokens fed back (all but the last)."""
    return np.concatenate([lv.req.prompt, np.asarray(lv.tokens[:-1], dtype=np.int32)])


def ref_logits(family, params, config, lv, device, quant: Optional[str] = None) -> torch.Tensor:
    seq = torch.from_numpy(sequence(lv).astype(np.int64)).to(device)
    return family.reference_logits(params, config, seq, len(lv.req.prompt) - 1, quant=quant)


def gaps_of(ref: torch.Tensor, chosen: Sequence[int]) -> np.ndarray:
    """ref [n, V]: the best logit less the chosen token's, per position."""
    idx = torch.as_tensor(list(chosen), device=ref.device, dtype=torch.long)
    best = ref.max(dim=-1).values
    return (best - ref.gather(1, idx[:, None])[:, 0]).cpu().numpy()


def served_gap(family, params, config, picked, device) -> Dict:
    """The widest gap of the served tokens of ``picked``."""
    widest, tokens = 0.0, 0
    for lv in picked:
        gaps = gaps_of(ref_logits(family, params, config, lv, device), lv.tokens)
        widest = max(widest, float(gaps.max()))
        tokens += len(gaps)
    return {"gap": widest, "tokens": tokens, "requests": len(picked)}


def control_gap(family, params, config, picked, device) -> Dict:
    """The widest gap of the tokens the float8 reference puts first, at
    the same positions of the same sequences."""
    widest = 0.0
    for lv in picked:
        ref = ref_logits(family, params, config, lv, device)
        low = ref_logits(family, params, config, lv, device, quant="fp8")
        widest = max(widest, float(gaps_of(ref, low.argmax(-1).tolist()).max()))
        del ref, low
    return {"gap": widest}
