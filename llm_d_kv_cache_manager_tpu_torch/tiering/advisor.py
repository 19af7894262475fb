"""Compute-or-load advisor: the scheduling half of the offload stack.

A prefix chunk resident on host DRAM or shared storage can reach the
GPU two ways: **load** the offloaded KV (pay the readback RTT) or
**recompute** it (pay prefill FLOPs) — and, per "Compute Or Load KV
Cache? Why Not Both?" (PAPERS.md), the two overlap: load the head
blocks while the GPU prefills the tail, finishing together.  The
advisor prices all three from two rolling estimators and returns the
cheapest:

* :class:`RttEstimator` — readback cost model ``t(nbytes) = floor +
  nbytes x per_byte``, fed by real offload load-job completions
  (``observe``; the offload worker calls it with each job's bytes and
  submit->harvest seconds) with an optional measured floor (a
  readback round trip measured apart);
* prefill rate — ``tokens / prefill_seconds`` EWMA (``observe_prefill``)
  or a configured constant.

Decision (documented in docs/tiering.md): compute ``load_s(n)``,
``recompute_s(n)`` and ``hybrid_s = min over k of max(load_s(k),
recompute_s(n - k))`` (the overlap split: head blocks k stream in
while the tail n-k prefills).  The cheapest wins; a pure action is
preferred when it is within ``margin`` of hybrid (simpler execution,
same latency).  With no RTT observations the advisor answers
**recompute** — never stall a request on an unmeasured I/O path — and
with no prefill-rate signal it answers **load**.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS
from llm_d_kv_cache_manager_tpu_torch.utils import lockorder
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("tiering.advisor")

EWMA_ALPHA = 0.3

LOAD = "load"
RECOMPUTE = "recompute"
HYBRID = "hybrid"

# Advisor locks are leaves: estimator updates and advice computation
# never call out while held.
# kvlint: lock-order: RttEstimator._lock ascending
lockorder.declare_ascending("RttEstimator._lock")


@dataclass(frozen=True)
class Advice:
    """One compute-or-load decision for a prefix chunk."""

    action: str  # load | recompute | hybrid
    blocks: int
    load_s: Optional[float]
    recompute_s: Optional[float]
    hybrid_s: Optional[float]
    # Hybrid split: head blocks loaded while the tail recomputes.
    load_blocks: int
    reason: str

    def to_dict(self) -> dict:
        def _round(value):
            return None if value is None else round(value, 6)

        return {
            "action": self.action,
            "blocks": self.blocks,
            "load_s": _round(self.load_s),
            "recompute_s": _round(self.recompute_s),
            "hybrid_s": _round(self.hybrid_s),
            "load_blocks": self.load_blocks,
            "reason": self.reason,
        }


class RttEstimator:
    """Rolling readback-cost model ``t(n) = floor_s + n x per_byte_s``.

    ``floor_s`` is the fixed per-transfer cost (RPC/syscall/submit
    latency — a readback round trip measured apart);
    ``per_byte_s`` is learned from job observations.  Each observation
    attributes ``max(seconds - floor_s, 0)`` to the bytes moved, so a
    measured floor keeps small transfers from inflating the slope.

    ``gauge`` is the Prometheus gauge the job-latency EWMA lands on —
    the load-side estimator publishes ``tiering_readback_rtt_seconds``,
    the store-side one ``tiering_writeback_rtt_seconds`` (None skips
    publication, for auxiliary estimators).
    """

    def __init__(self, floor_s: float = 0.0, gauge=None) -> None:
        self._lock = lockorder.tracked(
            threading.Lock(), "RttEstimator._lock"
        )
        self._gauge = gauge
        self._floor_s = floor_s  # guarded-by: _lock
        self._per_byte_s: Optional[float] = None  # guarded-by: _lock
        self._ewma_job_s: Optional[float] = None  # guarded-by: _lock
        self._observations = 0  # guarded-by: _lock

    def set_floor(self, floor_s: float) -> None:
        with self._lock:
            self._floor_s = max(0.0, floor_s)

    def observe(self, nbytes: int, seconds: float) -> None:
        """Fold one completed load job (bytes moved, submit->harvest
        seconds) into the model."""
        if nbytes <= 0 or seconds <= 0:
            return
        with self._lock:
            sample = max(seconds - self._floor_s, 0.0) / nbytes
            self._per_byte_s = (
                sample
                if self._per_byte_s is None
                else EWMA_ALPHA * sample
                + (1.0 - EWMA_ALPHA) * self._per_byte_s
            )
            self._ewma_job_s = (
                seconds
                if self._ewma_job_s is None
                else EWMA_ALPHA * seconds
                + (1.0 - EWMA_ALPHA) * self._ewma_job_s
            )
            self._observations += 1
            job_s = self._ewma_job_s
        if self._gauge is not None:
            self._gauge.set(job_s)

    def params(self):
        """(floor_s, per_byte_s) under one lock hit, or None when the
        model has no signal at all — lets callers price many sizes
        (the hybrid split scan) without re-locking per candidate."""
        with self._lock:
            per_byte = self._per_byte_s
            floor = self._floor_s
            if per_byte is None:
                if self._observations == 0 and floor <= 0.0:
                    return None
                per_byte = 0.0
        return floor, per_byte

    def estimate(self, nbytes: int) -> Optional[float]:
        """Predicted seconds to load ``nbytes``; None before any
        observation (unless a floor was measured)."""
        params = self.params()
        if params is None:
            return None
        if nbytes <= 0:
            return 0.0
        floor, per_byte = params
        return floor + nbytes * per_byte

    def stats(self) -> dict:
        with self._lock:
            return {
                "observations": self._observations,
                "floor_s": round(self._floor_s, 6),
                "per_byte_s": (
                    None
                    if self._per_byte_s is None
                    else self._per_byte_s
                ),
                "ewma_job_s": (
                    None
                    if self._ewma_job_s is None
                    else round(self._ewma_job_s, 6)
                ),
            }


@dataclass
class AdvisorConfig:
    # Host bytes of one KV block (the offload connector's
    # pool.block_nbytes); 0 = unknown, advise() answers recompute.
    bytes_per_block: int = 0
    # Tokens per KV block (the fleet block_size invariant).
    block_tokens: int = 16
    # Configured prefill rate (tokens/s); 0 = learn from
    # observe_prefill.
    prefill_tokens_per_s: float = 0.0
    # Fixed readback floor seeded into the estimator.
    rtt_floor_s: float = 0.0
    # Offer hybrid overlap at all.
    hybrid: bool = True
    # Prefer a pure action when it is within this fraction of hybrid.
    margin: float = 0.05


class ComputeOrLoadAdvisor:
    """Per-prefix-chunk load / recompute / hybrid decisions."""

    def __init__(self, config: Optional[AdvisorConfig] = None) -> None:
        self.config = config or AdvisorConfig()
        self.rtt = RttEstimator(
            floor_s=self.config.rtt_floor_s,
            gauge=METRICS.tiering_readback_rtt,
        )
        # Write-side cost model: fed by the offload store path
        # (device->host->file), so demotion is priced from measured
        # transfers, not the readback model's mirror image.
        self.rtt_store = RttEstimator(gauge=METRICS.tiering_writeback_rtt)
        # EWMA of the store path's device-transfer (gather + copy)
        # per-byte cost — the half of a demotion the file write hides.
        self._store_device_per_byte: Optional[float] = None
        self._store_device_observations = 0
        self._prefill_rate: Optional[float] = (
            self.config.prefill_tokens_per_s
            if self.config.prefill_tokens_per_s > 0
            else None
        )
        # Advice tallies (racy-tolerant ints for status; exact counts
        # live in the Prometheus counter).
        self.advice_counts = {LOAD: 0, RECOMPUTE: 0, HYBRID: 0}
        self._advice_children = {
            action: METRICS.tiering_advice.labels(action=action)
            for action in (LOAD, RECOMPUTE, HYBRID)
        }

    # -- estimator feeds ------------------------------------------------

    def observe_load(self, nbytes: int, seconds: float) -> None:
        self.rtt.observe(nbytes, seconds)

    def observe_store(
        self,
        nbytes: int,
        io_seconds: float,
        device_seconds: Optional[float] = None,
    ) -> None:
        """Fold one completed store job into the write-side model:
        ``io_seconds`` is the host->file window (submit to harvest),
        ``device_seconds`` the device->host half (gather + copy) when
        the path measured it (the staging engine and the one-shot
        handler both do)."""
        self.rtt_store.observe(nbytes, io_seconds)
        if device_seconds is None or device_seconds <= 0 or nbytes <= 0:
            return
        sample = device_seconds / nbytes
        self._store_device_per_byte = (
            sample
            if self._store_device_per_byte is None
            else EWMA_ALPHA * sample
            + (1.0 - EWMA_ALPHA) * self._store_device_per_byte
        )
        self._store_device_observations += 1

    def estimate_store_s(self, nbytes: int) -> Optional[float]:
        """Predicted seconds to demote ``nbytes`` down one rung
        (device transfer + file write); None before any store
        observation."""
        io_s = self.rtt_store.estimate(nbytes)
        if io_s is None:
            return None
        device = self._store_device_per_byte or 0.0
        return io_s + nbytes * device

    def observe_prefill(self, tokens: int, seconds: float) -> None:
        if tokens <= 0 or seconds <= 0:
            return
        if self.config.prefill_tokens_per_s > 0:
            return  # configured rate wins
        rate = tokens / seconds
        self._prefill_rate = (
            rate
            if self._prefill_rate is None
            else EWMA_ALPHA * rate + (1.0 - EWMA_ALPHA) * self._prefill_rate
        )

    @property
    def prefill_tokens_per_s(self) -> Optional[float]:
        return self._prefill_rate

    # -- the decision ---------------------------------------------------

    def _load_s(self, blocks: int) -> Optional[float]:
        if blocks <= 0:
            return 0.0
        bpb = self.config.bytes_per_block
        if bpb <= 0:
            return None
        return self.rtt.estimate(blocks * bpb)

    def _recompute_s(self, blocks: int) -> Optional[float]:
        if blocks <= 0:
            return 0.0
        rate = self._prefill_rate
        if rate is None or rate <= 0:
            return None
        return blocks * self.config.block_tokens / rate

    def advise(self, blocks: int, tier: Optional[str] = None) -> Advice:
        """Decide for a ``blocks``-long offloaded prefix chunk.

        ``tier`` is advisory context (recorded in the reason); the cost
        model is tier-agnostic because the estimator is fed by whatever
        path actually serves loads.
        """
        load_s = self._load_s(blocks)
        recompute_s = self._recompute_s(blocks)
        if blocks <= 0:
            return self._record(
                Advice(RECOMPUTE, 0, 0.0, 0.0, None, 0, "empty-chunk")
            )
        if load_s is None and recompute_s is None:
            return self._record(
                Advice(
                    RECOMPUTE, blocks, None, None, None, 0,
                    "no-rtt-and-no-prefill-signal",
                )
            )
        if load_s is None:
            return self._record(
                Advice(
                    RECOMPUTE, blocks, None, recompute_s, None, 0,
                    "no-rtt-observations",
                )
            )
        if recompute_s is None:
            return self._record(
                Advice(
                    LOAD, blocks, load_s, None, None, blocks,
                    "no-prefill-rate",
                )
            )

        hybrid_s: Optional[float] = None
        split = blocks
        if self.config.hybrid and blocks > 1:
            hybrid_s, split = self._best_split(blocks)

        margin = self.config.margin
        pure_best = min(load_s, recompute_s)
        if hybrid_s is not None and hybrid_s < pure_best * (1.0 - margin):
            return self._record(
                Advice(
                    HYBRID, blocks, load_s, recompute_s, hybrid_s, split,
                    f"overlap saves {pure_best - hybrid_s:.4f}s"
                    + (f" (tier {tier})" if tier else ""),
                )
            )
        if load_s <= recompute_s:
            action, load_blocks, reason = LOAD, blocks, "load cheaper"
        else:
            action, load_blocks, reason = RECOMPUTE, 0, "recompute cheaper"
        return self._record(
            Advice(
                action, blocks, load_s, recompute_s, hybrid_s, load_blocks,
                reason + (f" (tier {tier})" if tier else ""),
            )
        )

    def _best_split(self, blocks: int):
        """min over k of max(load(k), recompute(blocks - k)).

        Both arms are monotone in k (load rising, recompute falling),
        so the max is unimodal; the direct scan is O(blocks) over a few
        hundred candidates — robust over clever algebra, and exact for
        the floor discontinuity at k=0.  RTT/rate parameters are read
        ONCE (the estimator lock must not be taken per candidate — an
        explain over a 128k-token prompt scans thousands of splits).
        """
        params = self.rtt.params()
        floor, per_byte = params if params is not None else (0.0, 0.0)
        bpb = self.config.bytes_per_block
        rate = self._prefill_rate
        block_tokens = self.config.block_tokens
        best_s = None
        best_k = blocks
        for k in range(blocks + 1):
            load_k = floor + k * bpb * per_byte if k else 0.0
            comp_k = (blocks - k) * block_tokens / rate
            cell = max(load_k, comp_k)
            if best_s is None or cell < best_s:
                best_s = cell
                best_k = k
        return best_s, best_k

    def _record(self, advice: Advice) -> Advice:
        self.advice_counts[advice.action] += 1
        self._advice_children[advice.action].inc()
        return advice

    def stats(self) -> dict:
        return {
            "rtt": self.rtt.stats(),
            "rtt_store": self.rtt_store.stats(),
            "store_device_per_byte_s": self._store_device_per_byte,
            "store_device_observations": self._store_device_observations,
            "prefill_tokens_per_s": (
                None
                if self._prefill_rate is None
                else round(self._prefill_rate, 1)
            ),
            "bytes_per_block": self.config.bytes_per_block,
            "block_tokens": self.config.block_tokens,
            "hybrid": self.config.hybrid,
            "advice_counts": dict(self.advice_counts),
        }
