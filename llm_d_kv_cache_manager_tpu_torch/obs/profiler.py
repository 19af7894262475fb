"""Always-on sampling wall-clock profiler (docs/observability.md
"Continuous profiling").

One daemon sampler thread wakes ``PROFILE_HZ`` times a second, grabs
``sys._current_frames()`` (a GIL-atomic snapshot of every live
thread's top frame) and folds each thread's stack into a bounded
collapsed-stack table keyed by *thread role* — the ``kvtpu-<role>``
prefix every worker/poller/sweeper thread in this codebase carries.
That answers "where does wall time go across poller/worker/RPC
threads" continuously, not per-incident:

* wall-clock, not CPU: a thread blocked in ``zmq.poll``, a lock
  acquire, or a replica RPC is sampled exactly like a computing one —
  convoys and sequential fan-outs show up as big blocking frames;
* bounded: at most ``max_stacks`` distinct folded stacks are kept
  (overflow folds into a per-role ``<other>`` bucket, counted), depth
  capped at ``MAX_DEPTH`` frames, so weeks of always-on sampling
  cannot grow memory;
* cheap: the only cost when armed is the sampler thread itself —
  application threads never execute a single added instruction.
  ``PROFILE_HZ=0`` never starts the thread; the module is inert.

Exports the standard collapsed/folded flamegraph format
(``role;frame;frame... N`` — feed it to flamegraph.pl / speedscope)
and a top-N self-time table, both behind ``GET /debug/profile``.

Copied from the JAX reference's ``obs/profiler.py``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("obs.profiler")

DEFAULT_HZ = 19.0  # prime-ish: avoids aliasing with 1s/50ms periodic work
DEFAULT_MAX_STACKS = 4096
MAX_DEPTH = 48

_ROLE_PREFIX = "kvtpu-"


def thread_role(name: str) -> str:
    """Stable role of a thread name: ``kvtpu-events-3`` -> ``events``,
    ``kvtpu-evplane-poller-0`` -> ``evplane-poller``, and the
    ``ThreadPoolExecutor`` shape ``kvtpu-grpc_0`` -> ``grpc`` (its
    ``thread_name_prefix`` threads are named ``<prefix>_<n>``); the
    main thread is ``main``; anything else keeps its name under
    ``other:`` so an unnamed thread is visible (and countable)
    instead of hidden."""
    if name.startswith(_ROLE_PREFIX):
        role = name[len(_ROLE_PREFIX):]
        for sep in ("-", "_"):
            head, _, tail = role.rpartition(sep)
            if head and tail.isdigit():
                return head
        return role
    if name == "MainThread":
        return "main"
    return f"other:{name}"


def is_attributed(name: str) -> bool:
    """True when the thread carries a stable ``kvtpu-`` role name."""
    return name.startswith(_ROLE_PREFIX)


def _frame_label(frame) -> str:
    """``pkg/module.py:func`` — the last two path components keep
    same-named files (pool.py exists three times) distinguishable."""
    code = frame.f_code
    path = code.co_filename
    head, base = os.path.split(path)
    parent = os.path.basename(head)
    if parent:
        base = f"{parent}/{base}"
    return f"{base}:{code.co_name}"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        value = float(raw)
        if value < 0:
            raise ValueError(raw)
        return value
    except ValueError:
        logger.warning("invalid %s=%r; using %s", name, raw, default)
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        value = int(raw)
        if value <= 0:
            raise ValueError(raw)
        return value
    except ValueError:
        logger.warning("invalid %s=%r; using %s", name, raw, default)
        return default


@dataclass
class ProfilerConfig:
    # Samples per second; 0 disables (start() is a no-op — the
    # PROFILE_HZ=0 path is bit-identical to not having a profiler).
    hz: float = DEFAULT_HZ
    # Bound on distinct folded stacks kept; overflow folds into a
    # per-role "<other>" bucket so the table never grows past this.
    max_stacks: int = DEFAULT_MAX_STACKS

    @classmethod
    def from_env(cls) -> "ProfilerConfig":
        return cls(
            hz=_env_float("PROFILE_HZ", DEFAULT_HZ),
            max_stacks=_env_int("PROFILE_MAX_STACKS", DEFAULT_MAX_STACKS),
        )


class SamplingProfiler:
    """Folded-stack aggregation over a single sampler thread."""

    def __init__(self, config: Optional[ProfilerConfig] = None) -> None:
        self.config = config or ProfilerConfig.from_env()
        self._lock = threading.Lock()
        # folded stack (role, frame, frame, ...) -> sample count.
        self._stacks: Dict[Tuple[str, ...], int] = {}  # guarded-by: _lock
        self._role_samples: Dict[str, int] = {}  # guarded-by: _lock
        self._samples = 0  # guarded-by: _lock
        self._attributed = 0  # guarded-by: _lock
        self._overflowed = 0  # guarded-by: _lock
        self._wakeups = 0  # guarded-by: _lock
        self._started_at: Optional[float] = None  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> bool:
        """Spawn the sampler thread; False (and no thread, no cost)
        when ``hz`` is 0.  Idempotent while running."""
        if self.config.hz <= 0:
            return False
        if self._thread is not None and self._thread.is_alive():
            return True
        self._stop.clear()
        with self._lock:
            self._started_at = time.time()
        # gil-atomic: lifecycle ref; start/close are control-plane
        self._thread = threading.Thread(
            target=self._run, name="kvtpu-profiler", daemon=True
        )
        self._thread.start()
        return True

    def close(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5)
            # gil-atomic: lifecycle ref; start/close are control-plane
            self._thread = None

    def running(self) -> bool:
        thread = self._thread
        return thread is not None and thread.is_alive()

    def reset(self) -> None:
        """Clear the aggregation (bench A/B cells, tests)."""
        with self._lock:
            self._stacks.clear()
            self._role_samples.clear()
            self._samples = 0
            self._attributed = 0
            self._overflowed = 0
            self._wakeups = 0

    # -- sampling ------------------------------------------------------

    def _run(self) -> None:
        interval = 1.0 / self.config.hz
        own_ident = threading.get_ident()
        while not self._stop.wait(interval):
            try:
                self._sample_once(own_ident)
            except Exception:  # noqa: BLE001 — the sampler must survive
                logger.exception("profiler sample failed")

    def _sample_once(self, own_ident: int) -> None:
        # Thread names are resolved per wakeup: enumerate() is a lock
        # + list copy, frames a dict copy — both GIL-atomic enough
        # that a name can at worst be one wakeup stale.
        names = {
            thread.ident: thread.name
            for thread in threading.enumerate()
        }
        frames = sys._current_frames()
        folded: List[Tuple[str, bool]] = []
        try:
            for ident, frame in frames.items():
                if ident == own_ident:
                    continue
                name = names.get(ident, f"tid-{ident}")
                stack: List[str] = []
                depth = 0
                while frame is not None and depth < MAX_DEPTH:
                    stack.append(_frame_label(frame))
                    frame = frame.f_back
                    depth += 1
                stack.append(thread_role(name))
                stack.reverse()  # root first, leaf last
                folded.append((tuple(stack), is_attributed(name)))
        finally:
            del frames  # drop frame refs promptly (they pin locals)
        with self._lock:
            self._wakeups += 1
            for stack, attributed in folded:
                self._samples += 1
                if attributed:
                    self._attributed += 1
                role = stack[0]
                self._role_samples[role] = (
                    self._role_samples.get(role, 0) + 1
                )
                count = self._stacks.get(stack)
                if count is not None:
                    self._stacks[stack] = count + 1
                elif len(self._stacks) < self.config.max_stacks:
                    self._stacks[stack] = 1
                else:
                    self._overflowed += 1
                    bucket = (role, "<other>")
                    self._stacks[bucket] = (
                        self._stacks.get(bucket, 0) + 1
                    )

    # -- read surface --------------------------------------------------

    def _snapshot(self) -> Tuple[Dict[Tuple[str, ...], int], dict]:
        with self._lock:
            stacks = dict(self._stacks)
            meta = {
                "running": self.running(),
                "hz": self.config.hz,
                "samples": self._samples,
                "wakeups": self._wakeups,
                "attributed_samples": self._attributed,
                "attributed_fraction": (
                    round(self._attributed / self._samples, 4)
                    if self._samples
                    else 0.0
                ),
                "distinct_stacks": len(self._stacks),
                "max_stacks": self.config.max_stacks,
                "overflowed_samples": self._overflowed,
                "started_unix": self._started_at,
                "roles": dict(
                    sorted(
                        self._role_samples.items(),
                        key=lambda item: -item[1],
                    )
                ),
            }
        return stacks, meta

    def collapsed(self) -> str:
        """Collapsed/folded flamegraph format: one ``frame;frame N``
        line per distinct stack, root (the role) first."""
        stacks, _ = self._snapshot()
        lines = [
            f"{';'.join(stack)} {count}"
            for stack, count in sorted(stacks.items())
        ]
        return "\n".join(lines) + ("\n" if lines else "")

    def top(self, n: int = 30) -> List[dict]:
        """Top-N frames by SELF time (samples where the frame was the
        leaf), with the owning role split alongside."""
        stacks, meta = self._snapshot()
        total = meta["samples"] or 1
        selfs: Dict[Tuple[str, str], int] = {}
        for stack, count in stacks.items():
            key = (stack[0], stack[-1] if len(stack) > 1 else "<idle>")
            selfs[key] = selfs.get(key, 0) + count
        ranked = sorted(selfs.items(), key=lambda item: -item[1])[:n]
        return [
            {
                "role": role,
                "frame": frame,
                "self_samples": count,
                "self_pct": round(100.0 * count / total, 2),
            }
            for (role, frame), count in ranked
        ]

    def status(self, top: int = 30) -> dict:
        """The ``/debug/profile`` JSON payload."""
        _, meta = self._snapshot()
        meta["top"] = self.top(top)
        return meta


# Process-wide profiler, mirroring TRACER/METRICS: the service entry
# points start it (PROFILE_HZ=0 keeps it inert); embedders construct
# their own when they need isolated aggregation.
PROFILER = SamplingProfiler()
