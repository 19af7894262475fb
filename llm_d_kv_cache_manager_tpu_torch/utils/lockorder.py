"""Runtime lock-order watchdog: the dynamic half of kvlint KV006.

The static rule (hack/kvlint/kv006_lockorder.py) proves the global
lock-acquisition graph acyclic from the source; this module asserts the
same declared order while the code actually runs, so the two validate
each other — a nesting the static model cannot see (a lock smuggled
through an untyped receiver) still trips the watchdog under the
concurrency storm tests, and a stale declaration trips it immediately.

Debug-gated and ~zero-cost when off: :func:`tracked` returns the lock
it was given unchanged unless the watchdog is enabled
(``KVTPU_LOCK_ORDER_DEBUG=1``, or :func:`enable` from tests), so
production lock acquisition never crosses a wrapper.

Vocabulary (mirrors the ``# kvlint: lock-order:`` comment annotations
the static rule reads — declare both at the same site):

* :func:`declare_order(first, second)` — ``first < second``: any
  thread holding ``second`` must not acquire ``first``.
* :func:`declare_ascending(name)` — multiple instances of ``name``
  are only ever acquired in ascending :func:`tracked` ``rank`` order
  (the striped-shard pattern).

Checks fire on acquire, against a per-thread stack of held locks:

* re-acquiring the *same instance* of a non-reentrant lock
  (guaranteed self-deadlock; RLocks/Conditions re-enter freely);
* same-name nesting without an ``ascending`` declaration;
* same-name nesting with one, but a rank that is missing or not
  strictly greater than every held instance's;
* acquiring ``first`` of a declared pair while ``second`` is held.

Violations raise :class:`LockOrderViolation` (an ``AssertionError``
subclass, so storm tests fail loudly instead of deadlocking flakily).

Contention telemetry (docs/observability.md "Lock contention"): the
second, production-grade mode of :func:`tracked`.  Unlike the
watchdog it needs no debug flag — setting ``LOCK_CONTENTION_SAMPLE=N``
arms it in any build: every Nth acquire of a tracked lock runs a
non-blocking probe first; a probe that succeeds costs nothing beyond
the probe itself (the uncontended fast path stays ~free), a probe
that fails is a *contended* acquire whose wait is timed and folded
into a per-lock-name stat (count, EWMA, max, total) plus the
``kvtpu_lock_wait_seconds{lock}`` / ``kvtpu_lock_contention_total
{lock}`` metric families.  ``LOCK_CONTENTION_SAMPLE`` unset or ``0``
keeps today's behavior bit-identically: :func:`tracked` returns the
raw lock object.  The watchdog supersedes timing when both are armed
(it is a debug tool; timing is for production).

Copied from the JAX reference's ``utils/lockorder.py``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "GuardRecordingLock",
    "LockOrderViolation",
    "contention_sample",
    "contention_stats",
    "declare_ascending",
    "declare_order",
    "enable",
    "enabled",
    "guard_recording",
    "held",
    "holder_of",
    "holds",
    "raw_lock",
    "reset_contention_stats",
    "reset_declarations",
    "set_contention_sample",
    "set_fuzz_hook",
    "set_guard_recording",
    "tracked",
]


class LockOrderViolation(AssertionError):
    """A lock was acquired against the declared global order."""


_enabled = os.environ.get("KVTPU_LOCK_ORDER_DEBUG", "") in (
    "1",
    "true",
    "yes",
)
# first < second pairs and ascending-instance lock names.  Module-level
# registries mutated only at import/declaration time (single-threaded),
# read on every tracked acquire.
_ordered_pairs: Set[Tuple[str, str]] = set()
_ascending: Set[str] = set()

_state = threading.local()


def enabled() -> bool:
    return _enabled


def enable(flag: bool = True) -> bool:
    """Toggle the watchdog (tests); returns the previous state.

    Only locks created by :func:`tracked` *after* enabling are checked
    — construct the structures under test after calling this.
    """
    global _enabled
    previous = _enabled
    _enabled = flag
    return previous


def declare_order(first: str, second: str) -> None:
    """Declare ``first < second``: ``first`` is always acquired before
    ``second``; holding ``second`` forbids acquiring ``first``."""
    _ordered_pairs.add((first, second))


def declare_ascending(name: str) -> None:
    """Declare that instances of ``name`` nest only in ascending
    ``rank`` order (e.g. shard stripes by shard index)."""
    _ascending.add(name)


def reset_declarations() -> None:
    """Drop every declaration (test isolation)."""
    _ordered_pairs.clear()
    _ascending.clear()


def held() -> List[Tuple[str, Optional[int]]]:
    """The current thread's held tracked locks, outermost first."""
    return [
        (name, rank) for name, rank, _ in getattr(_state, "stack", ())
    ]


def _check(
    name: str, rank: Optional[int], ident: int, reentrant: bool
) -> None:
    stack = getattr(_state, "stack", [])
    if any(held_ident == ident for _, _, held_ident in stack):
        # Re-acquiring an instance this thread already holds: an RLock
        # (or Condition) re-enters without blocking — no hazard, no
        # order to check; a plain Lock is a guaranteed self-deadlock.
        if reentrant:
            return
        raise LockOrderViolation(
            f"'{name}' re-acquired by the thread already holding it — "
            "a non-reentrant lock self-deadlocks here"
        )
    for held_name, held_rank, _ in stack:
        if held_name == name:
            if name not in _ascending:
                raise LockOrderViolation(
                    f"'{name}' acquired while another instance of it is "
                    "held, with no '# kvlint: lock-order: "
                    f"{name} ascending' declaration"
                )
            if rank is None or held_rank is None or rank <= held_rank:
                raise LockOrderViolation(
                    f"'{name}' instances must be acquired in ascending "
                    f"rank order: holding rank {held_rank!r}, acquiring "
                    f"rank {rank!r}"
                )
        elif (name, held_name) in _ordered_pairs:
            raise LockOrderViolation(
                f"'{name}' acquired while holding '{held_name}', "
                f"contradicting the declared order "
                f"'{name} < {held_name}'"
            )


# ------------------------ held-lock registry ---------------------------
#
# The raceguard plane (utils/raceguard.py, KVTPU_RACEGUARD=1) needs one
# question answered on every guarded attribute access: "does the
# CURRENT thread hold this specific lock instance?"  The watchdog's
# per-thread stack answers by *name*; guarded-by enforcement needs
# *instance* identity, so this registry tracks raw-lock ids — fed by
# every wrapper (TrackedLock, ContentionTimedLock, GuardRecordingLock)
# when recording is armed, so raceguard composes with whichever mode a
# storm runs under.  Off (the default) it is a single module-global
# bool test on wrapper acquires and nothing at all on raw locks.

_guard_recording = False

# The preemption fuzzer's injection point (hack/racefuzz.py): called as
# ``hook(kind, name)`` at every recording-lock acquire and — via
# raceguard's descriptors — at every guarded read/write boundary.
# Lives here (not in raceguard) so wrappers need no circular import.
_fuzz_hook = None

# raw-lock id -> ident of the thread currently holding it; plain dict
# with single-key ops so the registry itself cannot deadlock anything.
_holder_by_lock: Dict[int, int] = {}


def guard_recording() -> bool:
    return _guard_recording


def set_guard_recording(flag: bool) -> bool:
    """Arm/disarm held-lock recording (raceguard, racefuzz, tests);
    returns the previous state."""
    global _guard_recording
    previous = _guard_recording
    _guard_recording = flag
    return previous


def set_fuzz_hook(hook):
    """Install the preemption-fuzz yield hook; returns the previous
    one.  ``hook(kind, name)`` fires at guarded-access and
    lock-acquire boundaries while recording is armed."""
    global _fuzz_hook
    previous = _fuzz_hook
    _fuzz_hook = hook
    return previous


def raw_lock(lock):
    """Unwrap OUR proxy layers only — never foreign internals (a
    ``Condition`` owns a ``_lock`` attribute that must stay inside
    it), so wrapper and checker agree on one lock identity."""
    while isinstance(
        lock, (TrackedLock, ContentionTimedLock, GuardRecordingLock)
    ):
        lock = lock._lock
    return lock


def _record_acquire(raw) -> None:
    stack = getattr(_state, "guard_held", None)
    if stack is None:
        stack = _state.guard_held = []
    stack.append(id(raw))
    # gil-atomic: single-key put; one holder per lock at a time
    _holder_by_lock[id(raw)] = threading.get_ident()


def _record_release(raw) -> None:
    stack = getattr(_state, "guard_held", None)
    ident = id(raw)
    if stack:
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == ident:
                del stack[i]
                break
        if ident not in stack:
            # Delete only our own entry: recording runs before the
            # actual release, so no racer can have re-claimed it yet.
            if _holder_by_lock.get(ident) == threading.get_ident():
                # gil-atomic: single-key del by the current holder
                _holder_by_lock.pop(ident, None)


def holds(lock) -> bool:
    """True when the CURRENT thread holds ``lock`` (any wrapping)."""
    stack = getattr(_state, "guard_held", None)
    return bool(stack) and id(raw_lock(lock)) in stack


def holder_of(lock):
    """Thread ident of the current holder, or None — the raceguard
    violation report uses it to attach the *other* thread's stack."""
    return _holder_by_lock.get(id(raw_lock(lock)))


class GuardRecordingLock:
    """Minimal held-lock-recording proxy for raw locks.

    When raceguard arms on a tree where neither the watchdog nor
    contention timing wrapped a class's lock (``tracked`` returned the
    raw primitive), instances get this wrapper at ``__init__`` time so
    their acquires still feed the registry — and the fuzz hook, which
    fires BEFORE the inner acquire: that gap between two acquisitions
    of a check-then-act is exactly where a seeded yield flushes the
    race out.
    """

    __slots__ = ("_lock", "_name")

    def __init__(self, lock, name: str = "") -> None:
        self._lock = lock
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    def acquire(self, *args, **kwargs):
        hook = _fuzz_hook
        if hook is not None:
            hook("lock-acquire", self._name)
        acquired = self._lock.acquire(*args, **kwargs)
        if acquired and _guard_recording:
            _record_acquire(self._lock)
        return acquired

    def release(self) -> None:
        if _guard_recording:
            _record_release(self._lock)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc_info) -> None:
        self.release()

    def __getattr__(self, attr):
        return getattr(self._lock, attr)


class TrackedLock:
    """Order-asserting proxy over a ``threading`` lock primitive.

    Proxies ``acquire``/``release`` and the context-manager protocol;
    anything else (``locked``, ``notify`` for Conditions) falls through
    via ``__getattr__``.
    """

    __slots__ = ("_lock", "_name", "_rank", "_reentrant")

    def __init__(self, lock, name: str, rank: Optional[int]) -> None:
        self._lock = lock
        self._name = name
        self._rank = rank
        self._reentrant = type(lock).__name__ in ("RLock", "Condition")

    @property
    def name(self) -> str:
        return self._name

    @property
    def rank(self) -> Optional[int]:
        return self._rank

    def acquire(self, *args, **kwargs):
        _check(self._name, self._rank, id(self), self._reentrant)
        hook = _fuzz_hook
        if hook is not None:
            hook("lock-acquire", self._name)
        acquired = self._lock.acquire(*args, **kwargs)
        if acquired:
            stack = getattr(_state, "stack", None)
            if stack is None:
                stack = _state.stack = []
            stack.append((self._name, self._rank, id(self)))
            if _guard_recording:
                _record_acquire(self._lock)
        return acquired

    def release(self) -> None:
        if _guard_recording:
            _record_release(self._lock)
        self._lock.release()
        stack = getattr(_state, "stack", [])
        # Remove the innermost matching hold (locks release LIFO in
        # `with` blocks; out-of-order manual release still unwinds the
        # right entry; reentrant holds pop one level per release).
        ident = id(self)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][2] == ident:
                del stack[i]
                break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc_info) -> None:
        self.release()

    def __getattr__(self, attr):
        return getattr(self._lock, attr)


# ------------------------ contention telemetry ------------------------


def _env_sample() -> int:
    raw = os.environ.get("LOCK_CONTENTION_SAMPLE", "")
    if not raw:
        return 0
    try:
        return max(0, int(raw))
    except ValueError:
        return 0


# 0 = off (tracked() returns the raw lock); N>0 = probe every Nth
# acquire of locks constructed after arming.  Mutated only by
# set_contention_sample() (tests/smokes) — read at lock construction.
_contention_sample = _env_sample()

_EWMA_ALPHA = 0.2

_contention_lock = threading.Lock()
_contention: Dict[str, "_ContentionStat"] = {}  # guarded-by: _contention_lock


class _ContentionStat:
    """Aggregate for one lock *name* (all instances fold together).

    ``sampled`` is bumped lock-free from the probe fast path — a plain
    int increment is GIL-coherent enough for a statistic, and putting
    a global lock on every Nth acquire of every tracked lock would
    manufacture exactly the contention this mode exists to find.  The
    contended-path fields are updated under ``_contention_lock``
    (that path just finished *waiting*; a lock op is noise there).
    """

    __slots__ = (
        "name",
        "sampled",
        "contended",
        "wait_total_s",
        "wait_max_s",
        "wait_ewma_s",
        "_wait_hist",
        "_contended_counter",
    )

    def __init__(self, name: str) -> None:
        self.name = name
        self.sampled = 0  # lock-free statistic (see class docstring)
        # The wait fields are updated/read under the MODULE-level
        # _contention_lock (record_contended/view) — KV001's
        # guarded-by annotation only resolves instance locks, so the
        # discipline is documented here instead.
        self.contended = 0
        self.wait_total_s = 0.0
        self.wait_max_s = 0.0
        self.wait_ewma_s = 0.0
        # Lazy import: lockorder must stay importable (and ~free) in
        # contexts that never arm timing and never touch prometheus.
        from llm_d_kv_cache_manager_tpu_torch.metrics.collector import METRICS

        self._wait_hist = METRICS.lock_wait.labels(lock=name)
        self._contended_counter = METRICS.lock_contention.labels(
            lock=name
        )

    def record_contended(self, wait_s: float) -> None:
        with _contention_lock:
            self.contended += 1
            self.wait_total_s += wait_s
            if wait_s > self.wait_max_s:
                self.wait_max_s = wait_s
            if self.wait_ewma_s == 0.0:
                self.wait_ewma_s = wait_s
            else:
                self.wait_ewma_s += _EWMA_ALPHA * (
                    wait_s - self.wait_ewma_s
                )
        self._contended_counter.inc()
        self._wait_hist.observe(wait_s)

    def view(self) -> dict:
        with _contention_lock:
            contended = self.contended
            view = {
                "sampled": self.sampled,
                "contended": contended,
                "wait_total_ms": round(self.wait_total_s * 1e3, 3),
                "wait_max_us": round(self.wait_max_s * 1e6, 1),
                "wait_ewma_us": round(self.wait_ewma_s * 1e6, 1),
            }
        sampled = view["sampled"]
        view["contention_ratio"] = (
            round(contended / sampled, 4) if sampled else 0.0
        )
        return view


def _stat_for(name: str) -> _ContentionStat:
    stat = _contention.get(name)
    if stat is not None:
        return stat
    # Construct OUTSIDE _contention_lock: the prometheus labels()
    # call takes the registry lock, and nesting a foreign lock under
    # ours is exactly the shape KV006 exists to forbid.  A racing
    # constructor loses to setdefault and its stat is garbage.
    stat = _ContentionStat(name)
    with _contention_lock:
        return _contention.setdefault(name, stat)


def contention_sample() -> int:
    """The armed sampling interval (0 = timing off)."""
    return _contention_sample


def set_contention_sample(sample: int) -> int:
    """Arm/disarm contention timing (tests, smokes); returns the
    previous interval.  Like :func:`enable`, only locks created by
    :func:`tracked` *after* the call pick the new mode up."""
    global _contention_sample
    previous = _contention_sample
    _contention_sample = max(0, int(sample))
    return previous


def contention_stats() -> Dict[str, dict]:
    """Per-lock-name contention view (the ``/debug/profile?kind=locks``
    payload): sampled/contended counts, contention ratio, wait EWMA /
    max / total."""
    with _contention_lock:
        stats = list(_contention.values())
    return {stat.name: stat.view() for stat in stats}


def reset_contention_stats() -> None:
    """Drop every accumulated stat (test/bench isolation).  Locks
    already constructed keep feeding their (now orphaned) stat
    objects; re-create structures after resetting, same as
    :func:`enable`."""
    with _contention_lock:
        _contention.clear()


class ContentionTimedLock:
    """Contention-timing proxy over a ``threading`` lock primitive.

    Every ``sample``-th acquire runs a non-blocking probe; only a
    failed probe (a genuinely contended acquire) pays for timestamps
    and stat recording.  Everything else proxies straight through,
    and non-acquire surface (``locked``, Condition ``wait``/``notify``)
    falls through via ``__getattr__`` exactly like ``TrackedLock``.
    """

    __slots__ = ("_lock", "_stat", "_sample", "_tick")

    def __init__(self, lock, stat: _ContentionStat, sample: int) -> None:
        self._lock = lock
        self._stat = stat
        self._sample = sample
        self._tick = 0

    @property
    def name(self) -> str:
        return self._stat.name

    def acquire(self, blocking: bool = True, timeout: float = -1):
        # gil-atomic: per-instance sampling tick; a lost ++ only
        # shifts which acquire gets probed
        self._tick += 1
        if self._tick % self._sample:
            acquired = self._lock.acquire(blocking, timeout)
            if acquired and _guard_recording:
                _record_acquire(self._lock)
            return acquired
        stat = self._stat
        # gil-atomic: lock-free statistic (see _ContentionStat)
        stat.sampled += 1
        if self._lock.acquire(False):
            if _guard_recording:
                _record_acquire(self._lock)
            return True
        if not blocking:
            # The probe WAS the caller's non-blocking attempt; a
            # failed one still proves contention.
            stat.record_contended(0.0)
            return False
        start = time.perf_counter()
        acquired = self._lock.acquire(blocking, timeout)
        stat.record_contended(time.perf_counter() - start)
        if acquired and _guard_recording:
            _record_acquire(self._lock)
        return acquired

    def release(self) -> None:
        if _guard_recording:
            _record_release(self._lock)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc_info) -> None:
        self.release()

    def __getattr__(self, attr):
        return getattr(self._lock, attr)


def tracked(lock, name: str, rank: Optional[int] = None):
    """Wrap ``lock`` for order checking or contention timing —
    identity when both modes are off, so the production fast path
    never pays for it.

    ``name`` should match the static model's lock identity
    (``Class._attr``); ``rank`` disambiguates instances under an
    ``ascending`` declaration (e.g. the shard index).
    """
    if _enabled:
        return TrackedLock(lock, name, rank)
    sample = _contention_sample
    if sample > 0:
        return ContentionTimedLock(lock, _stat_for(name), sample)
    return lock
