#!/usr/bin/env python3
"""Preemption fuzzer for the PyTorch port: the port's storms re-run
under the port's raceguard with hostile scheduling.

The port's counterpart of ``hack/racefuzz.py``, over
``llm_d_kv_cache_manager_tpu_torch.utils.raceguard`` and ``lockorder``
and the port's manifest (``utils/raceguard_manifest.json``).  Run as
``python -m hack.racefuzz_torch --plant check-then-act --seed 1337`` or
``python -m hack.racefuzz_torch --seed N`` (storm mode).

The port's concurrency storms (tests/test_torch_concurrency.py: the
index backends, the sharded index, the score memo, the cluster fan-out
and the event pool) normally run with CPython's default
5 ms switch interval, which hides narrow race windows: a thread that
reads a guarded value and writes it back two bytecodes later almost
never gets preempted in between.  This harness re-runs them with

* ``KVTPU_RACEGUARD=1`` semantics (guarded-by runtime enforcement,
  installed in-process from the kvlint manifest),
* ``sys.setswitchinterval(1e-6)`` — preemption every ~microsecond,
* seeded yield injection at guarded-access and lock-acquire
  boundaries: the raceguard descriptors and every lockorder wrapper
  fire the fuzz hook registered via ``lockorder.set_fuzz_hook``, and
  the hook — driven by a per-thread ``random.Random`` derived from
  ``--seed`` — sleeps at a seeded subset of those boundaries, forcing
  the interleavings the default scheduler never explores.

Python 3.10 has no ``sys.monitoring`` (3.12+), so the injection points
are the instrumentation boundaries themselves rather than per-opcode
callbacks; every guarded read/write and every lock acquire is a
boundary, which is exactly where check-then-act windows live.

Failures report the seed and BOTH thread stacks (raceguard violations
embed them already; planted lost-update collisions capture them via
``sys._current_frames`` at overlap time), so
``python -m hack.racefuzz_torch --seed N`` deterministically replays a
reported failure.

Planted defects (``--plant``) prove the harness can see what it claims
to see:

* ``guarded-write``  — a thread writes a guarded attr lockless;
  raceguard must raise.
* ``caller-locked``  — a method statically claims
  ``# kvlint: caller-locked`` but a caller invokes it without the
  lock; the runtime check must catch the false claim kvlint phase 1
  trusted.
* ``check-then-act`` — the KV009 shape at runtime: read under one
  acquisition feeds a write under a second one; two threads must lose
  an update, and the harness reports the overlapping stacks.

Exit codes: 0 = no race found (storm mode) / plant reproduced (plant
mode, which is the *expected* outcome); 1 = race found (storm mode) /
plant NOT reproduced; 2 = usage.
"""

from __future__ import annotations

import argparse
import importlib
import os
import random
import sys
import threading
import time
import traceback
from typing import List, Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

PACKAGE = "llm_d_kv_cache_manager_tpu_torch"


def _port(name: str):
    """The port's module ``name`` (looked up by name, as the port's
    scripts and tests reach it)."""
    return importlib.import_module(f"{PACKAGE}.{name}")


DEFAULT_STORMS = [
    "tests/test_torch_concurrency.py::TestBackendStorm",
    "tests/test_torch_concurrency.py::TestShardedIndexStorm",
    "tests/test_torch_concurrency.py::TestScoreMemoStorm",
    "tests/test_torch_concurrency.py::TestClusterFanoutStorm",
    "tests/test_torch_concurrency.py",
]

# Yield probability per fuzz boundary.  High enough to shuffle
# interleavings hard, low enough that a storm still finishes inside a
# CI smoke budget.
YIELD_RATE = 0.15


class _SeededYielder:
    """Fuzz hook: per-thread deterministic RNG, seeded yields.

    Each thread draws from ``Random(seed ^ arrival_index)`` so the
    yield pattern a thread sees depends only on the seed and the order
    threads first hit a boundary — replaying a seed replays the
    per-thread decision streams.
    """

    def __init__(self, seed: int, yield_rate: float = YIELD_RATE) -> None:
        self.seed = seed
        self.yield_rate = yield_rate
        self.boundaries = 0  # lone-advance statistic, races tolerated
        self.yields = 0
        self._local = threading.local()
        self._index_lock = threading.Lock()
        self._next_index = 0

    def _rng(self) -> random.Random:
        rng = getattr(self._local, "rng", None)
        if rng is None:
            with self._index_lock:
                index = self._next_index
                self._next_index += 1
            rng = self._local.rng = random.Random(self.seed ^ index)
        return rng

    def __call__(self, kind: str, name: str) -> None:
        self.boundaries += 1
        rng = self._rng()
        roll = rng.random()
        if roll < self.yield_rate:
            self.yields += 1
            # Mix zero-length yields (run queue rotation) with short
            # sleeps (force another thread deep into the window).
            if roll < self.yield_rate / 3:
                time.sleep(rng.uniform(1e-6, 5e-5))
            else:
                time.sleep(0)


def _arm(seed: int):
    lockorder, raceguard = _port("utils.lockorder"), _port("utils.raceguard")

    raceguard.install_from_env() if raceguard.armed_from_env() else None
    if not raceguard.installed():
        raceguard.install()
    lockorder.set_guard_recording(True)
    hook = _SeededYielder(seed)
    lockorder.set_fuzz_hook(hook)
    sys.setswitchinterval(1e-6)
    return hook


def _disarm() -> None:
    lockorder = _port("utils.lockorder")

    sys.setswitchinterval(0.005)
    lockorder.set_fuzz_hook(None)


# --------------------------- planted defects ---------------------------


class _PlantReport:
    def __init__(self) -> None:
        self.reproduced = False
        self.detail = ""
        self.stacks: List[str] = []


def _plant_guarded_write(seed: int, report: _PlantReport) -> None:
    """A guarded attr written without its lock: raceguard must raise
    on the very first write, no scheduling luck required."""
    raceguard = _port("utils.raceguard")

    class PlantedGuardedWrite:
        def __init__(self) -> None:
            self._lock = threading.Lock()
            self._value = 0  # guarded-by: _lock

        def buggy_write(self, value: int) -> None:
            self._value = value  # missing `with self._lock:`

    raceguard.guard_class(PlantedGuardedWrite, {"_value": "_lock"})
    obj = PlantedGuardedWrite()
    try:
        obj.buggy_write(7)
    except raceguard.RaceGuardViolation as exc:
        report.reproduced = True
        report.detail = str(exc).splitlines()[0]
        report.stacks = [str(exc)]


def _plant_caller_locked(seed: int, report: _PlantReport) -> None:
    """A method statically annotated caller-locked (kvlint phase 1
    trusts the claim and skips it) called WITHOUT the lock — the
    runtime check catches the lie."""
    raceguard = _port("utils.raceguard")

    class PlantedCallerLocked:
        def __init__(self) -> None:
            self._lock = threading.Lock()
            self._items: List[int] = []  # guarded-by: _lock

        def _append_locked(self, item: int) -> None:  # kvlint: caller-locked
            self._items.append(item)

        def honest_caller(self, item: int) -> None:
            with self._lock:
                self._append_locked(item)

        def lying_caller(self, item: int) -> None:
            self._append_locked(item)  # claim is false: no lock held

    raceguard.guard_class(PlantedCallerLocked, {"_items": "_lock"})
    obj = PlantedCallerLocked()
    obj.honest_caller(1)  # must pass: claim honoured
    try:
        obj.lying_caller(2)
    except raceguard.RaceGuardViolation as exc:
        report.reproduced = True
        report.detail = str(exc).splitlines()[0]
        report.stacks = [str(exc)]


def _plant_check_then_act(seed: int, report: _PlantReport) -> None:
    """The KV009 shape, live: read under one acquisition feeds a write
    under a second acquisition of the same lock.  Every access holds
    the lock, so raceguard stays silent — the fuzzer has to surface it
    as a lost update, and reports the two overlapping thread stacks
    captured the moment both threads sat inside the gap."""
    threads = 2
    increments = 400

    gap_lock = threading.Lock()
    in_gap: dict = {}  # thread ident -> True while inside the window

    class PlantedCounter:
        def __init__(self) -> None:
            self._lock = threading.Lock()
            self._value = 0  # guarded-by: _lock

        def buggy_increment(self) -> None:
            with self._lock:
                current = self._value
            me = threading.get_ident()
            with gap_lock:
                in_gap[me] = True
                others = [t for t in in_gap if t != me]
                if others and not report.stacks:
                    frames = sys._current_frames()
                    for ident in (me, others[0]):
                        frame = frames.get(ident)
                        if frame is not None:
                            report.stacks.append(
                                f"thread {ident}:\n"
                                + "".join(traceback.format_stack(frame))
                            )
            try:
                time.sleep(0)  # the gap the fuzz scheduling widens
                with self._lock:
                    self._value = current + 1
            finally:
                with gap_lock:
                    in_gap.pop(me, None)

    raceguard = _port("utils.raceguard")

    raceguard.guard_class(PlantedCounter, {"_value": "_lock"})
    counter = PlantedCounter()

    def worker() -> None:
        for _ in range(increments):
            counter.buggy_increment()

    pool = [
        threading.Thread(target=worker, name=f"racefuzz-{i}")
        for i in range(threads)
    ]
    for thread in pool:
        thread.start()
    for thread in pool:
        thread.join()

    expected = threads * increments
    with counter._lock:
        final = counter._value
    if final < expected:
        report.reproduced = True
        report.detail = (
            f"lost update: {expected - final} of {expected} increments "
            f"vanished (final={final}) — read and write sit in separate "
            f"acquisitions of the same lock"
        )


_PLANTS = {
    "guarded-write": _plant_guarded_write,
    "caller-locked": _plant_caller_locked,
    "check-then-act": _plant_check_then_act,
}


def _run_plant(kind: str, seed: int) -> int:
    hook = _arm(seed)
    report = _PlantReport()
    try:
        _PLANTS[kind](seed, report)
    finally:
        _disarm()
    print(
        f"racefuzz: plant={kind} seed={seed} "
        f"boundaries={hook.boundaries} yields={hook.yields}"
    )
    if report.reproduced:
        print(f"racefuzz: REPRODUCED: {report.detail}")
        for stack in report.stacks:
            print(stack)
        return 0
    print(f"racefuzz: plant '{kind}' NOT reproduced under seed {seed}")
    return 1


# ----------------------------- storm mode ------------------------------


def _run_storms(
    storms: List[str], seed: int, time_budget_s: Optional[float]
) -> int:
    import pytest

    hook = _arm(seed)
    deadline = (
        time.monotonic() + time_budget_s if time_budget_s else None
    )
    failed: List[str] = []
    try:
        for node in storms:
            if deadline is not None and time.monotonic() >= deadline:
                print(
                    f"racefuzz: time budget exhausted before {node!r}",
                    flush=True,
                )
                break
            print(f"racefuzz: seed={seed} storm={node}", flush=True)
            code = pytest.main(
                [
                    node,
                    "-q",
                    "-x",
                    "-p",
                    "no:cacheprovider",
                    "-p",
                    "no:randomly",
                ]
            )
            if code != 0:
                failed.append(node)
    finally:
        _disarm()
    print(
        f"racefuzz: seed={seed} boundaries={hook.boundaries} "
        f"yields={hook.yields} failed={len(failed)}"
    )
    if failed:
        print(
            f"racefuzz: RACE (or storm failure) under seed {seed}: "
            + ", ".join(failed)
        )
        print(
            f"racefuzz: replay with `python -m hack.racefuzz_torch "
            f"--seed {seed} --storms {' '.join(failed)}` — raceguard "
            f"violations above carry both thread stacks"
        )
        return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="racefuzz",
        description=(
            "re-run concurrency storms under raceguard with "
            "microsecond preemption and seeded yield injection"
        ),
    )
    parser.add_argument(
        "--seed",
        type=int,
        default=None,
        help="fuzz seed (default: derived from time; always printed)",
    )
    parser.add_argument(
        "--storms",
        nargs="+",
        default=None,
        metavar="NODE",
        help="pytest node ids to storm (default: the known storms)",
    )
    parser.add_argument(
        "--plant",
        choices=sorted(_PLANTS),
        default=None,
        help="run a planted defect instead of the storms; exit 0 iff "
        "the harness reproduces it",
    )
    parser.add_argument(
        "--time-budget",
        type=float,
        default=None,
        metavar="SECONDS",
        help="stop starting new storms after this budget (CI smoke)",
    )
    args = parser.parse_args(argv)

    seed = args.seed
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "big")

    if args.plant is not None:
        return _run_plant(args.plant, seed)
    storms = args.storms or DEFAULT_STORMS
    return _run_storms(storms, seed, args.time_budget)


if __name__ == "__main__":
    sys.exit(main())
