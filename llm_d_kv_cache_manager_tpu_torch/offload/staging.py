"""Host staging-memory budget for offload transfers.

The reference bounds staging memory by clamping I/O threads, since each
of its threads owns one pinned buffer (kv_connectors/llmd_fs_backend/
llmd_fs_backend/worker.py:191-216).  Our engine instead queues whole-job
host buffers, so the binding resource is *in-flight bytes*: every
submitted-but-unfinished job holds its gather/read buffers alive.  This
budget gates submissions on that total, blocking the submitter until
completions release enough bytes — backpressure, not OOM.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class StagingBudget:
    """Byte-budget gate for in-flight host buffers.

    ``acquire`` blocks until the bytes fit (a single over-budget request
    is admitted alone rather than deadlocking); ``release`` returns bytes
    at job completion.  Thread-safe; waiters wake on every release.
    """

    def __init__(self, max_bytes: int) -> None:
        if max_bytes <= 0:
            raise ValueError(f"max_bytes must be positive, got {max_bytes}")
        self.max_bytes = max_bytes
        self._in_flight = 0  # guarded-by: _cond
        # Leaf of the offload lock hierarchy: waiters block here, but
        # nothing else is acquired while it is held.
        self._cond = threading.Condition()

    @property
    def in_flight_bytes(self) -> int:
        with self._cond:
            return self._in_flight

    def _fits_locked(self, nbytes: int) -> bool:
        if self._in_flight + nbytes <= self.max_bytes:
            return True
        # A request larger than the whole budget can never "fit"; admit
        # it alone rather than wedging the caller forever.
        return nbytes > self.max_bytes and self._in_flight == 0

    def acquire(self, nbytes: int, timeout: Optional[float] = None) -> bool:
        """Block until ``nbytes`` fit in the budget; True on success."""
        if nbytes < 0:
            raise ValueError(f"nbytes must be non-negative, got {nbytes}")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._fits_locked(nbytes):
                if deadline is None:
                    self._cond.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            self._in_flight += nbytes
            return True

    def try_acquire(self, nbytes: int) -> bool:
        """Non-blocking acquire: True iff the bytes fit right now.

        Submission paths that run on a serving thread must use this
        instead of ``acquire``: when releases can only happen via later
        calls on the *same* thread (e.g. vLLM's worker polls
        ``get_finished`` between ``transfer_async`` calls), a blocking
        acquire deadlocks the serving loop once in-flight bytes reach
        the budget.
        """
        return self.acquire(nbytes, timeout=0)

    def release(self, nbytes: int) -> None:
        with self._cond:
            self._in_flight -= nbytes
            if self._in_flight < 0:  # defensive: never go negative
                self._in_flight = 0
            self._cond.notify_all()
