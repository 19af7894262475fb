"""Python surface of the native library.

``native_hash_chain`` hashes token ids into chained block keys for the
token processor (``kvcache/kvblock/token_processor.py``).
``OffloadEngine`` runs async host-buffer <-> file jobs on the
NUMA-pinned native I/O pool.  The pure-Python ``_PythonEngine``
(ThreadPoolExecutor + Python file I/O) stays as an explicit choice,
``KVTPU_DISABLE_NATIVE=1``; it is never what a failed build gives, since
``get_library`` raises then.

Buffers are numpy arrays (on the CUDA path, views of pinned host
tensors); the caller owns their memory until the job completes, and the
engine keeps references to them until the job is harvested.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from enum import IntEnum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from llm_d_kv_cache_manager_tpu_torch.native import get_library

logger = logging.getLogger(__name__)


class JobStatus(IntEnum):
    PENDING = 0
    SUCCEEDED = 1
    FAILED = 2
    UNKNOWN = 3


def native_hash_chain(
    parent_hash: int, tokens: Sequence[int], block_size: int
) -> Optional[List[int]]:
    """Chunk-hash via the native library.  None when an id is not an
    integer in uint32's range, so the caller takes the Python chain (an
    unsafe cast would wrap silently and diverge from it); a library that
    fails to build raises (``get_library``)."""
    lib = get_library()
    try:
        raw = np.asarray(tokens)
        if not np.issubdtype(raw.dtype, np.integer):
            return None
        if raw.dtype != np.uint32 and raw.size and (
            raw.min() < 0 or raw.max() > 0xFFFFFFFF
        ):
            return None
        token_array = raw.astype(np.uint32, copy=False)
        if not token_array.flags["C_CONTIGUOUS"]:
            token_array = np.ascontiguousarray(token_array)
    except (OverflowError, ValueError, TypeError):
        return None
    n_chunks = len(token_array) // block_size
    if n_chunks == 0:
        return []
    out = np.empty(n_chunks, dtype=np.uint64)
    written = lib.kvtpu_hash_chain(
        ctypes.c_uint64(parent_hash & 0xFFFFFFFFFFFFFFFF),
        token_array.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(token_array),
        block_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out[:written].tolist()


def store_file(
    path: str, buffer: np.ndarray, skip_existing: bool = True
) -> bool:
    """Synchronous atomic (tmp+rename) store of one host buffer — the
    Python engine's per-file primitive."""
    try:
        if skip_existing:
            # Dedupe only when the resident file covers at least our
            # bytes; a smaller file is a partial (head) group and is
            # upgraded by rewriting (file = head-k blocks of a
            # group).  If the stat/touch races a sweeper delete,
            # fall through and write the bytes we hold.
            try:
                if os.path.getsize(path) >= buffer.nbytes:
                    os.utime(path)
                    return True
            except OSError:
                pass
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(buffer.tobytes())
        os.replace(tmp, path)
        return True
    except OSError:
        return False


class _PythonEngine:
    """Job engine in pure Python: ThreadPoolExecutor + Python file I/O."""

    def __init__(self, n_threads: int) -> None:
        self._executor = ThreadPoolExecutor(
            max_workers=n_threads, thread_name_prefix="kvtpu-offload"
        )
        self._lock = threading.Lock()
        self._jobs: Dict[int, List[Future]] = {}  # guarded-by: _lock

    _store_one = staticmethod(store_file)

    @staticmethod
    def _load_one(path: str, buffer: np.ndarray) -> bool:
        try:
            expected = buffer.nbytes
            # A partial load reads the head of a (possibly larger) group
            # file; a file smaller than the request is a miss.
            if os.path.getsize(path) < expected:
                return False
            with open(path, "rb") as f:
                data = f.read(expected)
            if len(data) != expected:
                return False
            flat = buffer.reshape(-1).view(np.uint8)
            flat[:] = np.frombuffer(data, dtype=np.uint8)
            return True
        except OSError:
            return False

    def store(self, job_id, paths, buffers, skip_existing) -> None:
        futures = [
            self._executor.submit(self._store_one, p, b, skip_existing)
            for p, b in zip(paths, buffers)
        ]
        with self._lock:
            self._jobs[job_id] = futures

    def load(self, job_id, paths, buffers) -> None:
        futures = [
            self._executor.submit(self._load_one, p, b)
            for p, b in zip(paths, buffers)
        ]
        with self._lock:
            self._jobs[job_id] = futures

    def get_finished(self) -> List[Tuple[int, JobStatus]]:
        finished = []
        with self._lock:
            done_ids = [
                job_id
                for job_id, futures in self._jobs.items()
                if all(f.done() for f in futures)
            ]
            for job_id in done_ids:
                futures = self._jobs.pop(job_id)
                ok = all(f.result() for f in futures)
                finished.append(
                    (job_id, JobStatus.SUCCEEDED if ok else JobStatus.FAILED)
                )
        return finished

    def wait(self, job_id) -> JobStatus:
        with self._lock:
            futures = self._jobs.pop(job_id, None)
        if futures is None:
            return JobStatus.UNKNOWN
        ok = all(f.result() for f in futures)
        return JobStatus.SUCCEEDED if ok else JobStatus.FAILED

    def close(self) -> None:
        self._executor.shutdown(wait=True)


class OffloadEngine:
    """Async store/load of host numpy buffers to/from block files."""

    def __init__(self, n_threads: int = 4, numa_node: int = -1) -> None:
        self._closed = False
        self.n_threads = n_threads
        self._buffers_lock = threading.Lock()
        # Keep buffer references alive until their job is harvested.
        self._live_buffers: Dict[int, list] = {}  # guarded-by: _buffers_lock
        if os.environ.get("KVTPU_DISABLE_NATIVE"):
            self._lib = None
            self._handle = None
            self._fallback = _PythonEngine(n_threads)
            logger.info("python offload engine (KVTPU_DISABLE_NATIVE): %d threads", n_threads)
        else:
            self._lib = get_library()  # raises when the build fails
            self._handle = self._lib.kvtpu_engine_create(n_threads, numa_node)
            self._fallback = None
            logger.info(
                "native offload engine: %d threads, numa_node=%d",
                n_threads,
                numa_node,
            )

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("offload engine is closed")

    def _pin(self, job_id: int, buffers: list) -> None:
        with self._buffers_lock:
            if job_id in self._live_buffers:
                # Overwriting would drop the only references to buffers the
                # native workers still touch (use-after-free).
                raise ValueError(
                    f"job id {job_id} is still in flight; ids must be "
                    "unique until harvested"
                )
            self._live_buffers[job_id] = buffers

    def _unpin(self, job_id: int) -> None:
        with self._buffers_lock:
            self._live_buffers.pop(job_id, None)

    @staticmethod
    def _marshal(paths, buffers):
        n = len(paths)
        path_array = (ctypes.c_char_p * n)(
            *[p.encode() for p in paths]
        )
        ptr_array = (ctypes.c_void_p * n)(
            *[b.ctypes.data_as(ctypes.c_void_p) for b in buffers]
        )
        size_array = (ctypes.c_size_t * n)(*[b.nbytes for b in buffers])
        return path_array, ptr_array, size_array

    def store(
        self,
        job_id: int,
        paths: Sequence[str],
        buffers: Sequence[np.ndarray],
        skip_existing: bool = True,
    ) -> None:
        if len(paths) != len(buffers):
            raise ValueError("paths/buffers length mismatch")
        self._check_open()
        buffers = [np.ascontiguousarray(b) for b in buffers]
        self._pin(job_id, buffers)
        if self._fallback is not None:
            self._fallback.store(job_id, paths, buffers, skip_existing)
            return
        path_array, ptr_array, size_array = self._marshal(paths, buffers)
        self._lib.kvtpu_engine_store(
            self._handle,
            job_id,
            path_array,
            ptr_array,
            size_array,
            len(paths),
            1 if skip_existing else 0,
        )

    def load(
        self,
        job_id: int,
        paths: Sequence[str],
        buffers: Sequence[np.ndarray],
    ) -> None:
        if len(paths) != len(buffers):
            raise ValueError("paths/buffers length mismatch")
        self._check_open()
        for buffer in buffers:
            if not buffer.flags["C_CONTIGUOUS"] or not buffer.flags["WRITEABLE"]:
                raise ValueError("load buffers must be contiguous+writeable")
        buffers = list(buffers)
        self._pin(job_id, buffers)
        if self._fallback is not None:
            self._fallback.load(job_id, paths, buffers)
            return
        path_array, ptr_array, size_array = self._marshal(paths, buffers)
        self._lib.kvtpu_engine_load(
            self._handle,
            job_id,
            path_array,
            ptr_array,
            size_array,
            len(paths),
        )

    def get_finished(self, max_out: int = 1024) -> List[Tuple[int, JobStatus]]:
        self._check_open()
        if self._fallback is not None:
            finished = self._fallback.get_finished()
        else:
            job_ids = (ctypes.c_int64 * max_out)()
            statuses = (ctypes.c_int32 * max_out)()
            n = self._lib.kvtpu_engine_get_finished(
                self._handle, job_ids, statuses, max_out
            )
            finished = [
                (int(job_ids[i]), JobStatus(int(statuses[i])))
                for i in range(n)
            ]
        for job_id, _ in finished:
            self._unpin(job_id)
        return finished

    def wait(self, job_id: int) -> JobStatus:
        self._check_open()
        if self._fallback is not None:
            status = self._fallback.wait(job_id)
        else:
            status = JobStatus(
                int(self._lib.kvtpu_engine_wait(self._handle, job_id))
            )
        self._unpin(job_id)
        return status

    def close(self) -> None:
        if self._closed:
            return
        # gil-atomic: monotonic close flag; double close is idempotent
        self._closed = True
        if self._fallback is not None:
            self._fallback.close()
        elif self._handle is not None:
            self._lib.kvtpu_engine_destroy(self._handle)
            # gil-atomic: close is single-owner; __del__ runs at last ref only
            self._handle = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
