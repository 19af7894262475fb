"""Native runtime loader.

``get_library()`` returns the ctypes handle to the port's
``libkvtpu_native`` (built from ``src/`` at first use, see ``build.py``).
Unlike the JAX package's loader it never returns None: a failed build
raises, so no caller slips onto the pure-Python engine or hash chain
unnoticed.  The Python engine is an explicit choice
(``KVTPU_DISABLE_NATIVE=1``, read by ``engine.OffloadEngine``), as the
Python hash chain is (``ChunkedTokenDatabase(use_native=False)``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entries the port calls: the block-hash chain (the
    token processor's keys), XXH64 (the prefix store's chunk keys) and
    the offload engine."""
    lib.kvtpu_hash_chain.restype = ctypes.c_size_t
    lib.kvtpu_hash_chain.argtypes = [
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_size_t,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint64),
    ]

    lib.kvtpu_xxh64.restype = ctypes.c_uint64
    lib.kvtpu_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64]

    lib.kvtpu_engine_create.restype = ctypes.c_void_p
    lib.kvtpu_engine_create.argtypes = [ctypes.c_size_t, ctypes.c_int]
    lib.kvtpu_engine_destroy.argtypes = [ctypes.c_void_p]

    lib.kvtpu_engine_store.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_size_t,
        ctypes.c_int,
    ]
    lib.kvtpu_engine_load.argtypes = lib.kvtpu_engine_store.argtypes[:-1]
    lib.kvtpu_engine_get_finished.restype = ctypes.c_size_t
    lib.kvtpu_engine_get_finished.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_size_t,
    ]
    lib.kvtpu_engine_wait.restype = ctypes.c_int32
    lib.kvtpu_engine_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    return lib


def get_library() -> ctypes.CDLL:
    """The loaded native library, built on first use; raises
    ``RuntimeError`` (build) or ``OSError`` (load) on failure, and
    tries again on the next call."""
    global _lib
    with _lock:
        if _lib is None:
            from llm_d_kv_cache_manager_tpu_torch.native.build import build

            _lib = _configure(ctypes.CDLL(str(build())))
        return _lib
