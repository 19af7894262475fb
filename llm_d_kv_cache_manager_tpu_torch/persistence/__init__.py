"""Durable index persistence: snapshot + KV-event journal + recovery.

The global block-hash->pod index is rebuilt purely from live KVEvents,
so an indexer restart cold-starts routing across the whole fleet (the
bench's ``restart`` workload prices that at a ~10x hit-rate cliff).
This subsystem makes warm restarts possible for the in-process
backends:

* :mod:`snapshot` — atomic point-in-time dumps of any ``Index`` backend
  (versioned header, canonical-CBOR payload, CRC, tmp+rename publish).
* :mod:`journal` — an append-only log of applied index operations,
  tapped from the event pool's post-apply path, with segment rotation
  and per-pod sequence watermarks.
* :mod:`recovery` — the startup orchestrator: latest valid snapshot +
  journal-tail replay past the watermarks, torn tails tolerated.

``PersistenceManager`` composes the three; see docs/persistence.md for
the on-disk formats and crash-safety guarantees.

Copied from the JAX reference's ``persistence/__init__.py``, with the same
names.
"""

from llm_d_kv_cache_manager_tpu_torch.persistence.journal import (  # noqa: F401
    Journal,
    JournalRecord,
    OP_ADD,
    OP_EVICT,
    TailPosition,
    tail,
)
from llm_d_kv_cache_manager_tpu_torch.persistence.recovery import (  # noqa: F401
    PersistenceConfig,
    PersistenceManager,
    RecoveryReport,
    recover,
)
from llm_d_kv_cache_manager_tpu_torch.persistence.snapshot import (  # noqa: F401
    SnapshotInfo,
    load_latest_snapshot,
    write_snapshot,
)
