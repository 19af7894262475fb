"""KV events: the index write path (wire model, ingestion pool, resync,
subscriptions).

The reference's package names, with one change: the names from
``poller`` and ``subscriber_manager`` resolve lazily (PEP 562), so
``from llm_d_kv_cache_manager_tpu_torch.kvevents import Pool`` loads
neither the socket layer nor ``zmq``.  The port's socket modules import
``zmq`` only where a socket or context is made
(``zmq_subscriber.import_zmq``).
"""

from llm_d_kv_cache_manager_tpu_torch.kvevents.events import (  # noqa: F401
    AllBlocksCleared,
    BlockRemoved,
    BlockStored,
    EventBatch,
    decode_event,
    decode_event_batch,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.pool import (  # noqa: F401
    Message,
    Pool,
    PoolConfig,
    ResyncJob,
)
from llm_d_kv_cache_manager_tpu_torch.kvevents.resync import (  # noqa: F401
    CallableInventorySource,
    EmptyInventorySource,
    InventoryBlock,
    InventorySource,
    PodInventory,
    ResyncConfig,
    ResyncManager,
)

_LAZY = {
    "ChannelConfig": "poller",
    "PollerPool": "poller",
    "PollerPoolConfig": "poller",
    "SubscriberManager": "subscriber_manager",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
