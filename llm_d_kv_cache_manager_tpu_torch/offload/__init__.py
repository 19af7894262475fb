from llm_d_kv_cache_manager_tpu_torch.offload.file_mapper import FileMapper  # noqa: F401
from llm_d_kv_cache_manager_tpu_torch.offload.manager import (  # noqa: F401
    SharedStorageOffloadManager,
)
from llm_d_kv_cache_manager_tpu_torch.offload.spec import (  # noqa: F401
    TPUOffloadConnector,
    TPUOffloadSpec,
)
from llm_d_kv_cache_manager_tpu_torch.offload.staging_engine import (  # noqa: F401
    StagingConfig,
    StagingEngine,
    StagingSaturated,
)
from llm_d_kv_cache_manager_tpu_torch.offload.worker import (  # noqa: F401
    DeviceToStorageHandler,
    StorageToDeviceHandler,
)
