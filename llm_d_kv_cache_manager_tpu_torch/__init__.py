"""llm-d KV-cache manager, PyTorch/CUDA port.

A second package beside ``llm_d_kv_cache_manager_tpu`` (the JAX
reference), ported module by module for one NVIDIA H100.  It keeps the
reference's module paths, public names and tensor layouts, so each
counterpart is found under the same path in both packages.  It imports
``torch`` and numpy, never ``jax`` and nothing of the JAX package.

What is ported so far is the serving slice: a prompt is hashed into
chained block keys (``kvcache.kvblock.token_processor``), looked up in
the in-memory block index (``kvcache.kvblock.in_memory``) and scored by
longest resident prefix (``kvcache.scorer``); the chosen pod then runs
the paged-KV Llama (``models.llama``) over its ``KVCachePool``
(``models.kv_cache_pool``).  On CUDA tensors prefill attention runs the
hand-written kernel of ``ops.flash_cuda`` and decode attention the one
of ``ops.paged_decode_cuda``; on CPU tensors the plain PyTorch ops of
``ops.attention``, ``ops.flash_attention`` and ``ops.paged_attention``.

Entry points that create tensors take ``device="cuda"`` by default and
raise when no GPU is present, unless the caller asks for ``"cpu"``.
"""

__version__ = "0.1.0"

# Guarded-by runtime enforcement (KVTPU_RACEGUARD=1), as in the JAX
# package: instrument every class of the port's manifest
# (utils/raceguard_manifest.json) at import time, so all later
# constructions are covered.  Unarmed this is a single env check.
import os as _os  # noqa: E402

if _os.environ.get("KVTPU_RACEGUARD", "") in ("1", "true", "yes"):
    from llm_d_kv_cache_manager_tpu_torch.utils import raceguard as _raceguard

    _raceguard.install_from_env()
