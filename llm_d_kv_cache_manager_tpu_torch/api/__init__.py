"""The scoring service: ``api.http_service`` (``serve``, ``main``) and the
gRPC half (reference: api/indexerpb, api/tokenizerpb): the message
modules ``indexer_pb2`` and ``tokenizer_pb2``, byte-identical copies of
the JAX package's, the stubs and servicers of ``grpc_services`` and the
scoring service of ``indexer_service``.

Unlike the JAX package's ``api/__init__.py``, importing this package
loads no message module: ``api.http_service`` must import and serve on
a machine without ``grpc`` and ``google.protobuf``.  The message modules
load at first use, as ``api.indexer_pb2`` or
``from llm_d_kv_cache_manager_tpu_torch.api import indexer_pb2``.
"""

import importlib

__all__ = ["indexer_pb2", "tokenizer_pb2"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
