"""The scoring service: ``api.http_service`` (``serve``, ``main``).

The reference's gRPC half (``grpc_services``, ``indexer_service`` and the
``*_pb2`` message modules) is not ported yet.
"""
