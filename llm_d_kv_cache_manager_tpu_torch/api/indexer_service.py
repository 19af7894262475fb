"""gRPC scoring service wrapping the Indexer.

TPU-native counterpart of the reference's index service
(examples/kv_cache_index_service/server/server.go:67-93): one RPC,
``GetPodScores``, delegating to ``Indexer.get_pod_scores``.  Serves TCP
or Unix-domain endpoints (``unix:///path.sock``).

Copied from the JAX reference's ``api/indexer_service.py``; the trace
opens on the port's own ``obs.trace.TRACER``.
"""

from __future__ import annotations

from concurrent import futures
from typing import Optional

import grpc

from llm_d_kv_cache_manager_tpu_torch.api import indexer_pb2
from llm_d_kv_cache_manager_tpu_torch.api.grpc_services import (
    IndexerServiceServicer,
    IndexerServiceStub,
    add_indexer_servicer,
)
from llm_d_kv_cache_manager_tpu_torch.kvcache.indexer import Indexer
from llm_d_kv_cache_manager_tpu_torch.obs.trace import TRACER, use_trace
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("api.indexer_service")


class IndexerGrpcService(IndexerServiceServicer):
    def __init__(self, indexer: Indexer) -> None:
        self.indexer = indexer

    def GetPodScores(self, request, context):
        # W3C traceparent rides gRPC metadata (same semantics as the
        # HTTP header): a sampled flag forces tracing, and the server's
        # own traceparent is echoed in the initial metadata.
        traceparent = None
        for key, value in context.invocation_metadata() or ():
            if key == "traceparent":
                traceparent = value
        req_trace = TRACER.start_trace(
            "grpc.get_pod_scores", traceparent=traceparent
        )
        try:
            with use_trace(req_trace):
                scores = self.indexer.get_pod_scores(
                    prompt=request.prompt,
                    model_name=request.model_name,
                    pod_identifiers=list(request.pod_identifiers) or None,
                )
        except Exception as exc:
            if req_trace is not None:
                req_trace.set_error(repr(exc))
                req_trace.finish("error")
            logger.exception("GetPodScores failed")
            context.abort(grpc.StatusCode.INTERNAL, str(exc))
            return indexer_pb2.GetPodScoresResponse()
        if req_trace is not None:
            req_trace.finish()
            try:
                context.send_initial_metadata(
                    (("traceparent", req_trace.traceparent()),)
                )
            except Exception as exc:  # noqa: BLE001 - echo is best-effort
                # Headers may already be on the wire; the trace itself
                # is recorded either way.
                logger.debug("traceparent metadata echo failed: %s", exc)
        response = indexer_pb2.GetPodScoresResponse()
        # Deterministic order: score desc, pod asc (stable for clients).
        for pod, score in sorted(
            scores.items(), key=lambda kv: (-kv[1], kv[0])
        ):
            response.scores.add(pod=pod, score=score)
        return response


def serve(
    indexer: Indexer,
    address: str = "[::]:50051",
    max_workers: int = 8,
    server: Optional[grpc.Server] = None,
) -> grpc.Server:
    """Build+start a server; returns it (caller owns lifetime)."""
    if server is None:
        server = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=max_workers,
                thread_name_prefix="kvtpu-grpc",
            )
        )
    add_indexer_servicer(IndexerGrpcService(indexer), server)
    server.add_insecure_port(address)
    server.start()
    logger.info("indexer gRPC service listening on %s", address)
    return server


def new_client(address: str) -> IndexerServiceStub:
    return IndexerServiceStub(grpc.insecure_channel(address))
