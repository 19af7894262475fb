"""gRPC stubs + servicer registration for the two framework services.

Equivalent to the plugin-generated ``*_pb2_grpc.py`` modules of the
reference (api/indexerpb, api/tokenizerpb): same fully-qualified method
paths, so clients/servers interoperate with the reference's generated Go
and Python code.

Copied from the JAX reference's ``api/grpc_services.py``, over the
port's own byte-identical copies of ``indexer_pb2`` and ``tokenizer_pb2``
(proto packages ``indexer.v1`` and ``tokenization``): one process may
load both packages, and protobuf's default pool then holds one file of
each name, which the two copies share.
"""

from __future__ import annotations

import os
from typing import Optional

import grpc

from llm_d_kv_cache_manager_tpu_torch.api import indexer_pb2, tokenizer_pb2

INDEXER_SERVICE = "indexer.v1.IndexerService"
TOKENIZATION_SERVICE = "tokenization.TokenizationService"


class IndexerServiceStub:
    """Client stub for IndexerService (reference: indexer.proto:24-27)."""

    def __init__(self, channel: grpc.Channel) -> None:
        self.channel = channel  # retained so owners can close() it
        self.GetPodScores = channel.unary_unary(
            f"/{INDEXER_SERVICE}/GetPodScores",
            request_serializer=(
                indexer_pb2.GetPodScoresRequest.SerializeToString
            ),
            response_deserializer=(
                indexer_pb2.GetPodScoresResponse.FromString
            ),
        )


class IndexerServiceServicer:
    def GetPodScores(self, request, context):  # pragma: no cover - abstract
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()


def add_indexer_servicer(servicer: IndexerServiceServicer, server) -> None:
    handlers = {
        "GetPodScores": grpc.unary_unary_rpc_method_handler(
            servicer.GetPodScores,
            request_deserializer=indexer_pb2.GetPodScoresRequest.FromString,
            response_serializer=(
                indexer_pb2.GetPodScoresResponse.SerializeToString
            ),
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(INDEXER_SERVICE, handlers),)
    )


class TokenizationServiceStub:
    """Client stub for TokenizationService (tokenizer.proto:113-123)."""

    def __init__(self, channel: grpc.Channel) -> None:
        self.channel = channel  # retained so owners can close() it
        self.Tokenize = channel.unary_unary(
            f"/{TOKENIZATION_SERVICE}/Tokenize",
            request_serializer=tokenizer_pb2.TokenizeRequest.SerializeToString,
            response_deserializer=tokenizer_pb2.TokenizeResponse.FromString,
        )
        self.RenderChatTemplate = channel.unary_unary(
            f"/{TOKENIZATION_SERVICE}/RenderChatTemplate",
            request_serializer=(
                tokenizer_pb2.ChatTemplateRequest.SerializeToString
            ),
            response_deserializer=(
                tokenizer_pb2.ChatTemplateResponse.FromString
            ),
        )
        self.InitializeTokenizer = channel.unary_unary(
            f"/{TOKENIZATION_SERVICE}/InitializeTokenizer",
            request_serializer=(
                tokenizer_pb2.InitializeTokenizerRequest.SerializeToString
            ),
            response_deserializer=(
                tokenizer_pb2.InitializeTokenizerResponse.FromString
            ),
        )


class TokenizationServiceServicer:
    def Tokenize(self, request, context):  # pragma: no cover - abstract
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def RenderChatTemplate(self, request, context):  # pragma: no cover
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def InitializeTokenizer(self, request, context):  # pragma: no cover
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()


def add_tokenization_servicer(
    servicer: TokenizationServiceServicer, server
) -> None:
    handlers = {
        "Tokenize": grpc.unary_unary_rpc_method_handler(
            servicer.Tokenize,
            request_deserializer=tokenizer_pb2.TokenizeRequest.FromString,
            response_serializer=tokenizer_pb2.TokenizeResponse.SerializeToString,
        ),
        "RenderChatTemplate": grpc.unary_unary_rpc_method_handler(
            servicer.RenderChatTemplate,
            request_deserializer=tokenizer_pb2.ChatTemplateRequest.FromString,
            response_serializer=(
                tokenizer_pb2.ChatTemplateResponse.SerializeToString
            ),
        ),
        "InitializeTokenizer": grpc.unary_unary_rpc_method_handler(
            servicer.InitializeTokenizer,
            request_deserializer=(
                tokenizer_pb2.InitializeTokenizerRequest.FromString
            ),
            response_serializer=(
                tokenizer_pb2.InitializeTokenizerResponse.SerializeToString
            ),
        ),
    }
    server.add_generic_rpc_handlers(
        (
            grpc.method_handlers_generic_handler(
                TOKENIZATION_SERVICE, handlers
            ),
        )
    )


# --- Value <-> python conversion (tokenizer.proto:72-91 kwargs encoding) ---


def value_to_python(value: tokenizer_pb2.Value):
    kind = value.WhichOneof("value")
    if kind == "string_value":
        return value.string_value
    if kind == "number_value":
        # Always a float: ints travel as int_value, so 2.0 stays 2.0 and
        # sidecar rendering agrees with the in-process path.  Version
        # skew note: upgrade decode sides (servers) before encode sides —
        # an old server's pb2 lacks int_value and would null-out integer
        # kwargs sent by a new client.
        return value.number_value
    if kind == "int_value":
        return value.int_value
    if kind == "bool_value":
        return value.bool_value
    if kind == "list_value":
        return [value_to_python(item) for item in value.list_value.values]
    if kind == "struct_value":
        return {
            key: value_to_python(item)
            for key, item in value.struct_value.fields.items()
        }
    return None


# int_value (field 6) is an extension over the reference proto, whose
# Value oneof stops at number_value (api/tokenizerpb/tokenizer.proto).
# A reference Go sidecar receiving int_value leaves the oneof unset and
# the kwarg silently becomes null — so when talking to a peer that may
# run the reference implementation, disable the extension and fall back
# to the reference's lossy-float encoding.  Env toggle for deployments;
# per-call override for tests.
USE_INT_VALUE = os.environ.get("KVTPU_PROTO_INT_VALUE", "1") != "0"


def python_to_value(
    obj, use_int_value: Optional[bool] = None
) -> tokenizer_pb2.Value:
    if use_int_value is None:
        use_int_value = USE_INT_VALUE
    value = tokenizer_pb2.Value()
    if isinstance(obj, bool):
        value.bool_value = obj
    elif isinstance(obj, str):
        value.string_value = obj
    elif isinstance(obj, int):
        if use_int_value and -(2**63) <= obj < 2**63:
            value.int_value = obj
        else:  # beyond sint64 (or reference-compat mode): lossy float
            value.number_value = float(obj)
    elif isinstance(obj, float):
        value.number_value = obj
    elif isinstance(obj, (list, tuple)):
        value.list_value.values.extend(
            python_to_value(item, use_int_value) for item in obj
        )
    elif isinstance(obj, dict):
        value.struct_value.SetInParent()
        for key, item in obj.items():
            value.struct_value.fields[str(key)].CopyFrom(
                python_to_value(item, use_int_value)
            )
    elif obj is None:
        pass  # unset oneof round-trips as None in value_to_python
    else:
        raise TypeError(f"cannot encode {type(obj).__name__} as Value")
    return value


def struct_map_to_dict(fields) -> dict:
    return {key: value_to_python(item) for key, item in fields.items()}


def dict_to_struct_map(obj: dict, fields) -> None:
    for key, item in obj.items():
        fields[str(key)].CopyFrom(python_to_value(item))
