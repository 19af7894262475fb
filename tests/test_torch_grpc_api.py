"""The port's gRPC half (``api/grpc_services.py``, ``api/indexer_service.py``,
the ``*_pb2`` copies, ``services/uds_tokenizer.py`` and
``tokenization/uds_tokenizer.py``) against the JAX package's, on the CPU.

Every case of the reference's ``tests/test_grpc_api.py`` runs on both
packages (``m`` is either one's names) over real grpcio channels on
Unix-domain sockets in the test's temporary directory: score round trips,
the sidecar's tokenize, render and init, the UDS client backend, the
``Value`` kwargs codec, the UDS backend in ``IndexerConfig`` and garbage on
the wire.  Then the two packages against each other: the port's client
against the reference's server and the reverse, for both services, the
``python_to_value`` wire bytes equal, the message modules byte-identical
(one protobuf file each in the default pool, shared), and an Indexer
configured with ``uds_tokenizer_path`` scoring equal through each
package's own sidecar.
"""

import os
import random

import grpc
import pytest

from llm_d_kv_cache_manager_tpu.api import grpc_services as ref_grpc_services
from llm_d_kv_cache_manager_tpu.api import indexer_pb2 as ref_indexer_pb2
from llm_d_kv_cache_manager_tpu.api import indexer_service as ref_indexer_service
from llm_d_kv_cache_manager_tpu.api import tokenizer_pb2 as ref_tokenizer_pb2
from llm_d_kv_cache_manager_tpu.kvcache import indexer as ref_indexer
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import index as ref_index
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as ref_token_processor
from llm_d_kv_cache_manager_tpu.services import uds_tokenizer as ref_sidecar
from llm_d_kv_cache_manager_tpu.tokenization import pool as ref_tokenization_pool
from llm_d_kv_cache_manager_tpu.tokenization import tokenizers as ref_tokenizers
from llm_d_kv_cache_manager_tpu.tokenization import uds_tokenizer as ref_uds_tokenizer
from tests.helpers.tiny_tokenizer import (
    build_transformers_tokenizer,
    save_tokenizer_json,
)
from tests.helpers.torch_port import PACKAGE, namespace, port

SIDES = ("ref", "port")
_REF = {
    "api.indexer_pb2": ref_indexer_pb2,
    "api.tokenizer_pb2": ref_tokenizer_pb2,
    "api.grpc_services": ref_grpc_services,
    "api.indexer_service": ref_indexer_service,
    "kvcache.indexer": ref_indexer,
    "kvcache.kvblock.index": ref_index,
    "kvcache.kvblock.token_processor": ref_token_processor,
    "services.uds_tokenizer": ref_sidecar,
    "tokenization.pool": ref_tokenization_pool,
    "tokenization.tokenizers": ref_tokenizers,
    "tokenization.uds_tokenizer": ref_uds_tokenizer,
}
_NAMES = {
    "api.grpc_services": ("python_to_value", "value_to_python", "INDEXER_SERVICE",
                          "TOKENIZATION_SERVICE"),
    "api.indexer_service": ("new_client", "serve"),
    "kvcache.indexer": ("Indexer", "IndexerConfig"),
    "kvcache.kvblock.index": ("PodEntry",),
    "kvcache.kvblock.token_processor": ("EMPTY_BLOCK_HASH", "TokenProcessorConfig"),
    "services.uds_tokenizer": ("TokenizerRegistry",),
    "tokenization.pool": ("TokenizationPoolConfig",),
    "tokenization.tokenizers": ("LocalFastTokenizer",),
    "tokenization.uds_tokenizer": ("UdsTokenizer",),
}


def side(name):
    ns = namespace(name, _REF, _NAMES)
    pick = (lambda path: _REF[path]) if name == "ref" else port
    ns.indexer_pb2 = pick("api.indexer_pb2")
    ns.tokenizer_pb2 = pick("api.tokenizer_pb2")
    ns.serve_tokenizer = pick("services.uds_tokenizer").serve
    return ns


@pytest.fixture(params=SIDES)
def m(request):
    return side(request.param)


MODEL = "test-model"
BLOCK_SIZE = 4
PROMPT = "the quick brown fox jumps over the lazy dog"


def make_indexer(m, tmp_path, **config):
    tokenizer_dir = save_tokenizer_json(str(tmp_path), MODEL)
    indexer = m.Indexer(
        m.IndexerConfig(
            token_processor_config=m.TokenProcessorConfig(block_size=BLOCK_SIZE),
            tokenizers_pool_config=m.TokenizationPoolConfig(workers=2, model_name=MODEL),
            **config,
        ),
        tokenizer=m.LocalFastTokenizer(tokenizer_dir),
    )
    indexer.run()
    return indexer


@pytest.fixture()
def indexer(m, tmp_path):
    indexer = make_indexer(m, tmp_path)
    yield indexer
    indexer.shutdown()


def seed_index(m, indexer, prompt, pod):
    """Store the prompt's block chain for a pod, bypassing events."""
    tokens = indexer.tokenization_pool.tokenize(prompt, MODEL, None)
    keys = indexer.token_processor.tokens_to_kv_block_keys(m.EMPTY_BLOCK_HASH, tokens, MODEL)
    indexer.kv_block_index.add(keys, keys, [m.PodEntry(pod, "hbm")])
    return keys


@pytest.fixture()
def scoring_endpoint(m, indexer, tmp_path):
    uds = os.path.join(str(tmp_path), "indexer.sock")
    server = m.serve(indexer, f"unix://{uds}")
    yield indexer, f"unix://{uds}"
    server.stop(grace=None)


class TestIndexerService:
    def test_score_round_trip(self, m, scoring_endpoint):
        indexer, address = scoring_endpoint
        seed_index(m, indexer, PROMPT, "pod-a")
        client = m.new_client(address)
        response = client.GetPodScores(m.indexer_pb2.GetPodScoresRequest(
            prompt=PROMPT, model_name=MODEL, pod_identifiers=["pod-a", "pod-b"]))
        scores = {s.pod: s.score for s in response.scores}
        assert scores["pod-a"] > 0
        assert "pod-b" not in scores or scores["pod-b"] == 0
        client.channel.close()

    def test_empty_index_scores_nothing(self, m, scoring_endpoint):
        _, address = scoring_endpoint
        client = m.new_client(address)
        response = client.GetPodScores(
            m.indexer_pb2.GetPodScoresRequest(prompt=PROMPT, model_name=MODEL))
        assert len(response.scores) == 0
        client.channel.close()

    def test_scores_sorted_descending(self, m, scoring_endpoint):
        indexer, address = scoring_endpoint
        keys = seed_index(m, indexer, PROMPT, "pod-a")
        indexer.kv_block_index.add(keys[:1], keys[:1], [m.PodEntry("pod-b", "hbm")])
        client = m.new_client(address)
        response = client.GetPodScores(
            m.indexer_pb2.GetPodScoresRequest(prompt=PROMPT, model_name=MODEL))
        values = [s.score for s in response.scores]
        assert values == sorted(values, reverse=True)
        assert response.scores[0].pod == "pod-a"
        client.channel.close()

    def test_equal_scores_order_by_pod(self, m, scoring_endpoint):
        """Ties sort by pod name ascending (score descending first)."""
        indexer, address = scoring_endpoint
        keys = seed_index(m, indexer, PROMPT, "pod-c")
        indexer.kv_block_index.add(keys, keys, [m.PodEntry("pod-a", "hbm")])
        indexer.kv_block_index.add(keys[:1], keys[:1], [m.PodEntry("pod-b", "hbm")])
        client = m.new_client(address)
        response = client.GetPodScores(
            m.indexer_pb2.GetPodScoresRequest(prompt=PROMPT, model_name=MODEL))
        assert [s.pod for s in response.scores] == ["pod-a", "pod-c", "pod-b"]
        client.channel.close()


def start_sidecar(m, tmp_path, name="tokenizer.sock"):
    registry = m.TokenizerRegistry()
    registry.register(MODEL, build_transformers_tokenizer())
    uds = os.path.join(str(tmp_path), name)
    return m.serve_tokenizer(uds, max_workers=2, registry=registry), uds


@pytest.fixture()
def tokenizer_sidecar(m, tmp_path):
    server, uds = start_sidecar(m, tmp_path)
    yield uds
    server.stop(grace=None)


class TestTokenizerSidecar:
    def test_tokenize_with_offsets(self, m, tokenizer_sidecar):
        client = m.UdsTokenizer(tokenizer_sidecar)
        encoding = client.encode(PROMPT, MODEL, add_special_tokens=False)
        assert len(encoding.tokens) == len(PROMPT.split())
        assert len(encoding.offsets) == len(encoding.tokens)
        start, end = encoding.offsets[1]
        assert PROMPT[start:end] == "quick"
        client.close()

    def test_matches_local_backend(self, m, tokenizer_sidecar, tmp_path):
        local_dir = save_tokenizer_json(str(tmp_path / "local"), MODEL)
        local = m.LocalFastTokenizer(local_dir)
        client = m.UdsTokenizer(tokenizer_sidecar)
        via_uds = client.encode(PROMPT, MODEL, add_special_tokens=False)
        via_local = local.encode(PROMPT, MODEL, add_special_tokens=False)
        assert via_uds.tokens == via_local.tokens
        assert via_uds.offsets == via_local.offsets
        client.close()

    def test_initialize_and_render(self, m, tokenizer_sidecar):
        client = m.UdsTokenizer(tokenizer_sidecar)
        client.initialize_model(MODEL)
        request = m.tokenizer_pb2.ChatTemplateRequest(model_name=MODEL,
                                                      add_generation_prompt=True)
        turn = request.conversation_turns.add()
        turn.messages.add(role="user", content="hello world")
        response = client._stub.RenderChatTemplate(request)
        assert response.success
        assert "<|user|> hello world" in response.rendered_prompt
        assert response.rendered_prompt.endswith("<|assistant|>")
        client.close()

    def test_multi_turn_render(self, m, tokenizer_sidecar):
        client = m.UdsTokenizer(tokenizer_sidecar)
        request = m.tokenizer_pb2.ChatTemplateRequest(model_name=MODEL,
                                                      add_generation_prompt=True)
        for role, content in (("user", "hello"), ("assistant", "world"), ("user", "again")):
            turn = request.conversation_turns.add()
            turn.messages.add(role=role, content=content)
        response = client._stub.RenderChatTemplate(request)
        assert response.success, response.error_message
        assert "<|user|> hello" in response.rendered_prompt
        assert "<|assistant|> world" in response.rendered_prompt
        assert response.rendered_prompt.endswith("<|assistant|>")
        client.close()

    def test_unknown_model_reports_error(self, m, tmp_path):
        """A model the registry lacks goes to its loader; this one fails
        at once (no hub is asked), and the error travels in the answer."""
        def loader(name):
            raise OSError(f"no tokenizer for {name}")

        registry = m.TokenizerRegistry(loader=loader)
        uds = os.path.join(str(tmp_path), "unknown.sock")
        server = m.serve_tokenizer(uds, max_workers=2, registry=registry)
        client = m.UdsTokenizer(uds)
        try:
            response = client._stub.Tokenize(
                m.tokenizer_pb2.TokenizeRequest(input="x", model_name="no/such-model-xyz"))
            assert not response.success
            assert "no/such-model-xyz" in response.error_message
        finally:
            client.close()
            server.stop(grace=None)


class TestValueCodec:
    PAYLOAD = {
        "name": "tool",
        "depth": 3,
        "ratio": 0.5,
        "flag": True,
        "items": ["a", 1, False],
        "nested": {"k": "v"},
        "absent": None,
        "empty": {},
    }

    def test_round_trip(self, m):
        assert m.value_to_python(m.python_to_value(self.PAYLOAD)) == self.PAYLOAD

    def test_int_float_distinction_survives_roundtrip(self, m):
        as_float = m.value_to_python(m.python_to_value(2.0))
        assert as_float == 2.0 and isinstance(as_float, float)
        as_int = m.value_to_python(m.python_to_value(2))
        assert as_int == 2 and isinstance(as_int, int)
        assert m.value_to_python(m.python_to_value(-(2**40))) == -(2**40)

    def test_number_value_stays_float(self, m):
        value = m.tokenizer_pb2.Value(number_value=7.0)
        assert m.value_to_python(value) == 7.0
        assert isinstance(m.value_to_python(value), float)

    def test_reference_compat_mode_sends_ints_as_floats(self, m):
        value = m.python_to_value({"n": 3}, use_int_value=False)
        assert value.struct_value.fields["n"].WhichOneof("value") == "number_value"
        assert m.value_to_python(m.python_to_value(2**70)) == float(2**70)


class TestUdsInIndexerConfig:
    def test_composite_includes_uds_backend(self, m, tokenizer_sidecar):
        indexer = m.Indexer(m.IndexerConfig(
            tokenizers_pool_config=m.TokenizationPoolConfig(workers=1, model_name=MODEL),
            uds_tokenizer_path=tokenizer_sidecar))
        names = indexer.tokenization_pool._tokenizer.type()
        assert "uds" in names
        indexer.tokenization_pool._tokenizer.backends[0].close()
        indexer.shutdown()


class TestWireRobustness:
    def test_garbage_request_bytes_then_valid_call(self, m, scoring_endpoint):
        indexer, endpoint = scoring_endpoint
        seed_index(m, indexer, PROMPT, "pod-a")
        rng = random.Random(0)
        channel = grpc.insecure_channel(endpoint)
        raw = channel.unary_unary(f"/{m.INDEXER_SERVICE}/GetPodScores",
                                  request_serializer=lambda b: b,
                                  response_deserializer=lambda b: b)
        for _ in range(20):
            with pytest.raises(grpc.RpcError) as err:
                raw(rng.randbytes(rng.randint(1, 64)), timeout=10)
            assert err.value.code() in (grpc.StatusCode.INTERNAL,
                                        grpc.StatusCode.INVALID_ARGUMENT,
                                        grpc.StatusCode.UNKNOWN)
        channel.close()
        client = m.new_client(endpoint)
        response = client.GetPodScores(m.indexer_pb2.GetPodScoresRequest(
            prompt=PROMPT, model_name=MODEL, pod_identifiers=["pod-a"]))
        assert {s.pod: s.score for s in response.scores}["pod-a"] > 0
        client.channel.close()


# ------------------------------------------------ the packages together


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_message_modules_and_protos_are_byte_identical():
    """The port's ``*_pb2`` modules and protos are copies of the
    reference's, byte for byte; loaded beside them they share one
    descriptor and one message class each."""
    for name in ("indexer_pb2.py", "tokenizer_pb2.py", "protos/indexer.proto",
                 "protos/tokenizer.proto"):
        with open(os.path.join(REPO, "llm_d_kv_cache_manager_tpu", "api", name), "rb") as a, \
                open(os.path.join(REPO, PACKAGE, "api", name), "rb") as b:
            assert a.read() == b.read(), name
    ours, theirs = side("port"), side("ref")
    assert ours.indexer_pb2.DESCRIPTOR is theirs.indexer_pb2.DESCRIPTOR
    assert ours.tokenizer_pb2.Value is theirs.tokenizer_pb2.Value
    assert (ours.INDEXER_SERVICE, ours.TOKENIZATION_SERVICE) == (
        "indexer.v1.IndexerService", "tokenization.TokenizationService")
    assert (ours.INDEXER_SERVICE, ours.TOKENIZATION_SERVICE) == (
        theirs.INDEXER_SERVICE, theirs.TOKENIZATION_SERVICE)


@pytest.mark.parametrize("payload", [
    TestValueCodec.PAYLOAD, 2, 2.0, -(2**40), 2**70, "x", True, None, [1, "a", [2.5, {}]],
    {"tools": [{"type": "function", "function": {"name": "f", "parameters": {"n": 3}}}]},
])
@pytest.mark.parametrize("use_int_value", [None, True, False])
def test_value_wire_bytes_equal_across_packages(payload, use_int_value):
    ours, theirs = side("port"), side("ref")
    got = ours.python_to_value(payload, use_int_value).SerializeToString(deterministic=True)
    want = theirs.python_to_value(payload, use_int_value).SerializeToString(deterministic=True)
    assert got == want
    parsed = theirs.tokenizer_pb2.Value.FromString(got)
    assert ours.value_to_python(parsed) == theirs.value_to_python(parsed)


@pytest.mark.parametrize("server_side,client_side", [("ref", "port"), ("port", "ref")])
def test_indexer_service_interoperates(tmp_path, server_side, client_side):
    """One package's client against the other's server on a loopback
    Unix socket: the answer equals the server's in-process scores, in
    the same order, and the traceparent comes back."""
    server_m, client_m = side(server_side), side(client_side)
    indexer = make_indexer(server_m, tmp_path)
    uds = os.path.join(str(tmp_path), "ix.sock")
    server = server_m.serve(indexer, f"unix://{uds}")
    client = client_m.new_client(f"unix://{uds}")
    try:
        keys = seed_index(server_m, indexer, PROMPT, "pod-a")
        indexer.kv_block_index.add(keys[:1], keys[:1], [server_m.PodEntry("pod-b", "host")])
        trace_id = f"{0x5150:032x}"
        response, call = client.GetPodScores.with_call(
            client_m.indexer_pb2.GetPodScoresRequest(
                prompt=PROMPT, model_name=MODEL, pod_identifiers=["pod-a", "pod-b", "pod-c"]),
            metadata=(("traceparent", f"00-{trace_id}-{'ab' * 8}-01"),), timeout=30)
        want = indexer.get_pod_scores(PROMPT, MODEL, ["pod-a", "pod-b", "pod-c"])
        got = [(s.pod, s.score) for s in response.scores]
        assert got == sorted(want.items(), key=lambda kv: (-kv[1], kv[0]))
        assert got[0][0] == "pod-a" and got[0][1] > got[1][1] > 0
        echoed = dict(call.initial_metadata()).get("traceparent")
        assert echoed is not None and echoed.split("-")[1] == trace_id
    finally:
        client.channel.close()
        server.stop(grace=None)
        indexer.shutdown()


@pytest.mark.parametrize("server_side,client_side", [("ref", "port"), ("port", "ref")])
def test_tokenizer_sidecar_interoperates(tmp_path, server_side, client_side):
    server_m, client_m = side(server_side), side(client_side)
    server, uds = start_sidecar(server_m, tmp_path)
    client = client_m.UdsTokenizer(uds)
    try:
        client.initialize_model(MODEL)
        got = client.encode(PROMPT + " é", MODEL, add_special_tokens=False)
        local = client_m.LocalFastTokenizer(save_tokenizer_json(str(tmp_path / "local"), MODEL))
        want = local.encode(PROMPT + " é", MODEL, add_special_tokens=False)
        assert (got.tokens, got.offsets) == (want.tokens, want.offsets)
        request = client_m.tokenizer_pb2.ChatTemplateRequest(model_name=MODEL,
                                                             add_generation_prompt=True)
        request.conversation_turns.add().messages.add(role="user", content="hello")
        client_m_kwargs = client_m.python_to_value({"depth": 2}).struct_value.fields
        for key, value in client_m_kwargs.items():
            request.chat_template_kwargs[key].CopyFrom(value)
        rendered = client._stub.RenderChatTemplate(request)
        assert rendered.success, rendered.error_message
        assert rendered.rendered_prompt.endswith("<|assistant|>")
    finally:
        client.close()
        server.stop(grace=None)


def test_indexers_on_their_sidecars_score_equal(tmp_path):
    """An Indexer of each package configured with ``uds_tokenizer_path``
    and no tokenizer of its own, each over its own package's sidecar and
    the same block chains, scores the same prompts equally (the port's
    UDS backend is the first of its chain, as the reference's)."""
    results = {}
    for name in SIDES:
        m = side(name)
        server, uds = start_sidecar(m, tmp_path, f"{name}.sock")
        indexer = m.Indexer(m.IndexerConfig(
            token_processor_config=m.TokenProcessorConfig(block_size=BLOCK_SIZE),
            tokenizers_pool_config=m.TokenizationPoolConfig(workers=2, model_name=MODEL),
            uds_tokenizer_path=uds))
        indexer.run()
        try:
            assert [b.type() for b in indexer.tokenization_pool._tokenizer.backends] == [
                "uds", "transformers"]
            keys = seed_index(m, indexer, PROMPT, "pod-a")
            indexer.kv_block_index.add(keys[:1], keys[:1], [m.PodEntry("pod-b", "hbm")])
            results[name] = [indexer.get_pod_scores(p, MODEL) for p in (
                PROMPT, PROMPT + " again", "the lazy dog", "fox")]
        finally:
            indexer.tokenization_pool._tokenizer.backends[0].close()
            indexer.shutdown()
            server.stop(grace=None)
    assert results["port"] == results["ref"]
    assert results["port"][0]["pod-a"] > results["port"][0]["pod-b"] > 0
