"""Seeded fuzz of each package's HTTP scoring service, on the CPU.

Every case of the reference's ``tests/test_http_service_fuzz.py`` runs on
both packages (``m`` is either one's names): the server must answer every
request with a well-formed HTTP status (2xx-5xx) and keep serving —
garbage bodies, type-confused fields, hostile Content-Length headers and
random paths must never wedge a handler thread or kill the listener.
"""

import http.client
import json
import random

import pytest

from tests.helpers.tiny_tokenizer import save_tokenizer_json

from llm_d_kv_cache_manager_tpu.api import http_service as ref_http_service
from llm_d_kv_cache_manager_tpu.kvcache import indexer as ref_indexer
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import token_processor as ref_token_processor
from llm_d_kv_cache_manager_tpu.tokenization import pool as ref_pool
from llm_d_kv_cache_manager_tpu.tokenization import tokenizers as ref_tokenizers
from tests.helpers.torch_port import namespace

SIDES = ("ref", "port")
_REF = {
    "api.http_service": ref_http_service,
    "kvcache.indexer": ref_indexer,
    "kvcache.kvblock.token_processor": ref_token_processor,
    "tokenization.pool": ref_pool,
    "tokenization.tokenizers": ref_tokenizers,
}
_NAMES = {
    "api.http_service": ("MAX_BODY_BYTES", "serve"),
    "kvcache.indexer": ("Indexer", "IndexerConfig"),
    "kvcache.kvblock.token_processor": ("TokenProcessorConfig",),
    "tokenization.pool": ("TokenizationPoolConfig",),
    "tokenization.tokenizers": ("LocalFastTokenizer",),
}


@pytest.fixture(params=SIDES)
def m(request):
    return namespace(request.param, _REF, _NAMES)


MODEL = "test-model"
PATHS = [
    "/score_completions",
    "/score_chat_completions",
    "/admin/purge_pod",
    "/metrics",
    "/healthz",
    "/nope",
]


@pytest.fixture()
def service(m, tmp_path):
    tokenizer_dir = save_tokenizer_json(str(tmp_path), MODEL)
    indexer = m.Indexer(
        m.IndexerConfig(
            token_processor_config=m.TokenProcessorConfig(block_size=4),
            tokenizers_pool_config=m.TokenizationPoolConfig(
                workers=2, model_name=MODEL
            ),
        ),
        tokenizer=m.LocalFastTokenizer(tokenizer_dir),
    )
    indexer.run()
    server = m.serve(indexer, host="127.0.0.1", port=0)
    yield server.server_address[1]
    server.shutdown()
    server.server_close()
    indexer.shutdown()


def _request(port, method, path, body=b"", headers=None):
    """One raw request; returns the status, or None on a dropped
    connection.  A drop is a DESIGNED outcome for requests whose body
    the server never consumes (close-with-unread-data RSTs on Linux
    and can race away the queued error reply); callers that require an
    answer assert the status is not None."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        response = conn.getresponse()
        response.read()
        return response.status
    except (http.client.HTTPException, ConnectionError, OSError):
        return None
    finally:
        conn.close()


def _random_json(rng: random.Random, depth=0):
    kinds = ["int", "str", "none", "float", "bool", "list", "dict"]
    if depth >= 3:
        kinds = kinds[:5]
    kind = rng.choice(kinds)
    if kind == "int":
        return rng.randint(-(2**40), 2**40)
    if kind == "str":
        return rng.choice(["", "x", "prompt", "pods", "model", " "])
    if kind == "none":
        return None
    if kind == "float":
        return rng.random()
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "list":
        return [_random_json(rng, depth + 1) for _ in range(rng.randint(0, 4))]
    keys = ["prompt", "model", "pods", "messages", "tools", "pod", "x"]
    return {
        rng.choice(keys): _random_json(rng, depth + 1)
        for _ in range(rng.randint(0, 5))
    }


class TestHTTPFuzz:
    def test_random_bodies_always_answered(self, service):
        port = service
        rng = random.Random(0)
        post_routes = (
            "/score_completions",
            "/score_chat_completions",
            "/admin/purge_pod",
        )
        for _ in range(60):
            path = rng.choice(PATHS)
            if rng.random() < 0.5:
                body = json.dumps(_random_json(rng)).encode()
            else:
                body = rng.randbytes(rng.randint(0, 64))
            method = rng.choice(["POST", "GET"])
            status = _request(
                port,
                method,
                path,
                body=body,
                headers={"Content-Type": "application/json"},
            )
            if body and (method == "GET" or path not in post_routes):
                # A drop (None) is designed ONLY for requests whose
                # declared body may go unconsumed (404 paths,
                # GET-with-body): close-with-unread-data RSTs can race
                # away the reply.
                assert status is None or 200 <= status < 600
            else:
                # POSTs to real routes consume their body (loopback
                # passes the admin gate) and bodyless requests declare
                # nothing: no legitimate drop — the server must
                # answer, or the suite has lost the always-answered
                # regression it exists to rule out.
                assert status is not None and 200 <= status < 600
        # Liveness canary: whatever the fuzz provoked, a clean request
        # afterwards must still be answered.
        assert _request(port, "GET", "/healthz") == 200

    def test_hostile_content_length(self, m, service):
        port = service
        body = b'{"prompt": "x"}'
        # '+15', '1_5' and ' 15 ' are accepted by Python's liberal
        # int() but are corrupted headers under the strict digit
        # grammar (same policy as RespClient._parse_int).
        for bad in [
            "-1",
            "-99999",
            "notanint",
            "+15",
            "1_5",
            " 15 ",
            "0x10",
            str(m.MAX_BODY_BYTES + 1),
            # Past CPython's ~4300-digit str->int limit: must be
            # rejected by the digit-count bound, not crash the handler.
            "1" * 5000,
        ]:
            status = _request(
                port,
                "POST",
                "/score_completions",
                body=body,
                headers={"Content-Length": bad},
            )
            # None tolerated: the reject-and-close leaves the body
            # unread, and the RST can race away the queued reply.
            assert status in (None, 400, 413), (
                f"Content-Length {bad}: {status}"
            )
        # Liveness canary: a well-formed request (body fully consumed,
        # no legitimate drop) must still be answered after the storm.
        status = _request(
            port,
            "POST",
            "/score_completions",
            body=body,
            headers={"Content-Type": "application/json"},
        )
        assert status == 200, status

    def test_unconsumed_body_on_404_route_closes_connection(self, service):
        """A POST to an unknown path replies 404 before reading the
        body; the unread bytes must not be parsed as the next request
        line — the server closes the connection instead."""
        port = service
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            # The server may close with the body bytes unread (Linux
            # RSTs on such a close), which can race away the 404 —
            # either outcome proves the desync protection.
            try:
                conn.request(
                    "POST",
                    "/no/such/path",
                    body=b'{"x": 1}',
                    headers={"Content-Type": "application/json"},
                )
                response = conn.getresponse()
                response.read()
                assert response.status == 404
            except (http.client.HTTPException, ConnectionError, OSError):
                return  # server dropped the connection early: correct
            try:
                conn.request("GET", "/healthz")
                response = conn.getresponse()
                response.read()
                # If the connection survived, the reply must be a real
                # 200 — never a 400 from the body bytes parsed as a
                # request line.
                assert response.status == 200
            except (http.client.HTTPException, ConnectionError, OSError):
                pass  # server dropped the desynced connection: correct
        finally:
            conn.close()

    def test_conflicting_content_length_headers_rejected(self, service):
        """Duplicate Content-Length headers with different values are a
        request-smuggling primitive (read(first) leaves body bytes
        buffered as the next request line); reject with 400."""
        port = service
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            conn.putrequest("POST", "/score_completions")
            conn.putheader("Content-Length", "5")
            conn.putheader("Content-Length", "100")
            conn.endheaders()
            conn.send(b"A" * 100)
            response = conn.getresponse()
            response.read()
            assert response.status == 400
        except (http.client.HTTPException, ConnectionError, OSError):
            pass  # early close is also a correct rejection
        finally:
            conn.close()

    def test_chunked_transfer_encoding_rejected(self, service):
        """A chunked body is never decoded by _read_json; accepting it
        would leave the chunk framing buffered and desync keep-alive.
        The server must reject and drop the connection."""
        port = service
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            # The server may 501-and-close before the chunk bytes are
            # even sent (close-with-unread-data RSTs on Linux), so the
            # send and first read are themselves race-tolerant: either
            # we see the 501, or the connection is already gone —
            # both prove the reject-and-drop behavior.
            try:
                conn.putrequest("POST", "/score_completions")
                conn.putheader("Transfer-Encoding", "chunked")
                conn.endheaders()
                conn.send(b"5\r\nhello\r\n0\r\n\r\n")
                response = conn.getresponse()
                response.read()
                assert response.status == 501
            except (http.client.HTTPException, ConnectionError, OSError):
                return  # server dropped the connection early: correct
            # The connection must be closed: a follow-up either fails or
            # never sees the chunk bytes parsed as a request line.
            try:
                conn.request("GET", "/healthz")
                response = conn.getresponse()
                response.read()
                assert response.status == 200
            except (http.client.HTTPException, ConnectionError, OSError):
                pass  # server dropped the desynced connection: correct
        finally:
            conn.close()

    def test_rejected_body_does_not_desync_keepalive(self, m, service):
        """An unread body on a keep-alive connection must not be parsed
        as the next request line: the server closes the connection after
        rejecting.  A follow-up on the same socket either fails (closed)
        or — never — returns 501 for the garbage 'method'."""
        port = service
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            conn.request(
                "POST",
                "/score_completions",
                body=b"A" * 64,
                headers={"Content-Length": str(m.MAX_BODY_BYTES + 1)},
            )
            response = conn.getresponse()
            response.read()
            assert response.status == 413
            try:
                conn.request("GET", "/healthz")
                response = conn.getresponse()
                response.read()
                assert response.status == 200
            except (http.client.HTTPException, ConnectionError, OSError):
                pass  # server dropped the desynced connection: correct
        finally:
            conn.close()

    def test_server_alive_after_fuzz(self, service):
        port = service
        rng = random.Random(1)
        for _ in range(30):
            _request(
                port,
                "POST",
                rng.choice(PATHS),
                body=rng.randbytes(rng.randint(0, 32)),
            )
        status = _request(
            port,
            "POST",
            "/score_completions",
            body=json.dumps({"prompt": "hello world", "model": MODEL}).encode(),
            headers={"Content-Type": "application/json"},
        )
        assert status == 200
