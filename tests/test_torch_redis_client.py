"""The RESP client cases of the JAX package's ``tests/test_redis_client.py``
on both packages, on the CPU: URL parsing, the AUTH and TLS handshakes and
the atomic eviction prune, each against ``tests/helpers/miniresp.py`` as the
server (the card's machine has no Redis server).  ``m`` is either
package's names; each case holds both to the reference's expectations.
"""

import ssl
import subprocess
import threading

import pytest

from llm_d_kv_cache_manager_tpu.kvcache.kvblock import index as ref_index
from llm_d_kv_cache_manager_tpu.kvcache.kvblock import redis_index as ref_redis_index
from tests.helpers.miniresp import MiniRespServer
from tests.helpers.torch_port import namespace

SIDES = ("ref", "port")
_REF = {
    "kvcache.kvblock.index": ref_index,
    "kvcache.kvblock.redis_index": ref_redis_index,
}
_NAMES = {
    "kvcache.kvblock.index": ("PodEntry", "RedisIndexConfig"),
    "kvcache.kvblock.redis_index": ("_ENGINE_PREFIX", "_PRUNE_SCRIPT", "RedisIndex",
                                    "RespClient", "RespError", "parse_redis_url"),
}


def mods(side):
    m = namespace(side, _REF, _NAMES)
    m.POD1 = m.PodEntry("pod-1", "hbm")
    m.POD2 = m.PodEntry("pod-2", "hbm")
    return m


@pytest.fixture(params=SIDES)
def m(request):
    return mods(request.param)


class TestParseRedisURL:
    def test_bare_host_port(self, m):
        ep = m.parse_redis_url("example.com:7000")
        assert (ep.host, ep.port, ep.tls) == ("example.com", 7000, False)
        assert ep.password is None and ep.db == 0

    def test_defaults(self, m):
        ep = m.parse_redis_url("redis://")
        assert (ep.host, ep.port) == ("127.0.0.1", 6379)

    def test_valkey_rewrites(self, m):
        assert not m.parse_redis_url("valkey://h:1").tls
        assert m.parse_redis_url("valkeys://h:1").tls

    def test_credentials_and_db(self, m):
        ep = m.parse_redis_url("redis://user:s%40cret@h:6380/3")
        assert ep.username == "user"
        assert ep.password == "s@cret"
        assert (ep.host, ep.port, ep.db) == ("h", 6380, 3)

    def test_password_only(self, m):
        ep = m.parse_redis_url("redis://:pw@h")
        assert ep.username is None or ep.username == ""
        assert ep.password == "pw"

    def test_unix_socket(self, m):
        ep = m.parse_redis_url("unix:///var/run/redis.sock")
        assert ep.unix_path == "/var/run/redis.sock"

    def test_unix_socket_db_query(self, m):
        ep = m.parse_redis_url("unix:///var/run/redis.sock?db=3")
        assert ep.db == 3

    def test_unknown_query_param_rejected(self, m):
        with pytest.raises(ValueError, match="query parameter"):
            m.parse_redis_url("redis://h:1?ssl_cert_reqs=none")

    def test_rejects_unknown_scheme(self, m):
        with pytest.raises(ValueError):
            m.parse_redis_url("http://h:1")

    def test_rejects_bad_db(self, m):
        with pytest.raises(ValueError):
            m.parse_redis_url("redis://h:1/notanumber")


class TestAuthHandshake:
    def test_authenticated_roundtrip(self, m):
        server = MiniRespServer(password="hunter2")
        try:
            idx = m.RedisIndex(
                m.RedisIndexConfig(
                    address=f"redis://:hunter2@{server.address}"
                )
            )
            idx.add([1], [101], [m.POD1])
            assert idx.lookup([101]) == {101: [m.POD1]}
        finally:
            server.close()

    def test_wrong_password_rejected(self, m):
        server = MiniRespServer(password="hunter2")
        try:
            with pytest.raises(m.RespError):
                m.RedisIndex(
                    m.RedisIndexConfig(
                        address=f"redis://:wrong@{server.address}"
                    )
                )
        finally:
            server.close()

    def test_unauthenticated_client_refused(self, m):
        server = MiniRespServer(password="hunter2")
        try:
            client = m.RespClient("127.0.0.1", server.port)
            with pytest.raises(m.RespError, match="NOAUTH"):
                client.execute("PING")
        finally:
            server.close()

    def test_username_password_pair(self, m):
        server = MiniRespServer(password="hunter2")
        try:
            client = m.RespClient(
                endpoint=m.parse_redis_url(
                    f"redis://default:hunter2@{server.address}"
                )
            )
            assert client.execute("PING") == "PONG"
        finally:
            server.close()

    def test_reconnect_replays_auth(self, m):
        server = MiniRespServer(password="hunter2")
        try:
            client = m.RespClient(
                endpoint=m.parse_redis_url(
                    f"redis://:hunter2@{server.address}"
                )
            )
            assert client.execute("PING") == "PONG"
            client.close()  # force the transparent-reconnect path
            assert client.execute("PING") == "PONG"
        finally:
            server.close()


@pytest.fixture(scope="module")
def tls_cert(tmp_path_factory):
    base = tmp_path_factory.mktemp("tls")
    key, cert = str(base / "key.pem"), str(base / "cert.pem")
    proc = subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048",
            "-keyout", key, "-out", cert, "-days", "1", "-nodes",
            "-subj", "/CN=127.0.0.1",
            "-addext", "subjectAltName=IP:127.0.0.1",
        ],
        capture_output=True,
    )
    if proc.returncode != 0:
        pytest.skip(f"openssl unavailable: {proc.stderr[-200:]}")
    return key, cert


class TestTLSHandshake:
    def _server(self, tls_cert, password=None):
        key, cert = tls_cert
        context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        context.load_cert_chain(cert, key)
        return MiniRespServer(password=password, ssl_context=context)

    def test_rediss_with_ca_file(self, m, tls_cert):
        server = self._server(tls_cert)
        try:
            idx = m.RedisIndex(
                m.RedisIndexConfig(
                    address=f"rediss://127.0.0.1:{server.port}",
                    tls_ca_file=tls_cert[1],
                )
            )
            idx.add([2], [202], [m.POD1])
            assert idx.lookup([202]) == {202: [m.POD1]}
        finally:
            server.close()

    def test_untrusted_cert_rejected(self, m, tls_cert):
        server = self._server(tls_cert)
        try:
            with pytest.raises((ssl.SSLError, OSError)):
                m.RedisIndex(
                    m.RedisIndexConfig(
                        address=f"rediss://127.0.0.1:{server.port}"
                    )
                )
        finally:
            server.close()

    def test_insecure_skip_verify(self, m, tls_cert):
        server = self._server(tls_cert)
        try:
            idx = m.RedisIndex(
                m.RedisIndexConfig(
                    address=f"valkeys://127.0.0.1:{server.port}",
                    tls_insecure_skip_verify=True,
                )
            )
            idx.add([3], [303], [m.POD1])
            assert idx.lookup([303]) == {303: [m.POD1]}
        finally:
            server.close()

    def test_tls_with_auth(self, m, tls_cert):
        server = self._server(tls_cert, password="pw")
        try:
            idx = m.RedisIndex(
                m.RedisIndexConfig(
                    address=f"rediss://:pw@127.0.0.1:{server.port}",
                    tls_ca_file=tls_cert[1],
                )
            )
            idx.add([4], [404], [m.POD1])
            assert idx.lookup([404]) == {404: [m.POD1]}
        finally:
            server.close()


class TestEvictionAtomicity:
    def test_add_racing_into_prune_window_survives(self, m):
        """Deterministic interleave of the historical lost-add race:

        evictor:  HDEL last field          (hash now empty)
        adder:            HSET pod2 + SET engine   <- lands in the window
        evictor:  prune script             (must NOT delete the new add)
        """
        server = MiniRespServer()
        try:
            evictor = m.RespClient("127.0.0.1", server.port)
            adder = m.RespClient("127.0.0.1", server.port)
            rk, ek = "9001", f"{m._ENGINE_PREFIX}77"

            adder.execute("HSET", rk, "pod-1@hbm", "1")
            adder.execute("SET", ek, rk)

            evictor.execute("HDEL", rk, "pod-1@hbm")
            adder.pipeline(
                [("HSET", rk, "pod-2@hbm", "1"), ("SET", ek, rk)]
            )
            result = evictor.execute("EVAL", m._PRUNE_SCRIPT, "2", rk, ek)

            assert result == 0  # hash non-empty: nothing pruned
            assert adder.execute("HKEYS", rk) == [b"pod-2@hbm"]
            assert adder.execute("GET", ek) == rk.encode()
        finally:
            server.close()

    def test_prune_after_true_emptiness(self, m):
        server = MiniRespServer()
        try:
            idx = m.RedisIndex(
                m.RedisIndexConfig(address=f"redis://{server.address}")
            )
            idx.add([7], [707], [m.POD1])
            idx.evict(7, [m.POD1])
            assert idx.lookup([707]) == {}
            with pytest.raises(KeyError):
                idx.get_request_key(7)
        finally:
            server.close()

    def test_concurrent_add_evict_stress_no_lost_adds(self, m):
        server = MiniRespServer()
        try:
            idx_a = m.RedisIndex(
                m.RedisIndexConfig(address=f"redis://{server.address}")
            )
            idx_b = m.RedisIndex(
                m.RedisIndexConfig(address=f"redis://{server.address}")
            )
            stop = threading.Event()
            errors = []

            def evictor():
                while not stop.is_set():
                    try:
                        idx_b.evict(11, [m.POD1, m.POD2])
                    except Exception as e:  # noqa: BLE001
                        errors.append(e)
                        return

            thread = threading.Thread(target=evictor)
            thread.start()
            try:
                for _ in range(300):
                    idx_a.add([11], [1111], [m.POD1])
            finally:
                stop.set()
                thread.join(timeout=10)
            assert not errors
            # The last operation was an add: the entry must exist no
            # matter how evictions interleaved.
            idx_a.add([11], [1111], [m.POD1])
            assert idx_a.lookup([1111]) == {1111: [m.POD1]}
            assert idx_a.get_request_key(11) == 1111
        finally:
            server.close()
