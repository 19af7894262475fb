"""Distributed index backed by Redis / Valkey.

Capability parity with the reference's Redis backend
(pkg/kvcache/kvblock/redis.go): the shared schema is

* ``<request_key>``          -> Redis hash; fields are ``"pod@tier"``
* ``engine:<engine_key>``    -> string holding the request key

Lookups pipeline one ``HKEYS`` per block key in a single round trip; adds
pipeline ``HSET`` + ``SET``; evictions remove fields and atomically prune
the engine mapping with a server-side Lua script (reference:
redis.go:147-154).  Valkey endpoints (``valkey://``/``valkeys://``) speak
the same protocol and are accepted; URLs may carry credentials (AUTH on
connect), a ``/db`` index (SELECT), TLS (``rediss://``), or a ``unix://``
socket path.

The image ships no redis-py, so this module carries a deliberately small
RESP2 client (sockets + pipelining) — the indexer needs only a handful of
commands (HSET/HKEYS/HDEL/SET/GET/DEL plus EVAL, AUTH, SELECT).

Copied from the JAX reference's ``kvcache/kvblock/redis_index.py``.
"""

from __future__ import annotations

import socket
import ssl
import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple
from urllib.parse import unquote, urlparse

from llm_d_kv_cache_manager_tpu_torch.kvcache.kvblock.index import (
    Index,
    PodEntry,
    RedisIndexConfig,
)


class RespError(RuntimeError):
    """A server-side error reply (``-ERR ...``)."""


@dataclass
class RedisEndpoint:
    """A parsed redis/valkey URL (scheme-normalized, credential-aware)."""

    host: str = "127.0.0.1"
    port: int = 6379
    unix_path: Optional[str] = None
    username: Optional[str] = None
    password: Optional[str] = None
    db: int = 0
    tls: bool = False


class RespClient:
    """Minimal RESP2 client with pipelining and transparent reconnect.

    The connection handshake (TLS, AUTH, SELECT) lives in ``_connect`` so
    it is replayed automatically when the transport reconnects.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 6379,
        timeout: float = 5.0,
        endpoint: Optional[RedisEndpoint] = None,
        ssl_context: Optional[ssl.SSLContext] = None,
    ) -> None:
        self._endpoint = endpoint or RedisEndpoint(host=host, port=port)
        self._timeout = timeout
        self._ssl_context = ssl_context
        if self._endpoint.tls and ssl_context is None:
            self._ssl_context = ssl.create_default_context()
        self._sock = None
        self._reader = None
        self._lock = threading.Lock()
        self._connect()

    def _connect(self) -> None:
        ep = self._endpoint
        if ep.unix_path is not None:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(self._timeout)
            sock.connect(ep.unix_path)
        else:
            sock = socket.create_connection(
                (ep.host, ep.port), timeout=self._timeout
            )
            # Small request/reply packets: Nagle + delayed ACK otherwise
            # adds ~40ms stalls per pipelined round trip.
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._ssl_context is not None:
                sock = self._ssl_context.wrap_socket(
                    sock, server_hostname=ep.host
                )
        # gil-atomic: connect/close are single-owner (caller-serialized)
        self._sock = sock
        # gil-atomic: connect/close are single-owner (caller-serialized)
        self._reader = sock.makefile("rb")
        self._handshake()

    def _handshake(self) -> None:
        """AUTH + SELECT on the fresh connection (reference accepts
        credentialed URLs via go-redis ParseURL, redis.go:61-119)."""
        ep = self._endpoint
        commands: List[Sequence] = []
        # Empty password means "no AUTH" (go-redis ParseURL parity).
        if ep.password:
            if ep.username:
                commands.append(("AUTH", ep.username, ep.password))
            else:
                commands.append(("AUTH", ep.password))
        if ep.db:
            commands.append(("SELECT", str(ep.db)))
        if not commands:
            return
        payload = b"".join(self._encode(c) for c in commands)
        self._sock.sendall(payload)
        for _ in commands:
            reply = self._read_reply()
            if isinstance(reply, RespError):
                self.close()
                raise reply

    def close(self) -> None:
        if self._reader is not None:
            try:
                self._reader.close()
            except OSError:
                pass
            # gil-atomic: connect/close are single-owner (caller-serialized)
            self._reader = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            # gil-atomic: connect/close are single-owner (caller-serialized)
            self._sock = None

    @staticmethod
    def _encode(command: Sequence) -> bytes:
        parts = [b"*%d\r\n" % len(command)]
        for arg in command:
            if isinstance(arg, str):
                arg = arg.encode()
            elif isinstance(arg, int):
                arg = str(arg).encode()
            parts.append(b"$%d\r\n%s\r\n" % (len(arg), arg))
        return b"".join(parts)

    # Caps on attacker/misconfiguration-controlled sizes (e.g. the URL
    # points at an HTTP port, or a proxy garbles the stream): redis's own
    # proto-max-bulk-len default, and an array bound far above any reply
    # the index issues.
    _MAX_BULK = 512 * 1024 * 1024
    _MAX_ARRAY = 1 << 22
    _MAX_DEPTH = 32
    # Type-line bound: real RESP lines are tiny (a type byte + an
    # integer or a short status).  Without a limit, readline() on a
    # newline-free hostile stream buffers it whole before any other cap
    # is consulted.
    _MAX_LINE = 64 * 1024

    def _read_reply(self, depth: int = 0):
        """Read one reply; server error replies are *returned* as RespError
        instances (not raised) so a pipeline never desyncs the stream.

        Any malformed frame raises ConnectionError — not ValueError /
        UnicodeDecodeError / RecursionError — because a garbled stream
        means the connection is unusable: _round_trip_locked must tear
        it down and reconnect rather than keep pipelining on a desynced
        socket."""
        if depth > self._MAX_DEPTH:
            raise ConnectionError("RESP reply nested too deeply")
        line = self._reader.readline(self._MAX_LINE)
        if not line:
            raise ConnectionError("connection closed by server")
        if not line.endswith(b"\r\n"):
            # Truncated stream, or a line at the limit with no newline.
            raise ConnectionError(f"malformed RESP line: {line[:64]!r}")
        kind, payload = line[:1], line[1:-2]
        if kind == b"+":
            return payload.decode("utf-8", "replace")
        if kind == b"-":
            return RespError(payload.decode("utf-8", "replace"))
        if kind == b":":
            return self._parse_int(payload)
        if kind == b"$":
            length = self._parse_int(payload)
            if length == -1:
                return None
            if not 0 <= length <= self._MAX_BULK:
                raise ConnectionError(f"bad RESP bulk length {length}")
            data = self._reader.read(length + 2)
            if len(data) != length + 2:
                raise ConnectionError("short read from server")
            if data[-2:] != b"\r\n":
                # Wrong-length garbled frame: without this check the
                # stripped payload would be returned as a *successful*
                # reply and the stream left desynced.
                raise ConnectionError("bulk reply missing terminator")
            return data[:-2]
        if kind == b"*":
            count = self._parse_int(payload)
            if count == -1:
                return None
            if not 0 <= count <= self._MAX_ARRAY:
                raise ConnectionError(f"bad RESP array length {count}")
            return [self._read_reply(depth + 1) for _ in range(count)]
        raise ConnectionError(f"unknown RESP type: {kind!r}")

    @staticmethod
    def _parse_int(payload: bytes) -> int:
        # RESP grammar, not Python's int() (which accepts underscores,
        # whitespace, and '+': a corrupted b"1_0" must not parse as 10).
        digits = payload[1:] if payload[:1] == b"-" else payload
        if not digits or not digits.isdigit():
            raise ConnectionError(
                f"malformed RESP integer: {payload[:64]!r}"
            )
        return int(payload)

    def execute(self, *command):
        return self.pipeline([command])[0]

    def pipeline(
        self, commands: Iterable[Sequence], raise_on_error: bool = True
    ) -> List:
        """Send all commands, read all replies; raise the first server error
        only after the stream is fully drained.  On transport errors the
        connection is torn down and retried once on a fresh socket.
        ``raise_on_error=False`` returns ``RespError`` instances in place
        so callers can tolerate per-key failures (e.g. WRONGTYPE from
        foreign keys in a shared database)."""
        commands = list(commands)
        if not commands:
            return []
        payload = b"".join(self._encode(c) for c in commands)
        with self._lock:
            replies = self._round_trip_locked(payload, len(commands))
        if raise_on_error:
            for reply in replies:
                if isinstance(reply, RespError):
                    raise reply
        return replies

    def _round_trip_locked(self, payload: bytes, count: int) -> List:
        for attempt in (0, 1):
            try:
                if self._sock is None:
                    self._connect()
                self._sock.sendall(payload)
                return [self._read_reply() for _ in range(count)]
            except (OSError, ConnectionError):
                self.close()
                if attempt == 1:
                    raise
        raise AssertionError("unreachable")


def parse_redis_url(address: str) -> RedisEndpoint:
    """Parse a redis/valkey URL into a :class:`RedisEndpoint`.

    Mirrors the reference's normalization (redis.go:72-90): bare
    ``host:port`` defaults to ``redis://``; ``valkey://`` is rewritten to
    ``redis://`` and ``valkeys://`` to ``rediss://`` (TLS); ``unix://``
    selects a Unix-domain socket.  Credentials (``user:pass@``) and a
    trailing ``/db`` index are honored like go-redis ``ParseURL``.
    """
    address = address.strip()
    if "://" not in address:
        address = "redis://" + address
    if address.startswith("valkey://"):
        address = "redis://" + address[len("valkey://"):]
    elif address.startswith("valkeys://"):
        address = "rediss://" + address[len("valkeys://"):]

    parsed = urlparse(address)
    if parsed.scheme not in ("redis", "rediss", "unix"):
        raise ValueError(f"unsupported redis URL scheme: {parsed.scheme!r}")

    endpoint = RedisEndpoint(tls=parsed.scheme == "rediss")
    if parsed.username:
        endpoint.username = unquote(parsed.username)
    if parsed.password is not None:
        endpoint.password = unquote(parsed.password)

    # go-redis parity: ?db=N (the only way to select a db on a unix
    # socket); any other query key is rejected loudly rather than
    # silently ignored.
    if parsed.query:
        for pair in parsed.query.split("&"):
            key, _, raw = pair.partition("=")
            if key == "db":
                try:
                    endpoint.db = int(raw)
                except ValueError as e:
                    raise ValueError(
                        f"invalid db index in redis URL query: {raw!r}"
                    ) from e
            else:
                raise ValueError(
                    f"unsupported redis URL query parameter: {key!r}"
                )

    if parsed.scheme == "unix":
        if parsed.hostname:
            raise ValueError(
                "unix:// URL must use three slashes (unix:///path/to.sock)"
                f"; got authority {parsed.hostname!r}"
            )
        if not parsed.path:
            raise ValueError("unix:// URL must carry a socket path")
        endpoint.unix_path = parsed.path
        return endpoint

    endpoint.host = parsed.hostname or "127.0.0.1"
    endpoint.port = parsed.port or 6379
    db_path = parsed.path.lstrip("/")
    if db_path:
        try:
            endpoint.db = int(db_path)
        except ValueError as e:
            raise ValueError(
                f"invalid database index in redis URL: {db_path!r}"
            ) from e
    return endpoint


_ENGINE_PREFIX = "engine:"


# Atomic prune, byte-identical semantics to the reference's Lua script
# (redis.go:147-154): only if the request hash is empty (Redis removes
# hashes whose last field was HDELed) delete the engine->request mapping.
# Running HLEN + DEL server-side in one script closes the race where a
# concurrent add lands between the two and is then deleted wholesale.
_PRUNE_SCRIPT = (
    "local hashLen = redis.call('HLEN', KEYS[1])\n"
    "if hashLen == 0 then\n"
    "    redis.call('DEL', KEYS[2])\n"
    "    return 1\n"
    "end\n"
    "return 0"
)


class RedisIndex(Index):
    # The server outlives the indexer process and is shared by every
    # replica: startup recovery must never pipeline a possibly-stale
    # file snapshot back over fresher server state (persistence's
    # recover() gates on this; docs/persistence.md §6).  Explicit
    # dump/restore calls (parity tests, follower bootstrap, operator
    # backups) remain available.
    durable_backend = True

    def __init__(
        self,
        config: Optional[RedisIndexConfig] = None,
        client: Optional[RespClient] = None,
    ) -> None:
        self.config = config or RedisIndexConfig()
        if client is None:
            endpoint = parse_redis_url(self.config.address)
            ssl_context = None
            if endpoint.tls:
                ssl_context = ssl.create_default_context(
                    cafile=self.config.tls_ca_file
                )
                if self.config.tls_insecure_skip_verify:
                    ssl_context.check_hostname = False
                    ssl_context.verify_mode = ssl.CERT_NONE
            client = RespClient(
                endpoint=endpoint, ssl_context=ssl_context
            )
        self._client = client

    @staticmethod
    def _field(entry: PodEntry) -> str:
        return f"{entry.pod_identifier}@{entry.device_tier}"

    @staticmethod
    def _parse_field(field: bytes) -> Optional[PodEntry]:
        text = field.decode()
        pod, sep, tier = text.rpartition("@")
        if not sep:
            return None
        return PodEntry(pod_identifier=pod, device_tier=tier)

    def lookup(
        self,
        request_keys: Sequence[int],
        pod_identifier_set: Optional[Set[str]] = None,
    ) -> Dict[int, List[PodEntry]]:
        if not request_keys:
            raise ValueError("no request keys provided for lookup")
        replies = self._client.pipeline(
            [("HKEYS", str(key)) for key in request_keys]
        )
        result: Dict[int, List[PodEntry]] = {}
        for key, fields in zip(request_keys, replies):
            if not fields:
                continue
            pods = []
            for field in fields:
                entry = self._parse_field(field)
                if entry is None:
                    continue
                if (
                    pod_identifier_set
                    and entry.pod_identifier not in pod_identifier_set
                ):
                    continue
                pods.append(entry)
            if pods:
                result[key] = pods
        return result

    def lookup_chain(
        self, request_keys: Sequence[int]
    ) -> List[Sequence[PodEntry]]:
        """Aligned per-key pod entries for the fast-lane scoring walk:
        ONE pipelined round trip of HKEYS for the whole chunk (the
        default adapter would pay the same trip via :meth:`lookup` but
        build a dict to tear down again), truncated at the first key
        with no resident pods."""
        if not request_keys:
            return []
        replies = self._client.pipeline(
            [("HKEYS", str(key)) for key in request_keys]
        )
        out: List[Sequence[PodEntry]] = []
        for fields in replies:
            pods = []
            if fields:
                for field in fields:
                    entry = self._parse_field(field)
                    if entry is not None:
                        pods.append(entry)
            if not pods:
                break
            out.append(pods)
        return out

    def add(
        self,
        engine_keys: Sequence[int],
        request_keys: Sequence[int],
        entries: Sequence[PodEntry],
    ) -> None:
        if not engine_keys or not request_keys or not entries:
            raise ValueError("no keys or entries provided for add")
        if len(engine_keys) != len(request_keys):
            raise ValueError("engine/request key length mismatch")
        commands: List[Sequence] = []
        for engine_key, request_key in zip(engine_keys, request_keys):
            hset: List = ["HSET", str(request_key)]
            for entry in entries:
                hset += [self._field(entry), "1"]
            commands.append(hset)
            commands.append(
                ("SET", f"{_ENGINE_PREFIX}{engine_key}", str(request_key))
            )
        self._client.pipeline(commands)

    def add_mappings(
        self, engine_keys: Sequence[int], request_keys: Sequence[int]
    ) -> None:
        """Publish engine->request mappings (one pipelined round trip)
        — the eager half of the kvevents batched-apply surface."""
        if not engine_keys:
            return
        self._client.pipeline(
            [
                ("SET", f"{_ENGINE_PREFIX}{ek}", str(rk))
                for ek, rk in zip(engine_keys, request_keys)
            ]
        )

    def add_entries_batch(
        self,
        items: Sequence[Tuple[Sequence[int], Sequence[PodEntry]]],
    ) -> None:
        """Admit ``(request_keys, entries)`` groups in ONE pipelined
        round trip (the deferred half of the batched-apply surface;
        mappings travel separately via :meth:`add_mappings`)."""
        commands: List[Sequence] = []
        for request_keys, entries in items:
            if not entries:
                continue
            fields: List = []
            for entry in entries:
                fields += [self._field(entry), "1"]
            for request_key in request_keys:
                commands.append(["HSET", str(request_key)] + fields)
        if commands:
            self._client.pipeline(commands)

    def evict(self, engine_key: int, entries: Sequence[PodEntry]) -> None:
        if not entries:
            raise ValueError("no entries provided for eviction")
        request_key_raw = self._client.execute(
            "GET", f"{_ENGINE_PREFIX}{engine_key}"
        )
        if request_key_raw is None:
            return
        request_key = request_key_raw.decode()
        hdel: List = ["HDEL", request_key]
        hdel += [self._field(entry) for entry in entries]
        # HDEL of the last field removes the hash itself server-side; the
        # Lua prune then atomically deletes the engine->request mapping
        # only if the hash is still empty, so an add racing in between is
        # never lost.
        self._client.pipeline(
            [
                hdel,
                (
                    "EVAL",
                    _PRUNE_SCRIPT,
                    "2",
                    request_key,
                    f"{_ENGINE_PREFIX}{engine_key}",
                ),
            ]
        )

    def get_request_key(self, engine_key: int) -> int:
        raw = self._client.execute("GET", f"{_ENGINE_PREFIX}{engine_key}")
        if raw is None:
            raise KeyError(f"engine key not found: {engine_key:#x}")
        return int(raw.decode())

    def dump_entries(
        self,
    ) -> Tuple[List[Tuple[int, List[PodEntry]]], List[Tuple[int, int]]]:
        """SCAN-walk the full schema into the standard dump shape.

        This replaced the long-documented no-op when the backend was
        promoted to replica duty (docs/replication.md): a shared-tier
        replica must answer the same dump/restore contract as the
        in-process backends so cluster parity tests, follower
        bootstrap, and the index-truth auditor see one surface.  The
        order is server iteration order — Redis tracks no recency, so
        a capacity-bounded restore into an LRU backend treats the dump
        as equally-recent (documented divergence from the LRU-first
        ordering of in-process dumps).  Foreign keys in a shared
        database (non-numeric names, wrong types) are skipped, never
        fatal.

        NOTE for persistence: snapshotting a durable server through
        the file layer yields a second copy that can go stale; prefer
        pointing recovery at the server itself (restore is idempotent
        either way — see docs/persistence.md).
        """
        block_entries: List[Tuple[int, List[PodEntry]]] = []
        engine_map: List[Tuple[int, int]] = []
        cursor = b"0"
        while True:
            reply = self._client.execute(
                "SCAN", cursor.decode(), "COUNT", "512"
            )
            cursor, keys = reply[0], reply[1]
            hash_keys: List[int] = []
            engine_keys: List[int] = []
            for key in keys:
                text = key.decode("utf-8", "replace")
                if text.startswith(_ENGINE_PREFIX):
                    try:
                        engine_keys.append(
                            int(text[len(_ENGINE_PREFIX):])
                        )
                    except ValueError:
                        continue  # foreign engine:* key
                else:
                    try:
                        hash_keys.append(int(text))
                    except ValueError:
                        continue  # foreign key
            if hash_keys:
                field_lists = self._client.pipeline(
                    [("HKEYS", str(key)) for key in hash_keys],
                    raise_on_error=False,
                )
                for key, fields in zip(hash_keys, field_lists):
                    if isinstance(fields, RespError) or not fields:
                        continue  # foreign type, or raced a removal
                    pods = []
                    for field in fields:
                        entry = self._parse_field(field)
                        if entry is not None:
                            pods.append(entry)
                    if pods:
                        block_entries.append((key, pods))
            if engine_keys:
                values = self._client.pipeline(
                    [
                        ("GET", f"{_ENGINE_PREFIX}{key}")
                        for key in engine_keys
                    ],
                    raise_on_error=False,
                )
                for engine_key, raw in zip(engine_keys, values):
                    if isinstance(raw, RespError) or raw is None:
                        continue
                    try:
                        engine_map.append((engine_key, int(raw)))
                    except ValueError:
                        continue  # foreign value
            if cursor == b"0":
                return block_entries, engine_map

    def restore_entries(self, block_entries, engine_map) -> int:
        """Pipelined re-admission of a dump (idempotent: HSET/SET of
        existing state is a no-op server-side); returns block keys
        carrying entries.  No capacity bound applies — the server's
        own maxmemory policy governs."""
        commands: List[Sequence] = []
        restored = 0
        for request_key, entries in block_entries:
            if not entries:
                continue
            hset: List = ["HSET", str(request_key)]
            for entry in entries:
                hset += [self._field(entry), "1"]
            commands.append(hset)
            restored += 1
        for engine_key, request_key in engine_map:
            commands.append(
                ("SET", f"{_ENGINE_PREFIX}{engine_key}", str(request_key))
            )
        if commands:
            self._client.pipeline(commands)
        return restored

    def purge_pod(self, pod_identifier: str) -> int:
        """SCAN-walk the request hashes, HDEL the pod's fields.

        Cursor iteration keeps the server responsive (no KEYS); real
        Redis auto-removes hashes whose last field is deleted, so
        emptied keys cannot break other pods' prefix chains.  Shared
        databases may hold foreign non-hash keys — their WRONGTYPE
        replies are tolerated per key, never fatal to the purge.
        """
        prefix = f"{pod_identifier}@".encode()
        removed = 0
        cursor = b"0"
        while True:
            reply = self._client.execute(
                "SCAN", cursor.decode(), "COUNT", "512"
            )
            cursor, keys = reply[0], reply[1]
            hash_keys = [
                key
                for key in keys
                if not key.startswith(_ENGINE_PREFIX.encode())
            ]
            if hash_keys:
                field_lists = self._client.pipeline(
                    [("HKEYS", key.decode()) for key in hash_keys],
                    raise_on_error=False,
                )
                hdels = []
                for key, fields in zip(hash_keys, field_lists):
                    if isinstance(fields, RespError):
                        continue  # foreign key of another type
                    victims = [
                        f for f in fields if f.startswith(prefix)
                    ]
                    if victims:
                        removed += len(victims)
                        hdels.append(
                            ["HDEL", key.decode()]
                            + [f.decode() for f in victims]
                        )
                if hdels:
                    self._client.pipeline(hdels)
            if cursor == b"0":
                return removed
