"""A loopback ``POST /replica`` server for the cluster tests.

Each package serves a replica's wire endpoint from its HTTP service
(``api/http_service.py``).  This stdlib ``http.server`` is the transport's
counterpart without the service, so the transport's cases test it alone:
each request body goes to
``replica.handle_wire`` and its bytes come back as the response, so an
``HttpReplicaTransport`` talks to a real socket on 127.0.0.1.
"""

from __future__ import annotations

import http.server
import threading
from typing import Optional


class _ReplicaHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_POST(self) -> None:  # noqa: N802 - http.server's name
        server = self.server
        length = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(length)
        token = server.token  # type: ignore[attr-defined]
        if self.path != "/replica":
            status, out = 404, b""
        elif token and self.headers.get("Authorization") != f"Bearer {token}":
            status, out = 403, b""
        else:
            status = 200
            out = server.replica.handle_wire(body)  # type: ignore[attr-defined]
        self.send_response(status)
        self.send_header("Content-Type", "application/cbor")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, format, *args) -> None:  # noqa: A002 - quiet
        return None


class ReplicaHttpServer:
    """Serves ``replica`` on ``127.0.0.1`` at a free port until closed."""

    def __init__(self, replica, token: Optional[str] = None) -> None:
        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _ReplicaHandler)
        self._server.daemon_threads = True
        self._server.replica = replica  # type: ignore[attr-defined]
        self._server.token = token  # type: ignore[attr-defined]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
