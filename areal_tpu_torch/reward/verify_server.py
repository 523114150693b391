"""Standalone verification service, the server half of
`reward/remote_verify.py` (counterpart of `areal_tpu/reward/verify_server.py`).

Run ``python -m areal_tpu_torch.reward.verify_server --port 8841`` on any
CPU host and point trainers at it with ``AREAL_VERIFIER_SERVICE=host:8841``:
math (sympy) and code (sandboxed subprocess testcases) grading then runs
off the trainer's host. It is an `http.server.ThreadingHTTPServer`, as
the decode server is, with grading bounded by `max_workers` threads.

Endpoints:
  GET  /health  -> {"status": "ok"}
  POST /verify  {"uid", "language": "MATH" | "CODE", "payload": ...}
                -> {"uid", "results": [0/1, ...]}

An unknown language answers 400, a grader that raises 500 with its
`repr`, and a body above 64 MiB (the JAX server's `client_max_size`) 413.
"""

from __future__ import annotations

import argparse
import json
import socket
import socketserver
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from areal_tpu_torch.utils import logging

logger = logging.getLogger("verify_server")

MAX_BODY_BYTES = 64 * 1024**2
_DRAIN_CHUNK = 1 << 20


class VerifyServer:
    def __init__(self, max_workers: int = 8):
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._httpd: _Server | None = None
        self._thread: threading.Thread | None = None
        self.addr: str | None = None

    def verify(self, body: dict) -> tuple[int, dict]:
        """(status, answer) of one POST /verify body; the grading runs on
        the server's pool."""
        from areal_tpu_torch.reward.remote_verify import grade_code_batch, grade_math_batch

        lang = str(body.get("language", "")).upper()
        payload = body.get("payload") or {}
        try:
            if lang == "MATH":
                results = self._pool.submit(
                    grade_math_batch, payload["answers"], payload["solutions"]).result()
            elif lang == "CODE":
                results = self._pool.submit(grade_code_batch, payload["items"]).result()
            else:
                return 400, {"status": "error", "message": f"unknown language {lang}"}
        except Exception as e:  # noqa: BLE001 — report, keep serving
            return 500, {"status": "error", "message": repr(e)}
        return 200, {"uid": body.get("uid"), "results": results}

    def start(self, host: str = "0.0.0.0", port: int = 0) -> str:
        """Listen on `host:port` (0: any free port); returns the address
        clients reach it at."""
        app = self

        class Handler(_Handler):
            server_app = app

        self._httpd = _Server((host, port), Handler)
        actual_port = self._httpd.server_address[1]
        ip = "127.0.0.1" if host in ("0.0.0.0", "::", "") else host
        self.addr = f"{ip}:{actual_port}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs=dict(poll_interval=0.2), daemon=True,
            name="verify-server-http",
        )
        self._thread.start()
        logger.info(f"verify server on {self.addr}")
        return self.addr

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            # a kept-alive connection's handler would go on serving it
            self._httpd.close_connections()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self._pool.shutdown(wait=False)


class _Server(ThreadingHTTPServer):
    """Keeps its open connections, so that `close_connections` can end
    them when the service stops."""

    daemon_threads = True

    def __init__(self, *args, **kwargs):
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def server_bind(self) -> None:
        # HTTPServer.server_bind looks the bound address up in the
        # resolver (socket.getfqdn); the name is not needed
        socketserver.TCPServer.server_bind(self)
        self.server_name, self.server_port = self.server_address[:2]

    def process_request(self, request, client_address) -> None:
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request) -> None:
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def handle_error(self, request, client_address) -> None:
        # a connection that `close_connections` ended mid-request
        logger.debug(f"request from {client_address} ended:\n{traceback.format_exc()}")

    def close_connections(self) -> None:
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already closed by the client


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_app: VerifyServer

    def log_message(self, format: str, *args) -> None:
        logger.debug(format % args)

    def _reply(self, status: int, out: dict) -> None:
        data = json.dumps(out).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:
        if self.path.split("?")[0] == "/health":
            self._reply(200, {"status": "ok"})
        else:
            self._reply(404, {"status": "error", "message": f"no route {self.path}"})

    def do_POST(self) -> None:
        n = int(self.headers.get("Content-Length") or 0)
        if self.path.split("?")[0] != "/verify":
            self._drain(n)
            self._reply(404, {"status": "error", "message": f"no route {self.path}"})
            return
        if n > MAX_BODY_BYTES:
            # read the body away so the client sees the answer, not a reset
            self._drain(n)
            self.close_connection = True
            self._reply(413, {"status": "error",
                              "message": f"body of {n} bytes above {MAX_BODY_BYTES}"})
            return
        try:
            body = json.loads(self.rfile.read(n))
            if not isinstance(body, dict):
                raise ValueError(f"a JSON object is expected, got {type(body).__name__}")
        except Exception as e:  # noqa: BLE001 — a malformed body
            self._reply(500, {"status": "error", "message": repr(e)})
            return
        self._reply(*self.server_app.verify(body))

    def _drain(self, n: int) -> None:
        while n > 0:
            k = len(self.rfile.read(min(n, _DRAIN_CHUNK)))
            if not k:
                return
            n -= k


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="areal_tpu_torch verification service")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8841)
    p.add_argument("--max-workers", type=int, default=8)
    args = p.parse_args(argv)
    srv = VerifyServer(max_workers=args.max_workers)
    srv.start(args.host, args.port)
    try:
        threading.Event().wait()
    finally:
        srv.stop()


if __name__ == "__main__":
    main()
