"""HTTP helpers of the rollout control plane (counterpart of
`areal_tpu/utils/http.py`), on the standard library: the card machine
has no `aiohttp`.

- `request_with_retry` sends one JSON (or raw binary) request over a
  pooled keep-alive `http.client` connection and keeps the JAX version's
  rules: connection errors, 5xx and torn 2xx bodies (unparseable JSON)
  are retried with `backoff_delays`; a 4xx raises at once with the parsed
  error body on `HttpRequestError.body`.
- `arequest_with_retry` runs it on a daemon thread of its own and awaits
  the result, so a coroutine never blocks its event loop and any number
  of requests can be outstanding (a thread pool would cap them).
- A binary body may be a list of buffers (a weight frame's header and
  its tensors' byte views): the parts go to the socket one by one under
  one Content-Length, never joined into a copy.
- An idle pooled connection the server has since closed fails before any
  response arrives; such a request is sent once more on a new connection
  without counting as a retry.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import random
import threading
import time
from typing import Any

DEFAULT_RETRIES = 3
DEFAULT_REQUEST_TIMEOUT = 3600.0

# idle keep-alive connections per server address
_idle: dict[str, list[http.client.HTTPConnection]] = {}
_idle_lock = threading.Lock()


class HttpRequestError(Exception):
    def __init__(self, message: str, status: int | None = None,
                 body: dict[str, Any] | None = None):
        super().__init__(message)
        self.status = status
        # the parsed JSON error payload, when the server sent one
        self.body = body or {}


def _parse_json_body(text: str) -> dict[str, Any]:
    try:
        out = json.loads(text)
    except (ValueError, TypeError):
        return {}
    return out if isinstance(out, dict) else {}


def backoff_delays(base: float, retries: int, jitter: float = 0.25, cap: float = 60.0):
    """Jittered exponential backoff: base * 2^k, scaled by a uniform draw
    from [1 - jitter, 1 + jitter], capped."""
    for attempt in range(retries):
        d = min(base * (2**attempt), cap)
        if jitter > 0.0:
            d *= 1.0 + random.uniform(-jitter, jitter)
        yield max(d, 0.0)


def _new_conn(addr: str, timeout: float) -> http.client.HTTPConnection:
    host, port = addr.rsplit(":", 1)
    return http.client.HTTPConnection(host, int(port), timeout=timeout)


def _take(addr: str, timeout: float) -> tuple[http.client.HTTPConnection, bool]:
    """A pooled idle connection to `addr` (reused=True) or a new one."""
    with _idle_lock:
        pool = _idle.get(addr)
        conn = pool.pop() if pool else None
    if conn is None:
        return _new_conn(addr, timeout), False
    conn.timeout = timeout
    if conn.sock is not None:
        conn.sock.settimeout(timeout)
    return conn, True


def _give_back(addr: str, conn: http.client.HTTPConnection) -> None:
    with _idle_lock:
        _idle.setdefault(addr, []).append(conn)


def _body_of(payload, data, method: str) -> tuple[Any, dict[str, str]]:
    if data is not None:
        parts = data if isinstance(data, (list, tuple)) else [data]
        n = sum(memoryview(p).nbytes for p in parts)
        return list(parts), {"Content-Type": "application/octet-stream",
                             "Content-Length": str(n)}
    if method == "GET" or payload is None:
        return None, {"Content-Length": "0"} if method != "GET" else {}
    body = json.dumps(payload).encode()
    return body, {"Content-Type": "application/json", "Content-Length": str(len(body))}


def _send_once(addr: str, endpoint: str, method: str, body, headers: dict,
               timeout: float) -> tuple[int, str]:
    """One exchange; (status, response text). A pooled connection that
    fails before a response arrives is replaced once."""
    conn, reused = _take(addr, timeout)
    try:
        try:
            conn.request(method, endpoint, body=body, headers=headers)
            resp = conn.getresponse()
        except (ConnectionError, http.client.BadStatusLine):
            if not reused:
                raise
            # the server closed the idle connection: a fresh one, once
            conn.close()
            conn = _new_conn(addr, timeout)
            conn.request(method, endpoint, body=body, headers=headers)
            resp = conn.getresponse()
        text = resp.read().decode(errors="replace")
    except BaseException:
        conn.close()
        raise
    if resp.will_close:
        conn.close()
    else:
        _give_back(addr, conn)
    return resp.status, text


def request_with_retry(
    addr: str,
    endpoint: str,
    payload: dict[str, Any] | None = None,
    method: str = "POST",
    max_retries: int = DEFAULT_RETRIES,
    timeout: float = DEFAULT_REQUEST_TIMEOUT,
    retry_delay: float = 1.0,
    data: Any = None,
) -> dict[str, Any]:
    """`method` `http://{addr}{endpoint}` and return the parsed JSON reply
    (blocking). `data` sends a raw binary body (bytes, or a list of
    buffers sent in order) instead of JSON."""
    url = f"http://{addr}{endpoint}"
    body, headers = _body_of(payload, data, method)
    delays = backoff_delays(retry_delay, max_retries)
    last_exc: Exception | None = None
    for attempt in range(max_retries):
        try:
            status, text = _send_once(addr, endpoint, method, body, headers, timeout)
            if status >= 400:
                raise HttpRequestError(f"{url} -> {status}: {text}", status=status,
                                       body=_parse_json_body(text))
            try:
                return json.loads(text)
            except ValueError as e:
                # torn reply: the effect may have landed; the retry is
                # deduplicated by the server (xid, push id)
                raise HttpRequestError(
                    f"{url} -> torn response body ({len(text)} bytes): {e}"
                ) from e
        except (OSError, http.client.HTTPException, HttpRequestError) as e:
            if isinstance(e, HttpRequestError) and e.status is not None and e.status < 500:
                raise
            last_exc = e
            if attempt + 1 < max_retries:
                time.sleep(next(delays))
    raise HttpRequestError(f"request to {url} failed after {max_retries} retries") from last_exc


async def arequest_with_retry(addr: str, endpoint: str, **kwargs: Any) -> dict[str, Any]:
    """`request_with_retry` on a daemon thread, awaited."""
    loop = asyncio.get_running_loop()
    fut = loop.create_future()

    def _settle(ok: bool, value) -> None:
        if not fut.done():
            (fut.set_result if ok else fut.set_exception)(value)

    def _run() -> None:
        try:
            out, ok = request_with_retry(addr, endpoint, **kwargs), True
        except BaseException as e:  # noqa: BLE001 — handed to the awaiting task
            out, ok = e, False
        try:
            loop.call_soon_threadsafe(_settle, ok, out)
        except RuntimeError:
            pass  # the awaiting loop has closed: nobody reads the reply

    threading.Thread(target=_run, daemon=True, name="http-request").start()
    return await fut


async def wait_server_healthy(addr: str, timeout: float = 120.0, interval: float = 1.0) -> None:
    """Poll GET /health until it answers 200 or `timeout` elapses."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            await arequest_with_retry(addr, "/health", method="GET", max_retries=1, timeout=10)
            return
        except HttpRequestError:
            if time.monotonic() > deadline:
                raise TimeoutError(f"server {addr} not healthy after {timeout}s") from None
            await asyncio.sleep(interval)
