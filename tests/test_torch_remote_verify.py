"""The port's verification client and service against the JAX package's,
on the CPU, over the same wire protocol.

- Local grading (`grade_math_batch`, `grade_code_batch`, and the batch
  clients with no service set): equal results.
- The port's client against the port's `VerifyServer`; the JAX client
  (`aiohttp`) against the port's server; the port's client against the
  JAX `VerifyServer`: equal results, equal to local grading. Items go in
  payloads of 10.
- A dead address grades locally, with the same results.
- A server that answers a non-200 status (503, and 400 too) sees each
  payload 3 times from either client, then the call grades locally.
- The port's server answers 400 to an unknown language, 500 with the
  exception's repr when a grader raises, and 413 to a body above 64 MiB.

Every server binds port 0 on 127.0.0.1, and every request has a timeout.
"""

import asyncio
import http.client
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from areal_tpu.reward import remote_verify as jrv
from areal_tpu.reward.verify_server import VerifyServer as JServer
from areal_tpu_torch.reward import remote_verify as trv
from areal_tpu_torch.reward import verify_server as tvs

MATH_INFO = {
    "m1": dict(solutions=[r"\boxed{\frac{1}{2}}"]),
    "m2": dict(solutions=["4", "four"]),
    "m3": dict(answer="12"),
}
CODE_INFO = {
    "c1": dict(input_output=dict(inputs=["3 4\n"], outputs=["7\n"], fn_name="")),
    "c2": dict(input_output=dict(fn_name="add", inputs=[[1, 2]], outputs=[3])),
}
GOOD_CODE = "```python\na, b = map(int, input().split())\nprint(a + b)\n```"
BAD_CODE = "```python\nprint(0)\n```"
GOOD_FN = "```python\ndef add(a, b):\n    return a + b\n```"
# 12 math samples over three questions (m2 has two solutions: 16 pairs, 2
# payloads) and 12 code samples (2 payloads)
MATH_GENS = [r"so \boxed{0.5}", r"\boxed{3}", "the answer is 4", r"\boxed{12}"] * 3
MATH_QIDS = ["m1", "m1@idx:0", "m2", "m3@1"] * 3
CODE_GENS = [GOOD_CODE, BAD_CODE, GOOD_FN, "no code"] * 3
CODE_QIDS = ["c1", "c1@1", "c2", "c2@2"] * 3
WANT_MATH = [1, 0, 1, 1] * 3
WANT_CODE = [1, 0, 1, 0] * 3


@pytest.fixture
def no_service(monkeypatch):
    monkeypatch.delenv("AREAL_VERIFIER_SERVICE", raising=False)
    monkeypatch.delenv("FUNCTIONCALL_SERVICE_DOMAIN", raising=False)
    return monkeypatch


def _grade_all(mod):
    return (mod.batch_math_verify(MATH_INFO, MATH_GENS, MATH_QIDS),
            mod.batch_code_verify(CODE_INFO, CODE_GENS, CODE_QIDS))


def test_local_grading_equals_jax(no_service):
    assert _grade_all(trv) == _grade_all(jrv) == (WANT_MATH, WANT_CODE)
    assert trv.grade_math_batch([r"\boxed{2/4}", "x"], [r"\frac{1}{2}", "1"]) == [1, 0]
    assert jrv.grade_math_batch([r"\boxed{2/4}", "x"], [r"\frac{1}{2}", "1"]) == [1, 0]
    items = [dict(completion=GOOD_CODE, input_output=CODE_INFO["c1"]["input_output"]),
             dict(completion="none", input_output=CODE_INFO["c1"]["input_output"])]
    assert trv.grade_code_batch(items) == jrv.grade_code_batch(items) == [1, 0]


def test_service_addr_order(no_service):
    assert trv.service_addr() is None
    no_service.setenv("FUNCTIONCALL_SERVICE_DOMAIN", "h:2")
    assert trv.service_addr() == jrv.service_addr() == "h:2"
    no_service.setenv("AREAL_VERIFIER_SERVICE", "h:1")
    assert trv.service_addr() == jrv.service_addr() == "h:1"


class _Spy:
    """Counts the payloads a server's grading saw, by language."""

    def __init__(self, monkeypatch, mod):
        self.calls = {"MATH": 0, "CODE": 0}
        math, code = mod.grade_math_batch, mod.grade_code_batch

        def math_(answers, solutions):
            self.calls["MATH"] += 1
            assert len(answers) <= 10
            return math(answers, solutions)

        def code_(items):
            self.calls["CODE"] += 1
            assert len(items) <= 10
            return code(items)

        monkeypatch.setattr(mod, "grade_math_batch", math_)
        monkeypatch.setattr(mod, "grade_code_batch", code_)


@pytest.fixture
def port_server(no_service):
    spy = _Spy(no_service, trv)
    srv = tvs.VerifyServer(max_workers=2)
    addr = srv.start("127.0.0.1", 0)
    try:
        yield addr, spy
    finally:
        srv.stop()


@pytest.fixture
def jax_server(no_service):
    """The JAX `VerifyServer` on a private event loop thread."""
    spy = _Spy(no_service, jrv)
    srv = JServer(max_workers=2)
    loop = asyncio.new_event_loop()
    box = {}

    def run():
        asyncio.set_event_loop(loop)
        box["addr"] = loop.run_until_complete(srv.start("127.0.0.1", 0))
        loop.run_forever()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while "addr" not in box and time.monotonic() < deadline:
        time.sleep(0.05)
    assert "addr" in box, "the JAX verify server did not start"
    try:
        yield box["addr"], spy
    finally:
        asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(timeout=10)
        loop.call_soon_threadsafe(loop.stop)
        t.join(timeout=10)


@pytest.mark.parametrize("client", ["torch", "jax"])
def test_clients_against_the_port_server(client, port_server, monkeypatch):
    addr, spy = port_server
    monkeypatch.setenv("AREAL_VERIFIER_SERVICE", addr)
    assert _grade_all({"torch": trv, "jax": jrv}[client]) == (WANT_MATH, WANT_CODE)
    # 16 math pairs and 12 code items: payloads of 10
    assert spy.calls == {"MATH": 2, "CODE": 2}


def test_port_client_against_the_jax_server(jax_server, monkeypatch):
    addr, spy = jax_server
    monkeypatch.setenv("AREAL_VERIFIER_SERVICE", f"http://{addr}")
    assert _grade_all(trv) == (WANT_MATH, WANT_CODE)
    assert spy.calls == {"MATH": 2, "CODE": 2}


def test_dead_address_grades_locally(no_service):
    # nothing listens on port 1: three failed tries, then local grading
    no_service.setenv("AREAL_VERIFIER_SERVICE", "127.0.0.1:1")
    t0 = time.monotonic()
    assert _grade_all(trv) == (WANT_MATH, WANT_CODE)
    # each call: two waits of 0.2 and 0.4 s between its three tries
    assert time.monotonic() - t0 >= 2 * 0.6
    assert _grade_all(jrv) == (WANT_MATH, WANT_CODE)


class _Failing(ThreadingHTTPServer):
    daemon_threads = True


@pytest.mark.parametrize("status", [503, 400])
def test_non_200_is_retried_three_times_then_graded_locally(status, no_service):
    seen = []

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            seen.append(body["uid"])
            data = b'{"status": "error"}'
            self.send_response(status)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    srv = _Failing(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, kwargs=dict(poll_interval=0.05), daemon=True)
    t.start()
    try:
        no_service.setenv("AREAL_VERIFIER_SERVICE", f"127.0.0.1:{srv.server_address[1]}")
        counts = {}
        for name, mod in (("torch", trv), ("jax", jrv)):
            seen.clear()
            assert mod.batch_code_verify(CODE_INFO, CODE_GENS, CODE_QIDS) == WANT_CODE
            counts[name] = sorted(seen)
        # two payloads, each sent 3 times, by either client
        assert counts["torch"] == counts["jax"] == sorted(["code-0-10", "code-10-12"] * 3)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


def _post(addr: str, body: bytes, path: str = "/verify") -> tuple[int, dict]:
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request("POST", path, body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_server_answers(port_server):
    addr, _ = port_server
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    conn.request("GET", "/health")
    resp = conn.getresponse()
    assert (resp.status, json.loads(resp.read())) == (200, {"status": "ok"})
    conn.close()
    status, out = _post(addr, json.dumps({"uid": "u", "language": "math", "payload": {
        "answers": [r"\boxed{2/4}"], "solutions": ["0.5"]}}).encode())
    assert (status, out) == (200, {"uid": "u", "results": [1]})
    status, out = _post(addr, json.dumps({"uid": "u", "language": "LEAN"}).encode())
    assert status == 400 and out["message"] == "unknown language LEAN"
    # a payload without its items: the grader's KeyError, as its repr
    status, out = _post(addr, json.dumps({"uid": "u", "language": "CODE",
                                          "payload": {}}).encode())
    assert status == 500 and out["message"] == "KeyError('items')"


def test_body_above_64_mib_is_refused(port_server):
    addr, spy = port_server
    body = json.dumps({"uid": "big", "language": "MATH", "payload": {
        "answers": ["x" * (64 * 1024**2)], "solutions": ["1"]}}).encode()
    assert len(body) > tvs.MAX_BODY_BYTES
    status, out = _post(addr, body)
    assert status == 413 and "above" in out["message"]
    assert spy.calls == {"MATH": 0, "CODE": 0}
    # the server still serves
    status, out = _post(addr, json.dumps({"uid": "s", "language": "MATH", "payload": {
        "answers": ["x" * 1024], "solutions": ["1"]}}).encode())
    assert (status, out["results"]) == (200, [0])


def test_stop_ends_kept_alive_connections(no_service):
    """After `stop()` a client's pooled keep-alive connection is closed
    too: the next call is not served and grades locally."""
    srv = tvs.VerifyServer(max_workers=2)
    served = []
    verify = srv.verify
    srv.verify = lambda body: served.append(body["uid"]) or verify(body)
    no_service.setenv("AREAL_VERIFIER_SERVICE", srv.start("127.0.0.1", 0))
    try:
        assert trv.batch_code_verify(CODE_INFO, CODE_GENS[:4], CODE_QIDS[:4]) == WANT_CODE[:4]
        assert served == ["code-0-4"]
    finally:
        srv.stop()
    assert trv.batch_code_verify(CODE_INFO, CODE_GENS[:4], CODE_QIDS[:4]) == WANT_CODE[:4]
    assert served == ["code-0-4"]
