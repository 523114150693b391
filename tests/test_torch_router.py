"""The port's decode-fleet router (`areal_tpu_torch/launcher/router.py`)
against the JAX one, and the remote client's scheduling through it, on
the CPU.

- Decision parity: the same sequence of probe rounds, schedule requests,
  client requeues, finishes, field settings and clock steps is fed to
  JAX's `DecodeRouter` and the port's, through the methods both keep
  (`_apply_probes_locked`, `_expire_locked`, `_try_schedule_locked`,
  `_release_qid`, `_failover_locked`), with each module's clock replaced
  by one fake clock. After every step the placements, counters, load
  accounting, qid and prefix maps, breakers and live servers are equal.
  The scenarios are those of `tests/test_router.py`: qid and prefix
  affinity with the load override, the policies, pressure admission and
  headroom, the breaker (slow polls, half-open probes, probe expiry,
  relapse, erroring metrics), failover with requeue, TTL and size expiry;
  and the staleness gate over a grid.
- The bounded queue end to end: both routers over the same stdlib fake
  replicas queue, shed (429 with Retry-After), time out, honour a
  client's deadline and drain the queue when pressure falls, with equal
  counters.
- The wire both ways: the port's `RemoteInfEngine` schedules through the
  JAX router, and the JAX client through the port's, each finding it
  through its package's name_resolve; every qid is released at the end.
- The port client against the port router: a replica killed mid-request
  fails over with `requeue=True` and completes once; a router that sheds
  is honoured (Retry-After) until the deadline, then the local policy
  serves; a `router.schedule` abort falls back; a `router.poll` abort is
  a failed poll; `python -m areal_tpu_torch.launcher.router` serves.
"""

import asyncio
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from areal_tpu.api.cli_args import InferenceEngineConfig as JaxInferenceConfig
from areal_tpu.api.cli_args import RouterConfig as JaxRouterConfig
from areal_tpu.api.io_struct import ModelRequest as JaxRequest
from areal_tpu.core.remote_inf_engine import RemoteInfEngine as JaxRemoteInfEngine
from areal_tpu.launcher import router as jr
from areal_tpu.utils import name_resolve as j_nr
from areal_tpu.utils import names as j_names
from areal_tpu.utils.http import close_current_session
from areal_tpu_torch.api.cli_args import (
    GenerationHyperparameters,
    InferenceEngineConfig,
    NameResolveConfig,
    RouterConfig,
    TorchDecodeConfig,
)
from areal_tpu_torch.api.io_struct import ModelRequest, ModelResponse
from areal_tpu_torch.core import fault_injection as tfi
from areal_tpu_torch.core.remote_inf_engine import RemoteInfEngine
from areal_tpu_torch.launcher import router as tr
from areal_tpu_torch.launcher.decode_server import DecodeServer
from areal_tpu_torch.utils import name_resolve as t_nr
from areal_tpu_torch.utils import names as t_names
from areal_tpu_torch.utils.http import HttpRequestError, request_with_retry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    tfi.deactivate()
    t_nr.reconfigure(NameResolveConfig(type="memory"))
    j_nr.reconfigure(j_nr.NameResolveConfig(type="memory"))
    yield
    tfi.deactivate()


# -- decision parity -----------------------------------------------------------


def _req(qid, pl=10, budget=8, group=1, prefix=None, **kw):
    out = dict(qid=qid, prompt_len=pl, group_size=group, new_token_budget=budget, **kw)
    if prefix is not None:
        out["input_prefix"] = prefix
    return out


def _probe(s, v=1, load=5.0, est=0.0, pressure=None, rtt=0.01):
    return (s, v, load, est, pressure, rtt, "unified")


def _dead(s):
    return (s, None, None, 0.0, None, 0.01, "unified")


def _state(r) -> dict:
    """What the two routers must agree on after each step."""
    return dict(
        servers=list(r.servers),
        counters={k: r._counters[k] for k in tr.DecodeRouter()._counters},
        request_counts={s: c for s, c in r._request_counts.items() if c},
        token_loads={s: round(r._token_load(s), 9) for s in r.servers},
        token_usage={s: round(u, 9) for s, u in r._token_usage.items() if u},
        qids=dict(r._qid_to_server),
        pending=dict(r._qid_pending),
        cost={q: round(c, 9) for q, c in r._qid_cost.items()},
        prefixes=[(h, s) for h, (s, _) in r._prefix_map.items()],
        breaker={s: {k: b[k] for k in ("state", "bad", "probes")} for s, b in r._breaker.items()},
        health_fail={s: n for s, n in r._health_fail.items() if n},
        measured=dict(r._measured_tokens),
        pressure={s: dict(p) for s, p in r._pressure.items()},
        fleet_version=r.fleet_version,
    )


def _play(mod, cfg: dict, seed: list[str], steps: list, monkeypatch) -> list:
    """Run `steps` on a router of `mod` (the JAX or the port module) under
    a fake clock: the result and the state after each step."""
    clock = [1000.0]
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=lambda: clock[0]))
    config = (JaxRouterConfig if mod is jr else RouterConfig)(**cfg)
    r = mod.DecodeRouter(servers=seed, config=config)
    log = []
    for op, *args in steps:
        out = None
        if op == "poll":  # one round of the poll loop
            servers, probes = args
            r._apply_probes_locked(servers, probes)
            r._expire_locked(clock[0], servers)
        elif op == "sched":
            got = r._try_schedule_locked(dict(args[0]))
            out = None if got is None else (got["url"], got["version"])
        elif op == "requeue":  # the handler's requeue, then the schedule
            r._release_qid(args[0]["qid"])
            r._counters["client_requeues_total"] += 1
            got = r._try_schedule_locked(dict(args[0]))
            out = None if got is None else got["url"]
        elif op == "release":
            r._release_qid(args[0])
        elif op == "failover":
            r._failover_locked(args[0])
        elif op == "clock":
            clock[0] += args[0]
        elif op == "expire":
            r._expire_locked(clock[0], args[0])
        elif op == "set":  # poke a field, as tests/test_router.py does
            attr, key, value = args
            getattr(r, attr)[key] = value
        elif op == "admits":
            out = [r._breaker_admits(s) for s in args[0]]
        elif op == "headroom":
            out = [r._kv_headroom(s, args[1]) for s in args[0]]
        else:
            raise ValueError(op)
        log.append((op, out, _state(r)))
    return log


AB = ["a:1", "b:1"]
ABC = ["a:1", "b:1", "c:1"]
PREFIX = list(range(1, 129))  # two 64-token affinity blocks
POOL = dict(kv_block_size=16, kv_blocks_total=100, kv_pool_fragmentation=3,
            kv_tokens_allocated=400, active_tokens=0, running_requests=0, queued_requests=0,
            kv_dtype="fp")

SCENARIOS = {
    "affinity_and_override": (dict(schedule_policy="prefix_affinity"), AB, [
        ("poll", AB, [_probe("a:1"), _probe("b:1", load=2.0)]),
        *[("sched", _req(f"g{i}", pl=128, prefix=PREFIX)) for i in range(4)],
        ("sched", _req("h0", pl=100, prefix=list(range(500, 600)))),
        ("sched", _req("g0", pl=128, prefix=PREFIX)),  # qid affinity
        ("sched", _req("short", pl=30, prefix=list(range(30)))),  # under a block
        ("set", "_measured_tokens", "b:1", 1e9),
        ("set", "_measured_tokens", "a:1", 1e9),
        ("sched", _req("g9", pl=128, prefix=PREFIX)),
        # the affine server made hot, whichever it is: an override
        ("set", "_measured_tokens", "a:1", 1e9), ("set", "_measured_tokens", "b:1", 0.0),
        ("sched", _req("g10", pl=128, prefix=PREFIX)),
        ("set", "_measured_tokens", "a:1", 0.0), ("set", "_measured_tokens", "b:1", 1e9),
        ("sched", _req("g11", pl=128, prefix=PREFIX)),
        ("poll", AB, [_probe("a:1", load=1e6), _probe("b:1", load=0.0)]),
        ("release", "g0"), ("release", "g0"), ("release", "g1"),
        ("sched", _req("g1", pl=128, prefix=PREFIX, previous_server_url="a:1",
                       previous_version=1)),
    ]),
    "policies_round_robin": (dict(schedule_policy="round_robin"), ABC, [
        ("poll", ABC, [_probe(s) for s in ABC]),
        *[("sched", _req(f"q{i}")) for i in range(5)],
        ("release", "q1"), ("sched", _req("q5")),
    ]),
    "policies_least_requests": (dict(schedule_policy="least_requests"), ABC, [
        ("poll", ABC, [_probe(s) for s in ABC]),
        *[("sched", _req(f"q{i}", group=4)) for i in range(4)],
        ("release", "q0"), ("sched", _req("q9")),
    ]),
    "policies_least_token_usage": (dict(schedule_policy="least_token_usage"), AB, [
        ("poll", AB, [_probe("a:1", load=50.0), _probe("b:1", load=10.0)]),
        ("sched", _req("x", pl=100, budget=50)), ("sched", _req("y", pl=5)),
        ("poll", AB, [_probe("a:1", load=50.0, est=0.0), _probe("b:1", load=60.0, est=120.0)]),
        ("sched", _req("z", pl=5)),
        ("poll", AB, [_probe("a:1", v=None), _probe("b:1")]),
        ("poll", AB, [_probe("a:1", load=None), _probe("b:1", load=None)]),
        ("poll", AB, [_probe("a:1", load=None), _probe("b:1", load=None)]),
        ("poll", AB, [_probe("a:1", load=None), _probe("b:1", load=None)]),  # stale: dropped
        ("sched", _req("w", pl=5)),
    ]),
    "headroom_and_admission": (dict(schedule_policy="least_requests", max_inflight_per_server=3,
                                    kv_pressure_high=0.9), AB, [
        ("poll", AB, [_probe("a:1", pressure=dict(POOL)),
                      _probe("b:1", pressure=dict(POOL, kv_host_pool_enabled=True,
                                                  kv_tokens_allocated=1500))]),
        ("headroom", AB, 100.0),
        *[("sched", _req(f"p{i}", pl=300, budget=100)) for i in range(6)],
        ("poll", AB, [_probe("a:1", pressure=dict(POOL, running_requests=3)),
                      _probe("b:1", pressure=dict(POOL, running_requests=1, queued_requests=1))]),
        ("sched", _req("d1")), ("sched", _req("d2")),
        ("release", "p0"), ("release", "p1"),
        ("poll", AB, [_probe("a:1", pressure=dict(POOL)), _probe("b:1", pressure=dict(POOL))]),
        ("sched", _req("d3")),
    ]),
    "breaker_slow_polls_and_probe": (dict(schedule_policy="least_token_usage",
                                          breaker_trip_after=2, breaker_slow_s=0.1,
                                          breaker_probe_requests=1, dead_after_failures=100),
                                     AB, [
        ("poll", AB, [_probe("a:1"), _probe("b:1")]),
        ("poll", AB, [_probe("a:1", rtt=0.5), _probe("b:1")]),
        ("poll", AB, [_probe("a:1", rtt=0.5), _probe("b:1")]),
        ("admits", AB),
        ("sched", _req("aff")),
        ("poll", AB, [_probe("a:1"), _probe("b:1")]),
        ("set", "_measured_tokens", "a:1", 0.0), ("set", "_measured_tokens", "b:1", 10000.0),
        ("sched", _req("p1")), ("sched", _req("p2")),
        ("release", "p1"),
        ("sched", _req("p3")), ("admits", AB),
    ]),
    "breaker_probe_expiry_and_relapse": (dict(schedule_policy="least_token_usage",
                                              breaker_trip_after=1, breaker_slow_s=0.1,
                                              breaker_probe_ttl_s=5.0,
                                              dead_after_failures=100), AB, [
        ("poll", AB, [_probe("a:1", rtt=0.5, load=0.0), _probe("b:1", load=100.0)]),
        ("poll", AB, [_probe("a:1", load=0.0), _probe("b:1", load=100.0)]),
        ("sched", _req("probe")),  # charged, its client dies
        ("sched", _req("next")),
        ("clock", 6.0),
        ("poll", AB, [_probe("a:1", load=0.0), _probe("b:1", load=100.0)]),  # expired
        ("sched", _req("fresh")),
        ("poll", AB, [_probe("a:1", rtt=0.5, load=0.0), _probe("b:1", load=100.0)]),  # relapse
        ("admits", AB),
        ("poll", AB, [_probe("a:1", load=None), _probe("b:1", load=100.0)]),  # metrics error
        ("poll", AB, [_probe("a:1", load=0.0), _probe("b:1", load=100.0)]),
        ("admits", AB),
    ]),
    "breaker_disabled": (dict(breaker_enabled=False, breaker_trip_after=1, breaker_slow_s=0.1),
                         AB, [
        ("poll", AB, [_probe("a:1", rtt=0.5), _probe("b:1", rtt=0.5)]),
        ("admits", AB), ("sched", _req("q")),
    ]),
    "failover_requeue": (dict(schedule_policy="least_requests", dead_after_failures=2), ABC, [
        ("poll", ABC, [_probe(s) for s in ABC]),
        *[("sched", _req(f"q{i}", pl=40 + i, prefix=list(range(64)))) for i in range(6)],
        ("sched", _req("q0")),  # a second unit of q0
        ("poll", ABC, [_dead("a:1"), _probe("b:1"), _probe("c:1")]),
        ("poll", ABC, [_dead("a:1"), _probe("b:1"), _probe("c:1")]),  # declared dead
        ("requeue", _req("q0")), ("requeue", _req("q1")),
        ("release", "q0"), ("release", "q0"),
        ("poll", ABC, [_probe(s) for s in ABC]),  # back: clean breaker
        ("sched", _req("q9")),
        ("failover", "c:1"),
        ("poll", ["b:1"], [_probe("b:1")]),  # the others left discovery
    ]),
    "ttl_and_size_expiry": (dict(route_ttl_s=10.0, route_max_entries=3,
                                 schedule_policy="prefix_affinity"), AB, [
        ("poll", AB, [_probe("a:1"), _probe("b:1")]),
        *[("sched", _req(f"q{i}", pl=64, prefix=[i] * 64)) for i in range(5)],
        ("expire", AB),
        ("clock", 5.0), ("sched", _req("late", pl=64, prefix=[9] * 64)),
        ("clock", 6.0), ("expire", AB),
        ("clock", 20.0), ("expire", ["a:1"]),
    ]),
}


@pytest.mark.parametrize("name", SCENARIOS)
def test_router_decides_as_jax(name, monkeypatch):
    cfg, seed, steps = SCENARIOS[name]
    want = _play(jr, cfg, seed, steps, monkeypatch)
    got = _play(tr, cfg, seed, steps, monkeypatch)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, f"{name}: step {i} {steps[i][0]} differs\nport {g}\njax  {w}"
    # the scenario exercised what it is named for
    final = got[-1][2]["counters"]
    expect = {"affinity_and_override": ("affinity_hits_total", "affinity_overrides_total"),
              "breaker_slow_polls_and_probe": ("breaker_trips_total", "breaker_closes_total"),
              "breaker_probe_expiry_and_relapse": ("breaker_probe_expiries_total",),
              "failover_requeue": ("failovers_total", "requeues_total"),
              "ttl_and_size_expiry": ("expired_qids_total", "expired_prefixes_total")}
    for key in expect.get(name, ("schedules_total",)):
        assert final[key] > 0, (name, key, final)


def test_staleness_gate_as_jax(monkeypatch):
    """`_is_staled` over a grid of consumed samples, running rollouts and
    server versions; `/allocate_rollout` and `/finish_rollout` on the
    port's router read the published counter."""
    for trained in (0, 3, 8, 17):
        for running in (0, 2, 5):
            for versions in ({}, {"a": 1}, {"a": 2, "b": 1}):
                got = []
                for mod in (jr, tr):
                    r = mod.DecodeRouter("e", "t", config=(
                        JaxRouterConfig if mod is jr else RouterConfig)(
                            max_head_offpolicyness=1, train_batch_size=4))
                    monkeypatch.setattr(r, "_training_sample_cnt", lambda n=trained: n)
                    r._running = running
                    r._versions = dict(versions)
                    got.append(r._is_staled())
                assert got[0] == got[1], (trained, running, versions)
    r = tr.DecodeRouter("e", "t", config=RouterConfig(max_concurrent_rollouts=2,
                                                       max_head_offpolicyness=0,
                                                       train_batch_size=2))
    assert r._allocate_rollout({})["success"] and r._allocate_rollout({})["success"]
    full = r._allocate_rollout({})
    assert not full["success"] and "capacity" in full["reason"]
    r._finish_rollout({"accepted": True})
    t_nr.add(t_names.training_samples("e", "t"), "4")  # 4 // 2 > 0 + version 0
    staled = r._allocate_rollout({})
    assert not staled["success"] and "staled" in staled["reason"]
    assert r._health()["accepted"] == 1 and r._health()["submitted"] == 2


# -- end to end ------------------------------------------------------------------


class _Replica:
    """A stdlib fake decode server: /health with a version, /metrics from
    a dict the test edits."""

    def __init__(self, version=1, metrics=None):
        self.version = version
        self.metrics = dict(metrics or {"active_tokens": 0})
        rep = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                body = {"/health": {"status": "ok", "version": rep.version},
                        "/metrics": rep.metrics}.get(self.path)
                data = json.dumps(body).encode()
                self.send_response(200 if body is not None else 404)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.addr = f"127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class _LoopThread:
    """An asyncio loop on a thread, for the JAX package's aiohttp pieces."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        async def bye():
            await close_current_session()
        self.run(bye())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


@contextlib.contextmanager
def _router(jax: bool, servers, exp="", trial="", **cfg):
    """A started router of either package, and a blocking POST to it."""
    if jax:
        lt = _LoopThread()
        r = jr.DecodeRouter(exp, trial, servers, config=JaxRouterConfig(**cfg))
        addr = lt.run(r.start("127.0.0.1", 0))
        try:
            yield r, addr
        finally:
            lt.run(r.stop())
            lt.close()
    else:
        r = tr.DecodeRouter(exp, trial, servers, config=RouterConfig(**cfg))
        addr = r.start("127.0.0.1", 0)
        try:
            yield r, addr
        finally:
            r.stop()


def _sched(addr, **req):
    return request_with_retry(addr, "/schedule_request", payload=_req(**req), max_retries=1,
                              timeout=30)


def _shed_status(addr, **req):
    with pytest.raises(HttpRequestError) as e:
        _sched(addr, **req)
    return e.value.status, e.value.body


def _queue_scenario(jax: bool) -> dict:
    full = dict(active_tokens=0, kv_block_size=16, kv_blocks_total=10, kv_tokens_allocated=150)
    rep = _Replica(metrics=full)
    try:
        with _router(jax, [rep.addr], health_poll_interval=0.1, queue_max=1,
                     queue_timeout_s=0.6, retry_after_s=0.2) as (r, addr):
            time.sleep(0.4)
            out = {}
            with __import__("concurrent.futures").futures.ThreadPoolExecutor(2) as pool:
                held = pool.submit(_shed_status, addr, qid="held")
                time.sleep(0.15)
                out["full"] = _shed_status(addr, qid="second")  # the queue is full
                out["held"] = held.result(10)  # its hold ran out
            out["deadline"] = _shed_status(addr, qid="tight", deadline_s=0.1)
            with __import__("concurrent.futures").futures.ThreadPoolExecutor(1) as pool:
                later = pool.submit(_sched, addr, qid="later")
                time.sleep(0.15)
                rep.metrics = dict(full, kv_tokens_allocated=0)  # pressure falls
                out["admitted"] = later.result(10)["url"] == rep.addr
            m = request_with_retry(addr, "/metrics", method="GET")
            out["counters"] = {k: m[k] for k in (
                "queue_enqueues_total", "queue_admits_total", "queue_sheds_total",
                "queue_timeouts_total", "deadline_sheds_total", "schedules_total")}
            out["queue_depth"] = m["queue_depth"]
            return out
    finally:
        rep.stop()


def test_bounded_queue_and_shedding_as_jax():
    want, got = _queue_scenario(True), _queue_scenario(False)
    assert got == want, (got, want)
    assert got["full"][0] == 429 and got["full"][1]["retry_after"] == 0.2
    assert got["counters"]["queue_admits_total"] == 1 and got["admitted"]
    # the header as well as the body
    rep = _Replica(metrics=dict(active_tokens=0, kv_block_size=16, kv_blocks_total=1,
                                kv_tokens_allocated=100))
    try:
        with _router(False, [rep.addr], health_poll_interval=0.1, queue_max=0,
                     retry_after_s=1.5) as (_, addr):
            time.sleep(0.3)
            import http.client

            c = http.client.HTTPConnection(*addr.split(":"))
            c.request("POST", "/schedule_request", body=json.dumps(_req("x")),
                      headers={"Content-Type": "application/json"})
            resp = c.getresponse()
            assert resp.status == 429 and resp.getheader("Retry-After") == "2"
            c.close()
    finally:
        rep.stop()


def test_router_endpoints_and_metrics():
    rep = _Replica(metrics=dict(active_tokens=7, kv_block_size=16, kv_blocks_total=100,
                                kv_pool_fragmentation=2, kv_migrated_in_sessions_total=3,
                                kv_migrated_in_bytes_total=99))
    try:
        with _router(False, [rep.addr], "rexp", "rt", health_poll_interval=0.1,
                     max_concurrent_rollouts=1) as (r, addr):
            time.sleep(0.3)
            assert t_nr.get(t_names.rollout_router("rexp", "rt")) == addr
            assert _sched(addr, qid="q")["url"] == rep.addr
            assert request_with_retry(addr, "/allocate_rollout", payload={})["success"]
            assert not request_with_retry(addr, "/allocate_rollout", payload={})["success"]
            request_with_retry(addr, "/finish_rollout", payload=dict(qid="q", accepted=True))
            h = request_with_retry(addr, "/health", method="GET")
            assert h["servers"] == [rep.addr] and h["accepted"] == 1 and h["running"] == 0
            m = request_with_retry(addr, "/metrics", method="GET")
            assert m["tracked_qids"] == 0 and m["kv_migrated_sessions_total"] == 3
            assert m["pressure"][rep.addr]["kv_pool_fragmentation"] == 2
            assert m["roles"] == {rep.addr: "unified"} and m["breaker"][rep.addr]["state"] == "closed"
            for path in ("/nope", "/health"):
                with pytest.raises(HttpRequestError) as e:
                    request_with_retry(addr, path, payload={}, max_retries=1)
                assert e.value.status == 404
        with _router(False, [rep.addr], health_poll_interval=0.1,
                     schedule_policy="bogus") as (_, addr):
            time.sleep(0.3)
            with pytest.raises(HttpRequestError) as e:
                _sched(addr, qid="q")
            assert e.value.status == 400
    finally:
        rep.stop()


# -- the client through a router ----------------------------------------------------


class _StubEngine:
    """A decode engine whose stream is a function of the prompt, counting
    its generations, that can be held and killed."""

    def __init__(self, delay=0.01, metrics=None):
        self.delay = delay
        self.calls = 0
        self.killed = threading.Event()
        self.metrics = metrics or {"active_tokens": 0}

    def get_version(self):
        return 0

    def get_metrics(self):
        return dict(self.metrics)

    def generate(self, req):
        self.calls += 1
        t0 = time.monotonic()
        while time.monotonic() - t0 < self.delay:
            if self.killed.wait(0.01):
                raise RuntimeError("replica killed")
        toks = [(sum(req.input_ids) + k) % 97 for k in range(3)]
        return ModelResponse(input_tokens=list(req.input_ids), output_tokens=toks,
                             output_logprobs=[0.0] * 3, output_versions=[0] * 3,
                             stop_reason="stop", latency=0.0, ttft=0.0)


def _stub_servers(n, **kw):
    engines = [_StubEngine(**kw) for _ in range(n)]
    servers = [DecodeServer(TorchDecodeConfig(), engine=e) for e in engines]
    return engines, servers, [s.start("127.0.0.1", 0) for s in servers]


def _port_client(exp, trial, addrs, **cfg):
    client = RemoteInfEngine(InferenceEngineConfig(experiment_name=exp, trial_name=trial,
                                                   **cfg))
    client.addresses = list(addrs)
    return client


def _generate_all(client, rids, prompt_of):
    async def go():
        return await asyncio.gather(*[client.agenerate(ModelRequest(
            rid=rid, input_ids=prompt_of(rid), gconfig=GenerationHyperparameters(
                max_new_tokens=3))) for rid in rids])
    return asyncio.run(asyncio.wait_for(go(), 60))


@pytest.mark.parametrize("router_pkg", ["jax", "port"])
def test_port_client_schedules_through_router(router_pkg):
    engines, servers, addrs = _stub_servers(2)
    try:
        with _router(router_pkg == "jax", addrs, health_poll_interval=0.1,
                     schedule_policy="least_requests") as (r, raddr):
            time.sleep(0.3)
            t_nr.add(t_names.rollout_router("wexp", "wt"), raddr)
            client = _port_client("wexp", "wt", addrs, request_timeout=30)
            assert client._router_addr() == raddr
            rids = [f"r{i}" for i in range(6)]
            out = _generate_all(client, rids, lambda rid: [int(rid[1:]) + 1, 2, 3])
            assert all(o.stop_reason == "stop" and len(o.output_tokens) == 3 for o in out)
            m = request_with_retry(raddr, "/metrics", method="GET")
            assert m["schedules_total"] == 6 and m["tracked_qids"] == 0  # all released
            assert [e.calls for e in engines] == [3, 3]  # least_requests spread them
    finally:
        for s in servers:
            s.stop()


def test_jax_client_schedules_through_port_router():
    engines, servers, addrs = _stub_servers(2)
    lt = _LoopThread()
    try:
        with _router(False, addrs, health_poll_interval=0.1,
                     schedule_policy="round_robin") as (r, raddr):
            time.sleep(0.3)
            j_nr.add(j_names.rollout_router("jexp", "jt"), raddr)
            client = JaxRemoteInfEngine(JaxInferenceConfig(experiment_name="jexp",
                                                           trial_name="jt",
                                                           request_timeout=30))
            client.addresses = list(addrs)
            from areal_tpu.api.cli_args import GenerationHyperparameters as JaxGen

            async def go():
                return await asyncio.gather(*[client.agenerate(JaxRequest(
                    rid=f"j{i}", input_ids=[i + 1, 2], gconfig=JaxGen(max_new_tokens=3)))
                    for i in range(4)])
            out = lt.run(go())
            assert all(o.stop_reason == "stop" for o in out)
            m = request_with_retry(raddr, "/metrics", method="GET")
            assert m["schedules_total"] == 4 and m["tracked_qids"] == 0
            assert [e.calls for e in engines] == [2, 2]
    finally:
        lt.close()
        for s in servers:
            s.stop()


def test_client_failover_through_router_exactly_once():
    """The replica serving a request dies: the client reschedules with
    `requeue=True` and the request completes once on the survivor
    (`tests/test_fleet.py::test_client_failover_exactly_once`)."""
    engines, servers, addrs = _stub_servers(2, delay=30.0)
    try:
        with _router(False, addrs, health_poll_interval=0.15, schedule_policy="round_robin",
                     dead_after_failures=2) as (r, raddr):
            time.sleep(0.4)
            t_nr.add(t_names.rollout_router("fexp", "ft"), raddr)
            client = _port_client("fexp", "ft", addrs, request_timeout=60, request_retries=1,
                                  fleet_failover_retries=3)
            res = {}
            t = threading.Thread(target=lambda: res.update(r=_generate_all(
                client, ["fo-1"], lambda rid: [1, 2, 3])[0]), daemon=True)
            t.start()
            deadline = time.monotonic() + 10
            while sum(e.calls for e in engines) < 1:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            victim = 0 if engines[0].calls else 1
            live = 1 - victim
            engines[live].delay = 0.05
            servers[victim].stop()
            engines[victim].killed.set()
            t.join(30)
            assert res["r"].stop_reason == "stop" and len(res["r"].output_tokens) == 3
            assert engines[live].calls == 1  # one completion, none lost
            m = request_with_retry(raddr, "/metrics", method="GET")
            assert m["client_requeues_total"] >= 1 and m["tracked_qids"] == 0
    finally:
        for s in servers:
            s.stop()


def test_client_honors_429_then_falls_back():
    engines, servers, addrs = _stub_servers(1, metrics={
        "active_tokens": 0, "kv_blocks_total": 10, "kv_block_size": 16,
        "kv_tokens_allocated": 0})
    try:
        with _router(False, addrs, health_poll_interval=0.15, queue_max=0, retry_after_s=0.2,
                     kv_pressure_high=0.0) as (r, raddr):
            time.sleep(0.4)
            t_nr.add(t_names.rollout_router("qexp", "qt"), raddr)
            client = _port_client("qexp", "qt", addrs, request_timeout=1.0, request_retries=1)
            t0 = time.monotonic()
            (resp,) = _generate_all(client, ["q-1"], lambda rid: [1, 2, 3])
            assert resp.stop_reason == "stop" and time.monotonic() - t0 >= 0.2
            assert engines[0].calls == 1
            assert request_with_retry(raddr, "/metrics", method="GET")["queue_sheds_total"] >= 1
    finally:
        for s in servers:
            s.stop()


def test_router_seams_schedule_abort_and_poll_abort():
    """A `router.schedule` abort answers 500 and the client serves the
    request by its local policy; a `router.poll` abort is a failed poll."""
    engines, servers, addrs = _stub_servers(1)
    try:
        with _router(False, addrs, health_poll_interval=0.1) as (r, raddr):
            time.sleep(0.3)
            t_nr.add(t_names.rollout_router("sexp", "st"), raddr)
            client = _port_client("sexp", "st", addrs, request_timeout=20)
            tfi.configure(tfi.FaultPlan(points=[tfi.FaultPoint(
                site="router.schedule", mode="abort", times=2)]))
            (resp,) = _generate_all(client, ["s-1"], lambda rid: [4, 5])
            fired = tfi.snapshot()
            tfi.deactivate()
            assert resp.stop_reason == "stop" and engines[0].calls == 1
            assert fired == {"router.schedule|abort": 2}  # one call, its two tries
            assert client._router == ""  # forgotten until the cooldown
            tfi.configure(tfi.FaultPlan(points=[tfi.FaultPoint(
                site="router.poll", mode="abort", times=2)]))
            deadline = time.monotonic() + 10
            while tfi.snapshot().get("router.poll|abort", 0) < 2:
                assert time.monotonic() < deadline
                time.sleep(0.02)
            time.sleep(0.05)
            with r._lock:
                assert r._counters["failovers_total"] == 1  # dead_after_failures=2
            tfi.deactivate()
    finally:
        for s in servers:
            s.stop()


def test_router_main_serves():
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("AREAL_NAME_RESOLVE", None)
    port = __import__("areal_tpu_torch.utils.network", fromlist=["x"]).find_free_ports(1)[0]
    proc = subprocess.Popen([sys.executable, "-m", "areal_tpu_torch.launcher.router",
                             "--servers", "127.0.0.1:1", "--host", "127.0.0.1", "--port",
                             str(port), "--health-poll-interval", "0.2"], env=env, cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        h = {}
        # up, and its first poll round applied: the seed fails its probe
        while h.get("servers") != []:
            assert time.monotonic() < deadline and proc.poll() is None, h
            try:
                h = request_with_retry(f"127.0.0.1:{port}", "/health", method="GET",
                                       max_retries=1, timeout=2)
            except HttpRequestError:
                pass
            time.sleep(0.1)
        assert h["status"] == "ok"
    finally:
        proc.terminate()
        assert proc.wait(30) == 0
