"""The port's fault-injection harness (`areal_tpu_torch/core/fault_injection.py`)
and its seams, on the CPU.

- `tests/test_chaos.py`'s injector cases on the port: validation, plans
  from JSON and from the config, `at` / `times` / `match` gating, the
  seeded probability gate, delay and torn, `afire` counters, the fast
  path, a fault as catchable degradation.
- Parity: the JAX injector and the port's, driven through the same seam
  visits under several seeded plans, make the same decisions (raise or
  not, mode, sleep seconds, tear fraction and the torn bytes) and end
  with equal snapshots.
- The seams: weight staging (abort and retry, a torn frame rejected
  before a byte stages, short payloads), `task.run` releasing the
  runner's capacity, the client's `client.http.send` (no effect),
  `client.http.recv` (error after effect) and `client.http.body` (torn,
  retried) against a counting stdlib server, the config arming the
  injector (the remote client, and the GRPO entry point's colocated
  branch), the recovery seams on both packages' `RecoverHandler`s with
  equal results, and `dataloader.next` re-yielding its batch.
- The exactly-once smoke of `tests/test_chaos.py` on two port
  `DecodeServer`s over a deterministic stub engine, without the router
  (ROADMAP queue 1, item 4.2): 8 requests under a four-mode plan, 0 lost,
  streams equal to the fault-free function of the prompt, one engine
  generation per request, at least 2 idempotency hits.
"""

import asyncio
import json
import os
import struct
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from areal_tpu.core import fault_injection as jfi
from areal_tpu.utils import recover as j_rec
from areal_tpu_torch.api.cli_args import (
    FaultInjectionConfig,
    GenerationHyperparameters,
    InferenceEngineConfig,
    TorchDecodeConfig,
)
from areal_tpu_torch.api.io_struct import ModelRequest, ModelResponse
from areal_tpu_torch.core import fault_injection
from areal_tpu_torch.core.async_task_runner import AsyncTaskRunner
from areal_tpu_torch.core.fault_injection import (
    FaultInjector,
    FaultPlan,
    FaultPoint,
    InjectedFault,
)
from areal_tpu_torch.core.remote_inf_engine import RemoteInfEngine
from areal_tpu_torch.core.weight_transfer import WeightStaging, pack_buckets, unpack_bucket_parts
from areal_tpu_torch.dataset import SimpleDataLoader
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.launcher.decode_server import DecodeServer
from areal_tpu_torch.utils import http as thttp
from tests.test_torch_checkpoint import _FakeStateEngine, _both, _listing


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    fault_injection.deactivate()
    jfi.deactivate()
    yield
    fault_injection.deactivate()
    jfi.deactivate()


# -- injector semantics (tests/test_chaos.py) --------------------------------


def test_fault_point_validation():
    with pytest.raises(ValueError):
        FaultPoint(site="x", mode="explode")
    assert FaultPoint(site="x", at=[1, "2"]).at == (1, 2)


def test_plan_from_json_and_config():
    plan = FaultPlan.from_json(
        '[{"site": "a.b", "mode": "delay", "at": [0], "delay_s": 0.5}]', seed=7)
    assert plan.seed == 7 and plan.points[0].mode == "delay"
    plan = FaultPlan.from_json('{"seed": 3, "points": [{"site": "a"}]}')
    assert plan.seed == 3 and plan.points[0].site == "a"
    assert FaultPlan.from_config(FaultInjectionConfig()) is None
    cfg = FaultInjectionConfig(enabled=True, seed=9, plan='[{"site": "s", "mode": "abort"}]')
    plan = FaultPlan.from_config(cfg)
    assert plan.seed == 9 and plan.points[0].site == "s"


def test_at_times_and_match_gating():
    inj = FaultInjector(FaultPlan(points=[
        FaultPoint(site="s.*", mode="abort", at=(1, 3), times=2, match={"addr": "good"})]))
    fired = []
    for i in range(6):
        try:
            inj.fire("s.x", addr="good-host")
        except InjectedFault:
            fired.append(i)
    assert fired == [1, 3]
    inj2 = FaultInjector(FaultPlan(points=[FaultPoint(site="s.*", match={"addr": "good"})]))
    for _ in range(4):
        inj2.fire("s.x", addr="other")
    assert inj2.snapshot() == {}


def test_probability_gate_is_seed_deterministic():
    def run(seed):
        inj = FaultInjector(FaultPlan(seed=seed, points=[
            FaultPoint(site="s", mode="abort", p=0.5, times=0)]))
        hits = []
        for i in range(32):
            try:
                inj.fire("s")
            except InjectedFault:
                hits.append(i)
        return hits

    a, b = run(11), run(11)
    assert a == b and 0 < len(a) < 32
    assert run(12) != a


def _delay_torn_plan(seed):
    return FaultPlan(seed=seed, points=[
        FaultPoint(site="d", mode="delay", at=(0,), delay_s=0.05, jitter_s=0.05),
        FaultPoint(site="t", mode="torn", at=(0,)),
    ])


def test_delay_and_torn_modes():
    inj = FaultInjector(_delay_torn_plan(5))
    t0 = time.monotonic()
    inj.fire("d")
    assert 0.05 <= time.monotonic() - t0 < 1.0
    data = b"x" * 100
    torn = inj.tear("t", data)
    assert 1 <= len(torn) < len(data)
    inj2 = FaultInjector(_delay_torn_plan(5))
    inj2.fire("d")
    assert inj2.tear("t", data) == torn
    inj3 = FaultInjector(FaultPlan(points=[FaultPoint(site="t", mode="abort", at=(0,))]))
    assert inj3.tear("t", data) == data


def test_afire_delay_and_counters():
    async def go():
        inj = FaultInjector(FaultPlan(points=[
            FaultPoint(site="a", mode="delay", at=(0,), delay_s=0.03),
            FaultPoint(site="a", mode="error_after_effect", at=(0,)),
        ]))
        t0 = time.monotonic()
        await inj.afire("a")
        assert time.monotonic() - t0 >= 0.03
        with pytest.raises(InjectedFault) as ei:
            await inj.afire("a")
        assert ei.value.mode == "error_after_effect"
        return inj.snapshot()

    assert asyncio.run(go()) == {"a|delay": 1, "a|error_after_effect": 1}


def test_global_injector_fast_path():
    assert fault_injection.get() is None
    fault_injection.fire("anything")
    assert fault_injection.tear("anything", b"zz") == b"zz"
    assert fault_injection.snapshot() == {}
    fault_injection.configure(FaultPlan(points=[FaultPoint(site="g", mode="abort", at=(0,))]))
    with pytest.raises(InjectedFault):
        fault_injection.fire("g")
    fault_injection.deactivate()
    fault_injection.fire("g")


def test_injected_fault_is_catchable_degradation():
    f = InjectedFault("s", "abort", FaultPoint(site="s"))
    assert isinstance(f, Exception)
    assert not isinstance(f, asyncio.CancelledError)


# -- parity with the JAX injector ---------------------------------------------

SITES = ("client.http.send", "client.http.recv", "client.http.body", "weight.stage.add",
         "server.generate", "recover.load", "train.step")
PATTERNS = SITES + ("client.http.*", "*", "server.*", "train.*")
MODES = ("abort", "error_after_effect", "delay", "torn")


def _random_plan(seed: int) -> dict:
    """A plan as JSON-able points: sites, modes, `at` or `p`, `times`,
    delays with jitter and `match` filters, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    points = []
    for _ in range(int(rng.integers(2, 7))):
        pt = dict(site=str(rng.choice(PATTERNS)), mode=str(rng.choice(MODES)),
                  times=int(rng.integers(0, 4)))
        if rng.random() < 0.5:
            pt["at"] = sorted({int(x) for x in rng.integers(0, 12, int(rng.integers(1, 4)))})
        else:
            pt["p"] = float(rng.uniform(0.1, 0.9))
        if pt["mode"] == "delay":
            pt["delay_s"] = float(rng.uniform(0, 0.2))
            pt["jitter_s"] = float(rng.uniform(0, 0.2)) if rng.random() < 0.7 else 0.0
        if rng.random() < 0.3:
            pt["match"] = {"addr": str(rng.choice(["host-a", "host-"]))}
        points.append(pt)
    return dict(seed=int(rng.integers(0, 1000)), points=points)


def _visits(seed: int, n: int = 120) -> list:
    rng = np.random.default_rng(seed + 7919)
    return [(str(rng.choice(["fire", "tear"], p=[0.7, 0.3])), str(rng.choice(SITES)),
             dict(addr=str(rng.choice(["host-a", "host-b"])), attempt=int(rng.integers(0, 3))))
            for _ in range(n)]


def _drive(module, plan_text: str, visits: list, monkeypatch) -> tuple[list, dict]:
    """Each visit's outcome under `module`'s injector (sleeps recorded, not
    slept), and the final snapshot."""
    slept = []
    monkeypatch.setattr(module.time, "sleep", slept.append)
    inj = module.FaultInjector(module.FaultPlan.from_json(plan_text))
    data = bytes(range(256)) * 3
    out = []
    for entry, site, ctx in visits:
        if entry == "tear":
            got = inj.tear(site, data, **ctx)
            out.append(("tear", len(got), got == data[:len(got)]))
            continue
        n_slept = len(slept)
        try:
            inj.fire(site, **ctx)
            out.append(("ok", slept[n_slept:]))
        except module.InjectedFault as e:
            out.append(("raise", e.mode, e.site, e.point.site))
    return out, inj.snapshot()


@pytest.mark.parametrize("plan_seed", range(8))
def test_decisions_match_jax_injector(plan_seed, monkeypatch):
    plan = json.dumps(_random_plan(plan_seed))
    visits = _visits(plan_seed)
    j_out, j_snap = _drive(jfi, plan, visits, monkeypatch)
    t_out, t_snap = _drive(fault_injection, plan, visits, monkeypatch)
    assert t_out == j_out
    assert t_snap == j_snap
    # every plan fires at some visit, and some visits pass untouched
    assert j_snap and any(o == ("ok", []) for o in j_out)


def test_decide_actions_match_jax_bit_for_bit():
    """`_decide`'s actions, field for field (delays and tear fractions are
    floats from the per-point streams)."""
    plan = json.dumps(dict(seed=31, points=[
        dict(site="*", mode="delay", p=0.6, times=0, delay_s=0.01, jitter_s=0.3),
        dict(site="client.*", mode="torn", p=0.5, times=0),
        dict(site="train.step", mode="abort", at=[2, 5], times=0),
    ]))
    acts = {}
    for name, mod in (("jax", jfi), ("torch", fault_injection)):
        inj = mod.FaultInjector(mod.FaultPlan.from_json(plan))
        seq = []
        for k in range(200):
            site = SITES[k % len(SITES)]
            modes = ("torn",) if k % 3 == 0 else inj._FIRE_MODES
            a = inj._decide(site, {"k": k}, modes)
            seq.append(None if a is None else (a.mode, a.point.site, a.sleep_s, a.tear_frac))
        acts[name] = (seq, inj.snapshot())
    assert acts["torch"] == acts["jax"]
    assert sum(a is not None for a in acts["torch"][0]) > 20


# -- seam: weight staging -----------------------------------------------------


def test_weight_stage_seam_abort_and_retry():
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    frames = list(pack_buckets([("w", w)], chunk_mb=10.0))
    staging = WeightStaging()
    fault_injection.configure(FaultPlan(points=[FaultPoint(site="weight.stage.add", at=(0,))]))
    with pytest.raises(InjectedFault):
        staging.add_bucket(frames[0])
    assert len(staging) == 0 and staging.n_partial == 0
    for f in frames:
        staging.add_bucket(f)
    assert torch.equal(staging.finalize()["w"], w)


def test_weight_stage_torn_frame_rejected():
    w = torch.arange(256, dtype=torch.float32)
    (frame,) = pack_buckets([("w", w)], chunk_mb=10.0)
    staging = WeightStaging()
    fault_injection.configure(FaultPlan(seed=2, points=[
        FaultPoint(site="weight.stage.add", mode="torn", at=(0,))]))
    with pytest.raises(ValueError, match="torn weight frame"):
        staging.add_bucket(frame)
    assert len(staging) == 0 and staging.n_partial == 0
    fault_injection.deactivate()
    staging.add_bucket(frame)
    assert torch.equal(staging.finalize()["w"], w)


def test_unpack_rejects_short_payloads():
    with pytest.raises(ValueError):
        unpack_bucket_parts(b"\x01")
    (frame,) = pack_buckets([("w", torch.ones(16))], chunk_mb=10.0)
    (mlen,) = struct.unpack_from("<Q", frame, 0)
    with pytest.raises(ValueError):
        unpack_bucket_parts(frame[: 8 + mlen - 2])
    with pytest.raises(ValueError):
        unpack_bucket_parts(frame[:-4])


# -- seam: task.run ------------------------------------------------------------


def test_task_run_seam_releases_capacity():
    runner = AsyncTaskRunner(name="chaos-test")
    runner.start()
    try:
        fault_injection.configure(FaultPlan(points=[FaultPoint(site="task.run", at=(0,))]))

        async def ok():
            return 42

        runner.submit(lambda: ok())
        runner.submit(lambda: ok())
        results = runner.wait(2, timeout=10)
        excs = [r for r in results if r.exception is not None]
        oks = [r for r in results if r.exception is None]
        assert len(excs) == 1 and isinstance(excs[0].exception, InjectedFault)
        assert len(oks) == 1 and oks[0].result == 42
        assert runner.inflight == 0
    finally:
        runner.destroy()


# -- seam: the client's HTTP ---------------------------------------------------


class _CountingServer:
    """A stdlib endpoint counting its POSTs and answering fixed JSON."""

    def __init__(self):
        self.hits = 0
        app = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length") or 0))
                app.hits += 1
                body = json.dumps({"ok": True, "n": 123}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.addr = f"127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def counting():
    srv = _CountingServer()
    yield srv
    srv.stop()


@pytest.mark.parametrize("site,mode,hits", [
    ("client.http.send", "abort", 1),  # the server never saw the first send
    ("client.http.recv", "error_after_effect", 2),  # the effect landed, the reply lost
    ("client.http.body", "torn", 2),  # a torn reply, retried
])
def test_http_seams(counting, site, mode, hits):
    fault_injection.configure(FaultPlan(seed=4, points=[FaultPoint(site=site, mode=mode,
                                                                   at=(0,))]))
    out = asyncio.run(thttp.arequest_with_retry(counting.addr, "/gen", payload={},
                                                max_retries=3, retry_delay=0.01))
    assert out == {"ok": True, "n": 123}
    assert counting.hits == hits
    assert fault_injection.snapshot() == {f"{site}|{mode}": 1}


def test_http_fault_exhausts_retries(counting):
    fault_injection.configure(FaultPlan(points=[
        FaultPoint(site="client.http.send", times=0)]))
    with pytest.raises(thttp.HttpRequestError, match="after 2 retries") as ei:
        thttp.request_with_retry(counting.addr, "/gen", payload={}, max_retries=2,
                                 retry_delay=0.01)
    assert isinstance(ei.value.__cause__, InjectedFault)
    assert counting.hits == 0


# -- arming from the config -----------------------------------------------------


def _armed_cfg():
    return InferenceEngineConfig(fault_injection=FaultInjectionConfig(
        enabled=True, seed=1, plan='[{"site": "cfg.site", "mode": "abort", "at": [0]}]'))


def test_config_arms_global_injector():
    RemoteInfEngine(_armed_cfg())
    assert fault_injection.get() is not None
    with pytest.raises(InjectedFault):
        fault_injection.fire("cfg.site")
    # a disabled config leaves the armed injector
    RemoteInfEngine(InferenceEngineConfig())
    assert fault_injection.get() is not None


def test_colocated_engine_arms_from_its_rollout_config(tmp_path):
    """The GRPO entry point's colocated branch arms the injector from
    `rollout.fault_injection` (JAX's colocated run has no client to do it);
    the decode engine itself leaves the process's injector alone, as JAX's
    does."""
    from areal_tpu_torch.api.cli_args import GRPOConfig, load_expr_config
    from areal_tpu_torch.examples.gsm8k_grpo import build_rollout, check_allocation
    from areal_tpu_torch.models import qwen2 as tq

    TorchDecodeEngine(TorchDecodeConfig(), _armed_cfg(), device="cpu")
    assert fault_injection.get() is None
    plan = '[{"site": "cfg.site", "mode": "abort", "at": [0]}]'
    config, _ = load_expr_config(
        ["--config", "examples/configs/arith_grpo_smoke.yaml", f"cluster.fileroot={tmp_path}",
         "rollout.fault_injection.enabled=true", f"rollout.fault_injection.plan={plan}"],
        GRPOConfig)
    model = tq.ModelConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                           num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
                           dtype="float32", param_dtype="float32", scan_layers=False)
    actor = types.SimpleNamespace(
        params=tq.init_params(model, torch.Generator().manual_seed(0)), model_config=model)
    rollout, _ = build_rollout(config, check_allocation(config.allocation_mode), actor, None,
                               "cpu")
    try:
        with pytest.raises(InjectedFault):
            fault_injection.fire("cfg.site")
    finally:
        rollout.destroy()


# -- seams: recovery, on both packages ----------------------------------------


@pytest.mark.parametrize("site", ["recover.dump.save", "recover.dump.info",
                                  "recover.dump.marker"])
def test_recover_dump_seams_match_jax(tmp_path, site):
    """An abort at a dump seam degrades (no raise), leaves the committed
    step and no new candidate, and the next gate commits: the same files
    and counters in both packages."""
    def scenario(rec, cfg_fn, si, ft):
        fi = jfi if rec is j_rec else fault_injection
        cfg = cfg_fn(keep_last=3)
        h = rec.RecoverHandler(cfg, ft)
        h.dump(_FakeStateEngine(7.0), si(0), force=True)
        fi.configure(fi.FaultPlan(points=[fi.FaultPoint(site=site, at=(0,))]))
        try:
            failed = h.dump(_FakeStateEngine(8.0), si(1), force=True)
            after_fail = _listing(rec, cfg)
            eng = _FakeStateEngine()
            info = rec.RecoverHandler(cfg, ft).load(eng)
            retried = h.dump(_FakeStateEngine(9.0), si(1), force=True)
        finally:
            fi.deactivate()
        return dict(failed=failed, after_fail=after_fail, step=info.last_step_info.global_step,
                    weight=eng.weight, retried=os.path.basename(retried),
                    listing=_listing(rec, cfg), metrics=rec.get_metrics(),
                    fired=fi.snapshot())

    got = _both(scenario, tmp_path)
    assert got["failed"] is None and got["step"] == 0 and got["weight"] == 7.0
    assert got["retried"] == "step-1" and got["listing"] == ["step-0", "step-1"]
    assert all(not n.startswith("step-1") or n == "step-1.tmp" for n in got["after_fail"])
    assert got["metrics"]["recover_dump_failures_total"] == 1


def test_recover_load_abort_falls_back_like_jax(tmp_path):
    def scenario(rec, cfg_fn, si, ft):
        fi = jfi if rec is j_rec else fault_injection
        cfg = cfg_fn(keep_last=3)
        h = rec.RecoverHandler(cfg, ft)
        for g, w in enumerate((1.0, 2.0, 3.0)):
            e = _FakeStateEngine(w)
            e.set_version(g)
            h.dump(e, si(g), force=True)
        fi.configure(fi.FaultPlan(points=[fi.FaultPoint(site="recover.load", at=(0,))]))
        try:
            eng = _FakeStateEngine()
            info = rec.RecoverHandler(cfg, ft).load(eng)
        finally:
            fi.deactivate()
        return dict(step=info.last_step_info.global_step, weight=eng.weight,
                    version=eng.get_version(),
                    skipped=rec.get_metrics().get("recover_torn_skipped_total", 0))

    assert _both(scenario, tmp_path) == dict(step=1, weight=2.0, version=1, skipped=1)


# -- seam: dataloader.next ----------------------------------------------------


def test_dataloader_seam_re_yields_after_restore():
    data = [dict(i=i) for i in range(12)]
    loader = SimpleDataLoader(data, batch_size=4, shuffle=False)
    it = iter(loader)
    first = next(it)
    saved = loader.state_dict()
    fault_injection.configure(FaultPlan(points=[FaultPoint(site="dataloader.next", at=(0,))]))
    with pytest.raises(InjectedFault):
        next(it)
    # the fault came before the position moved: the saved state and the
    # loader agree, and a restored loader yields the batch the fault lost
    assert loader.state_dict() == saved
    fresh = SimpleDataLoader(data, batch_size=4, shuffle=False)
    fresh.load_state_dict(saved)
    assert next(iter(fresh)) == data[4:8] and first == data[:4]


# -- the exactly-once smoke on two port servers ---------------------------------


class DetStubEngine:
    """The stream is a pure function of the prompt; generations are counted
    per rid, so a duplicate generation shows."""

    def __init__(self, n_tokens=4):
        self.n_tokens = n_tokens
        self.calls: dict[str, int] = {}
        self._lock = threading.Lock()

    def get_version(self):
        return 0

    def get_metrics(self):
        return {"active_tokens": 0}

    @staticmethod
    def expected(input_ids, n_tokens=4):
        s = sum(input_ids) % 997
        return [(s + k) % 997 for k in range(n_tokens)]

    def generate(self, req):
        with self._lock:
            self.calls[req.rid] = self.calls.get(req.rid, 0) + 1
        time.sleep(0.02)
        toks = self.expected(req.input_ids, self.n_tokens)
        return ModelResponse(input_tokens=list(req.input_ids), output_tokens=toks,
                             output_logprobs=[0.0] * self.n_tokens,
                             output_versions=[0] * self.n_tokens, stop_reason="stop",
                             latency=0.02, ttft=0.02)


CHAOS_PLAN = FaultPlan(seed=77, points=[
    FaultPoint(site="client.http.send", mode="abort", at=(1,), times=1,
               match={"endpoint": "/generate"}),
    FaultPoint(site="client.http.recv", mode="error_after_effect", at=(0,), times=1,
               match={"endpoint": "/generate"}),
    FaultPoint(site="client.http.body", mode="torn", at=(2,), times=1,
               match={"endpoint": "/generate"}),
    FaultPoint(site="server.generate", mode="delay", at=(1,), times=1, delay_s=0.1),
])


def test_chaos_smoke_exactly_once():
    engines = [DetStubEngine(), DetStubEngine()]
    servers = [DecodeServer(TorchDecodeConfig(), engine=e) for e in engines]
    addrs = [s.start("127.0.0.1", 0) for s in servers]
    client = RemoteInfEngine(InferenceEngineConfig(
        experiment_name="chaosexp", trial_name="t", request_timeout=30, request_retries=3,
        fleet_failover_retries=2))
    client.addresses = list(addrs)
    prompts = {f"r{i}": [i + 1, i + 2, i + 3, 7 * i + 1] for i in range(8)}
    results = {}

    async def go():
        async def one(rid):
            r = await client.agenerate(ModelRequest(
                rid=rid, input_ids=prompts[rid],
                gconfig=GenerationHyperparameters(max_new_tokens=4)))
            assert rid not in results, f"duplicate completion {rid}"
            results[rid] = list(r.output_tokens)

        await asyncio.gather(*[one(rid) for rid in prompts])

    try:
        fault_injection.configure(CHAOS_PLAN)
        asyncio.run(asyncio.wait_for(go(), 60))
        counters = fault_injection.snapshot()
        fault_injection.deactivate()
        assert len(results) == len(prompts)
        for rid, toks in results.items():
            assert toks == DetStubEngine.expected(prompts[rid]), rid
        per_rid: dict[str, int] = {}
        for e in engines:
            for rid, c in e.calls.items():
                per_rid[rid] = per_rid.get(rid, 0) + c
        assert per_rid == {rid: 1 for rid in prompts}, per_rid
        assert {k.split("|")[1] for k in counters} == set(MODES), counters
        hits = sum(thttp.request_with_retry(a, "/metrics", method="GET", max_retries=1,
                                            timeout=5)["idem_hits_total"] for a in addrs)
        assert hits >= 2, hits
    finally:
        for s in servers:
            s.stop()


def test_server_commit_abort_keeps_the_staged_push(tmp_path):
    """`server.weights.commit` fires before `_ctl_lock`: an abort answers
    500 and installs nothing; the staged frames stay for the retry."""
    class Eng(DetStubEngine):
        model_config = None

        def update_weights_from_tensor(self, named, version=None):
            self.installed = (sorted(named), version)

    eng = Eng()
    srv = DecodeServer(TorchDecodeConfig(), engine=eng)
    addr = srv.start("127.0.0.1", 0)
    try:
        import areal_tpu_torch.launcher.decode_server as ds

        ds.to_layout, to_layout = (lambda staged, cfg: staged), ds.to_layout
        (frame,) = pack_buckets([("w", torch.ones(4))], chunk_mb=1.0)
        thttp.request_with_retry(addr, "/update_weights_from_tensor?push_id=p1", data=frame,
                                 max_retries=1)
        fault_injection.configure(FaultPlan(points=[
            FaultPoint(site="server.weights.commit", at=(0,))]))
        with pytest.raises(thttp.HttpRequestError):
            thttp.request_with_retry(addr, "/commit_weights",
                                     payload={"version": 1, "push_id": "p1"}, max_retries=1)
        assert not hasattr(eng, "installed")
        out = thttp.request_with_retry(addr, "/commit_weights",
                                       payload={"version": 1, "push_id": "p1"}, max_retries=1)
        assert out["status"] == "ok" and eng.installed == (["w"], 1)
    finally:
        ds.to_layout = to_layout
        srv.stop()
