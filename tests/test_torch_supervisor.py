"""The port's fleet supervisor (`areal_tpu_torch/launcher/supervisor.py`)
against the JAX one, and the local launcher's spawn seam, on the CPU.

- `plan_actions` equals JAX's on every row of `tests/test_supervisor.py`'s
  table (the same action: kind, target, role and reason), and on a
  hypothesis sweep of snapshots and policies, where no plan takes the
  alive count below `min_replicas` and no plan holds two actions.
- The executor, driven by `_tick` with a fake clock beside the JAX
  supervisor on the same inputs: crash-loop escalation (three failed
  spawns, then no more, however long the pressure lasts) and the replace
  of a dead replica (kill, respawn) end with equal counters; `/health` and
  `/supervisor` serve the counters, gauges and slots.
- The transitions against port decode servers: a scale-down drains, then
  kills; a `supervisor.drain` delay past `drain_deadline_s` rolls back
  and the drain is never sent; a `supervisor.kill` abort leaves the
  drained replica for the next tick; a `supervisor.health` abort on every
  probe replaces the replica.
- End to end on tiny CPU engines: two port decode servers behind the port
  router, a `RemoteInfEngine` with requests in mid-stream, and a
  supervisor whose policy plans a scale-down: the victim drains to the
  survivor and is killed, the clients fail over through the router, every
  resume on the survivor is a host-tier promotion (no prefill), migrated
  bytes are blocks x `kv_block_nbytes`, and the joined streams equal a
  never-interrupted engine's (greedy tokens exact, logprobs equal).
- `LocalLauncher.spawn_decode_server` starts a decode-server subprocess on
  the CPU that registers itself, and its handle kills it.
"""

import asyncio
import dataclasses
import json
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from areal_tpu.api.cli_args import SupervisorConfig as JaxSupervisorConfig
from areal_tpu.launcher import supervisor as js
from areal_tpu.models import qwen2 as jq
from areal_tpu.utils.http import close_current_session
from areal_tpu_torch.api.cli_args import (
    GenerationHyperparameters,
    InferenceEngineConfig,
    NameResolveConfig,
    RouterConfig,
    SupervisorConfig,
    TorchDecodeConfig,
)
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.core import fault_injection as tfi
from areal_tpu_torch.core.remote_inf_engine import RemoteInfEngine
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.launcher import supervisor as ts
from areal_tpu_torch.launcher.decode_server import DecodeServer
from areal_tpu_torch.launcher.local import LocalLauncher
from areal_tpu_torch.launcher.router import DecodeRouter
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy
from areal_tpu_torch.utils import name_resolve as t_nr
from areal_tpu_torch.utils import names as t_names
from areal_tpu_torch.utils.http import request_with_retry
from tests.test_supervisor import PLAN_TABLE


@pytest.fixture(autouse=True)
def _clean():
    tfi.deactivate()
    t_nr.reconfigure(NameResolveConfig(type="memory"))
    yield
    tfi.deactivate()


def _port_snap(snap: "js.FleetSnapshot") -> ts.FleetSnapshot:
    d = {f.name: getattr(snap, f.name) for f in dataclasses.fields(snap)}
    d["replicas"] = tuple(ts.ReplicaView(**dataclasses.asdict(r)) for r in snap.replicas)
    return ts.FleetSnapshot(**d)


def _port_pol(pol) -> SupervisorConfig:
    return SupervisorConfig(**dataclasses.asdict(pol))


def _acts(plan) -> list:
    return [(a.kind, a.target, a.role, a.reason) for a in plan]


@pytest.mark.parametrize("row", PLAN_TABLE, ids=[r[0] for r in PLAN_TABLE])
def test_plan_actions_equal_jax_on_the_table(row):
    name, snap, pol, expected, check = row
    want = js.plan_actions(snap, pol)
    got = ts.plan_actions(_port_snap(snap), _port_pol(pol))
    assert _acts(got) == _acts(want), name
    assert [a.kind for a in got] == ([] if expected is None else [expected]), name


_views = st.lists(st.builds(
    dict, alive=st.booleans(), role=st.sampled_from(["unified", "prefill", "decode"]),
    breaker_state=st.sampled_from(["closed", "open", "half_open"]),
    load=st.floats(0, 100, allow_nan=False)), max_size=6)
_kinds = st.sampled_from(["scale_up", "scale_down", "replace", "rerole"])


@settings(max_examples=300, deadline=None)
@given(views=_views, queue=st.integers(0, 20), shed=st.sampled_from([0.0, 0.5, 3.0]),
       util=st.floats(0, 3, allow_nan=False),
       share=st.one_of(st.none(), st.floats(0, 1, allow_nan=False)),
       last=st.dictionaries(_kinds, st.floats(900, 1000, allow_nan=False), max_size=3),
       inflight=st.booleans(), fails=st.integers(0, 4), pending=st.integers(0, 2),
       floor=st.integers(0, 4), cap=st.integers(1, 8), band=st.floats(0, 0.5, allow_nan=False),
       rerole=st.booleans())
def test_plan_actions_equal_jax_on_a_sweep(views, queue, shed, util, share, last, inflight,
                                           fails, pending, floor, cap, band, rerole):
    reps = tuple(dict(addr=f"r{i}:1", **v) for i, v in enumerate(views))
    kw = dict(now=1000.0, queue_depth=queue, shed_rate=shed, util=util, prefill_share=share,
              last_action_t=last, disruptive_inflight=inflight, spawn_failures=fails,
              pending_spawns=pending)
    pol = dict(min_replicas=floor, max_replicas=cap, rerole_band=band, rerole_enabled=rerole)
    want = js.plan_actions(js.FleetSnapshot(replicas=tuple(js.ReplicaView(**r) for r in reps),
                                            **kw), JaxSupervisorConfig(**pol))
    got = ts.plan_actions(ts.FleetSnapshot(replicas=tuple(ts.ReplicaView(**r) for r in reps),
                                           **kw), SupervisorConfig(**pol))
    assert _acts(got) == _acts(want) and len(got) <= 1
    n_alive = sum(1 for r in reps if r["alive"])
    if got and got[0].kind == "scale_down":
        assert n_alive - 1 >= max(1, floor)  # the floor holds


# -- the executor against the JAX one, on a fake clock -------------------------


class _Handle:
    def __init__(self, addr):
        self.addr = addr
        self.killed = threading.Event()

    def kill(self):
        self.killed.set()


def _settle(sup):
    """Wait for the port supervisor's spawns and transition."""
    for w in list(sup._workers):
        w.join(30)


def _crash_loop(mod):
    clock = {"t": 100.0}
    attempts = []

    def spawn_fn(role):
        attempts.append(role)
        raise RuntimeError("broken image")

    cfg = (JaxSupervisorConfig if mod is js else SupervisorConfig)(
        min_replicas=1, max_replicas=4, spawn_max_attempts=3, spawn_backoff_s=0.01,
        spawn_backoff_max_s=0.02, spawn_backoff_jitter=0.0, scale_up_cooldown_s=0.0,
        scale_up_queue_depth=1)
    sup = mod.FleetSupervisor("127.0.0.1:1", spawn_fn, config=cfg, time_fn=lambda: clock["t"])
    log = []
    if mod is js:
        async def router():
            return {"queue_depth": 10}  # pressure that never ends

        async def healths():
            return []

        async def run():
            sup._poll_router, sup._poll_healths = router, healths
            for _ in range(25):
                await sup._tick()
                for _ in range(200):
                    await asyncio.sleep(0.005)
                    if not any(s.spawning for s in sup._slots.values()):
                        break
                clock["t"] += 1.0
                log.append(dict(sup.get_metrics()))
            await close_current_session()
        asyncio.run(run())
    else:
        sup._poll_router = lambda: {"queue_depth": 10}
        sup._poll_healths = lambda: []
        for _ in range(25):
            sup._tick()
            _settle(sup)
            clock["t"] += 1.0
            log.append(dict(sup.get_metrics()))
    return log, attempts


def _replace_dead(mod):
    clock = {"t": 100.0}
    spawned = []
    dead, ok = _Handle("dead:1"), _Handle("ok:1")

    def spawn_fn(role):
        h = _Handle(f"new{len(spawned)}:1")
        spawned.append(h)
        return h

    cfg = (JaxSupervisorConfig if mod is js else SupervisorConfig)(
        min_replicas=2, max_replicas=4, spawn_max_attempts=3, spawn_backoff_s=0.01,
        replace_cooldown_s=0.0, health_fail_threshold=2)
    sup = mod.FleetSupervisor("127.0.0.1:1", spawn_fn, config=cfg, time_fn=lambda: clock["t"])
    sup.adopt(dead)
    sup.adopt(ok)

    def healths():
        return [(s.slot_id, s.addr != "dead:1") for s in sup._slots.values()
                if s.handle is not None]

    log = []
    if mod is js:
        async def router():
            return {}

        async def ahealths():
            return healths()

        async def run():
            sup._poll_router, sup._poll_healths = router, ahealths
            for _ in range(8):
                await sup._tick()
                for _ in range(200):
                    await asyncio.sleep(0.005)
                    if not any(s.spawning for s in sup._slots.values()):
                        break
                if sup._disruptive_task is not None:
                    await sup._disruptive_task
                clock["t"] += 1.0
                log.append(dict(sup.get_metrics()))
            await close_current_session()
        asyncio.run(run())
    else:
        sup._poll_router = lambda: {}
        sup._poll_healths = healths
        for _ in range(8):
            sup._tick()
            _settle(sup)
            clock["t"] += 1.0
            log.append(dict(sup.get_metrics()))
    slots = sorted((s.addr, s.health_fails) for s in sup._slots.values())
    return log, (dead.killed.is_set(), ok.killed.is_set(), [h.addr for h in spawned], slots)


def test_crash_loop_escalates_as_jax():
    want, w_attempts = _crash_loop(js)
    got, g_attempts = _crash_loop(ts)
    drop = ("replica_seconds",)
    assert [{k: v for k, v in m.items() if k not in drop} for m in got] == [
        {k: v for k, v in m.items() if k not in drop} for m in want]
    assert len(g_attempts) == len(w_attempts) == 3  # no fourth try
    m = got[-1]
    assert m["crash_loops_total"] == 1 and m["scale_ups_total"] == 1
    assert m["crash_looped_slots"] == 1 and m["spawn_failures_total"] == 3


def test_replace_of_a_dead_replica_as_jax():
    want, w_end = _replace_dead(js)
    got, g_end = _replace_dead(ts)
    assert [m["replacements_total"] for m in got] == [m["replacements_total"] for m in want]
    assert got[-1] == want[-1]
    assert g_end == w_end == (True, False, ["new0:1"], [("new0:1", 0), ("ok:1", 0)])
    assert got[-1]["kills_total"] == 1 and got[-1]["fleet_alive"] == 2


def test_supervisor_endpoints():
    ((eng, h),) = _stub_fleet(1)
    sup = ts.FleetSupervisor("127.0.0.1:1", lambda role: None,
                             config=SupervisorConfig(tick_interval_s=0.05, min_replicas=1))
    sup.adopt(h)
    addr = sup.start("127.0.0.1", 0)
    try:
        assert request_with_retry(addr, "/health", method="GET")["status"] == "ok"
        time.sleep(0.3)
        body = request_with_retry(addr, "/supervisor", method="GET")
        for key in ("scale_ups_total", "scale_downs_total", "replacements_total",
                    "reroles_total", "crash_loops_total", "drain_rollbacks_total",
                    "fleet_alive", "replica_seconds", "slots", "ticks_total"):
            assert key in body, key
        assert body["ticks_total"] >= 2 and body["fleet_alive"] == 1
        assert body["slots"] == [dict(slot_id=0, role="unified", addr=h.addr, alive=True,
                                      spawning=False, fail_count=0, crash_looped=False,
                                      health_fails=0)]
        assert body["kills_total"] == 0  # at the floor, blind to the router
    finally:
        sup.stop()
        h.srv.stop()


# -- the transitions against port decode servers ------------------------------


class _DrainStub:
    """A decode engine with nothing to export, counting the drains that
    reach it."""

    config = TorchDecodeConfig()

    def __init__(self):
        self.drains = 0

    def get_version(self):
        return 0

    def get_metrics(self):
        return {"active_tokens": 0}

    def pause_generation(self):
        self.drains += 1

    def continue_generation(self):
        pass

    def abort_all(self):
        return 0

    def list_exportable_sessions(self):
        return []


class _InProc:
    """A replica handle over an in-process server."""

    def __init__(self, srv, eng=None):
        self.srv, self.eng, self.addr = srv, eng, srv.addr
        self.killed = False

    def kill(self):
        self.killed = True
        self.srv.stop()
        if self.eng is not None and hasattr(self.eng, "destroy"):
            self.eng.destroy()


def _stub_fleet(n=2):
    out = []
    for _ in range(n):
        eng = _DrainStub()
        srv = DecodeServer(eng.config, engine=eng)
        srv.start("127.0.0.1", 0)
        out.append((eng, _InProc(srv)))
    return out


def _idle_sup(handles, **cfg):
    """A supervisor whose router reads idle: it plans a scale-down."""
    sup = ts.FleetSupervisor("127.0.0.1:1", lambda role: None, config=SupervisorConfig(
        min_replicas=1, max_replicas=len(handles), scale_down_cooldown_s=0.0,
        drain_deadline_s=5.0, **cfg))
    for h in handles:
        sup.adopt(h)
    sup._poll_router = lambda: {"token_loads": {h.addr: float(i) for i, h in
                                                enumerate(handles)}}
    return sup


def test_scale_down_drains_then_kills():
    (e0, h0), (e1, h1) = _stub_fleet()
    sup = _idle_sup([h0, h1])
    try:
        sup._tick()
        _settle(sup)
        m = sup.get_metrics()
        assert e0.drains == 1 and h0.killed and not h1.killed  # the least loaded
        assert m["scale_downs_total"] == 1 and m["kills_total"] == 1
        sup._tick()
        _settle(sup)
        assert sup.get_metrics()["scale_downs_total"] == 1  # at the floor
    finally:
        h1.srv.stop()


def test_drain_past_its_deadline_rolls_back_unsent():
    (e0, h0), (e1, h1) = _stub_fleet()
    sup = _idle_sup([h0, h1])
    sup.config.drain_deadline_s = 0.3
    tfi.configure(tfi.FaultPlan(points=[tfi.FaultPoint(site="supervisor.drain", mode="delay",
                                                       at=(0,), delay_s=0.8)]))
    try:
        sup._tick()
        _settle(sup)
        m = sup.get_metrics()
        assert m["drain_rollbacks_total"] == 1 and m["kills_total"] == 0
        assert not h0.killed and e0.drains == 0  # the hung drain was never sent
        assert request_with_retry(h0.addr, "/health", method="GET")["status"] == "ok"
    finally:
        tfi.deactivate()
        h0.srv.stop()
        h1.srv.stop()


def test_kill_abort_leaves_the_replica_for_the_next_tick():
    (e0, h0), (e1, h1) = _stub_fleet()
    sup = _idle_sup([h0, h1])
    tfi.configure(tfi.FaultPlan(points=[tfi.FaultPoint(site="supervisor.kill", mode="abort",
                                                       at=(0,), times=1)]))
    try:
        sup._tick()
        _settle(sup)
        assert not h0.killed and sup.get_metrics()["scale_downs_total"] == 0
        sup._tick()  # replans; the repeated drain finds nothing to export
        _settle(sup)
        m = sup.get_metrics()
        assert h0.killed and m["scale_downs_total"] == 1 and m["kills_total"] == 1
        assert e0.drains == 2
    finally:
        tfi.deactivate()
        h1.srv.stop()


def test_health_aborts_replace_the_replica():
    (e0, h0), (e1, h1) = _stub_fleet()
    spawned = []

    def spawn_fn(role):
        eng = _DrainStub()
        srv = DecodeServer(eng.config, engine=eng)
        srv.start("127.0.0.1", 0)
        spawned.append(_InProc(srv))
        return spawned[-1]

    sup = ts.FleetSupervisor("127.0.0.1:1", spawn_fn, config=SupervisorConfig(
        min_replicas=2, max_replicas=2, health_fail_threshold=2, replace_cooldown_s=0.0))
    sup.adopt(h0)
    sup.adopt(h1)
    sup._poll_router = lambda: {}
    tfi.configure(tfi.FaultPlan(points=[tfi.FaultPoint(
        site="supervisor.health", mode="abort", times=2, match={"target": h0.addr})]))
    try:
        for _ in range(3):
            sup._tick()
            _settle(sup)
        m = sup.get_metrics()
        assert m["replacements_total"] == 1 and m["kills_total"] == 1 and h0.killed
        assert e0.drains == 0  # unreachable: killed without a drain
        assert len(spawned) == 1 and m["spawn_attempts_total"] == 1
        assert sorted(s.addr for s in sup._slots.values()) == sorted([h1.addr, spawned[0].addr])
    finally:
        tfi.deactivate()
        for h in [h1] + spawned:
            h.srv.stop()


# -- end to end: a drain-first scale-down under live traffic ------------------------

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, dtype="float32",
          param_dtype="float32")
DECODE = dict(page_size=8, new_tokens_per_chunk=4, dtype="float32", kv_cache_dtype="float32",
              context_length=512, max_running_requests=4, kv_migrate_chunk_mb=0.002)


def test_scale_down_drains_first_under_live_traffic():
    jp = jq.init_params(jq.ModelConfig(**KW), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), tq.ModelConfig(**KW))

    def engine(**cfg):
        eng = TorchDecodeEngine(TorchDecodeConfig(**dict(DECODE, **cfg)), device="cpu")
        eng.set_model(params, tq.ModelConfig(**KW))
        return eng.initialize() or eng

    rng = np.random.default_rng(5)
    prompts = {f"s{i}": rng.integers(1, 64, int(rng.integers(10, 30))).tolist()
               for i in range(4)}
    g = GenerationHyperparameters(max_new_tokens=200, greedy=True)
    oracle = engine(max_running_requests=8)
    try:
        async def ref():
            return await asyncio.gather(*[oracle.agenerate(ModelRequest(
                rid=r, input_ids=p, gconfig=g)) for r, p in prompts.items()])
        want = {r: (list(o.output_tokens), list(o.output_logprobs))
                for r, o in zip(prompts, asyncio.run(ref()))}
    finally:
        oracle.destroy()

    engines = [engine(), engine()]
    servers = [DecodeServer(e.config, engine=e) for e in engines]
    handles = [_InProc(s, e) for s, e in zip(servers, engines)]
    for s in servers:
        s.start("127.0.0.1", 0)
        handles[servers.index(s)].addr = s.addr
    addrs = [s.addr for s in servers]
    for a in addrs:
        t_nr.add(t_names.gen_server("fexp", "ft", a), a)
    router = DecodeRouter("fexp", "ft", config=RouterConfig(
        schedule_policy="round_robin", health_poll_interval=0.1, dead_after_failures=2))
    raddr = router.start("127.0.0.1", 0)
    sup = ts.FleetSupervisor(raddr, lambda role: None, experiment_name="fexp", trial_name="ft",
                             config=SupervisorConfig(
                                 min_replicas=1, max_replicas=2, scale_down_util=1.0,
                                 scale_down_cooldown_s=0.0, tick_interval_s=0.1,
                                 drain_deadline_s=60.0))
    for h in handles:
        sup.adopt(h)
    client = RemoteInfEngine(InferenceEngineConfig(experiment_name="fexp", trial_name="ft",
                                                   request_timeout=120, request_retries=2,
                                                   fleet_failover_retries=3))
    client.addresses = list(addrs)
    out: dict = {}

    def traffic():
        async def go():
            return await asyncio.gather(*[client.agenerate(ModelRequest(
                rid=r, input_ids=p, gconfig=g)) for r, p in prompts.items()])
        out["r"] = asyncio.run(go())

    try:
        time.sleep(0.4)
        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        deadline = time.monotonic() + 60
        while not all(e.get_metrics()["running_requests"] >= 2
                      and e.get_metrics()["generated_tokens_total"] >= 8 for e in engines):
            assert time.monotonic() < deadline, "traffic never ran on both servers"
            time.sleep(0.005)
        sup.start("127.0.0.1", 0)
        t.join(120)
        assert "r" in out, "the clients did not finish"
        deadline = time.monotonic() + 30
        while sup.get_metrics()["kills_total"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        sup.stop()
        m = sup.get_metrics()
        victim = next(i for i, h in enumerate(handles) if h.killed)
        survivor = engines[1 - victim]
        sm = survivor.get_metrics()
        vserver = servers[victim]
        rm = request_with_retry(raddr, "/metrics", method="GET")
    finally:
        sup.stop()
        router.stop()
        for h in handles:
            if not h.killed:
                h.kill()
    got = {r: (list(o.output_tokens), list(o.output_logprobs)) for r, o in zip(prompts, out["r"])}
    assert got == want  # greedy tokens and logprobs, joined across the drain
    assert m["scale_downs_total"] == 1 and m["kills_total"] == 1
    assert m["drain_rollbacks_total"] == 0
    stats = vserver._migrate_stats
    assert stats["out_sessions"] == 2 and stats["out_failures"] == 0, stats
    assert sm["kv_migrated_in_sessions_total"] == 2
    assert sm["kv_host_hits_total"] == 2  # every resume promoted
    assert sm["prefills_total"] == 2  # only its own two fresh admissions
    assert sm["kv_migrated_in_bytes_total"] % sm["kv_block_nbytes"] == 0
    assert rm["tracked_qids"] == 0  # every qid released


# -- the launcher's spawn seam -------------------------------------------------


def test_spawn_decode_server_on_the_cpu(tmp_path):
    from areal_tpu_torch.models.smoke import SMOKE_MODEL_DICT

    nr = NameResolveConfig(type="nfs", nfs_record_root=str(tmp_path / "nr"))
    t_nr.reconfigure(nr)
    launcher = LocalLauncher("sexp", "st", str(tmp_path))
    h = launcher.spawn_decode_server(
        model_path="synthetic-arith", env=t_nr.to_env(nr), timeout=120,
        extra_args=["--device", "cpu", "--dtype", "float32", "--context-length", "256",
                    "--max-running-requests", "2", "--scratch-model",
                    json.dumps(SMOKE_MODEL_DICT)])
    try:
        assert t_nr.get(t_names.gen_server("sexp", "st", h.addr)) == h.addr
        assert request_with_retry(h.addr, "/health", method="GET")["role"] == "unified"
        out = request_with_retry(h.addr, "/generate", payload=dict(
            input_ids=[1, 2, 3], gconfig=dict(max_new_tokens=4, greedy=True)), timeout=60)
        assert len(out["output_tokens"]) == 4
        assert launcher.jobs == [h.job]
    finally:
        h.kill()
    assert launcher.jobs == [] and h.job.proc.poll() is not None
