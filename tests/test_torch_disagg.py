"""The port's prefill/decode roles against the JAX package's, on the CPU:
prefill-only admissions (`aprefill`, `/prefill`), the client's handoff, the
router's disaggregated pick and fabric decisions, the supervisor's re-role
and warm start, and a decode server spawned with a role. The scenarios are
those of `tests/test_kv_migration.py` (:131, :336, :641-692) and
`tests/test_kv_fabric.py`'s router cases.

- A prefill-only request parks exactly `prompt[:-1]`, with JAX's counters
  (a group of duplicates forks the first member's prefill), and its resume
  here prefills nothing and streams as a never-parked request would:
  tokens exact, logprobs equal.
- `/prefill` with a target streams the session to a port decode server,
  from a port prefill server and from a JAX one; a replay with the same
  xid answers the cached result, a replayed `/kv_commit` deduplicates,
  and the decode replica's `/generate` resumes with no prefill, with the
  stream of an engine that prefilled itself (tokens exact, logprobs
  within 1e-5).
- The router: the same probes and requests fed to JAX's router and the
  port's give the same placements (`url`, `prefill_url`, the `kv_fabric`
  hint), counters, costs and fabric index: the disaggregated pick, a
  unified fleet with no `prefill_url`, the degrade when every prefill
  replica is saturated, a priced remote-fetch hint, a fabric-local route,
  and the index dropped on failover.
- End to end: a port router over a prefill and a decode replica, and a
  `RemoteInfEngine` whose requests are all handed off; streams equal one
  in-process engine's.
- The supervisor, with a fake clock: a prefill share past `rerole_band`
  drains a decode replica and flips it through `/set_role`; a spawned
  replica is warm-started from its peers before it is registered.
- `LocalLauncher.spawn_decode_server("prefill")` on the CPU reports its
  role on `/health`.
"""

import asyncio
import json
import threading
import time

import numpy as np
import pytest

import jax

from areal_tpu.api import cli_args as j_cli
from areal_tpu.api.io_struct import ModelRequest as JaxRequest
from areal_tpu.engine.jax_decode import JaxDecodeEngine
from areal_tpu.launcher import router as jr
from areal_tpu.models import qwen2 as jq
from areal_tpu_torch.api import cli_args as t_cli
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.core import kv_fabric
from areal_tpu_torch.core.remote_inf_engine import RemoteInfEngine
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.launcher import router as tr
from areal_tpu_torch.launcher import supervisor as ts
from areal_tpu_torch.launcher.decode_server import DecodeServer
from areal_tpu_torch.launcher.local import LocalLauncher
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy
from areal_tpu_torch.utils import name_resolve as t_nr
from areal_tpu_torch.utils import names as t_names
from areal_tpu_torch.utils.http import request_with_retry
from tests.test_remote_inf_engine import _ServerThread

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, dtype="float32",
          param_dtype="float32")
LOGP_ATOL = 1e-5
GREEDY = dict(max_new_tokens=10, greedy=True)
SAMPLED = dict(max_new_tokens=10, temperature=0.8, top_p=0.9)


@pytest.fixture(autouse=True)
def _memory_names():
    t_nr.reconfigure(t_cli.NameResolveConfig(type="memory"))
    yield


@pytest.fixture(scope="module")
def weights():
    jparams = jq.init_params(jq.ModelConfig(**KW), jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), tq.ModelConfig(**KW))


def _engine(weights, jax_engine=False, **kw):
    base = dict(context_length=256, max_running_requests=3, new_tokens_per_chunk=4,
                page_size=8, kv_migrate_chunk_mb=0.01, dtype="float32",
                kv_cache_dtype="float32")
    base.update(kw)
    if jax_engine:
        eng = JaxDecodeEngine(j_cli.JaxDecodeConfig(paged_attn_impl="xla", **base),
                              j_cli.InferenceEngineConfig())
        eng.set_model(weights[0], jq.ModelConfig(**KW))
    else:
        eng = TorchDecodeEngine(t_cli.TorchDecodeConfig(**base), device="cpu")
        eng.set_model(weights[1], tq.ModelConfig(**KW))
    eng.initialize()
    return eng


def _req(eng, ids, rid, g):
    if isinstance(eng, JaxDecodeEngine):
        return JaxRequest(rid=rid, input_ids=list(ids),
                          gconfig=j_cli.GenerationHyperparameters(**g))
    return ModelRequest(rid=rid, input_ids=list(ids),
                        gconfig=t_cli.GenerationHyperparameters(**g))


def _gen(eng, ids, rid, g=GREEDY):
    return eng.generate(_req(eng, ids, rid, g), timeout=120)


def _prefill_all(eng, reqs):
    """aprefill each (ids, rid) in one admission wave."""
    out = []

    def run():
        async def go():
            return await asyncio.gather(*[eng.aprefill(_req(eng, ids, rid, GREEDY))
                                          for ids, rid in reqs])
        out.extend(asyncio.run(go()))

    eng.pause_generation()
    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while eng._request_q.qsize() < len(reqs):
        assert time.monotonic() < deadline
        time.sleep(0.005)
    eng.continue_generation()
    t.join(120)
    return out


def _prompt(n, seed=3):
    return np.random.RandomState(seed).randint(1, 64, (n,)).tolist()


def _post(addr, endpoint, payload=None, method="POST"):
    return request_with_retry(addr, endpoint, payload=payload, method=method, max_retries=1,
                              timeout=120)


class _Port:
    def __init__(self, eng):
        self.eng, self.srv = eng, DecodeServer(eng.config, engine=eng)
        self.addr = self.srv.start("127.0.0.1", 0)

    def stop(self):
        self.srv.stop()


# -- prefill-only admissions -------------------------------------------------


@pytest.mark.parametrize("gname", ["greedy", "sampled"])
def test_prefill_only_parks_the_prompt_and_resumes_locally(weights, gname):
    g = GREEDY if gname == "greedy" else SAMPLED
    prompt = _prompt(40)
    oracle = _engine(weights)
    try:
        want = _gen(oracle, prompt, "a", g)
    finally:
        oracle.destroy()
    counts = {}
    for jax_engine in (False, True):
        eng = _engine(weights, jax_engine)
        try:
            (r,) = _prefill_all(eng, [(prompt, "a")])
            assert r.stop_reason == "prefill" and r.output_tokens == []
            assert eng.list_exportable_sessions() == ["a"]
            assert eng._parked_tokens["a"] == prompt[:-1]
            m0 = eng.get_metrics()
            full = _gen(eng, prompt, "a", g)
            m1 = eng.get_metrics()
            assert m1["prefills_total"] == m0["prefills_total"] == 1
            assert eng.list_exportable_sessions() == []
            assert full.output_tokens == want.output_tokens
            np.testing.assert_allclose(full.output_logprobs, want.output_logprobs,
                                       atol=0 if not jax_engine else LOGP_ATOL, rtol=0)
            # a group of duplicates: one prefill, the rest fork it
            group = _prefill_all(eng, [(_prompt(40, 9), f"g{i}") for i in range(3)])
            assert [x.stop_reason for x in group] == ["prefill"] * 3
            m = eng.get_metrics()
            counts[jax_engine] = {k: m[k] for k in ("prefills_total", "prefix_forks_total",
                                                    "suffix_prefills_total")}
            assert sorted(eng.list_exportable_sessions()) == ["g0", "g1", "g2"]
        finally:
            eng.destroy()
    assert counts[False] == counts[True] == dict(prefills_total=2, prefix_forks_total=2,
                                                 suffix_prefills_total=0)


@pytest.mark.parametrize("prefill_pkg", ["torch", "jax"])
def test_prefill_handoff_over_http_and_commit_idempotency(weights, prefill_pkg):
    prompt = _prompt(40, 17)
    oracle = _engine(weights)
    try:
        want = _gen(oracle, prompt, "hh")
    finally:
        oracle.destroy()
    pre = _engine(weights, jax_engine=prefill_pkg == "jax", role="prefill")
    dec = _engine(weights, role="decode")
    ps = _ServerThread(pre) if prefill_pkg == "jax" else _Port(pre)
    ds = _Port(dec)
    body = dict(rid="hh", input_ids=prompt, gconfig=GREEDY, target=ds.addr, xid="handoff-1")
    try:
        out = _post(ps.addr, "/prefill", body)
        assert out["stop_reason"] == "prefill" and out["migrated"] is True
        nb = -(-(len(prompt) - 1) // 8)
        block = dec.get_metrics()["kv_block_nbytes"]
        assert out["kv_bytes"] > nb * block
        again = _post(ps.addr, "/prefill", body)  # a lost reply, replayed
        assert again["dedup"] == "completed" and again["kv_bytes"] == out["kv_bytes"]
        m0 = _post(ds.addr, "/metrics", method="GET")
        assert m0["kv_migrated_in_sessions_total"] == 1
        assert m0["kv_migrated_in_bytes_total"] == nb * block
        commit = _post(ds.addr, "/kv_commit", {"xid": "handoff-1"})
        assert commit["dedup"] is True and commit["imported"] == 1
        got = _post(ds.addr, "/generate", dict(rid="hh", input_ids=prompt, gconfig=GREEDY))
        m1 = _post(ds.addr, "/metrics", method="GET")
        assert m1["kv_migrated_in_sessions_total"] == 1  # imported once
        assert m1["prefills_total"] == m0["prefills_total"] == 0
        assert m1["kv_host_hits_total"] == 1 and m1["ttft_transfer_p99_ms"] > 0
        assert got["output_tokens"] == want.output_tokens
        np.testing.assert_allclose(got["output_logprobs"], want.output_logprobs,
                                   atol=LOGP_ATOL, rtol=0)
        pm = _post(ps.addr, "/metrics", method="GET")
        assert pm["kv_migrated_out_sessions_total"] == 1 and pm["role"] == "prefill"
    finally:
        ds.stop()
        ps.stop()
        pre.destroy()
        dec.destroy()


# -- the router's decisions --------------------------------------------------


def _routers(servers, roles, pressure, fabric=None, **cfg):
    out = []
    for mod, cls in ((jr, j_cli.RouterConfig), (tr, t_cli.RouterConfig)):
        r = mod.DecodeRouter(servers=list(servers), config=cls(**cfg))
        r.servers = list(servers)
        r._roles = dict(roles)
        r._pressure = {s: dict(p) for s, p in pressure.items()}
        r._versions = {s: 0 for s in servers}
        r._fabric_index = {s: set(k) for s, k in (fabric or {}).items()}
        out.append(r)
    return out


def _view(r, out):
    """What the two routers must agree on after one placement."""
    place = None if out is None else {k: out.get(k) for k in
                                      ("url", "version", "prefill_url", "kv_fabric")}
    return dict(place=place, counters={k: r._counters[k] for k in tr.DecodeRouter()._counters},
                cost={q: round(c, 9) for q, c in r._qid_cost.items()},
                est={s: round(e, 9) for s, e in r._est_since_poll.items() if e},
                prefixes=[(h, s) for h, (s, _) in r._prefix_map.items()],
                fabric={s: sorted(k) for s, k in r._fabric_index.items()})


def _schedule_both(routers, reqs):
    views = []
    for r in routers:
        views.append([_view(r, r._try_schedule_locked(dict(q))) for q in reqs])
    assert views[1] == views[0]
    return views[1]


PREFIX = list(range(128))
DISAGG = (["p1:1", "p2:1", "d1:1", "d2:1"],
          {"p1:1": "prefill", "p2:1": "prefill", "d1:1": "decode", "d2:1": "decode"},
          {"d1:1": dict(kv_blocks_total=100, kv_block_size=8, kv_tokens_allocated=760,
                        kv_host_pool_enabled=True),
           "d2:1": dict(kv_blocks_total=100, kv_block_size=8, kv_tokens_allocated=80,
                        kv_host_pool_enabled=True),
           "p1:1": dict(kv_blocks_total=100, kv_block_size=8, kv_tokens_allocated=0),
           "p2:1": dict(kv_blocks_total=100, kv_block_size=8, kv_tokens_allocated=0)})


def test_router_disagg_pick_equals_jax():
    routers = _routers(*DISAGG)
    q = dict(prompt_len=128, new_token_budget=64, input_prefix=PREFIX)
    views = _schedule_both(routers, [dict(q, qid="q1"), dict(q, qid="q2"), dict(q, qid="q1"),
                                     dict(prompt_len=30, new_token_budget=8, qid="short")])
    first, second, resume, short = (v["place"] for v in views)
    assert first["url"] == "d2:1" and first["prefill_url"] in ("p1:1", "p2:1")
    assert second["prefill_url"] == first["prefill_url"]  # prefill affinity
    assert resume["url"] == first["url"] and resume["prefill_url"] is None
    assert short["prefill_url"] is not None
    assert views[0]["cost"]["q1"] == pytest.approx(0.4 * 64)  # the decode share only
    assert views[-1]["counters"]["disagg_schedules_total"] == 3


def test_router_unified_fleet_has_no_prefill_url():
    routers = _routers(["a:1", "b:1"], {"a:1": "unified", "b:1": "unified"}, {})
    views = _schedule_both(routers, [dict(qid="q", prompt_len=32, new_token_budget=16)])
    assert views[0]["place"]["prefill_url"] is None
    assert views[0]["counters"]["disagg_schedules_total"] == 0


def test_router_disagg_degrades_when_prefill_replicas_saturated():
    routers = _routers(["p1:1", "d1:1"], {"p1:1": "prefill", "d1:1": "decode"}, {
        "p1:1": dict(kv_blocks_total=10, kv_block_size=8, kv_tokens_allocated=80),
        "d1:1": dict(kv_blocks_total=100, kv_block_size=8, kv_tokens_allocated=0,
                     kv_host_pool_enabled=True)})
    views = _schedule_both(routers, [dict(qid="q", prompt_len=128, new_token_budget=64)])
    assert views[0]["place"]["url"] == "d1:1" and views[0]["place"]["prefill_url"] is None
    # the decode replica prefills itself, charged the whole request
    assert views[0]["cost"]["q"] == pytest.approx(128 + 0.4 * 64)


def _chain(prefix, version=0, dtype="bfloat16"):
    cfg = t_cli.RouterConfig()
    nb = min(len(prefix) // cfg.prefix_block_tokens, cfg.prefix_max_blocks)
    return kv_fabric.chain_keys(prefix, cfg.prefix_block_tokens, version, dtype, max_blocks=nb)


def test_router_fabric_hint_and_local_route_equal_jax():
    prefix = _prompt(256, 24)
    chain = _chain(prefix)
    q = dict(prompt_len=256, new_token_budget=10, group_size=1, input_prefix=prefix)
    # s2 holds the run but is far too hot: s1, with a priced fetch hint
    routers = _routers(["s1", "s2"], {}, {}, fabric={"s2": chain},
                       schedule_policy="prefix_affinity")
    for r in routers:
        r._measured_tokens["s2"] = 1e9
    (hint,) = _schedule_both(routers, [dict(q, qid="q1")])
    assert hint["place"]["url"] == "s1" and hint["place"]["kv_fabric"]["peer"] == "s2"
    assert kv_fabric.decode_digest(hint["place"]["kv_fabric"]["keys"]) == chain
    assert hint["counters"]["fabric_remote_hints_total"] == 1
    assert hint["cost"]["q1"] == pytest.approx(256 + 0.4 * 10 - 4 * 64 * 0.75)
    # no affinity entry, s2 cool: routed to the holder, nothing to fetch
    routers = _routers(["s1", "s2"], {}, {}, fabric={"s2": chain},
                       schedule_policy="prefix_affinity")
    (local,) = _schedule_both(routers, [dict(q, qid="q2")])
    assert local["place"]["url"] == "s2" and local["place"]["kv_fabric"] is None
    assert local["counters"]["fabric_local_routes_total"] == 1
    # kv_fabric off: neither
    routers = _routers(["s1", "s2"], {}, {}, fabric={"s2": chain},
                       schedule_policy="prefix_affinity", kv_fabric=False)
    (off,) = _schedule_both(routers, [dict(q, qid="q3")])
    assert off["counters"]["fabric_local_routes_total"] == 0 and off["place"]["kv_fabric"] is None


def test_router_fabric_index_follows_polls_and_failover():
    prefix = _prompt(256, 25)
    chain = _chain(prefix, dtype="fp")
    servers = ["a:1", "b:1"]

    def probe(s, digest="", v=1):
        p = dict(active_tokens=0, kv_dtype="fp", kv_fabric_digest=digest, role="unified")
        return (s, v, 0.0, 0.0, p, 0.01, "unified")

    routers = _routers(servers, {}, {})
    steps = [
        [probe("a:1", kv_fabric.encode_digest(chain[:2])), probe("b:1")],
        [probe("a:1", kv_fabric.encode_digest(chain)), probe("b:1", "!!!")],
        [(s, None, None, 0.0, None, 0.01, "unified") for s in servers],
    ]
    for r in routers:
        r.config.dead_after_failures = 1
    logs = []
    for r in routers:
        log = []
        for probes in steps:
            r._apply_probes_locked(servers, probes)
            log.append({s: sorted(k) for s, k in r._fabric_index.items()})
        logs.append(log)
    assert logs[1] == logs[0]
    assert logs[0][0] == {"a:1": sorted(chain[:2])}
    # a garbled digest advertises nothing
    assert logs[0][1] == {"a:1": sorted(chain), "b:1": []}
    assert logs[0][2] == {}  # failed over: it serves no fetch


# -- end to end through the router ------------------------------------------


def test_client_hands_off_every_request_through_the_router(weights):
    prompts = [_prompt(20 + 7 * i, 60 + i) for i in range(4)]
    oracle = _engine(weights)
    try:
        want = [_gen(oracle, p, f"e{i}") for i, p in enumerate(prompts)]
    finally:
        oracle.destroy()
    # three slots for four prompts: a parked session that the next
    # admission evicts before its export is offloaded, and exported from
    # the host tier
    pre = _engine(weights, role="prefill", kv_host_pool_mb=16.0)
    dec = _engine(weights, role="decode")
    ps, ds = _Port(pre), _Port(dec)
    router = tr.DecodeRouter("dexp", "dt", [ps.addr, ds.addr],
                             config=t_cli.RouterConfig(health_poll_interval=0.1))
    raddr = router.start("127.0.0.1", 0)
    try:
        deadline = time.monotonic() + 10
        while set(router._roles.values()) != {"prefill", "decode"}:
            assert time.monotonic() < deadline, router._roles
            time.sleep(0.02)
        assert t_nr.get(t_names.rollout_router("dexp", "dt")) == raddr
        client = RemoteInfEngine(t_cli.InferenceEngineConfig(
            experiment_name="dexp", trial_name="dt", request_timeout=60))
        client.addresses = [ps.addr, ds.addr]

        async def go():
            return await asyncio.gather(*[client.agenerate(ModelRequest(
                rid=f"e{i}", input_ids=p, gconfig=t_cli.GenerationHyperparameters(**GREEDY)))
                for i, p in enumerate(prompts)])

        got = asyncio.run(asyncio.wait_for(go(), 120))
        md, mp = dec.get_metrics(), pre.get_metrics()
        mr = _post(raddr, "/metrics", method="GET")
    finally:
        router.stop()
        ds.stop()
        ps.stop()
        pre.destroy()
        dec.destroy()
    for a, b in zip(want, got):
        assert b.output_tokens == a.output_tokens
        np.testing.assert_allclose(b.output_logprobs, a.output_logprobs, atol=LOGP_ATOL,
                                   rtol=0)
    assert md["prefills_total"] == 0 and md["kv_migrated_in_sessions_total"] == 4
    assert md["kv_host_hits_total"] == 4
    assert mp["prefills_total"] == 4 and mp["kv_migrated_out_sessions_total"] == 4
    assert mr["disagg_schedules_total"] == 4 and mr["tracked_qids"] == 0
    assert mr["roles"] == {ps.addr: "prefill", ds.addr: "decode"}


# -- the supervisor ----------------------------------------------------------


class _Handle:
    def __init__(self, port):
        self.port, self.addr = port, port.addr
        self.killed = False

    def kill(self):
        self.killed = True
        self.port.stop()


def test_supervisor_reroles_a_decode_replica_on_a_prefill_heavy_mix(weights):
    engines = [_engine(weights, role=r) for r in ("prefill", "decode", "decode")]
    ports = [_Port(e) for e in engines]
    clock = {"t": 100.0}
    sup = ts.FleetSupervisor("127.0.0.1:1", lambda role: None, time_fn=lambda: clock["t"],
                             config=t_cli.SupervisorConfig(
                                 min_replicas=1, max_replicas=3, rerole_cooldown_s=0.0,
                                 rerole_band=0.25, drain_deadline_s=30.0,
                                 scale_up_util=2.0, scale_down_util=-1.0))
    for p, e in zip(ports, engines):
        sup.adopt(_Handle(p), role=e.config.role)
    secs = {p.addr: [0.0, 0.0] for p in ports}

    def router():
        # prefill seconds grow and nothing else does: the prefill share is 1
        for s in secs.values():
            s[0] += 1.0
        return {"roles": {p.addr: e.config.role for p, e in zip(ports, engines)},
                "pressure": {a: dict(prefill_secs_total=s[0], device_busy_s=s[1])
                             for a, s in secs.items()},
                "token_loads": {a: 0.0 for a in secs}}

    sup._poll_router = router
    try:
        for _ in range(3):
            sup._tick()
            for w in list(sup._workers):
                w.join(30)
            clock["t"] += 1.0
        m = sup.get_metrics()
        roles = [_post(p.addr, "/health", method="GET")["role"] for p in ports]
    finally:
        for p in ports:
            p.stop()
        for e in engines:
            e.destroy()
    assert m["reroles_total"] == 1 and m["drain_rollbacks_total"] == 0
    assert sorted(roles) == ["decode", "prefill", "prefill"]


def test_supervisor_warm_starts_a_spawned_replica(weights):
    prompt = _prompt(96, 43)
    a = _engine(weights)
    pa = _Port(a)
    spawned = []

    def spawn(role):
        eng = _engine(weights)
        spawned.append((eng, _Port(eng)))
        return _Handle(spawned[-1][1])

    sup = ts.FleetSupervisor("127.0.0.1:1", spawn, config=t_cli.SupervisorConfig(
        min_replicas=2, max_replicas=2, warm_start_sessions=2))
    sup.adopt(_Handle(pa))
    sup._poll_router = lambda: {"queue_depth": 10}  # pressure: scale up
    registered = []
    sup._register = lambda addr: registered.append(
        (addr, spawned[-1][0].get_metrics()["kv_fabric_sessions_in_total"]))
    try:
        _gen(a, prompt, "w1")
        sup._tick()
        for w in list(sup._workers):
            w.join(60)
        (eng, port), = spawned
        m0 = eng.get_metrics()
        r = _gen(eng, prompt, "w2")
        m1 = eng.get_metrics()
    finally:
        pa.stop()
        a.destroy()
        for eng, port in spawned:
            port.stop()
            eng.destroy()
    # the warm start landed before the replica was registered
    assert registered == [(port.addr, 1)]
    assert m1["kv_fabric_remote_hits_total"] - m0["kv_fabric_remote_hits_total"] == 1
    assert m1["prefills_total"] == m0["prefills_total"] == 0
    assert len(r.output_tokens) == 10


def test_spawn_decode_server_with_a_role_on_the_cpu(tmp_path):
    nr = t_cli.NameResolveConfig(type="nfs", nfs_record_root=str(tmp_path / "nr"))
    t_nr.reconfigure(nr)
    launcher = LocalLauncher("rexp", "rt", str(tmp_path))
    h = launcher.spawn_decode_server(
        "prefill", model_path="synthetic-arith", env=t_nr.to_env(nr), timeout=120,
        extra_args=["--device", "cpu", "--dtype", "float32", "--context-length", "64",
                    "--max-running-requests", "2", "--scratch-model", json.dumps(KW)])
    try:
        assert t_nr.get(t_names.gen_server("rexp", "rt", h.addr)) == h.addr
        assert _post(h.addr, "/health", method="GET")["role"] == "prefill"
        out = _post(h.addr, "/prefill", dict(rid="x", input_ids=[1, 2, 3],
                                             gconfig=dict(max_new_tokens=4)))
        assert out["stop_reason"] == "prefill" and out["migrated"] is False
    finally:
        h.kill()
    assert launcher.jobs == [] and h.job.proc.poll() is not None
