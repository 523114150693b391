"""Session migration on the CPU: the port's counterparts of
`tests/test_kv_migration.py` (the unified fleet's part; the prefill role's
is in `tests/test_torch_disagg.py`) and of the fragmentation key the
router admits on.

- `pack_kv_session` frames are byte-equal to JAX's for the same meta and
  arrays (fp, int8, identity-only), and each package unpacks the other's.
- `export_session` / `import_session`: a session parked by an interrupt,
  exported, sent through the frames and imported on another engine
  resumes with no prefill, its joined stream bit-identical to the port's
  never-interrupted stream (tokens and logprobs equal) and equal to the
  JAX engine's (greedy tokens exact, logprobs within `LOGP_ATOL`), on the
  paged and workspace layouts, greedy and sampled, and with int8 blocks.
- Across packages: a JAX-exported session imports into the port and a
  port-exported one into JAX, and each resume equals the exporter's
  never-interrupted stream (tokens exact, logprobs within `LOGP_ATOL`).
- A stale weight version or another pool dtype is an honest miss on both
  packages (the same verdict, the rid tombstoned, the resume prefills);
  malformed sessions are rejected; a host-tier session exports too.
- The server wire: a torn `/kv_recv` frame is refused before a byte
  stages and the replay lands once, `/kv_commit` deduplicates; a drain
  survives a `kv.migrate.send` abort composed with two torn receives;
  concurrent `/drain`s export once; `/drain` of sessions in mid-stream
  gives zero re-prefill on the survivor.
- `kv_pool_fragmentation` equals the JAX engine's after the same
  admissions.

Tolerance: `LOGP_ATOL` = 1e-5 on f32 logprobs between the packages (they
sum in different orders); within the port, equal.
"""

import asyncio
import concurrent.futures
import threading
import time

import numpy as np
import pytest
import torch

import jax

from areal_tpu.api.cli_args import GenerationHyperparameters as JaxGen
from areal_tpu.api.cli_args import InferenceEngineConfig as JaxInferenceConfig
from areal_tpu.api.cli_args import JaxDecodeConfig
from areal_tpu.api.io_struct import ModelRequest as JaxRequest
from areal_tpu.core import fault_injection as jfi
from areal_tpu.core import weight_transfer as jwt
from areal_tpu.engine import jax_decode as jd
from areal_tpu.models import qwen2 as jq
from areal_tpu_torch.api.cli_args import GenerationHyperparameters, TorchDecodeConfig
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.core import fault_injection as tfi
from areal_tpu_torch.core import weight_transfer as twt
from areal_tpu_torch.engine import torch_decode as td
from areal_tpu_torch.launcher.decode_server import DecodeServer
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy
from areal_tpu_torch.utils.http import HttpRequestError, request_with_retry

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, dtype="float32",
          param_dtype="float32")
LOGP_ATOL = 1e-5
# the engines of `tests/test_kv_migration.py`: page 8, 4-token chunks
BASE = dict(page_size=8, new_tokens_per_chunk=4, dtype="float32", kv_cache_dtype="float32",
            context_length=256, max_running_requests=3, kv_migrate_chunk_mb=0.002)
TIMEOUT = 180
GREEDY = dict(greedy=True, max_new_tokens=64)
SAMPLED = dict(greedy=False, temperature=0.8, top_p=0.9, max_new_tokens=64)


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    tfi.deactivate()
    jfi.deactivate()
    yield
    tfi.deactivate()
    jfi.deactivate()


@pytest.fixture(scope="module")
def weights():
    jp = jq.init_params(jq.ModelConfig(**KW), jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tq.ModelConfig(**KW))


def _engine(weights, jax_engine: bool = False, **cfg):
    cfg = dict(BASE, **cfg)
    if jax_engine:
        eng = jd.JaxDecodeEngine(JaxDecodeConfig(**dict({"paged_attn_impl": "xla"}, **cfg)),
                                 JaxInferenceConfig())
        eng.set_model(weights[0], jq.ModelConfig(**KW))
    else:
        eng = td.TorchDecodeEngine(TorchDecodeConfig(**cfg), device="cpu")
        eng.set_model(weights[1], tq.ModelConfig(**KW))
    return eng.initialize() or eng


def _req(eng, ids, g: dict, rid=None):
    jax_engine = isinstance(eng, jd.JaxDecodeEngine)
    gen = (JaxGen if jax_engine else GenerationHyperparameters)(**g)
    kw = {} if rid is None else dict(rid=rid)
    return (JaxRequest if jax_engine else ModelRequest)(input_ids=list(ids), gconfig=gen, **kw)


def _in_thread(fn, timeout=TIMEOUT):
    out: dict = {}

    def go():
        try:
            out["r"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["e"] = e

    t = threading.Thread(target=go, daemon=True)
    t.start()
    t.join(timeout)
    if "e" in out:
        raise out["e"]
    assert "r" in out, "timed out"
    return out["r"]


def _run(eng, reqs) -> list:
    async def main():
        return await asyncio.gather(*[eng.agenerate(r) for r in reqs])
    return _in_thread(lambda: asyncio.run(main()))


def _interrupt(eng, rid, prompt, g: dict):
    """One request paused and aborted once it has emitted a token: its KV
    parks under `rid`."""
    out: dict = {}

    def go():
        out["r"] = asyncio.run(eng.agenerate(_req(eng, prompt, g, rid=rid)))

    base = eng.get_metrics()["generated_tokens_total"]
    t = threading.Thread(target=go, daemon=True)
    t.start()
    deadline = time.monotonic() + TIMEOUT
    while eng.get_metrics()["generated_tokens_total"] <= base:
        assert time.monotonic() < deadline, "no token emitted"
        time.sleep(0.002)
    eng.pause_generation()
    eng.abort_all()
    eng.continue_generation()
    t.join(TIMEOUT)
    resp = out["r"]
    assert resp.stop_reason == "interrupt" and resp.output_tokens
    assert len(resp.output_tokens) < g["max_new_tokens"]
    return resp


def _resume(eng, rid, prompt, seg1, g: dict):
    g = dict(g, max_new_tokens=g["max_new_tokens"] - len(seg1.output_tokens))
    return _run(eng, [_req(eng, list(prompt) + list(seg1.output_tokens), g, rid=rid)])[0]


def _prompt(n=20, seed=3):
    return np.random.RandomState(seed).randint(1, 64, (n,)).tolist()


def _stream(r) -> tuple:
    return list(r.output_tokens), list(r.output_logprobs)


def _assert_close(got, want, atol: float, what: str) -> None:
    assert got[0] == want[0], f"{what}: tokens differ\n{got[0]}\n{want[0]}"
    if atol == 0:
        assert got[1] == want[1], f"{what}: logprobs differ"
    else:
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=atol, err_msg=what)


def _oracle(weights, jax_engine, prompt, g, **cfg):
    eng = _engine(weights, jax_engine, **cfg)
    try:
        return _stream(_run(eng, [_req(eng, prompt, g, rid="o")])[0])
    finally:
        eng.destroy()


def _wire(pack_mod, unpack_mod, sess, chunk_mb=0.002):
    """A session through `pack_mod`'s frames into `unpack_mod`'s staging:
    the (meta, k, v, scales) it unpacks to."""
    frames = list(pack_mod.pack_kv_session(sess["meta"], sess["k"], sess["v"],
                                           ks=sess.get("ks"), vs=sess.get("vs"),
                                           chunk_mb=chunk_mb))
    st = unpack_mod.WeightStaging()
    for f in frames:
        st.add_bucket(f)
    (out,) = unpack_mod.unpack_kv_sessions(st.finalize())
    return out, frames


def _migrate(src, dst, rid, pack_mod=twt, unpack_mod=twt):
    sess = src.export_session(rid)
    assert sess is not None
    (meta, k, v, scales), frames = _wire(pack_mod, unpack_mod, sess)
    assert len(frames) > 1
    ks, vs = scales if scales is not None else (None, None)
    return sess, dst.import_session(meta, k, v, ks, vs)


# -- the frames -------------------------------------------------------------


def _session_arrays(kind: str):
    rng = np.random.default_rng(4)
    meta = dict(rid="s", covered=13, tokens=list(range(13)), rope_delta=0, base_key=[3, 5],
                weight_version=2, nb=2, kv_dtype="int8" if kind == "int8" else "fp")
    if kind == "meta_only":
        return dict(meta, meta_only=True), None, None, None, None
    shape = (2, 2, 8, 2, 4)
    if kind == "int8":
        k = rng.integers(-127, 128, shape, dtype=np.int8)
        v = rng.integers(-127, 128, shape, dtype=np.int8)
        ks = rng.random((2, 2, 2, 8), dtype=np.float32)
        return meta, k, v, ks, ks * 2
    return meta, rng.random(shape, dtype=np.float32), rng.random(shape, dtype=np.float32), None, None


@pytest.mark.parametrize("kind", ["fp", "int8", "meta_only"])
def test_kv_frames_byte_equal_jax_and_cross_unpack(kind):
    meta, k, v, ks, vs = _session_arrays(kind)
    j = list(jwt.pack_kv_session(meta, k, v, ks=ks, vs=vs, chunk_mb=0.0005))
    t = list(twt.pack_kv_session(
        meta, None if k is None else torch.from_numpy(k), None if v is None else torch.from_numpy(v),
        ks=None if ks is None else torch.from_numpy(ks),
        vs=None if vs is None else torch.from_numpy(vs), chunk_mb=0.0005))
    assert j == t and (len(j) > 1 or kind == "meta_only")
    for pack_frames, um in ((j, twt), (t, jwt)):
        st = um.WeightStaging()
        for f in reversed(pack_frames):  # staging is order-free
            st.add_bucket(f)
        (m2, k2, v2, sc), = um.unpack_kv_sessions(st.finalize())
        assert m2 == meta
        if kind == "meta_only":
            assert k2 is None and sc is None
            continue
        assert np.array_equal(np.asarray(k2), k) and np.array_equal(np.asarray(v2), v)
        assert (sc is None) == (kind == "fp")
        if sc is not None:
            assert np.array_equal(np.asarray(sc[0]), ks) and np.array_equal(np.asarray(sc[1]), vs)
    if kind == "meta_only":
        with pytest.raises(ValueError, match="must not carry blocks"):
            list(twt.pack_kv_session(meta, torch.zeros(1), torch.zeros(1)))
        return
    with pytest.raises(ValueError, match="scales"):
        list(twt.pack_kv_session(dict(meta, kv_dtype="fp"), k, v, ks=ks if ks is not None else k))
    with pytest.raises(ValueError, match="missing"):
        list(twt.pack_kv_session({"rid": "s"}, k, v))


def test_unpack_refuses_incomplete_sessions():
    meta, k, v, ks, vs = _session_arrays("int8")
    blob = np.frombuffer(__import__("json").dumps(meta).encode(), np.uint8)
    for named, match in (([("kvmeta/s", blob)], "missing blocks"),
                         ([("kvmeta/s", blob), ("kvdata/s/k", k), ("kvdata/s/v", v)],
                          "without scale"),
                         ([("kvdata/x/k", k)], "without session metadata")):
        for mod in (jwt, twt):
            st = mod.WeightStaging()
            for f in mod.pack_buckets(named, chunk_mb=1):
                st.add_bucket(f)
            with pytest.raises(ValueError, match=match):
                mod.unpack_kv_sessions(st.finalize())


# -- export and import -------------------------------------------------------


@pytest.mark.parametrize("kv_layout", ["paged", "workspace"])
@pytest.mark.parametrize("gname", ["greedy", "sampled"])
def test_export_import_stream_bit_identity(weights, kv_layout, gname):
    g = GREEDY if gname == "greedy" else SAMPLED
    prompt = _prompt(22, seed=5)
    cfg = dict(kv_layout=kv_layout, paged_attn_impl="xla" if kv_layout == "workspace" else "auto")
    own = _oracle(weights, False, prompt, g, **cfg)
    want = _oracle(weights, True, prompt, g, kv_layout=kv_layout)
    src, dst = _engine(weights, **cfg), _engine(weights, **cfg)
    try:
        seg1 = _interrupt(src, "m", prompt, g)
        assert src.list_exportable_sessions() == ["m"]
        sess, verdict = _migrate(src, dst, "m")
        assert verdict == "ok"
        assert sess["meta"]["covered"] == len(prompt) + len(seg1.output_tokens) - 1
        m = src.get_metrics()
        assert m["kv_migrated_out_sessions_total"] == 1
        assert m["kv_migrated_out_bytes_total"] == sess["meta"]["nb"] * m["kv_block_nbytes"]
        assert src.list_exportable_sessions() == []  # the session moved
        m0 = dst.get_metrics()
        seg2 = _resume(dst, "m", prompt, seg1, g)
        m1 = dst.get_metrics()
    finally:
        src.destroy()
        dst.destroy()
    assert m1["prefills_total"] == m0["prefills_total"]  # a promotion
    assert m1["kv_host_hits_total"] - m0["kv_host_hits_total"] == 1
    assert m1["kv_migrated_in_sessions_total"] == 1
    assert m1["kv_migrated_in_bytes_total"] == m["kv_migrated_out_bytes_total"]
    joined = _stream(seg1)[0] + _stream(seg2)[0], _stream(seg1)[1] + _stream(seg2)[1]
    _assert_close(joined, own, 0, "migrated vs the port's never-interrupted")
    _assert_close(joined, want, LOGP_ATOL, "migrated vs JAX never-interrupted")


def test_int8_session_migrates_as_it_is(weights):
    """An int8 pool's blocks and scales travel as they are: the resumed
    stream equals the never-interrupted one bit for bit."""
    prompt = _prompt(22, seed=7)
    own = _oracle(weights, False, prompt, SAMPLED, kv_dtype="int8")
    src, dst = _engine(weights, kv_dtype="int8"), _engine(weights, kv_dtype="int8")
    try:
        seg1 = _interrupt(src, "q", prompt, SAMPLED)
        sess, verdict = _migrate(src, dst, "q")
        seg2 = _resume(dst, "q", prompt, seg1, SAMPLED)
        m = dst.get_metrics()
    finally:
        src.destroy()
        dst.destroy()
    assert verdict == "ok" and sess["k"].dtype == torch.int8 and sess["ks"].dtype == torch.float32
    assert m["kv_host_hits_total"] == 1 and m["prefills_total"] == 0
    joined = _stream(seg1)[0] + _stream(seg2)[0], _stream(seg1)[1] + _stream(seg2)[1]
    _assert_close(joined, own, 0, "int8 migrated vs never-interrupted")


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("gname", ["greedy", "sampled"])
def test_cross_package_migration(weights, direction, gname):
    """The exporter's session through its own frames into the importer's
    staging; the resume equals the exporter's never-interrupted stream."""
    g = GREEDY if gname == "greedy" else SAMPLED
    prompt = _prompt(22, seed=9)
    src_jax = direction == "jax-to-port"
    want = _oracle(weights, src_jax, prompt, g)
    src, dst = _engine(weights, src_jax), _engine(weights, not src_jax)
    try:
        seg1 = _interrupt(src, "x", prompt, g)
        _, verdict = _migrate(src, dst, "x", pack_mod=jwt if src_jax else twt,
                              unpack_mod=twt if src_jax else jwt)
        m0 = dst.get_metrics()
        seg2 = _resume(dst, "x", prompt, seg1, g)
        m1 = dst.get_metrics()
    finally:
        src.destroy()
        dst.destroy()
    assert verdict == "ok"
    assert m1["prefills_total"] == m0["prefills_total"] and m1["kv_host_hits_total"] == 1
    joined = _stream(seg1)[0] + _stream(seg2)[0], _stream(seg1)[1] + _stream(seg2)[1]
    _assert_close(joined, want, LOGP_ATOL, f"{direction} resume vs the exporter's stream")


def _parked_session(weights, prompt, rid, **cfg):
    src = _engine(weights, **cfg)
    try:
        _interrupt(src, rid, prompt, GREEDY)
        sess = src.export_session(rid)
    finally:
        src.destroy()
    return sess


@pytest.mark.parametrize("case", ["stale_version", "kv_dtype_mismatch"])
def test_honest_misses_match_jax(weights, case):
    """A session from another weight version, or from a pool of the other
    dtype scheme, gets the same verdict from both packages; the rid is
    tombstoned, and its resume counts a miss and prefills."""
    prompt = _prompt(20, seed=11)
    sess = _parked_session(weights, prompt, "v")
    meta = dict(sess["meta"], tokens=list(sess["meta"]["tokens"]))
    if case == "kv_dtype_mismatch":
        meta["kv_dtype"] = "int8"
    scales = (None, None) if case == "stale_version" else (torch.ones(1), torch.ones(1))
    resume = prompt + meta["tokens"][len(prompt):] + [1]
    counter = ("kv_migrate_version_rejects_total" if case == "stale_version"
               else "kv_migrate_dtype_rejects_total")
    for jax_engine in (True, False):
        dst = _engine(weights, jax_engine)
        try:
            if case == "stale_version":
                dst.set_version(7)  # a weight commit raced the migration
            k, v = sess["k"], sess["v"]
            if jax_engine:
                k, v = np.asarray(k), np.asarray(v)
            ks, vs = scales if not jax_engine or scales[0] is None else tuple(
                np.asarray(s) for s in scales)
            assert dst.import_session(meta, k, v, ks, vs) == case, jax_engine
            m0 = dst.get_metrics()
            assert m0[counter] == 1 and m0["kv_migrated_in_sessions_total"] == 0
            r = _run(dst, [_req(dst, resume, dict(GREEDY, max_new_tokens=4), rid="v")])[0]
            m1 = dst.get_metrics()
        finally:
            dst.destroy()
        assert m1["prefills_total"] - m0["prefills_total"] == 1, jax_engine
        assert m1["kv_host_misses_total"] - m0["kv_host_misses_total"] == 1, jax_engine
        assert len(r.output_tokens) == 4


def test_import_rejects_malformed_sessions(weights):
    prompt = _prompt(18, seed=13)
    sess = _parked_session(weights, prompt, "x")
    meta, k, v = sess["meta"], sess["k"], sess["v"]
    cases = [
        (meta, torch.zeros(1, 1, 2, 1, 2), torch.zeros(1, 1, 2, 1, 2)),  # block geometry
        (dict(meta, covered=meta["covered"] + 1), k, v),  # coverage != tokens
        (dict(meta, nb=meta["nb"] + 1), k, v),  # blocks != coverage
        ({k_: x for k_, x in meta.items() if k_ != "base_key"}, k, v),  # a missing field
    ]
    for jax_engine in (True, False):
        dst = _engine(weights, jax_engine)
        try:
            for m, kk, vv in cases:
                if jax_engine:
                    kk, vv = np.asarray(kk), np.asarray(vv)
                assert dst.import_session(m, kk, vv) == "rejected", (jax_engine, m.keys())
            assert dst.get_metrics()["kv_migrated_in_sessions_total"] == 0
            assert dst.export_session("nope") is None
        finally:
            dst.destroy()
    dst = _engine(weights)
    try:
        # the port's own refusal: another fp dtype
        assert dst.import_session(meta, k.double(), v.double()) == "rejected"
    finally:
        dst.destroy()
    # an identity-only session (a cheap drain) lands as JAX's does, and a
    # malformed one is rejected by both
    for jax_engine in (True, False):
        dst = _engine(weights, jax_engine)
        try:
            assert dst.import_session(dict(meta, meta_only=True), None, None) == "ok"
            assert dst.import_session(dict(meta, meta_only=True, covered=meta["covered"] + 1),
                                      None, None) == "rejected"
            assert dst.get_metrics()["kv_migrated_in_sessions_total"] == 1
        finally:
            dst.destroy()


def test_export_from_host_tier_after_eviction(weights):
    """A parked session already offloaded to the host tier exports from
    there; without `kv_host_pool_mb` the importer makes a tier from
    `kv_import_pool_mb`."""
    prompt = _prompt(20, seed=17)
    want = _oracle(weights, False, prompt, GREEDY)
    src = _engine(weights, kv_host_pool_mb=16.0)
    dst = _engine(weights, kv_import_pool_mb=1.0)
    try:
        seg1 = _interrupt(src, "h", prompt, GREEDY)
        src.pause_generation()
        with src._sched_lock:
            assert src._evict_parked_lru() is not None
        src.continue_generation()
        assert src.get_metrics()["kv_host_pool_entries"] == 1
        assert src.list_exportable_sessions() == ["h"]
        sess, verdict = _migrate(src, dst, "h")
        assert verdict == "ok" and src.list_exportable_sessions() == []
        assert dst.get_metrics()["kv_host_pool_bytes"] == 1024 * 1024
        seg2 = _resume(dst, "h", prompt, seg1, GREEDY)
        m = dst.get_metrics()
    finally:
        src.destroy()
        dst.destroy()
    assert m["prefills_total"] == 0 and m["kv_host_hits_total"] == 1
    joined = _stream(seg1)[0] + _stream(seg2)[0], _stream(seg1)[1] + _stream(seg2)[1]
    _assert_close(joined, want, 0, "host-tier export vs never-interrupted")


# -- the server wire ---------------------------------------------------------


def _server(eng):
    srv = DecodeServer(eng.config, engine=eng)
    srv.start("127.0.0.1", 0)
    return srv


def _post(addr, path, payload=None, data=None, retries=1, timeout=60):
    return request_with_retry(addr, path, payload=payload, data=data, max_retries=retries,
                              timeout=timeout)


def test_kv_recv_torn_frame_refused_then_replay_lands_once(weights):
    prompt = _prompt(20, seed=19)
    sess = _parked_session(weights, prompt, "t")
    frames = list(twt.pack_kv_session(sess["meta"], sess["k"], sess["v"], chunk_mb=0.002))
    assert len(frames) >= 2
    dec = _engine(weights)
    srv = _server(dec)
    try:
        with pytest.raises(HttpRequestError):  # torn in flight: nothing staged
            _post(srv.addr, "/kv_recv?xid=mig1", data=frames[0][: len(frames[0]) // 2])
        with pytest.raises(HttpRequestError) as e:
            _post(srv.addr, "/kv_recv", data=frames[0])
        assert e.value.status == 400  # no xid
        with pytest.raises(HttpRequestError) as e:  # incomplete: 400, staging kept
            _post(srv.addr, "/kv_commit", payload=dict(xid="mig1"))
        assert e.value.status == 400
        for f in frames:
            _post(srv.addr, "/kv_recv?xid=mig1", data=f)
        out = _post(srv.addr, "/kv_commit", payload=dict(xid="mig1"))
        assert out["imported"] == 1 and out["rids"] == ["t"]
        again = _post(srv.addr, "/kv_commit", payload=dict(xid="mig1"))
        assert again["dedup"] is True and again["rids"] == ["t"]
        straggler = _post(srv.addr, "/kv_recv?xid=mig1", data=frames[0])
        assert straggler["staged"] == 0
        m = request_with_retry(srv.addr, "/metrics", method="GET")
        assert m["kv_migrate"]["in_commits"] == 1 and m["kv_migrate"]["commit_dedups"] == 1
        assert m["kv_migrated_in_sessions_total"] == 1
    finally:
        srv.stop()
        dec.destroy()


def _mid_stream(eng, addr, prompts, budget):
    """`prompts` as concurrent /generate calls to `addr`, returned once
    each is running with a token out: the futures of their replies."""
    pool = concurrent.futures.ThreadPoolExecutor(len(prompts))
    futs = []
    for i, p in enumerate(prompts):
        futs.append(pool.submit(_post, addr, "/generate", dict(
            rid=f"s{i}", input_ids=p, gconfig=dict(max_new_tokens=budget, greedy=True)),
            None, 1, 120))
        time.sleep(0.05)  # admission order is the oracle's
    deadline = time.monotonic() + 60
    while True:
        m = eng.get_metrics()
        if m["running_requests"] >= len(prompts) and m["generated_tokens_total"] >= len(prompts):
            break
        assert time.monotonic() < deadline, "requests never ran"
        time.sleep(0.005)
    pool.shutdown(wait=False)
    return futs


def test_drain_survives_composed_send_and_recv_faults(weights):
    """A sender abort on the first attempt and two torn receives on the
    replay (enough to beat the per-frame retry): the replay budget still
    lands the session once."""
    a, b = _engine(weights, kv_host_pool_mb=16.0), _engine(weights)
    sa, sb = _server(a), _server(b)
    try:
        futs = _mid_stream(a, sa.addr, [_prompt(20, seed=29)], 160)
        tfi.configure(tfi.FaultPlan(seed=7, points=[
            tfi.FaultPoint(site="kv.migrate.send", mode="abort", at=(0,), times=1),
            tfi.FaultPoint(site="kv.migrate.recv", mode="torn", at=(1, 2), times=2),
        ]))
        try:
            drain = _post(sa.addr, "/drain", dict(targets=[sb.addr]), timeout=120)
        finally:
            fired = tfi.snapshot()
            tfi.deactivate()
        assert futs[0].result(60)["stop_reason"] == "interrupt"
        assert drain["drained"] == 1 and drain["failed"] == 0, drain
        assert any(k.startswith("kv.migrate.send") for k in fired), fired
        assert any(k.startswith("kv.migrate.recv") for k in fired), fired
        mb = request_with_retry(sb.addr, "/metrics", method="GET")
        assert mb["kv_migrate"]["in_commits"] == 1 and mb["kv_migrated_in_sessions_total"] == 1
    finally:
        sa.stop()
        sb.stop()
        a.destroy()
        b.destroy()


class _SlowDrainEngine:
    """Two parked sessions that export slowly (`tests/test_fleet.py`'s
    DrainStubEngine): a second /drain arrives while the first exports."""

    config = TorchDecodeConfig()

    def __init__(self):
        self.exports: list[str] = []
        self._parked = ["p0", "p1"]

    def get_version(self):
        return 0

    def get_metrics(self):
        return {}

    def pause_generation(self):
        pass

    def continue_generation(self):
        pass

    def abort_all(self):
        return 0

    def list_exportable_sessions(self):
        return list(self._parked)

    def export_session(self, rid):
        time.sleep(0.3)
        self.exports.append(rid)
        self._parked.remove(rid)
        return None  # the stream is not under test: counted failed


def test_concurrent_drains_export_once():
    eng = _SlowDrainEngine()
    srv = DecodeServer(eng.config, engine=eng)
    srv.start("127.0.0.1", 0)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            f1 = pool.submit(_post, srv.addr, "/drain", dict(targets=["127.0.0.1:1"]))
            time.sleep(0.1)
            f2 = pool.submit(_post, srv.addr, "/drain", dict(targets=["127.0.0.1:1"]))
            r1, r2 = f1.result(30), f2.result(30)
        assert eng.exports == ["p0", "p1"]  # each session exported once
        assert r1["sessions"] == r2["sessions"] == 2 and r2["dedup"] == "in_progress"
        # a later drain is a new one
        r3 = _post(srv.addr, "/drain", dict(targets=["127.0.0.1:1"]))
        assert r3["sessions"] == 0 and "dedup" not in r3
        with pytest.raises(HttpRequestError) as e:
            _post(srv.addr, "/drain", dict(targets=[]))
        assert e.value.status == 400
    finally:
        srv.stop()


def test_drain_migrates_mid_stream_sessions_zero_reprefill(weights):
    """`tests/test_kv_migration.py:540` on the port: two requests in
    mid-stream, drained to a survivor, resumed there as promotions; the
    joined streams equal the never-interrupted ones."""
    prompts = [_prompt(20, seed=23 + i) for i in range(2)]
    budget = 160
    g = dict(greedy=True, max_new_tokens=budget)
    oracle = _engine(weights)
    try:
        want = [list(r.output_tokens) for r in _run(oracle, [
            _req(oracle, p, g, rid=f"s{i}") for i, p in enumerate(prompts)])]
    finally:
        oracle.destroy()
    a, b = _engine(weights, kv_host_pool_mb=16.0), _engine(weights)
    sa, sb = _server(a), _server(b)
    try:
        futs = _mid_stream(a, sa.addr, prompts, budget)
        drain = _post(sa.addr, "/drain", dict(targets=[sb.addr]), timeout=120)
        parts = [f.result(60) for f in futs]
        assert all(p["stop_reason"] == "interrupt" for p in parts)
        assert drain["drained"] == drain["sessions"] == 2 and drain["failed"] == 0, drain
        assert drain["bytes"] > 0
        m0 = b.get_metrics()
        full = []
        for i, p in enumerate(parts):
            toks = [int(t) for t in p["output_tokens"]]
            out = _post(sb.addr, "/generate", dict(
                rid=f"s{i}", input_ids=prompts[i] + toks,
                gconfig=dict(max_new_tokens=budget - len(toks), greedy=True)), timeout=120)
            full.append(toks + [int(t) for t in out["output_tokens"]])
        m1 = b.get_metrics()
    finally:
        sa.stop()
        sb.stop()
        a.destroy()
        b.destroy()
    assert m1["prefills_total"] == m0["prefills_total"]
    assert m1["kv_host_hits_total"] - m0["kv_host_hits_total"] == 2
    assert full == want


# -- the router's fragmentation input ----------------------------------------


def test_kv_pool_fragmentation_matches_jax(weights):
    """After the same admissions both engines report the same free blocks
    and `kv_pool_fragmentation` (free blocks % max blocks per slot)."""
    prompts = [_prompt(n, seed=31 + n) for n in (9, 17, 30)]
    g = dict(greedy=True, max_new_tokens=12)
    got = {}
    for jax_engine in (True, False):
        eng = _engine(weights, jax_engine, context_length=64, kv_pool_tokens=400,
                      decode_runahead_chunks=0)
        try:
            _run(eng, [_req(eng, p, g) for p in prompts])
            m = eng.get_metrics()
            got[jax_engine] = {k: m[k] for k in ("kv_blocks_total", "kv_blocks_free",
                                                 "kv_pool_fragmentation")}
        finally:
            eng.destroy()
    assert got[False] == got[True], got
    assert got[False]["kv_pool_fragmentation"] == got[False]["kv_blocks_free"] % 8
