"""The port's KV fabric (`core/kv_fabric.py`, the host store's content
index, the engine's device and host rungs, `export_fabric_blocks`,
`/kv_fetch`, `/warm_start` and identity-only sessions) against the JAX
package's, on the CPU. The scenarios are those of `tests/test_kv_fabric.py`.

- Chain keys, digests and longest runs equal JAX's bit for bit.
- The host store's index (`match_blocks`, `fabric_keys`, identity-only
  entries) takes JAX's decisions and counts as JAX's on one sequence of
  calls.
- The device rung: a prompt sharing a block-aligned head with a
  registration that diverges later forks the head and prefills the
  suffix, with the JAX engine's tokens (exact), logprobs (within 1e-5: the
  packages sum in different orders) and counters, prefill, fork, suffix
  and fabric alike; and the same tokens as a `kv_fabric=False` engine that
  prefills in full (logprobs within 1e-5: the suffix prefill sums in
  another order than a full one).
- A weight flip: keys of the old version never match, and the install
  empties the digest.
- Over HTTP: a peer-to-peer `/kv_fetch` (from a port replica and from a
  JAX one) and a `/warm_start`, each a remote fabric hit with no full
  prefill; two requests with one hint wait on one fetch; a run fetched
  from another weight version is an honest miss; a failed upload of a
  run is a counted miss with the same stream; `export_fabric_blocks`
  copies and drops nothing.
- Identity-only sessions: the frame is byte-equal to JAX's, and a session
  exported by either package imports into either as "ok", keeps its
  sampling key, and prefills honestly; a `/drain` with the survivor's
  digest sends identities only, and their resumes fork the survivor's
  blocks; the refetchable gate needs every complete block.

The engines serve the tiny f32 model of `tests/test_kv_fabric.py` at page
8, context 256, three slots, 4-token chunks.
"""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

import jax

from areal_tpu.api import cli_args as j_cli
from areal_tpu.api.io_struct import ModelRequest as JaxRequest
from areal_tpu.core import kv_fabric as j_fab
from areal_tpu.core import weight_transfer as jwt
from areal_tpu.engine import kv_pool as jkv
from areal_tpu.engine.jax_decode import JaxDecodeEngine
from areal_tpu.models import qwen2 as jq
from areal_tpu_torch.api import cli_args as t_cli
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.core import kv_fabric as t_fab
from areal_tpu_torch.core import weight_transfer as twt
from areal_tpu_torch.engine import kv_pool as tkv
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.launcher.decode_server import DecodeServer
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy
from areal_tpu_torch.utils.http import request_with_retry
from tests.test_remote_inf_engine import _ServerThread

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, dtype="float32",
          param_dtype="float32")
LOGP_ATOL = 1e-5
GREEDY = dict(max_new_tokens=10, greedy=True)
SAMPLED = dict(max_new_tokens=10, temperature=0.8, top_p=0.9)
COUNTERS = ("prefills_total", "prefix_forks_total", "suffix_prefills_total",
            "kv_fabric_local_hits_total", "kv_fabric_local_tokens_avoided_total",
            "kv_fabric_remote_hits_total", "kv_fabric_remote_tokens_avoided_total",
            "reprefill_tokens_avoided_total", "kv_host_hits_total")


@pytest.fixture(scope="module")
def weights():
    jparams = jq.init_params(jq.ModelConfig(**KW), jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), tq.ModelConfig(**KW))


def _cfg(cli, **kw):
    base = dict(context_length=256, max_running_requests=3, new_tokens_per_chunk=4,
                page_size=8, kv_layout="paged", kv_migrate_chunk_mb=0.01, dtype="float32",
                kv_cache_dtype="float32")
    base.update(kw)
    if cli is j_cli:
        base.setdefault("paged_attn_impl", "xla")
        return j_cli.JaxDecodeConfig(**base)
    return t_cli.TorchDecodeConfig(**base)


def _engine(weights, jax_engine=False, **kw):
    if jax_engine:
        eng = JaxDecodeEngine(_cfg(j_cli, **kw), j_cli.InferenceEngineConfig())
        eng.set_model(weights[0], jq.ModelConfig(**KW))
    else:
        eng = TorchDecodeEngine(_cfg(t_cli, **kw), device="cpu")
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


def _prefill(eng, ids, rid, g=GREEDY):
    out = {}

    def run():
        out["r"] = asyncio.run(eng.aprefill(_req(eng, ids, rid, g)))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(120)
    return out["r"]


def _prompt(n, seed=3):
    return np.random.RandomState(seed).randint(1, 64, (n,)).tolist()


def _chain(eng, tokens):
    return t_fab.chain_keys(tokens, eng._alloc.block_size, int(eng._version),
                            str(eng.config.kv_dtype))


def _counts(m):
    return {k: m[k] for k in COUNTERS}


def _same(a, b, tol=LOGP_ATOL):
    assert list(b.output_tokens) == list(a.output_tokens)
    np.testing.assert_allclose(b.output_logprobs, a.output_logprobs, atol=tol, rtol=0)


# -- keys and digests --------------------------------------------------------

KEY_CASES = [(list(range(100, 230)), 64, 0, "fp"), (_prompt(640, 22), 64, 3, "fp"),
             (_prompt(96, 21), 8, 7, "int8"), (_prompt(7, 1), 8, 0, "fp"),
             (_prompt(300, 5), 128, -1, "bfloat16")]


@pytest.mark.parametrize("tokens,bs,version,dtype", KEY_CASES,
                         ids=[f"{len(c[0])}x{c[1]}" for c in KEY_CASES])
def test_chain_keys_and_digests_equal_jax(tokens, bs, version, dtype):
    assert t_fab.CHAIN_ROOT == j_fab.CHAIN_ROOT
    assert t_fab.DIGEST_HARD_CAP == j_fab.DIGEST_HARD_CAP
    keys = t_fab.chain_keys(tokens, bs, version, dtype)
    assert keys == j_fab.chain_keys(tokens, bs, version, dtype)
    assert len(keys) == len(tokens) // bs
    for mb in (1, 2, 100):
        assert t_fab.chain_keys(tokens, bs, version, dtype, max_blocks=mb) == keys[:mb]
    for cap in (0, 1, 3, 10 ** 9):
        d = t_fab.encode_digest(keys, cap=cap)
        assert d == j_fab.encode_digest(keys, cap=cap)
        assert t_fab.decode_digest(d) == j_fab.decode_digest(d)
    for n in range(len(keys) + 1):
        resident = set(keys[:n]) | {12345}
        assert t_fab.longest_run(keys, resident) == j_fab.longest_run(keys, resident) == n
    if keys:
        assert (t_fab.content_key(t_fab.CHAIN_ROOT, tokens[:bs], version, dtype)
                == keys[0])


def test_digest_caps_and_malformed_input_as_jax():
    big = range(t_fab.DIGEST_HARD_CAP + 100)
    assert t_fab.encode_digest(big, cap=10 ** 9) == j_fab.encode_digest(big, cap=10 ** 9)
    assert len(t_fab.decode_digest(t_fab.encode_digest(big, cap=10 ** 9))) == 4096
    for bad in ("", "!!!not-base64!!!", "AAA=", None, 7):
        assert t_fab.decode_digest(bad) == j_fab.decode_digest(bad) == []
    assert t_fab.encode_digest([]) == ""
    # version and dtype salt every key
    toks = _prompt(128, 21)
    a, b, c = (set(t_fab.chain_keys(toks, 64, v, d)) for v, d in
               ((3, "fp"), (4, "fp"), (3, "int8")))
    assert not (a & b or a & c or b & c)


# -- the host store's index --------------------------------------------------


def _entry(mod, rid, tokens, bs, version=0, meta_only=False, nb=None):
    nb = len(tokens) // bs if nb is None else nb
    keys = tuple(t_fab.chain_keys(tokens, bs, version, "fp"))
    arr = None if meta_only else (np.zeros if mod is jkv else torch.zeros)((2, nb, bs, 1, 2))
    extra = dict(rope_delta=0) if mod is jkv else {}
    return mod.HostKVEntry(rid=rid, k=arr, v=arr, nb=nb, covered=len(tokens),
                           tokens=list(tokens), base_key=np.zeros(2, np.uint32),
                           weight_version=version, block_keys=() if meta_only else keys,
                           **extra)


def _store_script(mod):
    bs = 4
    s = mod.HostKVStore(budget_bytes=40 * 16, block_nbytes=16, block_size=bs)
    a, b = _prompt(24, 1), _prompt(24, 1)[:16] + _prompt(12, 2)
    chain_a = t_fab.chain_keys(a, bs, 0, "fp")
    chain_b = t_fab.chain_keys(b, bs, 0, "fp")
    log = []

    def note(x):
        if isinstance(x, tuple):
            x = (x[0].rid, x[1])
        elif isinstance(x, mod.HostKVEntry):
            x = x.rid
        log.append((x, s.bytes_used, len(s), sorted(s.fabric_keys()), s.hits, s.misses,
                    s.evictions, s.rejected_puts))

    note(s.put(_entry(mod, "a", a, bs)))
    note(s.match_blocks(chain_a))
    note(s.match_blocks(chain_a[:3]))
    note(s.match_blocks(chain_b))  # shares 4 blocks of a
    note(s.match_blocks(chain_b, min_blocks=5))
    note(s.match_blocks([123456789]))
    note(s.put(_entry(mod, "m", a, bs, meta_only=True)))  # identity only
    note(s.peek("m").meta_only)
    note(s.match("m", len(a), a))  # an identity never promotes
    note(s.put(_entry(mod, "b", b, bs)))
    note(s.match_blocks(chain_b))
    e = s.take("a")
    note(e)
    note(s.match_blocks(chain_a))  # a's run left with it
    s.restore(e)
    note(s.match_blocks(chain_a))
    note(s.put(_entry(mod, "big", _prompt(100, 3), bs)))  # evicts down the LRU
    note(s.match_blocks(chain_a))
    note(s.clear())
    note(s.match_blocks(chain_b))
    return log


def test_host_store_index_decides_as_jax():
    assert _store_script(tkv) == _store_script(jkv)


# -- the device rung ---------------------------------------------------------


@pytest.mark.parametrize("gname", ["greedy", "sampled"])
def test_device_rung_on_a_diverging_tail_equals_jax(weights, gname):
    """Request 2 shares an 80-token head with request 1 and diverges after
    it: no registered key is a prefix of its prompt, and the fabric forks
    the head's 10 blocks and prefills the rest."""
    g = GREEDY if gname == "greedy" else SAMPLED
    head = _prompt(80, 31)
    p1, p2 = head + _prompt(16, 32), head + _prompt(16, 33)
    runs = {}
    for name, kw in (("jax", dict(jax_engine=True)), ("torch", {}),
                     ("oracle", dict(kv_fabric=False))):
        eng = _engine(weights, **kw)
        try:
            _gen(eng, p1, "d1", g)
            m0 = eng.get_metrics()
            r2 = _gen(eng, p2, "d2", g)
            runs[name] = (r2, m0, eng.get_metrics())
        finally:
            eng.destroy()
    (rj, j0, j1), (rt, t0, t1), (ro, _, o1) = runs["jax"], runs["torch"], runs["oracle"]
    _same(rj, rt)
    _same(ro, rt)
    assert _counts(t1) == _counts(j1) and _counts(t0) == _counts(j0)
    assert t1["kv_fabric_local_hits_total"] - t0["kv_fabric_local_hits_total"] == 1
    assert t1["kv_fabric_local_tokens_avoided_total"] == 80
    assert t1["reprefill_tokens_avoided_total"] == 80
    assert t1["kv_host_hits_total"] == 0 and t1["prefills_total"] == 1
    assert o1["prefills_total"] == 2 and o1["kv_fabric_enabled"] is False
    assert o1["kv_fabric_digest"] == ""
    # the digests hold the same keys
    assert (set(t_fab.decode_digest(t1["kv_fabric_digest"]))
            == set(j_fab.decode_digest(j1["kv_fabric_digest"])))


def test_registry_stale_on_weight_flip(weights):
    prompt = _prompt(96, 34)
    for jax_engine in (False, True):
        eng = _engine(weights, jax_engine)
        try:
            _gen(eng, prompt, "w")
            m0 = eng.get_metrics()
            old = set(t_fab.decode_digest(m0["kv_fabric_digest"]))
            # the retired conversation: 96 + 9 generated rows, 13 blocks
            assert m0["kv_fabric_blocks_resident"] == len(old) == 13
            eng.set_version(1)  # a bare version bump: old keys never match
            assert not old & set(_chain(eng, prompt[:-1]))
            eng.pause_generation()
            with eng._sched_lock:
                eng._invalidate_parked()  # the install's flush
            eng.continue_generation()
            m1 = eng.get_metrics()
            assert m1["kv_fabric_blocks_resident"] == 0
            assert t_fab.decode_digest(m1["kv_fabric_digest"]) == []
            if not jax_engine:
                assert eng._fabric_dev == {} and eng._slot_fabric_keys == {}
        finally:
            eng.destroy()


def test_host_tier_indexes_an_evicted_session(weights):
    prompt = _prompt(96, 35)
    eng = _engine(weights, kv_host_pool_mb=16.0)
    try:
        assert _prefill(eng, prompt, "h").stop_reason == "prefill"
        eng.pause_generation()
        with eng._sched_lock:
            assert eng._evict_parked_lru() is not None
        eng.continue_generation()
        chain = _chain(eng, prompt[:-1])
        with eng._host_lock:
            store = eng._host_store
            assert set(chain) <= set(store.fabric_keys())
            entry, n = store.match_blocks(chain)
            assert entry.rid == "h" and n == len(chain) == 11
            assert store.match_blocks(chain[:9])[1] == 9
            assert store.match_blocks([123456789]) is None
        m = eng.get_metrics()
        assert set(chain) <= set(t_fab.decode_digest(m["kv_fabric_digest"]))
        # another rid with the same head is served by the host rung
        r = _gen(eng, prompt[:88] + _prompt(8, 36), "other")
        m1 = eng.get_metrics()
        assert len(r.output_tokens) == 10
        assert m1["kv_fabric_local_hits_total"] == 1
        assert m1["prefills_total"] == m["prefills_total"] == 1  # h's own
        assert m1["suffix_prefills_total"] == 1
    finally:
        eng.destroy()


# -- over the wire -----------------------------------------------------------


class _Port:
    """A port decode server in this process."""

    def __init__(self, eng):
        self.eng, self.srv = eng, DecodeServer(eng.config, engine=eng)
        self.addr = self.srv.start("127.0.0.1", 0)

    def stop(self):
        self.srv.stop()


def _post(addr, endpoint, payload=None, method="POST"):
    return request_with_retry(addr, endpoint, payload=payload, method=method, max_retries=1,
                              timeout=120)


@pytest.mark.parametrize("peer", ["torch", "jax"])
def test_kv_fetch_peer_to_peer_is_a_remote_hit(weights, peer):
    """Replica A (of either package) holds the prompt's blocks; the port's
    B gets a /generate with the router's hint, pulls the run from A over
    /kv_fetch and prefills only the suffix."""
    prompt = _prompt(96, 41)
    oracle = _engine(weights, kv_fabric=False)
    try:
        ro = _gen(oracle, prompt, "f2")
    finally:
        oracle.destroy()
    a = _engine(weights, jax_engine=peer == "jax")
    b = _engine(weights)
    sa = _ServerThread(a) if peer == "jax" else _Port(a)
    sb = _Port(b)
    try:
        _post(sa.addr, "/generate", dict(rid="f1", input_ids=prompt, gconfig=GREEDY))
        chain = _chain(b, prompt[:-1])
        assert len(chain) == 11
        out = _post(sb.addr, "/generate", dict(
            rid="f2", input_ids=prompt, gconfig=GREEDY,
            kv_fabric=dict(peer=sa.addr, keys=t_fab.encode_digest(chain))))
        ma = _post(sa.addr, "/metrics", method="GET")
        mb = _post(sb.addr, "/metrics", method="GET")
    finally:
        sb.stop()
        sa.stop()
        a.destroy()
        b.destroy()
    assert out["output_tokens"] == ro.output_tokens
    np.testing.assert_allclose(out["output_logprobs"], ro.output_logprobs, atol=LOGP_ATOL,
                               rtol=0)
    block = mb["kv_block_nbytes"]
    assert ma["kv_fabric"]["serve_sessions"] == 1
    assert ma["kv_fabric"]["serve_bytes"] > 11 * block
    assert mb["kv_fabric"]["fetch_sessions"] == 1 and mb["kv_fabric"]["fetch_failures"] == 0
    assert mb["kv_fabric_sessions_in_total"] == 1
    assert mb["kv_fabric_fetch_bytes_total"] == 11 * block
    assert mb["kv_fabric_remote_hits_total"] == 1
    assert mb["kv_fabric_remote_tokens_avoided_total"] == 88
    assert mb["kv_migrated_in_sessions_total"] == 0 and mb["prefills_total"] == 0
    assert mb["ttft_transfer_p99_ms"] > 0


def test_requests_with_one_hint_wait_on_one_fetch(weights):
    """Two /generate's on B carry the same hint on two HTTP threads: one
    fetch goes to A, the other request waits on it (no lock held while it
    waits), and both are remote hits."""
    prompt = _prompt(96, 42)
    a, b = _engine(weights), _engine(weights)
    sa, sb = _Port(a), _Port(b)
    serve = sa.srv._kv_fetch

    def slow_fetch(query, body):
        time.sleep(0.5)  # both of B's requests arrive while this runs
        return serve(query, body)
    sa.srv._kv_fetch = slow_fetch
    try:
        _post(sa.addr, "/generate", dict(rid="h0", input_ids=prompt, gconfig=GREEDY))
        hint = dict(peer=sa.addr, keys=t_fab.encode_digest(_chain(b, prompt[:-1])))
        outs = {}

        def run(rid):
            outs[rid] = _post(sb.addr, "/generate", dict(rid=rid, input_ids=prompt,
                                                         gconfig=GREEDY, kv_fabric=hint))
        threads = [threading.Thread(target=run, args=(f"h{i}",)) for i in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        mb = _post(sb.addr, "/metrics", method="GET")
    finally:
        sb.stop()
        sa.stop()
        a.destroy()
        b.destroy()
    assert outs["h1"]["output_tokens"] == outs["h2"]["output_tokens"]
    assert mb["kv_fabric"]["fetch_attempts"] == mb["kv_fabric"]["fetch_sessions"] == 1
    assert mb["kv_fabric"]["inflight"] == 0 and mb["kv_fabric_sessions_in_total"] == 1
    # the other request reuses the first one's rows, by a fork or in place
    assert mb["kv_fabric_remote_hits_total"] == 1
    assert mb["prefix_forks_total"] + mb["prefix_inplace_total"] == 1
    assert mb["prefills_total"] == 0


def test_a_failed_run_upload_is_a_counted_miss(weights):
    """The host rung's upload dies: the request prefills in full with the
    same stream, and the failure counts in `kv_promote_failures_total`."""
    prompt = _prompt(96, 44)
    other = prompt[:88] + _prompt(8, 46)
    oracle = _engine(weights, kv_fabric=False)
    try:
        want = _gen(oracle, other, "u")
    finally:
        oracle.destroy()
    eng = _engine(weights, kv_host_pool_mb=16.0)
    try:
        _prefill(eng, prompt, "h")
        eng.pause_generation()
        with eng._sched_lock:
            eng._evict_parked_lru()
        eng.continue_generation()
        upload = eng._upload
        calls = {"n": 0}

        def failing_upload(arr):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("planted upload failure")
            return upload(arr)
        eng._upload = failing_upload
        r = _gen(eng, other, "u")
        m = eng.get_metrics()
    finally:
        eng.destroy()
    _same(want, r)
    assert m["kv_promote_failures_total"] == 1 and m["kv_fabric_local_hits_total"] == 0
    assert m["prefills_total"] == 2  # h's, and this one in full


def test_warm_start_pulls_top_runs_then_hits(weights):
    prompt = _prompt(96, 43)
    a, b = _engine(weights), _engine(weights)
    sa, sb = _Port(a), _Port(b)
    try:
        _post(sa.addr, "/generate", dict(rid="w1", input_ids=prompt, gconfig=GREEDY))
        out = _post(sb.addr, "/warm_start", dict(peers=[sa.addr, sb.addr], max_sessions=2))
        mb = _post(sb.addr, "/metrics", method="GET")
        assert out["status"] == "ok" and out["peers"] == 1 and out["failures"] == 0
        assert out["sessions"] == 1 and out["bytes"] > 0
        assert mb["kv_fabric"]["warm_start_sessions"] == 1
        assert mb["kv_fabric_sessions_in_total"] == 1
        # w1's whole conversation is registered on A: 105 covered rows
        assert mb["kv_fabric_blocks_resident"] == 13
        m0 = b.get_metrics()
        r = _gen(b, prompt, "w2")
        m1 = b.get_metrics()
        assert len(r.output_tokens) == 10
        assert m1["kv_fabric_remote_hits_total"] - m0["kv_fabric_remote_hits_total"] == 1
        assert m1["prefills_total"] == m0["prefills_total"]
    finally:
        sb.stop()
        sa.stop()
        a.destroy()
        b.destroy()


def test_run_from_another_weight_version_is_an_honest_miss(weights):
    prompt = _prompt(96, 45)
    a, b = _engine(weights), _engine(weights)
    try:
        _gen(a, prompt, "s1")
        (sess,) = a.export_fabric_blocks(keys=_chain(a, prompt[:-1]))
        assert sess["meta"]["rid"].startswith("fabric-") and sess["meta"]["fabric"] is True
        b.set_version(7)  # a commit on B raced the fetch
        assert b.import_session(sess["meta"], sess["k"], sess["v"]) == "stale_version"
        m0 = b.get_metrics()
        assert m0["kv_fabric_sessions_in_total"] == 0
        assert m0["kv_migrate_version_rejects_total"] == 1
        r = _gen(b, prompt, "s2")
        m1 = b.get_metrics()
        assert len(r.output_tokens) == 10
        assert m1["kv_fabric_remote_hits_total"] == m1["kv_fabric_local_hits_total"] == 0
        assert m1["prefills_total"] - m0["prefills_total"] == 1
    finally:
        a.destroy()
        b.destroy()


def test_export_fabric_blocks_copies_and_drops_nothing(weights):
    prompt = _prompt(96, 47)
    exports = {}
    for jax_engine in (False, True):
        eng = _engine(weights, jax_engine)
        try:
            _gen(eng, prompt, "c1")
            chain = _chain(eng, prompt[:-1])
            before = eng.get_metrics()["kv_fabric_blocks_resident"]
            first = eng.export_fabric_blocks(keys=chain)
            assert len(first) == 1 and eng.export_fabric_blocks(keys=chain)  # repeatable
            top = eng.export_fabric_blocks(top=4)
            assert len(top) == 1 and top[0]["meta"]["nb"] == 13
            assert eng.get_metrics()["kv_fabric_blocks_resident"] == before
            r = _gen(eng, prompt, "c2")  # the donor still forks locally
            assert len(r.output_tokens) == 10
            assert eng.get_metrics()["prefills_total"] == 1
            exports[jax_engine] = first[0]
        finally:
            eng.destroy()
    t, j = exports[False], exports[True]
    assert t["meta"] == j["meta"]
    # the KV rows of the two packages' prefills and decode steps, which sum
    # in different orders: within 1e-5, absolute and relative
    for key in ("k", "v"):
        np.testing.assert_allclose(np.asarray(t[key]), np.asarray(j[key]), atol=1e-5,
                                   rtol=1e-5)


# -- identity-only sessions --------------------------------------------------


@pytest.mark.parametrize("src,dst", [("torch", "torch"), ("torch", "jax"), ("jax", "torch")])
def test_meta_only_session_round_trips_and_imports_honestly(weights, src, dst):
    prompt = _prompt(96, 49)
    g = SAMPLED
    pre = _engine(weights, jax_engine=src == "jax", role="prefill")
    try:
        _prefill(pre, prompt, "m", g)
        chain = _chain(pre, prompt[:-1])
        sess = pre.export_session("m", refetchable=set(chain))
        m = pre.get_metrics()
        assert m["kv_fabric_meta_only_exports_total"] == 1
        assert m["kv_migrated_out_sessions_total"] == 1
    finally:
        pre.destroy()
    assert sess["meta"]["meta_only"] is True and "k" not in sess
    frames = list(twt.pack_kv_session(sess["meta"], None, None, chunk_mb=0.01))
    assert frames == list(jwt.pack_kv_session(sess["meta"], None, None, chunk_mb=0.01))
    assert len(frames) == 1
    staged = (twt.WeightStaging if dst == "torch" else jwt.WeightStaging)()
    staged.add_bucket(frames[0])
    unpack = twt.unpack_kv_sessions if dst == "torch" else jwt.unpack_kv_sessions
    ((meta, k, v, scales),) = unpack(staged.finalize())
    assert meta == sess["meta"] and k is None and v is None and scales is None
    dec = _engine(weights, jax_engine=dst == "jax", role="decode")
    oracle = _engine(weights, role="decode")
    try:
        # the decode replica's own first admission draws its first key
        _gen(dec, _prompt(20, 50), "other", g)
        assert dec.import_session(meta, k, v) == "ok"
        m0 = dec.get_metrics()
        assert m0["kv_migrated_in_sessions_total"] == 1
        assert m0["kv_migrated_in_bytes_total"] == 0
        r = _gen(dec, prompt, "m", g)
        m1 = dec.get_metrics()
        # no sibling holds the blocks here: an honest prefill, no fabric hit
        assert m1["prefills_total"] - m0["prefills_total"] == 1
        assert m1["kv_fabric_remote_hits_total"] == 0
        # the identity kept the sampling key the prefill replica drew
        # (the first admission's), so the stream is a never-moved one's
        _same(_gen(oracle, prompt, "m", g), r)
    finally:
        dec.destroy()
        oracle.destroy()


def test_drain_sends_identities_the_survivor_can_serve(weights):
    """/drain with the survivor's digest as `refetchable`: the victim's
    parked session leaves as an identity (no block bytes), and its resume
    on the survivor forks the survivor's own blocks."""
    prompt = _prompt(96, 53)
    surv, victim = _engine(weights), _engine(weights)
    ss, sv = _Port(surv), _Port(victim)
    try:
        want = _gen(surv, prompt, "s0")  # the survivor holds the whole run
        _prefill(victim, prompt, "m")
        digest = surv.get_metrics()["kv_fabric_digest"]
        out = _post(sv.addr, "/drain", dict(targets=[ss.addr], refetchable=digest))
        m0 = surv.get_metrics()
        r = _gen(surv, prompt, "m")
        m1 = surv.get_metrics()
    finally:
        sv.stop()
        ss.stop()
        surv.destroy()
        victim.destroy()
    assert out["sessions"] == out["drained"] == out["meta_only"] == 1 and out["failed"] == 0
    assert out["bytes"] < 4096
    assert m0["kv_migrated_in_sessions_total"] == 1 and m0["kv_migrated_in_bytes_total"] == 0
    assert m1["prefills_total"] == m0["prefills_total"] == 1  # s0's own
    _same(want, r)


def test_refetchable_gate_needs_every_block(weights):
    prompt = _prompt(96, 51)
    for jax_engine in (False, True):
        pre = _engine(weights, jax_engine, role="prefill")
        try:
            _prefill(pre, prompt, "p")
            chain = _chain(pre, prompt[:-1])
            sess = pre.export_session("p", refetchable=set(chain[:-1]))
            assert not sess["meta"].get("meta_only") and sess["k"] is not None
            assert pre.get_metrics()["kv_fabric_meta_only_exports_total"] == 0
            assert pre.export_session("p", refetchable=set(chain)) is None  # it moved
        finally:
            pre.destroy()
