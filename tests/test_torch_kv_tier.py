"""The host KV tier, the gather paths and fp pools in another dtype, on the CPU.

The port's counterparts of `tests/test_kv_offload.py` and of the layout
and dtype cases of the JAX decode tests:

- `HostKVStore`: the five store cases of `tests/test_kv_offload.py`
  (:80-180) run on the JAX store and the port's, with equal decisions and
  counters; the `kv.swap_out` / `kv.swap_in` seams decide as the JAX
  injector does over the same visits.
- The tier in the engine. Several JAX tests of the tier fail on the
  reference itself (ROADMAP queue 3), so the port's evicted and preempted
  streams are held against a live `JaxDecodeEngine`'s never-evicted
  streams (greedy tokens equal, logprobs within `LOGP_ATOL`), and against
  the port's own never-evicted streams bit for bit (tokens and logprobs
  equal): paged and workspace, greedy and sampled, with spec decode on. A
  host miss prefills again, a disabled tier leaves every tier counter at
  0, a weight push clears the tier, int8 blocks go through it unchanged,
  and a planted offload or promotion fault degrades to a prefill with the
  same stream.
- The gather paths (`kv_layout="workspace"`, `paged_attn_impl="xla"`), with
  and without spec decode, against the JAX engine on the same layout,
  `kv_workspace_copy_bytes_total` equal to JAX's.
- All four pairs of model dtype and pool dtype in {float32, bfloat16}
  against the JAX engine's XLA path, and the plain mixed-dtype
  `paged_attention_ref` / `paged_attention_qlen_ref` against the JAX Pallas
  kernels in interpret mode.

Tolerances: greedy tokens exact everywhere. f32 logprobs within
`LOGP_ATOL` = 1e-5 of JAX (the packages sum in different orders). A bf16
model's logprobs within `BF16_LOGP_ATOL` = 0.05 of JAX's (bf16 matmuls
round differently in the two packages). An f32 model over a bf16 pool
within `POOL_ROUNDING_LOGP_ATOL` = 1e-3: a K/V row whose f32 value the two
packages sum to a different last bit may round to neighbouring bf16
values (one bf16 step is 2^-8 of the value), which moved logprobs by up
to 5.3e-5 here. The plain attention against the
Pallas kernels: 1e-5 when q is f32 (both widen a bf16 pool exactly);
`BF16_ATTN_TOL` = (2^-6, 2^-6) when q is bf16 (XLA rounds an f32 pool to
bf16 and scores in bf16, Pallas computes in f32).
"""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from areal_tpu.api.cli_args import GenerationHyperparameters as JaxGen
from areal_tpu.api.cli_args import InferenceEngineConfig as JaxInferenceConfig
from areal_tpu.api.cli_args import JaxDecodeConfig
from areal_tpu.api.io_struct import ModelRequest as JaxRequest
from areal_tpu.core import fault_injection as jfi
from areal_tpu.engine import jax_decode as jd
from areal_tpu.engine import kv_pool as jkv
from areal_tpu.models import qwen2 as jq
from areal_tpu.ops import paged_attention as jpa
from areal_tpu_torch.api.cli_args import GenerationHyperparameters, TorchDecodeConfig
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.core import fault_injection as tfi
from areal_tpu_torch.engine import kv_pool as tkv
from areal_tpu_torch.engine import torch_decode as td
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy
from areal_tpu_torch.ops import paged_attention as tpa

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2)
LOGP_ATOL = 1e-5
BF16_LOGP_ATOL = 0.05
POOL_ROUNDING_LOGP_ATOL = 1e-3
BF16_ATTN_TOL = (2.0 ** -6, 2.0 ** -6)
# the engines of `tests/test_kv_offload.py`: page 8, 4-token chunks
BASE = dict(page_size=8, new_tokens_per_chunk=4, spec_k=3, decode_runahead_chunks=1)
TIMEOUT = 180


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    tfi.deactivate()
    jfi.deactivate()
    yield
    tfi.deactivate()
    jfi.deactivate()


def _cfgs(dtype: str):
    kw = dict(KW, dtype=dtype, param_dtype=dtype)
    return jq.ModelConfig(**kw), tq.ModelConfig(**kw)


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port params) per model dtype, the same values."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _cfgs(dtype)
        jp = jq.init_params(jcfg, jax.random.PRNGKey(0))
        out[dtype] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg))
    return out


def _engine(weights, jax_engine: bool, dtype="float32", **cfg):
    cfg = dict(BASE, dtype=dtype, **{"kv_cache_dtype": dtype, **cfg})
    jcfg, tcfg = _cfgs(dtype)
    if jax_engine:
        eng = jd.JaxDecodeEngine(JaxDecodeConfig(**cfg), JaxInferenceConfig())
        eng.set_model(weights[dtype][0], jcfg)
    else:
        eng = td.TorchDecodeEngine(TorchDecodeConfig(**cfg), device="cpu")
        eng.set_model(weights[dtype][1], tcfg)
    return eng.initialize() or eng


def _req(eng, ids, g: dict, rid=None):
    jax_engine = isinstance(eng, jd.JaxDecodeEngine)
    gen = (JaxGen if jax_engine else GenerationHyperparameters)(**g)
    kw = {} if rid is None else dict(rid=rid)
    return (JaxRequest if jax_engine else ModelRequest)(input_ids=list(ids), gconfig=gen, **kw)


def _run(eng, reqs) -> list:
    """Serve `reqs` concurrently from one event loop in a thread."""
    out: dict = {}

    def go():
        async def main():
            return await asyncio.gather(*[eng.agenerate(r) for r in reqs])
        try:
            out["r"] = asyncio.run(main())
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["e"] = e

    t = threading.Thread(target=go, daemon=True)
    t.start()
    t.join(TIMEOUT)
    if "e" in out:
        raise out["e"]
    assert "r" in out, "the requests did not finish"
    return out["r"]


def _interrupt(eng, rid, prompt, g: dict):
    """One request, paused and aborted once it has emitted a token: its KV
    parks under `rid` (`tests/test_kv_offload.py::_interrupt_first_segment`)."""
    out: dict = {}

    def go():
        async def main():
            return await eng.agenerate(_req(eng, prompt, g, rid=rid))
        out["r"] = asyncio.run(main())

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
    return resp


def _resume(eng, rid, prompt, seg1, g: dict):
    """The client's resume: prompt + partial tokens under the same rid."""
    g = dict(g, max_new_tokens=g["max_new_tokens"] - len(seg1.output_tokens))
    return _run(eng, [_req(eng, list(prompt) + list(seg1.output_tokens), g, rid=rid)])[0]


def _streams(resps) -> list:
    return [(list(r.output_tokens), list(r.output_logprobs)) for r in resps]


def _prompts(seed: int, n: int, length: int = 8) -> list:
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, 60, length)] for _ in range(n)]


def _oracle(weights, jax_engine: bool, prompts, gs, **cfg) -> list:
    """Never-evicted streams: enough slots and the dense pool, so nothing
    is parked out or preempted."""
    eng = _engine(weights, jax_engine, max_running_requests=len(prompts) + 1, **cfg)
    try:
        return _streams(_run(eng, [_req(eng, p, g) for p, g in zip(prompts, gs)]))
    finally:
        eng.destroy()


def _assert_close(got, want, atol: float, what: str) -> None:
    """Tokens equal; logprobs within `atol` (0: equal)."""
    assert got[0] == want[0], f"{what}: tokens differ\n{got[0]}\n{want[0]}"
    if atol == 0:
        assert got[1] == want[1], f"{what}: logprobs differ"
    else:
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=atol, err_msg=what)


def _evict_and_resume(eng, prompts, g: dict, g_fill: dict):
    """Interrupt prompt 0, let the fillers (prompts 1..) evict its parked
    slot to the host tier, resume it: its joined stream and the fillers'."""
    seg1 = _interrupt(eng, "a", prompts[0], g)
    fillers = _run(eng, [_req(eng, p, g_fill) for p in prompts[1:]])
    seg2 = _resume(eng, "a", prompts[0], seg1, g)
    joined = (seg1.output_tokens + seg2.output_tokens,
              seg1.output_logprobs + seg2.output_logprobs)
    return joined, _streams(fillers)


# -- the store ---------------------------------------------------------------


def _entry(mod, rid, nb=2, covered=None, tokens=None, pending=False):
    covered = covered if covered is not None else nb * 4
    tokens = tokens if tokens is not None else list(range(covered))
    kw = dict(rid=rid, nb=nb, covered=covered, tokens=tokens, base_key=np.zeros(2, np.uint32),
              pending=pending)
    if mod is jkv:
        return mod.HostKVEntry(k=np.zeros((1, nb, 4, 1, 2), np.float32),
                               v=np.zeros((1, nb, 4, 1, 2), np.float32), rope_delta=0,
                               ts=time.monotonic(), **kw)
    return mod.HostKVEntry(k=torch.zeros(1, nb, 4, 1, 2), v=torch.zeros(1, nb, 4, 1, 2), **kw)


def _counters(st) -> dict:
    return {k: getattr(st, k) for k in (
        "bytes_used", "swap_out_bytes_total", "swap_in_bytes_total", "hits", "misses",
        "evictions", "rejected_puts", "reprefill_tokens_avoided")} | dict(n=len(st))


def _case_budget_lru_tombstones(mod, log):
    st = mod.HostKVStore(budget_bytes=200, block_nbytes=100, block_size=4)
    log += [st.put(_entry(mod, "a", nb=1)), st.put(_entry(mod, "b", nb=1)), _counters(st)]
    log += [st.put(_entry(mod, "c", nb=1)), _counters(st)]
    log += [st.match("a", 4, list(range(4))), st.match("a", 4, list(range(4))), _counters(st)]
    log += [st.put(_entry(mod, "huge", nb=3)), st.match("huge", 12, list(range(12)))]
    log += [st.match("b", 4, list(range(4)))]
    e = st.take("b")
    st.note_hit(e)
    log += [e.covered, _counters(st)]


def _case_stale_entry(mod, log):
    st = mod.HostKVStore(budget_bytes=1000, block_nbytes=100, block_size=4)
    st.put(_entry(mod, "a", nb=1, covered=4, tokens=[1, 2, 3, 4]))
    log += [st.match("a", 4, [1, 2, 3, 9]), _counters(st)]
    st.put(_entry(mod, "b", nb=1, covered=4, tokens=[1, 2, 3, 4]))
    log += [st.match("b", 3, [1, 2, 3]), _counters(st)]


def _case_take_restore(mod, log):
    st = mod.HostKVStore(budget_bytes=1000, block_nbytes=100, block_size=4)
    st.put(_entry(mod, "a", nb=2))
    e = st.take("a")
    log += [_counters(st)]
    st.restore(e)
    log += [_counters(st), st.match("a", e.covered, e.tokens)]


def _case_clear(mod, log):
    st = mod.HostKVStore(budget_bytes=1000, block_nbytes=100, block_size=4)
    st.put(_entry(mod, "a", nb=1))
    st.put(_entry(mod, "b", nb=1))
    log += [st.clear(), _counters(st)]
    log += [st.match("a", 4, list(range(4))), st.match("b", 4, list(range(4))), _counters(st)]


class _CountingArray:
    """A JAX entry's in-flight device array: `np.asarray` materializes it."""

    def __init__(self, arr):
        self.arr, self.materialized = arr, 0

    def __array__(self, dtype=None, copy=None):
        self.materialized += 1
        return self.arr

    def copy_to_host_async(self):
        pass


class _CountingEvent:
    """A port entry's copy event: `materialize` waits on it once."""

    def __init__(self):
        self.materialized = 0

    def synchronize(self):
        self.materialized += 1


def _case_pending_window(mod, log):
    st = mod.HostKVStore(budget_bytes=10_000, block_nbytes=100, block_size=4, pending_window=2)
    marks = []
    for rid in ("a", "b", "c", "d"):
        e = _entry(mod, rid, nb=1, pending=True)
        if mod is jkv:
            e.k, e.v = _CountingArray(np.asarray(e.k)), _CountingArray(np.asarray(e.v))
            marks.append(e.k)
        else:
            e.event = _CountingEvent()
            marks.append(e.event)
        st.put(e)
    log += [[m.materialized for m in marks]]
    e = st.take("d")
    log += [[m.materialized for m in marks], e.pending]
    st.flush_pending()
    log += [[m.materialized for m in marks], _counters(st)]


STORE_CASES = dict(budget_lru_tombstones=_case_budget_lru_tombstones,
                   stale_entry=_case_stale_entry, take_restore=_case_take_restore,
                   clear=_case_clear, pending_window=_case_pending_window)


@pytest.mark.parametrize("case", STORE_CASES)
def test_store_case_matches_jax(case):
    logs = {}
    for mod in (jkv, tkv):
        logs[mod] = []
        STORE_CASES[case](mod, logs[mod])
    assert logs[tkv] == logs[jkv]


@pytest.mark.parametrize("plan", [
    '{"seed": 5, "points": [{"site": "kv.swap_out", "at": [1, 3]}]}',
    '{"seed": 7, "points": [{"site": "kv.swap_*", "p": 0.5, "times": 0}]}',
])
def test_swap_seams_decide_as_jax(plan):
    """The same puts and takes under the same plan raise at the same visits
    in both packages' stores and leave equal counters and snapshots."""
    logs = {}
    for mod, fi in ((jkv, jfi), (tkv, tfi)):
        fi.configure(fi.FaultPlan.from_json(plan))
        st = mod.HostKVStore(budget_bytes=10_000, block_nbytes=100, block_size=4)
        log = []
        for i in range(6):
            for op in ("put", "take"):
                try:
                    log.append(bool(st.put(_entry(mod, f"r{i}", nb=1))) if op == "put"
                               else st.take(f"r{i}") is not None)
                except fi.InjectedFault:
                    log.append("fault")
        logs[mod] = (log, _counters(st), fi.snapshot())
        fi.deactivate()
    assert logs[tkv] == logs[jkv]
    assert "fault" in logs[tkv][0]


# -- the tier in the engine --------------------------------------------------


@pytest.mark.parametrize("kv_layout", ["paged", "workspace"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_evicted_resume_against_jax(weights, kv_layout, greedy):
    """Park, evict to the host tier, promote: the joined stream equals the
    JAX engine's never-evicted one and, bit for bit, the port's own."""
    prompts = _prompts(11, 3)
    g = dict(greedy=greedy, temperature=1.0, max_new_tokens=48)
    g_fill = dict(g, max_new_tokens=12)
    gs = [g, g_fill, g_fill]
    cfg = dict(kv_layout=kv_layout, paged_attn_impl="xla", spec_decode="ngram")
    want = _oracle(weights, True, prompts, gs, **cfg)
    own = _oracle(weights, False, prompts, gs, **cfg)
    eng = _engine(weights, False, max_running_requests=2, kv_host_pool_mb=64, **cfg)
    try:
        joined, fillers = _evict_and_resume(eng, prompts, g, g_fill)
        m = eng.get_metrics()
    finally:
        eng.destroy()
    assert m["kv_host_hits_total"] == 1 and m["kv_host_hit_rate"] == 1.0, m
    assert m["kv_swap_in_bytes_total"] > 0 and m["reprefill_tokens_avoided_total"] > 0, m
    assert m["prefills_total"] == 3, m  # the resume prefilled nothing
    assert m["kv_offload_failures_total"] == m["kv_promote_failures_total"] == 0, m
    _assert_close(joined, want[0], LOGP_ATOL, "evicted resume vs JAX never-evicted")
    _assert_close(joined, own[0], 0, "evicted resume vs the port's never-evicted")
    for f, w in zip(fillers, own[1:]):
        _assert_close(f, w, 0, "filler")


def test_preempt_offload_against_jax(weights):
    """Pool pressure preempts active slots; with the tier their consumed
    coverage is offloaded and promoted back at re-admission: sampled
    streams equal JAX's never-preempted ones, and the port's bit for bit."""
    prompts = _prompts(7, 3)
    g = dict(greedy=False, temperature=1.0, max_new_tokens=60)
    cfg = dict(context_length=128, paged_attn_impl="xla", spec_decode="ngram")
    want = _oracle(weights, True, prompts, [g] * 3, **cfg)
    own = _oracle(weights, False, prompts, [g] * 3, **cfg)
    # 24 usable blocks, 3 x 8-block admissions: crossing 64 rows preempts
    eng = _engine(weights, False, max_running_requests=3, kv_pool_tokens=192,
                  kv_host_pool_mb=64, **cfg)
    try:
        got = _streams(_run(eng, [_req(eng, p, g) for p in prompts]))
        m = eng.get_metrics()
    finally:
        eng.destroy()
    assert m["preemptions_total"] > 0 and m["kv_host_hits_total"] > 0, m
    for a, w, o in zip(got, want, own):
        _assert_close(a, w, LOGP_ATOL, "preempted vs JAX")
        _assert_close(a, o, 0, "preempted vs the port's never-preempted")


def test_host_miss_prefills_again(weights):
    """Session 0's host entry is evicted from the tier by session 1's
    offload (a 6-block budget): its resume misses and prefills, session
    1's hits; both greedy streams equal JAX's never-evicted ones
    (`tests/test_kv_offload.py::test_host_miss_falls_back_to_reprefill`)."""
    prompts = _prompts(23, 2, 30) + _prompts(24, 2)
    g = dict(greedy=True, max_new_tokens=48)
    g_fill = dict(g, max_new_tokens=12)
    cfg = dict(paged_attn_impl="xla", spec_decode="ngram", new_tokens_per_chunk=2)
    want = _oracle(weights, True, prompts, [g, g, g_fill, g_fill], **cfg)
    block = 2 * 2 * 8 * 2 * 8 * 4  # K+V bytes of a block: 2 layers, page 8, f32
    eng = _engine(weights, False, max_running_requests=2,
                  kv_host_pool_mb=6 * block / (1024 * 1024), **cfg)
    try:
        seg1 = [_interrupt(eng, f"s{i}", prompts[i], g) for i in range(2)]
        _run(eng, [_req(eng, p, g_fill) for p in prompts[2:]])
        mid = eng.get_metrics()
        p0 = eng.prefill_calls
        seg2 = [_resume(eng, f"s{i}", prompts[i], seg1[i], g) for i in range(2)]
        m = eng.get_metrics()
        assert eng.prefill_calls - p0 == 1  # the miss only
    finally:
        eng.destroy()
    assert mid["kv_host_evictions_total"] >= 1 and mid["kv_host_pool_entries"] == 1, mid
    assert m["kv_host_misses_total"] == 1 and m["kv_host_hits_total"] == 1, m
    assert m["kv_host_hit_rate"] == 0.5
    for i in range(2):
        joined = (seg1[i].output_tokens + seg2[i].output_tokens,
                  seg1[i].output_logprobs + seg2[i].output_logprobs)
        _assert_close(joined, want[i], LOGP_ATOL, f"session {i}")


TIER_KEYS = ("kv_host_pool_tokens", "kv_host_pool_entries", "kv_host_pool_bytes",
             "kv_swap_out_bytes_total", "kv_swap_in_bytes_total", "kv_host_hits_total",
             "kv_host_misses_total", "kv_host_evictions_total", "kv_offload_failures_total",
             "kv_promote_failures_total", "reprefill_tokens_avoided_total")


def test_disabled_tier_keeps_todays_counters(weights):
    """kv_host_pool_mb=0: eviction drops the parked KV, the resume prefills,
    every tier counter stays 0, and the greedy stream is JAX's."""
    prompts = _prompts(31, 3)
    g = dict(greedy=True, max_new_tokens=48)
    g_fill = dict(g, max_new_tokens=12)
    cfg = dict(paged_attn_impl="xla", spec_decode="ngram")
    want = _oracle(weights, True, prompts, [g, g_fill, g_fill], **cfg)
    eng = _engine(weights, False, max_running_requests=2, **cfg)
    try:
        assert eng._host_store is None
        joined, _ = _evict_and_resume(eng, prompts, g, g_fill)
        m = eng.get_metrics()
    finally:
        eng.destroy()
    assert not m["kv_host_pool_enabled"] and m["kv_host_hit_rate"] == 0.0
    assert all(m[k] == 0 for k in TIER_KEYS), {k: m[k] for k in TIER_KEYS}
    assert m["prefills_total"] == 4, m  # the resume prefilled again
    _assert_close(joined, want[0], LOGP_ATOL, "drop-and-prefill resume")


def test_weight_push_clears_the_tier(weights):
    """A weight install empties the tier; the resume after it is a
    tombstoned miss and prefills, with JAX's greedy stream."""
    prompts = _prompts(41, 3)
    g = dict(greedy=True, max_new_tokens=48)
    g_fill = dict(g, max_new_tokens=12)
    cfg = dict(paged_attn_impl="xla", spec_decode="off")
    want = _oracle(weights, True, prompts, [g, g_fill, g_fill], **cfg)
    eng = _engine(weights, False, max_running_requests=2, kv_host_pool_mb=64, **cfg)
    try:
        seg1 = _interrupt(eng, "a", prompts[0], g)
        _run(eng, [_req(eng, p, g_fill) for p in prompts[1:]])
        assert eng.get_metrics()["kv_swap_out_bytes_total"] > 0
        eng.update_weights_from_distributed(None, params=weights["float32"][1])
        assert eng.get_metrics()["kv_host_pool_entries"] == 0
        seg2 = _resume(eng, "a", prompts[0], seg1, g)
        m = eng.get_metrics()
    finally:
        eng.destroy()
    assert m["kv_host_hits_total"] == 0 and m["kv_host_misses_total"] == 1, m
    _assert_close((seg1.output_tokens + seg2.output_tokens,
                   seg1.output_logprobs + seg2.output_logprobs), want[0], LOGP_ATOL, "after push")


def test_int8_blocks_through_the_tier(weights):
    """An int8 pool's blocks and scales go to the host and back as they
    are: evicted streams equal the same engine's never-evicted ones bit for
    bit, and the swap bytes are whole int8 blocks (data and scales)."""
    prompts = _prompts(13, 3)
    g = dict(greedy=False, temperature=1.0, max_new_tokens=40)
    g_fill = dict(g, max_new_tokens=12)
    cfg = dict(kv_dtype="int8", spec_decode="ngram")
    own = _oracle(weights, False, prompts, [g, g_fill, g_fill], **cfg)
    eng = _engine(weights, False, max_running_requests=2, kv_host_pool_mb=64, **cfg)
    try:
        joined, fillers = _evict_and_resume(eng, prompts, g, g_fill)
        m = eng.get_metrics()
    finally:
        eng.destroy()
    block = 2 * 2 * 8 * 2 * (8 + 4)  # int8 data and an f32 scale per (row, kv head)
    assert m["kv_block_nbytes"] == block and m["kv_host_hits_total"] == 1, m
    assert m["kv_swap_out_bytes_total"] % block == 0 and m["kv_swap_in_bytes_total"] > 0, m
    _assert_close(joined, own[0], 0, "int8 evicted vs never-evicted")
    for f, w in zip(fillers, own[1:]):
        _assert_close(f, w, 0, "int8 filler")


@pytest.mark.parametrize("site,counter", [("kv.swap_out", "kv_offload_failures_total"),
                                          ("kv.swap_in", "kv_promote_failures_total")])
def test_planted_swap_fault_degrades_to_prefill(weights, site, counter):
    """One planted fault at a seam: counted once, the resume prefills, and
    its greedy stream is the never-evicted one bit for bit (a prefilled
    resume is a new admission with a new sampling key, as in JAX, so only
    greedy streams survive a miss)."""
    prompts = _prompts(11, 3)
    g = dict(greedy=True, max_new_tokens=48)
    g_fill = dict(g, max_new_tokens=12)
    cfg = dict(spec_decode="ngram")
    own = _oracle(weights, False, prompts, [g, g_fill, g_fill], **cfg)
    eng = _engine(weights, False, max_running_requests=2, kv_host_pool_mb=64, **cfg)
    tfi.configure(tfi.FaultPlan.from_json(f'{{"points": [{{"site": "{site}", "at": [0]}}]}}'))
    try:
        joined, _ = _evict_and_resume(eng, prompts, g, g_fill)
        m = eng.get_metrics()
    finally:
        eng.destroy()
    assert m[counter] == 1 and m["kv_host_hits_total"] == 0, m
    assert m["prefills_total"] == 4, m
    _assert_close(joined, own[0], 0, f"{site} fault")


@pytest.mark.parametrize("site", [None, "kv.swap_out", "kv.swap_in"])
def test_swap_rates_count_what_the_store_kept(weights, site):
    """`swap_rates` reads its bytes from the store, so they equal the
    metrics' swap bytes; an offload whose entry the store refused, or a
    promotion that never uploaded, adds no seconds either."""
    prompts = _prompts(11, 3)
    g = dict(greedy=True, max_new_tokens=48)
    eng = _engine(weights, False, max_running_requests=2, kv_host_pool_mb=64)
    if site:
        tfi.configure(tfi.FaultPlan.from_json(f'{{"points": [{{"site": "{site}", "at": [0]}}]}}'))
    try:
        _evict_and_resume(eng, prompts, g, dict(g, max_new_tokens=12))
        m, rates = eng.get_metrics(), eng.swap_rates()
    finally:
        tfi.deactivate()
        eng.destroy()
    for way in ("out", "in"):
        assert rates[way]["bytes"] == m[f"kv_swap_{way}_bytes_total"], (way, rates, m)
        assert (rates[way]["seconds"] > 0) == (rates[way]["bytes"] > 0), (way, rates)
    moved = {None: ("out", "in"), "kv.swap_out": (), "kv.swap_in": ("out",)}[site]
    assert tuple(w for w in ("out", "in") if rates[w]["bytes"]) == moved, rates


def test_refused_layouts_and_pools(weights):
    for cfg, exc, match in ((dict(kv_dtype="int8", kv_layout="workspace"), ValueError,
                             "kv_layout='paged'"),
                            (dict(kv_layout="ring"), ValueError, "kv_layout"),
                            (dict(kv_cache_dtype="float16"), NotImplementedError, "item 3.6")):
        eng = td.TorchDecodeEngine(TorchDecodeConfig(**dict(BASE, dtype="float32", **cfg)),
                                   device="cpu")
        eng.set_model(weights["float32"][1], _cfgs("float32")[1])
        with pytest.raises(exc, match=match):
            eng.initialize()


# -- the gather paths --------------------------------------------------------


@pytest.mark.parametrize("spec", ["off", "ngram"])
@pytest.mark.parametrize("layout", ["workspace", "xla"])
def test_gather_path_matches_jax(weights, layout, spec):
    """A wave of greedy and sampled requests on the workspace layout or the
    paged gather path: streams equal the JAX engine's on the same layout,
    and so does `kv_workspace_copy_bytes_total` (run-ahead 0, so both
    engines dispatch the same passes)."""
    prompts = _prompts(5, 4, 12)
    gs = [dict(greedy=True, max_new_tokens=24), dict(greedy=True, max_new_tokens=17),
          dict(greedy=False, temperature=1.0, max_new_tokens=24),
          dict(greedy=False, temperature=0.7, max_new_tokens=9)]
    cfg = dict(kv_layout="workspace" if layout == "workspace" else "paged",
               paged_attn_impl="xla", spec_decode=spec, decode_runahead_chunks=0,
               max_running_requests=4)
    got = {}
    for jax_engine in (True, False):
        eng = _engine(weights, jax_engine, **cfg)
        try:
            got[jax_engine] = (_streams(_run(eng, [_req(eng, p, g) for p, g in zip(prompts, gs)])),
                               eng.get_metrics()["kv_workspace_copy_bytes_total"])
        finally:
            eng.destroy()
    for a, w in zip(got[False][0], got[True][0]):
        _assert_close(a, w, LOGP_ATOL, f"{layout}/{spec}")
    assert got[False][1] == got[True][1] > 0


# -- fp pools in another dtype -----------------------------------------------

PAIRS = [("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32"),
         ("bfloat16", "bfloat16")]


@pytest.mark.parametrize("dtype,pool", PAIRS, ids=[f"{a}-{b}" for a, b in PAIRS])
def test_dtype_pair_matches_jax(weights, dtype, pool):
    """Greedy streams of a model in `dtype` over a pool in `pool`, with
    spec decode on, equal the JAX engine's XLA path."""
    prompts = _prompts(3, 3, 10)
    g = dict(greedy=True, max_new_tokens=20)
    cfg = dict(kv_cache_dtype=pool, paged_attn_impl="xla", spec_decode="ngram",
               decode_runahead_chunks=0, max_running_requests=3)
    got = {}
    for jax_engine in (True, False):
        eng = _engine(weights, jax_engine, dtype=dtype, **cfg)
        try:
            if not jax_engine:
                assert eng._k_pool.dtype == tq.torch_dtype(pool)
            got[jax_engine] = _streams(_run(eng, [_req(eng, p, g) for p in prompts]))
        finally:
            eng.destroy()
    atol = (BF16_LOGP_ATOL if dtype == "bfloat16"
            else POOL_ROUNDING_LOGP_ATOL if pool == "bfloat16" else LOGP_ATOL)
    for a, w in zip(got[False], got[True]):
        _assert_close(a, w, atol, f"{dtype} over a {pool} pool")


def _mixed_case(qdt, pdt, W: int, seed: int = 0):
    """q in `qdt` over a pool in `pdt`: slot 0 ends on page 1's last row,
    slot 1 mid-page 2, slot 2 on row 0."""
    R, nH, nKV, hd, bsz, nb = 3, 8, 2, 16, 8, 3
    g = torch.Generator().manual_seed(seed)
    k = torch.randn(1 + R * nb, bsz, nKV, hd, generator=g).to(pdt)
    v = torch.randn(1 + R * nb, bsz, nKV, hd, generator=g).to(pdt)
    q = torch.randn(R, W, nH, hd, generator=g).to(qdt)
    table = torch.arange(1, 1 + R * nb, dtype=torch.int32).reshape(R, nb)
    ends = torch.tensor([bsz - 1, bsz + 3, 0])
    pos = ends[:, None] + torch.arange(W)
    valid = torch.arange(nb * bsz)[None, None, :] <= pos[:, :, None]
    return q, k, v, table, valid


@pytest.mark.parametrize("verify", [False, True], ids=["decode", "verify"])
@pytest.mark.parametrize("qdt,pdt", [(torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)],
                         ids=["f32q-bf16pool", "bf16q-f32pool"])
def test_mixed_plain_attention_against_pallas(qdt, pdt, verify):
    """The plain mixed-dtype attention (the kernels' reference) against the
    JAX Pallas kernel in interpret mode on the same inputs, and against
    JAX's XLA path exactly in the f32 case up to `LOGP_ATOL`."""
    W = 3 if verify else 1
    q, k, v, table, valid = _mixed_case(qdt, pdt, W)

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else t.numpy().dtype)

    if verify:
        ref = tpa.paged_attention_qlen_ref(q, k, v, table, valid)
        pallas = jpa.paged_attention_qlen(j(q), j(k), j(v), jnp.asarray(table.numpy()),
                                          jnp.asarray(valid.numpy()), impl="pallas", interpret=True)
    else:
        ref = tpa.paged_attention_ref(q[:, 0], k, v, table, valid[:, 0])
        pallas = jpa.paged_attention(j(q[:, 0]), j(k), j(v), jnp.asarray(table.numpy()),
                                     jnp.asarray(valid[:, 0].numpy()), impl="pallas",
                                     interpret=True)
    assert ref.dtype == qdt
    got = ref.float().numpy()
    want = np.asarray(pallas.astype(jnp.float32))
    if qdt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGP_ATOL)
    else:
        atol, rtol = BF16_ATTN_TOL
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
