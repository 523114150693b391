"""TorchDecodeEngine's run-ahead dispatch (`decode_runahead_chunks`).

The port's counterparts of `tests/test_decode_runahead.py`: with the
run-ahead on (1, the default), pass k+1 is dispatched before the host
consumes pass k. Per-slot position keys make every stream a function of
its key and positions alone, so the streams of `decode_runahead_chunks`
0 and 1 must be equal bit for bit inside the port; the greedy ones are
also held against a live JaxDecodeEngine (tokens equal, logprobs within
`LOGP_ATOL`). Then the reconcile (a slot retired by a stop id while its
next pass is in flight, its length rewound), the pause that drains every
pass in flight and so fences a weight commit, the count of consumed
tokens only, speculation and the frequency penalty under run-ahead, and
pool pressure while saturated slots still hold blocks.
"""

import asyncio
import threading
import time

import numpy as np
import pytest

import jax

from areal_tpu.api.cli_args import GenerationHyperparameters as JaxGen
from areal_tpu.api.cli_args import InferenceEngineConfig as JaxInferenceConfig
from areal_tpu.api.cli_args import JaxDecodeConfig
from areal_tpu.api.io_struct import ModelRequest as JaxRequest
from areal_tpu.engine import jax_decode as jd
from areal_tpu.models import qwen2 as jq
from areal_tpu_torch.api.cli_args import GenerationHyperparameters, TorchDecodeConfig
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.engine import torch_decode as td
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy

KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, dtype="float32",
          param_dtype="float32")
JCFG = jq.ModelConfig(**KW)
TCFG = tq.ModelConfig(**KW)
LOGP_ATOL = 1e-5
BASE = dict(page_size=16, dtype="float32", kv_cache_dtype="float32")


@pytest.fixture(scope="module")
def weights():
    jparams = jq.init_params(JCFG, jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG)


def _make_engine(tparams, runahead: int, **kw):
    cfg = dict(context_length=128, max_running_requests=4, new_tokens_per_chunk=4,
               random_seed=5)
    cfg.update(kw)
    eng = td.TorchDecodeEngine(
        TorchDecodeConfig(**BASE, decode_runahead_chunks=runahead, **cfg), device="cpu")
    eng.set_model(tparams, TCFG)
    return eng.initialize()


def _run(eng, reqs):
    async def go():
        return await asyncio.gather(*[eng.agenerate(r) for r in reqs])

    return asyncio.run(go())


def _wave(eng, reqs):
    """Serve `reqs` as one admission wave: queued while the engine is
    paused, then released together."""
    eng.pause_generation()
    out: list = []
    t = threading.Thread(target=lambda: out.extend(_run(eng, reqs)), daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while eng._request_q.qsize() < len(reqs):
        assert time.monotonic() < deadline, "requests never enqueued"
        time.sleep(0.005)
    eng.continue_generation()
    t.join(300)
    assert len(out) == len(reqs), "the wave did not finish"
    return out


def _both(tparams, make_reqs, **kw):
    """The same request set on a run-ahead 0 and a run-ahead 1 engine."""
    outs = []
    for runahead in (0, 1):
        eng = _make_engine(tparams, runahead, **kw)
        try:
            outs.append(_run(eng, make_reqs()))
        finally:
            eng.destroy()
    return outs


def _bit_equal(sync, ahead) -> None:
    for i, (a, b) in enumerate(zip(sync, ahead)):
        assert a.output_tokens == b.output_tokens, i
        assert a.output_logprobs == b.output_logprobs, i
        assert a.stop_reason == b.stop_reason, i


def test_greedy_bit_identical_runahead(weights):
    """Greedy streams of more requests than slots: bit-identical between
    run-ahead 0 and 1, and the JAX engine's (test_decode_runahead.py:79)."""
    def reqs(cls=ModelRequest, gen=GenerationHyperparameters):
        return [cls(input_ids=[2 + i, 7, 11, 3], gconfig=gen(greedy=True, max_new_tokens=10))
                for i in range(6)]

    sync, ahead = _both(weights[1], reqs)
    _bit_equal(sync, ahead)
    jeng = jd.JaxDecodeEngine(JaxDecodeConfig(
        **BASE, context_length=128, max_running_requests=4, new_tokens_per_chunk=4,
        random_seed=5), JaxInferenceConfig())
    jeng.set_model(weights[0], JCFG)
    jeng.initialize()
    try:
        want = _run(jeng, reqs(JaxRequest, JaxGen))
    finally:
        jeng.destroy()
    for a, b in zip(want, ahead):
        assert b.output_tokens == a.output_tokens
        np.testing.assert_allclose(b.output_logprobs, a.output_logprobs, atol=LOGP_ATOL, rtol=0)


def test_sampled_bit_identical_runahead(weights):
    """Sampled streams (temperature 1, top-p 0.9 on every other request)
    are bit-identical too (test_decode_runahead.py:98)."""
    def reqs():
        return [ModelRequest(input_ids=[1 + i, 9, 4], gconfig=GenerationHyperparameters(
            temperature=1.0, top_p=0.9 if i % 2 else 1.0, max_new_tokens=9)) for i in range(5)]

    _bit_equal(*_both(weights[1], reqs))


def test_stop_token_bit_identical_and_lengths_rewound(weights):
    """A stop id found mid-chunk retires the slot while its next pass is in
    flight: that pass's tokens are discarded, the slot's length rewound to
    the true end (its registration covers exactly prompt[:-1] + the
    delivered tokens), and the stream equals the synchronous one; the
    engine stays right for a later request on the retired donor's KV
    (test_decode_runahead.py:125)."""
    prompt = [1, 5, 9, 13, 2]
    probe = _make_engine(weights[1], 0)
    try:
        full = probe.generate(ModelRequest(input_ids=prompt, gconfig=GenerationHyperparameters(
            greedy=True, max_new_tokens=12)), timeout=120).output_tokens
    finally:
        probe.destroy()
    stop = full[5]  # inside the second chunk of 4
    cut = full.index(stop) + 1

    def reqs():
        return [ModelRequest(input_ids=prompt, gconfig=GenerationHyperparameters(
            greedy=True, max_new_tokens=12, stop_token_ids=[stop]))]

    sync_eng = _make_engine(weights[1], 0)
    try:
        sync, = _run(sync_eng, reqs())
    finally:
        sync_eng.destroy()
    eng = _make_engine(weights[1], 1)
    try:
        resp = eng.generate(reqs()[0], timeout=120)
        _bit_equal([sync], [resp])
        assert resp.stop_reason == "stop" and resp.output_tokens == full[:cut]
        eng.pause_generation()
        assert not eng._inflight
        assert eng.runahead_discarded > 0, "the next pass was in flight at the stop"
        assert all(int(x) == 0 for x in eng._slot_lengths)
        keys = [k for k in eng._slot_prefix if k is not None]
        assert [len(k) for k in keys] == [len(prompt) - 1 + cut]
        assert eng.decode_tokens == cut
        eng.continue_generation()
        again = eng.generate(ModelRequest(input_ids=prompt, gconfig=GenerationHyperparameters(
            greedy=True, max_new_tokens=6)), timeout=120)
        assert again.output_tokens == full[:6]
        assert eng._n_prefills == 1 and eng._n_prefix_forks + eng._n_prefix_inplace == 1
    finally:
        eng.destroy()


def _start(eng, req):
    box = {}
    done = threading.Event()

    def run():
        box["resp"] = eng.generate(req, timeout=300)
        done.set()

    threading.Thread(target=run, daemon=True).start()
    deadline = time.monotonic() + 60
    while not eng._active_mask().any():
        assert time.monotonic() < deadline, "the request was never admitted"
        time.sleep(0.001)
    return box, done


def test_pause_drains_inflight_chunks(weights):
    """pause_generation returns only once no pass is dispatched: a version
    bump inside the pause never stamps a token of the pass before it
    (test_decode_runahead.py:193)."""
    eng = _make_engine(weights[1], 1, context_length=512, max_running_requests=2)
    try:
        box, done = _start(eng, ModelRequest(input_ids=[3, 1, 4],
                                             gconfig=GenerationHyperparameters(
                                                 greedy=True, max_new_tokens=200)))
        for _ in range(3):
            eng.pause_generation()
            assert not eng._inflight
            eng.set_version(eng.get_version() + 1)
            eng.continue_generation()
            time.sleep(0.02)
        assert done.wait(120)
        versions = box["resp"].output_versions
        assert versions == sorted(versions) and len(versions) == 200
    finally:
        eng.destroy()


def test_commit_weights_fenced_by_drain(weights):
    """A weight push pauses, and the pause consumes the pass in flight
    before the install: tokens after the push carry the new version, and
    the version sequence flips once (test_decode_runahead.py:241)."""
    eng = _make_engine(weights[1], 1, context_length=512, max_running_requests=2)
    try:
        box, done = _start(eng, ModelRequest(input_ids=[3, 1, 4],
                                             gconfig=GenerationHyperparameters(
                                                 greedy=True, max_new_tokens=160)))
        new = jq.init_params(JCFG, jax.random.PRNGKey(9))
        eng.update_weights_from_tensor(params_from_numpy(jax.tree.map(np.asarray, new), TCFG),
                                       version=7)
        assert not eng._inflight
        assert done.wait(120)
        versions = box["resp"].output_versions
        assert set(versions) <= {0, 7} and versions == sorted(versions)
    finally:
        eng.destroy()


def test_generated_token_count_counts_consumed_only(weights):
    """Tokens cut past a stop never count as delivered: 6 of a chunk's 8
    are cut, and only the 2 delivered are counted
    (test_decode_runahead.py:286)."""
    eng = _make_engine(weights[1], 0, new_tokens_per_chunk=8)
    try:
        probe = eng.generate(ModelRequest(input_ids=[2, 7, 11], gconfig=GenerationHyperparameters(
            greedy=True, max_new_tokens=8)), timeout=120)
        count0 = eng.decode_tokens
        assert count0 == probe.output_len
        resp = eng.generate(ModelRequest(input_ids=[2, 7, 11], gconfig=GenerationHyperparameters(
            greedy=True, max_new_tokens=8, stop_token_ids=[probe.output_tokens[1]])), timeout=120)
        assert resp.stop_reason == "stop" and resp.output_len == 2
        assert eng.decode_tokens == count0 + 2 and eng.tokens_cut == 6
    finally:
        eng.destroy()


def _echo(tparams):
    """Weights whose attention and MLP outputs are zero, so each token's
    logits depend on the token alone: greedy streams enter a short cycle
    that the n-gram drafter predicts (as tests/test_torch_spec_decode.py)."""
    out = dict(tparams)
    for name in ("layers/attn/o_kernel", "layers/mlp/down_kernel"):
        out[name] = out[name] * 0
    return out


def _spec_requests():
    rng = np.random.default_rng(11)
    reqs = []
    for i, n_new in enumerate([37, 30, 26, 33, 29, 35]):
        seg = rng.integers(0, JCFG.vocab_size, 4 + i).tolist()
        g = GenerationHyperparameters(max_new_tokens=n_new, greedy=i < 3,
                                      top_p=0.7 if i == 5 else 1.0, temperature=1.0)
        reqs.append(ModelRequest(rid=f"r{i}", input_ids=seg * 3, gconfig=g))
    return reqs


@pytest.mark.parametrize("dtypes", [("fp", "fp"), ("int8", "int8")], ids=["fp", "w8kv8"])
def test_spec_streams_under_runahead_equal_spec_off(weights, dtypes):
    """Speculative decode under run-ahead (passes already landed consumed
    before drafting; acceptance and the next pass's lengths on the
    device): the streams equal the synchronous spec-off engine's, and
    the counters add up."""
    params = _echo(weights[1])
    w, kv = dtypes
    outs, engines = {}, {}
    for spec, runahead in (("off", 0), ("ngram", 1)):
        eng = _make_engine(params, runahead, context_length=128, new_tokens_per_chunk=8,
                           spec_decode=spec, spec_k=4, weight_dtype=w, kv_dtype=kv)
        try:
            outs[spec] = _run(eng, [r.copy() for r in _spec_requests()])
        finally:
            eng.destroy()
        engines[spec] = eng
    on = engines["ngram"]
    assert on.verify_dispatches > 0 and on.spec_accepted > 0
    for a, b in zip(outs["off"], outs["ngram"]):
        assert b.output_tokens == a.output_tokens
        np.testing.assert_allclose(b.output_logprobs, a.output_logprobs, atol=LOGP_ATOL, rtol=0)
    delivered = sum(r.output_len for r in outs["ngram"])
    assert on.decode_tokens == delivered
    assert on.spec_chunk_slots + on.spec_accepted + on.chunk_tokens - on.tokens_cut == delivered
    assert on.spec_drafted == on.spec_accepted + on.spec_rejected


def test_frequency_penalty_under_runahead_and_speculation(weights):
    """A penalized request's counts evolve token by token, chained on the
    device across passes: its stream (greedy and sampled) is bit-identical
    under run-ahead 0 and 1; on a spec engine no verify forward runs while
    it is active, and its stream is the spec-off one."""
    def reqs():
        return [ModelRequest(input_ids=[3, 7, 11, 3, 7, 11], gconfig=GenerationHyperparameters(
                    greedy=True, max_new_tokens=30, frequency_penalty=1.0)),
                ModelRequest(input_ids=[5, 2, 5, 2], gconfig=GenerationHyperparameters(
                    temperature=0.5, max_new_tokens=30, frequency_penalty=2.0))]

    params = _echo(weights[1])
    sync, ahead = _both(params, reqs)
    _bit_equal(sync, ahead)
    eng = _make_engine(params, 1, spec_decode="ngram", spec_k=4)
    try:
        got = _run(eng, reqs())
        assert eng.verify_dispatches == 0 and eng.decode_steps > 0
        # a penalty-free self-quoting request alone does verify
        eng.generate(ModelRequest(input_ids=[5, 2, 5, 2], gconfig=GenerationHyperparameters(
            greedy=True, max_new_tokens=20)), timeout=120)
        assert eng.verify_dispatches > 0
    finally:
        eng.destroy()
    _bit_equal(sync, got)


PRESSURE = dict(context_length=256, max_running_requests=4, new_tokens_per_chunk=8,
                kv_pool_tokens=128)  # the floor: 16 usable blocks, one full slot


def _pressure_prompts() -> list[list[int]]:
    """Four 56-token prompts, the last a copy of the first: their 64-token
    buckets fill the pool, and the copy forks the first."""
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, 40, size=56)] for _ in range(3)]
    return prompts + [list(prompts[0])]


def test_pool_pressure_with_saturated_slots_in_flight(weights):
    """Pool pressure under run-ahead: a slot whose last pass is in flight
    is masked out of the next dispatch but holds its blocks until that
    pass is consumed. With this traffic the JAX engine finds no victim to
    preempt there and its scheduler raises "KV pool cannot back a single
    active slot" (ROADMAP.md queue 3); the port consumes the pass in
    flight, the saturated slots retire, and every stream equals the JAX
    engine's on a pool with room."""
    prompts = _pressure_prompts()
    roomy = jd.JaxDecodeEngine(JaxDecodeConfig(**BASE, **dict(PRESSURE, kv_pool_tokens=None)),
                               JaxInferenceConfig())
    roomy.set_model(weights[0], JCFG)
    roomy.initialize()
    tight = _make_engine(weights[1], 1, **PRESSURE)
    try:
        want = _wave(roomy, [JaxRequest(input_ids=p, gconfig=JaxGen(greedy=True, max_new_tokens=24))
                            for p in prompts])
        got = _wave(tight, [ModelRequest(input_ids=p, gconfig=GenerationHyperparameters(
            greedy=True, max_new_tokens=24)) for p in prompts])
        for a, b in zip(want, got):
            assert b.output_tokens == a.output_tokens
            np.testing.assert_allclose(b.output_logprobs, a.output_logprobs, atol=LOGP_ATOL,
                                       rtol=0)
        assert tight.n_preemptions > 0
    finally:
        roomy.destroy()
        tight.destroy()
