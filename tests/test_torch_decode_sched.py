"""TorchDecodeEngine's default scheduling against a live JaxDecodeEngine.

The port's counterparts of the JAX package's allocator and scheduler tests
(`tests/test_kv_pool.py`, `tests/test_jax_decode.py`): refcounted blocks
and forks, the prefix registry (group forks, in-place reuse of a retired
donor, suffix prefill of a multi-turn follow-up), wave-batched prefill,
parked-KV resume after `abort_all`, reclaim under pool pressure, stop
strings and the frequency penalty. Each runs the JAX engine and the port
on the same tiny f32 model (`TINY` of `tests/test_jax_decode.py`, JAX
weights moved into the port) with the same inputs, page size and seed:
greedy tokens equal, logprobs within `LOGP_ATOL` (the packages sum in
different orders), and the admission counters (`_n_prefills`,
`_n_prefix_forks`, `_n_prefix_inplace`, `_n_suffix_prefills`) equal. The
JAX tests ran at page 128 and contexts up to 2048; these keep their
shapes at page 16 and context 256 or less, so that they run in seconds.
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
from areal_tpu.engine import jax_decode as jd
from areal_tpu.engine import kv_pool as jkv
from areal_tpu.models import qwen2 as jq
from areal_tpu_torch.api.cli_args import GenerationHyperparameters, TorchDecodeConfig
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.engine import kv_pool as tkv
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


def _engines(weights, **cfg):
    """A JAX engine and a port engine with the same settings and weights."""
    jeng = jd.JaxDecodeEngine(JaxDecodeConfig(**BASE, **cfg), JaxInferenceConfig())
    jeng.set_model(weights[0], JCFG)
    jeng.initialize()
    teng = td.TorchDecodeEngine(TorchDecodeConfig(**BASE, **cfg), device="cpu")
    teng.set_model(weights[1], TCFG)
    teng.initialize()
    return jeng, teng


def _gen(eng, **g):
    return (JaxGen if isinstance(eng, jd.JaxDecodeEngine) else GenerationHyperparameters)(**g)


def _req(eng, ids, rid=None, **g):
    cls = JaxRequest if isinstance(eng, jd.JaxDecodeEngine) else ModelRequest
    kw = {} if rid is None else dict(rid=rid)
    return cls(input_ids=list(ids), gconfig=_gen(eng, **g), **kw)


def _item(eng, rid, prompt, **g):
    """A scheduler slot entry for driving an engine by hand."""
    mod = jd if isinstance(eng, jd.JaxDecodeEngine) else td
    return mod._Slot(rid=rid, prompt=list(prompt), gconfig=_gen(eng, **g), future=None, loop=None)


def _step(eng, chunk: bool = True) -> None:
    """One synchronous scheduler pass by hand: admit, then one chunk."""
    with eng._sched_lock:
        eng._admit()
        act = eng._active_mask()
        if chunk and act.any():
            eng._run_chunk(act)


def _wave(eng, reqs, timeout: float = 300):
    """Serve `reqs` as one admission wave: queued while the engine is
    paused, then released together."""
    eng.pause_generation()
    out: list = []

    def run():
        async def go():
            return await asyncio.gather(*[eng.agenerate(r) for r in reqs])
        out.extend(asyncio.run(go()))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while eng._request_q.qsize() < len(reqs):
        assert time.monotonic() < deadline, "requests never enqueued"
        time.sleep(0.005)
    eng.continue_generation()
    t.join(timeout)
    assert len(out) == len(reqs), "the wave did not finish"
    return out


def _counters(eng) -> dict:
    return {k: getattr(eng, k) for k in
            ("_n_prefills", "_n_prefix_forks", "_n_prefix_inplace", "_n_suffix_prefills")}


def _same_stream(a, b) -> None:
    assert list(b.output_tokens) == list(a.output_tokens)
    np.testing.assert_allclose(b.output_logprobs, a.output_logprobs, atol=LOGP_ATOL, rtol=0)
    assert b.stop_reason == a.stop_reason


def _prompt(n: int, start: int = 1, mod: int = 40) -> list[int]:
    return [start + (i % mod) for i in range(n)]


# -- the allocator (tests/test_kv_pool.py:49, 65, 73, 92) ---------------


def _ensure_and_free(mod):
    a = mod.KVBlockAllocator(n_slots=4, n_blocks=9, block_size=128, max_blocks_per_slot=8)
    seen = [a.free_blocks, a.ensure(0, 200), int(a.nblocks[0]), a.free_blocks,
            a.ensure(0, 200), a.free_blocks, a.ensure(0, 500), int(a.nblocks[0]),
            a.free_blocks, a.allocated_tokens()]
    a.free_slot(0)
    return seen + [a.free_blocks, int(a.nblocks[0]), a.tables.tolist(), a.refcount.tolist()]


def _dry_and_guard(mod):
    a = mod.KVBlockAllocator(4, 9, 128, 8)
    seen = [a.ensure(0, 8 * 128), a.ensure(1, 1)]
    try:
        mod.KVBlockAllocator(4, 8, 128, 8)  # smaller than one full slot
        seen.append("built")
    except (AssertionError, ValueError):  # JAX asserts, the port raises ValueError
        seen.append("refused")
    return seen


def _fork_aliases(mod):
    a = mod.KVBlockAllocator(4, 17, 128, 8)
    seen = [a.ensure(0, 300), a.free_blocks]
    cp = a.fork(0, 1, covered=300)
    seen += [a.free_blocks, tuple(int(x) for x in cp), a.tables.tolist(), a.refcount.tolist()]
    a.free_slot(0)
    seen += [a.refcount.tolist(), a.ensure(2, 256), a.fork(2, 3, covered=256), a.tables.tolist()]
    return seen


def _fork_rollback(mod):
    a = mod.KVBlockAllocator(3, 9, 128, 8)
    seen = [a.ensure(0, 300), a.ensure(2, 5 * 128), a.free_blocks]
    try:
        a.fork(0, 1, covered=300)
        seen.append("forked")
    except mod.PoolDry:
        seen.append("dry")
    return seen + [int(a.nblocks[1]), a.refcount.tolist(), a.tables.tolist()]


@pytest.mark.parametrize("case", [_ensure_and_free, _dry_and_guard, _fork_aliases,
                                  _fork_rollback], ids=lambda f: f.__name__.strip("_"))
def test_allocator_matches_jax(case):
    """Ensure, free, the pool-dry answer and the size guard, fork aliasing
    (refcounts, the boundary copy pair, a block-aligned fork) and the
    rollback of a fork that finds no boundary block: the same tables,
    refcounts and answers as the JAX allocator."""
    assert case(tkv) == case(jkv)


# -- pool pressure, group sharing, reclaim (tests/test_kv_pool.py:159, 215, 266)


PRESSURE = dict(context_length=256, max_running_requests=4, new_tokens_per_chunk=8,
                kv_pool_tokens=128)  # the floor: 16 usable blocks, one full slot


def _pressure_prompts() -> list[list[int]]:
    """Four 56-token prompts, the last a copy of the first: their 64-token
    buckets fill the pool, and the copy forks the first."""
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, 40, size=56)] for _ in range(3)]
    return prompts + [list(prompts[0])]


def test_pool_pressure_with_forks(weights):
    """Concurrent generations outgrow a pool that holds one full-context
    slot: both engines preempt and requeue invisibly, and every stream is
    the JAX engine's; the fork's aliased blocks are under the same
    pressure (test_kv_pool.py:159). The synchronous schedule: under
    run-ahead the JAX engine raises here
    (tests/test_torch_decode_runahead.py)."""
    outs, engines = [], _engines(weights, **PRESSURE, decode_runahead_chunks=0)
    try:
        for eng in engines:
            outs.append(_wave(eng, [_req(eng, p, greedy=True, max_new_tokens=24)
                                    for p in _pressure_prompts()]))
        jeng, teng = engines
        for a, b in zip(*outs):
            _same_stream(a, b)
        assert teng.n_preemptions > 0 and jeng._n_preemptions > 0
        assert teng._n_prefix_forks >= 1
    finally:
        for e in engines:
            e.destroy()


def test_group_fork_shares_blocks(weights):
    """A group's shared prompt is stored once: later members alias the
    primary's full blocks and own only the boundary block and their tail,
    as the JAX engine's do (the same allocated tokens)."""
    cfg = dict(context_length=256, max_running_requests=8, new_tokens_per_chunk=8)
    prompt = _prompt(60)  # covered 59: 3 full blocks + 1 partial at page 16
    outs, engines = [], _engines(weights, **cfg)
    try:
        for eng in engines:
            outs.append(_wave(eng, [_req(eng, prompt, greedy=True, max_new_tokens=4)
                                    for _ in range(4)]))
        jeng, teng = engines
        for a, b in zip(*outs):
            _same_stream(a, b)
        assert _counters(teng) == _counters(jeng)
        assert teng._n_prefix_forks == 3 and teng._n_prefills == 1
        assert teng._alloc.allocated_tokens() == jeng._alloc.allocated_tokens()
        # unshared, each member would hold 5 blocks (59 + 8 rows); aliasing
        # holds the 3 full prompt blocks once, plus each member's boundary
        # block and the block its chunk grew into
        assert teng._alloc.allocated_tokens() <= (3 + 4 * 2) * 16
        assert teng._alloc.peak_table_blocks > teng._alloc.peak_blocks
    finally:
        for e in engines:
            e.destroy()


def test_reclaim_never_eats_inflight_donor(weights):
    """A fork that finds the pool dry must not reclaim its own donor, here
    a parked slot whose admission registration makes it the donor: the
    fork defers, the donor survives, and the deferred request later
    decodes the JAX engine's stream (driven by hand on both engines)."""
    cfg = dict(context_length=256, max_running_requests=4, new_tokens_per_chunk=8,
               kv_pool_tokens=128)
    prompt_a = _prompt(38)  # covered 37: a 64-token bucket, 4 blocks
    seen, engines = [], _engines(weights, **cfg)
    try:
        for eng in engines:
            eng.pause_generation()
            a = _item(eng, "a", prompt_a, greedy=True, max_new_tokens=40)
            eng._request_q.put(a)
            _step(eng)
            eng.abort_all()
            donor_slot = eng._parked["a"][0]
            assert tuple(prompt_a[:-1]) in eng._prefix_lookup
            donor_blocks = list(eng._alloc.tables[donor_slot, :3])
            # hog the remaining 12 blocks (a 192-token bucket)
            hog = _item(eng, "hog", _prompt(190, start=2, mod=30), greedy=True,
                        max_new_tokens=40)
            eng._request_q.put(hog)
            _step(eng, chunk=False)
            assert eng._alloc.free_blocks == 0
            c = _item(eng, "c", prompt_a, greedy=True, max_new_tokens=4)
            eng._request_q.put(c)
            _step(eng, chunk=False)
            assert "a" in eng._parked, "reclaim evicted the in-flight donor"
            assert list(eng._alloc.tables[donor_slot, :3]) == donor_blocks
            assert all(b != 0 for b in donor_blocks)
            assert tuple(prompt_a[:-1]) in eng._prefix_lookup
            for _ in range(60):
                _step(eng)
                if c.stop_reason is not None and hog.stop_reason is not None:
                    break
            assert c.stop_reason is not None, "c never completed"
            seen.append((list(a.tokens), list(c.tokens), list(hog.tokens), c.logprobs))
        (ja, jc, jh, jl), (ta, tc, th, tl) = seen
        assert (ta, tc, th) == (ja, jc, jh)
        np.testing.assert_allclose(tl, jl, atol=LOGP_ATOL, rtol=0)
    finally:
        for e in engines:
            e.destroy()


# -- the scheduler (tests/test_jax_decode.py) ----------------------------


def test_interrupt_resume_reuses_parked_kv(weights):
    """An interrupted request's KV stays parked in its slot; its resume
    (prompt + partial tokens, same rid) prefills nothing and continues
    the JAX engine's stream (test_jax_decode.py:201)."""
    cfg = dict(context_length=64, max_running_requests=2, new_tokens_per_chunk=4)
    prompt = [1, 5, 9, 13, 2]
    seen, engines = [], _engines(weights, **cfg)
    try:
        for eng in engines:
            eng.pause_generation()
            item = _item(eng, "r1", prompt, greedy=True, max_new_tokens=12)
            eng._request_q.put(item)
            _step(eng)
            assert len(item.tokens) == 4
            assert eng.abort_all() == 1 and item.stop_reason == "interrupt"
            assert "r1" in eng._parked
            before = _counters(eng)
            item2 = _item(eng, "r1", prompt + item.tokens, greedy=True, max_new_tokens=8)
            eng._request_q.put(item2)
            _step(eng)
            _step(eng)
            assert _counters(eng) == before, "resume must not prefill or fork"
            assert "r1" not in eng._parked
            seen.append(item.tokens + item2.tokens)
        jeng, teng = engines
        assert seen[1] == seen[0]
        assert teng.prefill_calls == 1
    finally:
        for e in engines:
            e.destroy()


class DigitTok:
    """Decodes token t as the digit t % 10 (test_jax_decode.py:380)."""

    eos_token_id = None

    def decode(self, ids):
        return "".join(str(i % 10) for i in ids)


def test_stop_strings(weights):
    """Stop strings cut at the earliest token whose decoded output holds
    the string, also across a chunk boundary; a stop id after the string
    loses to it, a stop id before it wins (the two-cut rule,
    test_jax_decode.py:373)."""
    cfg = dict(context_length=64, max_running_requests=2, new_tokens_per_chunk=4)
    prompt = [1, 5, 9, 13, 2]
    full = None
    results, engines = [], []
    for make in (jd.JaxDecodeEngine, td.TorchDecodeEngine):
        kw = {} if make is jd.JaxDecodeEngine else dict(device="cpu")
        c = (JaxDecodeConfig if make is jd.JaxDecodeEngine else TorchDecodeConfig)(**BASE, **cfg)
        eng = make(c, (JaxInferenceConfig() if make is jd.JaxDecodeEngine else None),
                   tokenizer=DigitTok(), **kw)
        eng.set_model(weights[0] if make is jd.JaxDecodeEngine else weights[1],
                      JCFG if make is jd.JaxDecodeEngine else TCFG)
        eng.initialize()
        engines.append(eng)
    try:
        for eng in engines:
            got = []
            full = eng.generate(_req(eng, prompt, greedy=True, max_new_tokens=12),
                                timeout=300).output_tokens
            text = DigitTok().decode(full)
            # a string completed by token 4 (inside the first chunk), one
            # completed by token 6 that spans the chunk boundary at 4
            for lo, hi in ((2, 4), (3, 6)):
                s = text[lo:hi]
                assert s not in text[: hi - 1], "the string must first complete at hi"
                got.append(eng.generate(_req(eng, prompt, greedy=True, max_new_tokens=12,
                                             stop=[s]), timeout=300))
            s = text[2:4]
            # a stop id after the string's boundary: the string wins
            late = next((t for t in full[4:] if t not in full[:4]), None)
            if late is not None:
                got.append(eng.generate(_req(eng, prompt, greedy=True, max_new_tokens=12,
                                             stop=[s], stop_token_ids=[late]), timeout=300))
            # a stop id at token 1: it wins
            got.append(eng.generate(_req(eng, prompt, greedy=True, max_new_tokens=12,
                                         stop=[s], stop_token_ids=[full[0]]), timeout=300))
            results.append((full, got))
        (jfull, jgot), (tfull, tgot) = results
        assert tfull == jfull
        assert [r.output_len for r in tgot][:2] == [4, 6]
        assert tgot[-1].output_len == 1
        for a, b in zip(jgot, tgot):
            _same_stream(a, b)
            assert b.stop_reason == "stop"
    finally:
        for e in engines:
            e.destroy()


def test_frequency_penalty_matches_jax(weights):
    """A strong frequency penalty reduces repetition against the
    unpenalized run, and the penalized sampled stream is the JAX engine's
    token for token (the counts evolve token by token within a chunk;
    test_jax_decode.py:416)."""
    cfg = dict(context_length=96, max_running_requests=1, new_tokens_per_chunk=8,
               random_seed=11)
    streams, engines = {}, _engines(weights, **cfg)
    try:
        for eng in engines:
            for pen in (0.0, 8.0):
                r = eng.generate(_req(eng, [3, 7, 11], max_new_tokens=48, temperature=0.3,
                                      frequency_penalty=pen), timeout=300)
                streams[(type(eng).__name__, pen)] = r
        for pen in (0.0, 8.0):
            _same_stream(streams[("JaxDecodeEngine", pen)], streams[("TorchDecodeEngine", pen)])
        base = streams[("TorchDecodeEngine", 0.0)].output_tokens
        pen = streams[("TorchDecodeEngine", 8.0)].output_tokens
        assert len(set(pen)) / len(pen) > len(set(base)) / len(base)
    finally:
        for e in engines:
            e.destroy()


def test_frequency_penalty_counts_on_slot_reuse_match_jax(weights):
    """A chunk that carries penalty counts adds every active slot's
    tokens, but only penalized slots are reset at the next admission
    (jax_decode.py:2723-2729, 3547-3550): a penalized request admitted
    into the slot of an unpenalized one that ran beside a penalized
    request starts from its counts. The port keeps this reference
    behaviour, and its streams equal the JAX engine's (ROADMAP.md queue
    3)."""
    cfg = dict(context_length=96, max_running_requests=2, new_tokens_per_chunk=8)
    seen, engines = [], _engines(weights, **cfg)
    try:
        for eng in engines:
            wave = _wave(eng, [_req(eng, [3, 7, 11], greedy=True, max_new_tokens=16),
                               _req(eng, [5, 2, 5], greedy=True, max_new_tokens=16,
                                    frequency_penalty=2.0)])
            assert not eng._slot_used_freq[0] and eng._slot_used_freq[1]
            counts = np.asarray(eng._freq_counts)
            assert counts[0].sum() > 0, "slot 0 holds the unpenalized request's counts"
            again = eng.generate(_req(eng, [9, 4, 9, 4], greedy=True, max_new_tokens=16,
                                      frequency_penalty=2.0), timeout=300)
            seen.append(wave + [again])
        for a, b in zip(*seen):
            _same_stream(a, b)
    finally:
        for e in engines:
            e.destroy()


def test_prefix_fork_group_decode(weights):
    """A group of same-prompt requests prefills once and forks the rest;
    a later same-prompt request reuses the retired rows without a
    prefill; a weight install drops the registry so the next admission
    prefills again (test_jax_decode.py:502)."""
    cfg = dict(context_length=96, max_running_requests=4, new_tokens_per_chunk=8)
    prompt = [3, 7, 11, 2, 9, 4]
    seen, engines = [], _engines(weights, **cfg)
    try:
        for eng in engines:
            g = dict(greedy=True, max_new_tokens=9)
            group = _wave(eng, [_req(eng, prompt, **g) for _ in range(4)])
            assert all(r.ttft != float("inf") and len(r.itl) == r.output_len for r in group)
            c1 = dict(_counters(eng))
            again = eng.generate(_req(eng, prompt, **g), timeout=300)
            c2 = dict(_counters(eng))
            eng.update_weights_from_tensor({}, version=1)
            after = eng.generate(_req(eng, prompt, **g), timeout=300)
            seen.append((group + [again, after], c1, c2, dict(_counters(eng))))
        (jr, *jc), (tr, *tc) = seen
        for a, b in zip(jr, tr):
            _same_stream(a, b)
        assert tc == jc
        assert tc[0]["_n_prefills"] == 1 and tc[0]["_n_prefix_forks"] == 3
        assert tc[1]["_n_prefills"] == 1 and tc[2]["_n_prefills"] == 2
        assert tr[-1].output_versions == [1] * 9
    finally:
        for e in engines:
            e.destroy()


def test_parked_long_sequence_survives_bucketed_chunks(weights):
    """A parked long sequence survives another slot's chunks on a smaller
    bucket (inactive slots never write), then resumes with the JAX
    engine's continuation (test_jax_decode.py:611)."""
    cfg = dict(context_length=512, max_running_requests=2, new_tokens_per_chunk=8)
    long_prompt = _prompt(300)
    seen, engines = [], _engines(weights, **cfg)
    try:
        for eng in engines:
            eng.pause_generation()
            item = _item(eng, "long", long_prompt, greedy=True, max_new_tokens=64)
            eng._request_q.put(item)
            _step(eng)
            partial = list(item.tokens)
            assert len(partial) == 8
            eng.abort_all()
            assert "long" in eng._parked
            nbs = []
            if isinstance(eng, td.TorchDecodeEngine):
                real = eng._dispatch_chunk

                def spy(active, real=real):
                    rec = real(active)
                    nbs.append(rec.nb)
                    return rec
                eng._dispatch_chunk = spy
            short = _item(eng, "short", [2, 4, 6], greedy=True, max_new_tokens=8)
            eng._request_q.put(short)
            _step(eng)
            if isinstance(eng, td.TorchDecodeEngine):
                assert nbs == [256 // 16], "the short request runs on the 256-row bucket"
                del eng._dispatch_chunk
            resume = _item(eng, "long", long_prompt + partial, greedy=True, max_new_tokens=8)
            eng._request_q.put(resume)
            _step(eng)
            seen.append((partial + resume.tokens, list(short.tokens)))
        assert seen[1] == seen[0]
    finally:
        for e in engines:
            e.destroy()


def test_retired_donor_survives_later_chunks(weights):
    """A slot retires while another keeps chunking; a same-prompt request
    then forks the retired donor's rows (registered as the whole
    conversation, found as its head) and decodes the same stream
    (test_jax_decode.py:678)."""
    cfg = dict(context_length=96, max_running_requests=2, new_tokens_per_chunk=4)
    prompt_a, prompt_b = [3, 7, 11, 2, 9], [4, 8, 12, 1]
    seen, engines = [], _engines(weights, **cfg)
    try:
        for eng in engines:
            eng.pause_generation()
            a = _item(eng, "a", prompt_a, greedy=True, max_new_tokens=4)
            b = _item(eng, "b", prompt_b, greedy=True, max_new_tokens=20)
            eng._request_q.put(a)
            eng._request_q.put(b)
            _step(eng)
            assert a.stop_reason == "length"
            pa = tuple(prompt_a[:-1])
            assert any(k[: len(pa)] == pa and len(k) > len(pa) for k in eng._prefix_lookup)
            for _ in range(4):
                _step(eng)
            assert b.stop_reason == "length"
            reuse0 = eng._n_prefix_forks + eng._n_prefix_inplace
            c = _item(eng, "c", prompt_a, greedy=True, max_new_tokens=4)
            eng._request_q.put(c)
            _step(eng)
            assert eng._n_prefix_forks + eng._n_prefix_inplace == reuse0 + 1
            assert c.tokens == a.tokens
            seen.append((a.tokens, b.tokens, c.tokens, _counters(eng)))
        assert seen[1] == seen[0]
    finally:
        for e in engines:
            e.destroy()


def test_partial_prefix_sharing_multi_turn(weights):
    """A follow-up turn (history + answer + a new user turn) forks the
    shared history and prefills only the suffix; a third turn extends the
    registry's longer key (test_jax_decode.py:740)."""
    cfg = dict(context_length=512, max_running_requests=2, new_tokens_per_chunk=8)
    turn1 = _prompt(100)
    seen, engines = [], _engines(weights, **cfg)
    try:
        for eng in engines:
            g = dict(greedy=True, max_new_tokens=8)
            r1 = eng.generate(_req(eng, turn1, **g), timeout=300)
            turn2 = turn1 + list(r1.output_tokens) + [5, 17, 3, 29, 11]
            r2 = eng.generate(_req(eng, turn2, **g), timeout=300)
            c2 = dict(_counters(eng))
            turn3 = turn2 + list(r2.output_tokens) + [7, 2]
            r3 = eng.generate(_req(eng, turn3, **g), timeout=300)
            seen.append(([r1, r2, r3], c2, dict(_counters(eng))))
        (jr, *jc), (tr, *tc) = seen
        for a, b in zip(jr, tr):
            _same_stream(a, b)
        assert tc == jc
        assert tc[0] == dict(_n_prefills=1, _n_prefix_forks=0, _n_prefix_inplace=0,
                             _n_suffix_prefills=1)
        assert tc[1]["_n_prefills"] == 1 and tc[1]["_n_suffix_prefills"] == 2
    finally:
        for e in engines:
            e.destroy()


def test_batched_prefill_wave_unique_prompts(weights):
    """A wave of distinct prompts in one bucket prefills in one batched
    forward (the JAX engine's (64, 4) vmapped prefill), with the JAX
    engine's streams (test_jax_decode.py:790)."""
    cfg = dict(context_length=96, max_running_requests=4, new_tokens_per_chunk=8)
    prompts = [[2 + i, 7, 11, 3 + i] for i in range(4)]
    outs, engines = [], _engines(weights, **cfg)
    try:
        for eng in engines:
            outs.append(_wave(eng, [_req(eng, p, greedy=True, max_new_tokens=6)
                                    for p in prompts]))
        jeng, teng = engines
        for a, b in zip(*outs):
            _same_stream(a, b)
        assert teng._n_prefills == jeng._n_prefills == 4
        assert (64, 4) in jeng._batched_prefill_fns
        assert teng.prefill_calls == 1
    finally:
        for e in engines:
            e.destroy()


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_sched_streams_on_pools_match_jax(weights, kv_dtype):
    """On an fp and an int8 pool, the same traffic through both engines:
    a wave with a group and distinct prompts (batched prefill, wave forks)
    and a multi-turn follow-up (suffix prefill: an int8 pool reads its
    prefix dequantized and quantizes only the new rows)."""
    cfg = dict(context_length=256, max_running_requests=6, new_tokens_per_chunk=8,
               kv_dtype=kv_dtype)
    rng = np.random.RandomState(3)
    shared = [int(t) for t in rng.randint(1, 60, size=70)]
    distinct = [[int(t) for t in rng.randint(1, 60, size=n)] for n in (40, 50)]
    seen, engines = [], _engines(weights, **cfg)
    try:
        for eng in engines:
            g = dict(greedy=True, max_new_tokens=10)
            wave = _wave(eng, [_req(eng, p, **g) for p in [shared] * 3 + distinct])
            follow = shared + list(wave[0].output_tokens) + [9, 8, 7, 6]
            turn = eng.generate(_req(eng, follow, **g), timeout=300)
            seen.append((wave + [turn], dict(_counters(eng)), eng.prefill_calls
                         if isinstance(eng, td.TorchDecodeEngine) else None))
        (jr, jc, _), (tr, tc, calls) = seen
        for a, b in zip(jr, tr):
            _same_stream(a, b)
        assert tc == jc == dict(_n_prefills=3, _n_prefix_forks=2, _n_prefix_inplace=0,
                                _n_suffix_prefills=1)
        assert calls == 3  # one batch of the two 64-token prompts, one 128, one suffix
    finally:
        for e in engines:
            e.destroy()


def test_weight_push_empties_registry_and_parked(weights):
    """Every weight install drops the prefix registry and the parked KV,
    and frees the blocks only they held: KV from old weights never seeds
    a request under the new ones (jax_decode.py:4815-4829)."""
    cfg = dict(context_length=96, max_running_requests=2, new_tokens_per_chunk=4)
    jeng, teng = _engines(weights, **cfg)
    try:
        for eng in (jeng, teng):
            eng.pause_generation()
            a = _item(eng, "a", [3, 7, 11, 2, 9], greedy=True, max_new_tokens=4)
            b = _item(eng, "b", [4, 8, 12, 1, 6], greedy=True, max_new_tokens=12)
            eng._request_q.put(a)
            eng._request_q.put(b)
            _step(eng)
            eng.abort_all()  # a retired ("length") and registered; b parked
            assert eng._prefix_lookup and "b" in eng._parked
            held = eng._alloc.free_blocks
            eng.update_weights_from_tensor({}, version=3)
            assert not eng._prefix_lookup and not eng._parked and not eng._parked_tokens
            assert all(k is None for k in eng._slot_prefix)
            assert eng._alloc.free_blocks > held
            assert eng._alloc.free_blocks == eng._alloc.usable_blocks
            # b's resume (prompt + partial tokens, same rid) prefills again,
            # under the new version
            before = eng._n_prefills
            b2 = _item(eng, "b", b.prompt + b.tokens, greedy=True, max_new_tokens=4)
            eng._request_q.put(b2)
            _step(eng)
            assert eng._n_prefills == before + 1 and b2.versions == [3] * 4
    finally:
        jeng.destroy()
        teng.destroy()


# -- the model functions (models/qwen2.py:1872-2043) ---------------------


@pytest.mark.parametrize("plen,T", [(64, 64), (70, 16), (1, 8)])
def test_prefill_with_prefix_matches_jax(weights, plen, T):
    """A suffix over cached prefix KV: the JAX `prefill_with_prefix` and
    the port's, on the same prefix rows (a prefill's, read through a
    larger bucket with garbage past prefix_len) and suffix ids; and the
    suffix rows equal those of one full prefill of prefix + suffix."""
    jparams, tparams = weights
    rng = np.random.default_rng(plen + T)
    ids = rng.integers(0, JCFG.vocab_size, plen + T)
    Tp = 128
    _, pk, pv = jq.prefill(jparams, jnp.asarray(ids[:plen]), jnp.arange(plen), JCFG,
                           with_logits=False)
    garbage = rng.standard_normal((JCFG.num_hidden_layers, Tp - plen) + pk.shape[2:])
    pk = jnp.concatenate([pk, jnp.asarray(garbage, jnp.float32)], axis=1)
    pv = jnp.concatenate([pv, jnp.asarray(-garbage, jnp.float32)], axis=1)
    jk, jv = jq.prefill_with_prefix(jparams, jnp.asarray(ids[plen:]), pk, pv, plen, JCFG)
    tk, tv = tq.prefill_with_prefix(tparams, torch.as_tensor(ids[plen:]),
                                    torch.from_numpy(np.array(pk)),
                                    torch.from_numpy(np.array(pv)), plen, TCFG)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    _, fk, fv = tq.prefill(tparams, torch.as_tensor(ids), torch.arange(plen + T), TCFG,
                           with_logits=False)
    np.testing.assert_allclose(tk.numpy(), fk[:, plen:].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), fv[:, plen:].numpy(), atol=1e-5, rtol=0)


def test_batched_prefill_matches_jax_vmap(weights):
    """B distinct prompts in one bucket: the port's batched prefill against
    the JAX engine's vmap of `prefill` (each with its own valid length),
    and each batch row equal to the port's single prefill of it."""
    jparams, tparams = weights
    rng = np.random.default_rng(5)
    B, T = 4, 64
    ids = rng.integers(0, JCFG.vocab_size, (B, T))
    lens = jnp.asarray([64, 10, 33, 1])

    def one(x, n):
        return jq.prefill(jparams, x, jnp.arange(T), JCFG, valid=jnp.arange(T) < n,
                          with_logits=False)[1:]

    jk, jv = jax.vmap(one)(jnp.asarray(ids), lens)
    _, tk, tv = tq.prefill(tparams, torch.as_tensor(ids), torch.arange(T), TCFG,
                           with_logits=False)
    assert tuple(tk.shape) == tuple(jk.shape)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    for b in range(B):
        _, k1, v1 = tq.prefill(tparams, torch.as_tensor(ids[b]), torch.arange(T), TCFG,
                               with_logits=False)
        np.testing.assert_allclose(tk[b].numpy(), k1.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(tv[b].numpy(), v1.numpy(), atol=1e-6, rtol=0)
