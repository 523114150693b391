"""TorchDecodeEngine on the CPU against the JAX package's model functions.

The reference is a plain loop over the JAX `qwen2.prefill` (of
`prompt[:-1]`) and `decode_step_paged` (attn_impl="xla"), greedy, one
request at a time, at the smoke geometry in f32 with the same weights,
for each (weight_dtype, kv_dtype) in {fp, int8}^2: int8 weights are the
JAX `quantize_weights` of the same fp weights, and an int8 pool gets the
prompt rows through `quantize_kv` and `scales_blocked`. Greedy tokens must
match exactly and logprobs within atol 1e-5 (the two packages sum in
different orders; int8 rows quantized from them agree within one step,
which the logprobs absorb). The rest checks the serving contract:
batching does not change a request's stream, stop ids, max_new_tokens,
pause/continue, weight pushes (fp and int8) and version stamps,
pool-pressure preemption (greedy and sampled), the position-keyed
sampler (its statistics, and a sampled stream's independence of its
batchmates), and the device rule.
"""

import asyncio
import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from areal_tpu.models import qwen2 as jq
from areal_tpu.ops.kv_quant import quantize_kv as jax_quantize_kv
from areal_tpu.ops.kv_quant import scales_blocked as jax_scales_blocked
from areal_tpu_torch.api.cli_args import (
    GenerationHyperparameters,
    TorchDecodeConfig,
)
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.engine.sampling import sample, slot_base_key
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy
from areal_tpu_torch.models.smoke import SMOKE_MODEL_DICT

KW = dict(SMOKE_MODEL_DICT, dtype="float32", param_dtype="float32")
JCFG = jq.ModelConfig(**KW)
TCFG = tq.ModelConfig(**KW)
SMALL = dict(context_length=128, max_running_requests=4, page_size=16,
             new_tokens_per_chunk=8, kv_cache_dtype="float32")


@pytest.fixture(scope="module")
def weights():
    jparams = jq.init_params(JCFG, jax.random.PRNGKey(7))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG)


def _engine(tparams, **over):
    eng = TorchDecodeEngine(TorchDecodeConfig(**dict(SMALL, **over)), device="cpu")
    eng.set_model(tparams, TCFG)
    return eng.initialize()


@pytest.fixture
def engine(weights):
    eng = _engine(weights[1])
    yield eng
    eng.destroy()


def _greedy(n, **kw):
    return GenerationHyperparameters(max_new_tokens=n, greedy=True, **kw)


_JAX_STEP = jax.jit(
    lambda p, t, pos, k, v, table: jq.decode_step_paged(
        p, t, pos, k, v, table, JCFG, active=jnp.ones(1, bool), attn_impl="xla"
    )
)


def _jax_greedy(jparams, prompt, n_new, bsz=16, nb=8, weight_dtype="fp", kv_dtype="fp"):
    """Reference loop: prefill prompt[:-1] into a one-slot paged pool, then
    decode_step_paged token by token, greedy. int8 weights are quantized
    with the JAX `quantize_weights`; an int8 pool holds the prompt rows as
    the JAX engine's prefill scatter writes them (`quantize_kv`, then
    `scales_blocked` into the scale pool)."""
    L, nKV, hd = JCFG.num_hidden_layers, JCFG.num_key_value_heads, JCFG.head_dim_
    if weight_dtype == "int8":
        jparams = jq.quantize_weights(jparams)
    kp = jnp.zeros((L, nb + 1, bsz, nKV, hd), jnp.float32)
    vp = jnp.zeros_like(kp)
    table = jnp.arange(1, nb + 1, dtype=jnp.int32)[None]
    pre = len(prompt) - 1
    ks = vs = jnp.zeros((L, 0, nKV, hd), jnp.float32)
    if pre:
        _, ks, vs = jq.prefill(
            jparams, jnp.asarray(prompt[:-1], jnp.int32),
            jnp.arange(pre, dtype=jnp.int32), JCFG, with_logits=False,
        )
    if kv_dtype == "int8":
        pools = []
        for rows in (ks, vs):
            rows = jnp.pad(rows, ((0, 0), (0, nb * bsz - pre), (0, 0), (0, 0)))
            q, sc = jax_quantize_kv(rows)
            data = jnp.zeros((L, nb + 1, bsz, nKV, hd), jnp.int8)
            scales = jnp.zeros((L, nb + 1, nKV, bsz), jnp.float32)
            pools.append((
                data.at[:, 1:].set(q.reshape(L, nb, bsz, nKV, hd)),
                scales.at[:, 1:].set(jax_scales_blocked(sc, nb, bsz)),
            ))
        kp, vp = pools
    elif pre:
        rows = jnp.arange(pre)
        kp = kp.at[:, 1 + rows // bsz, rows % bsz].set(ks)
        vp = vp.at[:, 1 + rows // bsz, rows % bsz].set(vs)

    def step(p, t, pos, k, v):
        return _JAX_STEP(p, t, pos, k, v, table)

    tok, toks, logps = prompt[-1], [], []
    for i in range(n_new):
        logits, kp, vp = step(
            jparams, jnp.asarray([tok], jnp.int32),
            jnp.asarray([pre + i], jnp.int32), kp, vp,
        )
        lp = jax.nn.log_softmax(logits[0])
        tok = int(jnp.argmax(logits[0]))
        toks.append(tok)
        logps.append(float(lp[tok]))
    return toks, logps


PROMPTS = [[3], [1, 5, 9, 2, 7], list(range(2, 30)) + [4] * 40]
_PROMPT_IDS = ["len1", "len5", "len68"]
# (weight_dtype, kv_dtype) and the id suffix; the fp/fp cases keep the
# plain prompt ids
DTYPES = [("fp", "fp", ""), ("int8", "fp", "-w8"), ("fp", "int8", "-kv8"),
          ("int8", "int8", "-w8kv8")]


@pytest.mark.parametrize(
    "prompt,weight_dtype,kv_dtype",
    [(p, w, kv) for w, kv, _ in DTYPES for p in PROMPTS],
    ids=[i + sfx for _, _, sfx in DTYPES for i in _PROMPT_IDS],
)
def test_greedy_matches_jax_reference(weights, prompt, weight_dtype, kv_dtype):
    n = 20
    want_toks, want_logps = _jax_greedy(
        weights[0], prompt, n, weight_dtype=weight_dtype, kv_dtype=kv_dtype
    )
    engine = _engine(weights[1], weight_dtype=weight_dtype, kv_dtype=kv_dtype)
    try:
        resp = engine.generate(ModelRequest(input_ids=prompt, gconfig=_greedy(n)), timeout=120)
    finally:
        engine.destroy()
    assert resp.output_tokens == want_toks
    np.testing.assert_allclose(resp.output_logprobs, want_logps, atol=1e-5, rtol=0)
    assert resp.stop_reason == "length" and resp.output_versions == [0] * n


def test_concurrent_requests_match_solo_runs(engine):
    prompts = [[1, 2, 3], [4] * 17, [5, 6], list(range(31))]
    ns = [19, 8, 25, 11]
    solo = [
        engine.generate(ModelRequest(input_ids=p, gconfig=_greedy(n)), timeout=120)
        for p, n in zip(prompts, ns)
    ]

    async def together():
        return await asyncio.gather(*[
            engine.agenerate(ModelRequest(input_ids=p, gconfig=_greedy(n)))
            for p, n in zip(prompts, ns)
        ])

    batched = asyncio.run(together())
    for a, b, n in zip(solo, batched, ns):
        assert b.output_len == n
        assert a.output_tokens == b.output_tokens
        np.testing.assert_allclose(a.output_logprobs, b.output_logprobs, atol=1e-5, rtol=0)


def test_stop_id_and_max_new_tokens(engine):
    prompt = [2, 7, 1, 8]
    full = engine.generate(ModelRequest(input_ids=prompt, gconfig=_greedy(12)), timeout=120)
    assert full.output_len == 12 and full.stop_reason == "length"
    stop = full.output_tokens[5]
    first = full.output_tokens.index(stop)
    cut = engine.generate(
        ModelRequest(input_ids=prompt, gconfig=_greedy(12, stop_token_ids=[stop])),
        timeout=120,
    )
    assert cut.stop_reason == "stop"
    assert cut.output_tokens == full.output_tokens[: first + 1]
    assert len(cut.output_logprobs) == len(cut.output_versions) == first + 1
    # min_new_tokens defers the stop past its first occurrence
    later = engine.generate(
        ModelRequest(input_ids=prompt, gconfig=_greedy(12, stop_token_ids=[stop], min_new_tokens=first + 2)),
        timeout=120,
    )
    assert later.output_tokens[: first + 1] == full.output_tokens[: first + 1]
    assert later.output_len > first + 1


def test_prompt_past_context_returns_length(engine):
    resp = engine.generate(
        ModelRequest(input_ids=[1] * 100, gconfig=_greedy(64)), timeout=60
    )
    assert resp.stop_reason == "length" and resp.output_len == 0


def test_pause_and_continue(engine):
    engine.pause_generation()
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "r", engine.generate(ModelRequest(input_ids=[1, 2], gconfig=_greedy(6)), timeout=120)
    ))
    t.start()
    time.sleep(0.3)
    assert "r" not in out  # nothing decodes while paused
    engine.continue_generation()
    t.join(timeout=120)
    assert not t.is_alive() and out["r"].output_len == 6


def test_weight_push_and_versions(engine, weights):
    req = ModelRequest(input_ids=[3, 1, 4], gconfig=_greedy(10))
    before = engine.generate(req.copy(), timeout=120)
    engine.set_version(3)
    assert engine.get_version() == 3
    same = engine.generate(req.copy(), timeout=120)
    assert same.output_versions == [3] * 10
    assert same.output_tokens == before.output_tokens
    new_norm = np.linspace(0.5, 1.5, TCFG.hidden_size).astype(np.float32)
    engine.update_weights_from_tensor({"final_norm": new_norm}, version=4)
    assert engine.get_version() == 4
    assert torch.equal(engine.params["final_norm"], torch.from_numpy(new_norm))
    after = engine.generate(req.copy(), timeout=120)
    assert after.output_versions == [4] * 10
    assert after.output_logprobs != before.output_logprobs
    with pytest.raises(KeyError):
        engine.update_weights_from_tensor({"no/such/weight": new_norm})
    with pytest.raises(ValueError):
        engine.update_weights_from_tensor({"final_norm": new_norm[:-1]})
    # a refused push writes nothing
    assert torch.equal(engine.params["final_norm"], torch.from_numpy(new_norm))
    engine.update_weights_from_tensor({"final_norm": weights[1]["final_norm"]})


def test_layer_weight_push_reaches_the_decode_step(engine, weights):
    """The engine keeps per-layer views built at set_model; an in-place
    push of a layer weight must show through them."""
    req = ModelRequest(input_ids=[3, 1, 4], gconfig=_greedy(6))
    before = engine.generate(req.copy(), timeout=120)
    name = sorted(n for n in engine.params if n.endswith("mlp/down_kernel"))[0]
    engine.update_weights_from_tensor({name: np.zeros(engine.params[name].shape, np.float32)})
    assert (engine._layers[0]["mlp/down_kernel"] == 0).all()
    after = engine.generate(req.copy(), timeout=120)
    assert after.output_logprobs != before.output_logprobs
    engine.update_weights_from_tensor({name: weights[1][name]})
    again = engine.generate(req.copy(), timeout=120)
    assert again.output_tokens == before.output_tokens
    np.testing.assert_allclose(again.output_logprobs, before.output_logprobs, atol=0, rtol=0)


def test_pool_pressure_preempts_and_streams_stay_exact(weights):
    """Requests whose KV cannot all fit: the longest is requeued and
    re-prefilled, and every stream, the sampled one included (it keeps its
    base key across the requeue), still equals its solo run."""
    tparams = weights[1]
    roomy = _engine(tparams)
    # 8 usable blocks of 16 rows; the requests grow to 6 + 5 + 4 blocks
    tight = _engine(tparams, kv_pool_tokens=96)
    try:
        reqs = [
            ModelRequest(input_ids=list(range(1, 20)), gconfig=_greedy(60)),
            ModelRequest(input_ids=[2, 2, 5], gconfig=_greedy(60)),
            ModelRequest(input_ids=[6, 1, 6], gconfig=GenerationHyperparameters(
                max_new_tokens=50, temperature=1.0, top_p=0.9)),
        ]
        # one at a time: the same admission order, so the same keys
        solo = [roomy.generate(r.copy(), timeout=120) for r in reqs]

        async def together():
            return await asyncio.gather(*[tight.agenerate(r.copy()) for r in reqs])

        both = asyncio.run(together())
        assert tight.n_preemptions > 0
        for a, b in zip(solo, both):
            assert a.output_tokens == b.output_tokens
            np.testing.assert_allclose(a.output_logprobs, b.output_logprobs, atol=1e-5, rtol=0)
    finally:
        roomy.destroy()
        tight.destroy()


def test_sampled_stream_ignores_a_top_p_batchmate(weights):
    """A sampled request's stream alone equals its stream beside a top-p
    batchmate admitted after it. The batchmate makes the chunk run the
    top-p sampler variant, which draws a second noise block per step: with
    one sequential generator that moved the request's draws; with draws
    keyed by (request key, position) it cannot."""
    req = ModelRequest(input_ids=[3, 1, 4, 1, 5], gconfig=GenerationHyperparameters(
        max_new_tokens=24, temperature=1.0))
    mate = ModelRequest(input_ids=[2, 7], gconfig=GenerationHyperparameters(
        max_new_tokens=24, temperature=1.0, top_p=0.5))
    alone_eng, pair_eng = _engine(weights[1]), _engine(weights[1])
    try:
        alone = alone_eng.generate(req.copy(), timeout=120)
        pair_eng.pause_generation()

        async def both():
            tasks = [asyncio.ensure_future(pair_eng.agenerate(r.copy())) for r in (req, mate)]
            await asyncio.sleep(0)  # both queued, in order, before an admission
            pair_eng.continue_generation()
            return await asyncio.gather(*tasks)

        pair = asyncio.run(both())
    finally:
        alone_eng.destroy()
        pair_eng.destroy()
    assert pair[0].output_tokens == alone.output_tokens
    np.testing.assert_allclose(pair[0].output_logprobs, alone.output_logprobs, atol=1e-5, rtol=0)


def _keys(n: int, seed: int) -> torch.Tensor:
    """[n, 2] base keys, as the engine gives its first n admissions."""
    return torch.from_numpy(np.stack([slot_base_key(seed, i) for i in range(n)]).astype(np.int64))


def test_sampler_matches_softmax_at_temperature_one():
    rng = np.random.default_rng(0)
    V, R, rounds = 16, 4000, 5
    logits = rng.standard_normal(V).astype(np.float32) * 1.5
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    keys = _keys(R, 0)
    batch = torch.from_numpy(np.tile(logits, (R, 1)))
    counts = np.zeros(V)
    for position in range(rounds):
        tok, logp = sample(
            batch, keys, torch.full((R,), position), torch.ones(R), torch.ones(R),
            torch.zeros(R, dtype=torch.bool), use_topp=False,
        )
        counts += np.bincount(tok.numpy(), minlength=V)
        np.testing.assert_allclose(
            logp.numpy(), np.log(probs)[tok.numpy()], atol=1e-5, rtol=0
        )
    n = R * rounds
    chi2 = float(((counts - n * probs) ** 2 / (n * probs)).sum())
    assert chi2 < 37.7  # chi-square, 15 dof, p = 0.001


def test_top_p_samples_stay_in_the_nucleus():
    rng = np.random.default_rng(1)
    V, R, top_p = 100, 2000, 0.6
    logits = rng.standard_normal(V).astype(np.float32) * 2.0
    order = np.argsort(-logits)
    p = np.exp(logits[order] - logits.max())
    p /= p.sum()
    nucleus = set(order[(np.cumsum(p) - p) < top_p].tolist())
    tops = torch.full((R,), top_p)
    tops[: R // 2] = 1.0  # the full-vocab rows of a mixed batch
    tok, logp = sample(
        torch.from_numpy(np.tile(logits, (R, 1))), _keys(R, 1), torch.arange(R),
        torch.ones(R), tops, torch.zeros(R, dtype=torch.bool), use_topp=True,
    )
    inside = set(tok[R // 2:].tolist())
    assert inside <= nucleus and len(inside) > 1
    assert not set(tok[: R // 2].tolist()) <= nucleus  # top_p=1 rows roam
    full_lp = torch.log_softmax(torch.from_numpy(logits), -1)
    torch.testing.assert_close(logp, full_lp[tok])


def test_greedy_rows_take_the_argmax():
    logits = torch.randn(6, 50, generator=torch.Generator().manual_seed(2))
    greedy = torch.tensor([True, False] * 3)
    tok, _ = sample(logits, _keys(6, 3), torch.arange(6), torch.full((6,), 0.7),
                    torch.ones(6), greedy, use_topp=False)
    assert torch.equal(tok[greedy], logits.argmax(-1)[greedy])


def test_device_none_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchDecodeEngine(TorchDecodeConfig())
    assert TorchDecodeEngine(TorchDecodeConfig(), device="cpu").device.type == "cpu"


# the roles are accepted since they came (ROADMAP queue 1, items 4.3-4.4):
# a role beside a setting still refused is refused for that setting
@pytest.mark.parametrize(
    "setting",
    [dict(role="decode", tensor_parallel_size=2), dict(tensor_parallel_size=2),
     dict(tensor_parallel_size=4), dict(role="prefill", kv_cache_dtype="float16"),
     dict(kv_cache_dtype="float16")],  # the model here is float32
)
def test_unported_settings_raise(weights, setting):
    eng = TorchDecodeEngine(TorchDecodeConfig(**dict(SMALL, **setting)), device="cpu")
    eng.set_model(weights[1], TCFG)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.initialize()


@pytest.mark.parametrize("role", ["unified", "prefill", "decode", "router"])
def test_roles_are_accepted_as_in_jax(weights, role):
    eng = TorchDecodeEngine(TorchDecodeConfig(**dict(SMALL, role=role)), device="cpu")
    eng.set_model(weights[1], TCFG)
    if role == "router":  # not a role: JAX's ValueError (jax_decode.py:721-727)
        with pytest.raises(ValueError, match="role='router'"):
            eng.initialize()
        return
    eng.initialize()
    try:
        assert eng.get_metrics()["role"] == role
    finally:
        eng.destroy()


def test_model_path_loads_the_checkpoint(weights, tmp_path):
    """With no model installed, `initialize` reads the HF checkpoint at
    `model_path` in `dtype` (jax_decode.py:646-655): the weights the port
    exported, served with the greedy tokens of the installed ones. A path
    with no checkpoint fails on its config.json, and no model and no path
    is an error."""
    from areal_tpu_torch.models import hf_io

    hf_io.save_hf_params(weights[1], TCFG, str(tmp_path))
    (tmp_path / "config.json").write_text(json.dumps(dict(
        model_type="qwen2", **SMOKE_MODEL_DICT, rope_theta=TCFG.rope_theta,
        rms_norm_eps=TCFG.rms_norm_eps, max_position_embeddings=TCFG.max_position_embeddings)))
    eng = TorchDecodeEngine(TorchDecodeConfig(**dict(SMALL, model_path=str(tmp_path),
                                                     dtype="float32")), device="cpu")
    eng.initialize()
    ref = _engine(weights[1])
    try:
        assert eng.model_config == dataclasses.replace(TCFG, scan_layers=True)
        for k, t in weights[1].items():
            assert torch.equal(eng.params[k], t), k
        req = ModelRequest(input_ids=[3, 9, 4, 7], gconfig=_greedy(6))
        assert eng.generate(req).output_tokens == ref.generate(req.copy()).output_tokens
    finally:
        eng.destroy()
        ref.destroy()
    with pytest.raises(FileNotFoundError, match="config.json"):
        TorchDecodeEngine(TorchDecodeConfig(**dict(SMALL, model_path=str(tmp_path / "none"))),
                          device="cpu").initialize()
    with pytest.raises(RuntimeError, match="no model installed"):
        TorchDecodeEngine(TorchDecodeConfig(**SMALL), device="cpu").initialize()


@pytest.mark.parametrize("setting", [dict(spec_decode="medusa"), dict(spec_decode="ngram", spec_k=0)])
def test_bad_spec_settings_raise(weights, setting):
    """As the JAX engine (jax_decode.py:731-742): a spec_decode outside
    ("off", "ngram"), or spec_k < 1 with "ngram", is a ValueError."""
    eng = TorchDecodeEngine(TorchDecodeConfig(**dict(SMALL, **setting)), device="cpu")
    eng.set_model(weights[1], TCFG)
    with pytest.raises(ValueError, match="spec_"):
        eng.initialize()


@pytest.mark.parametrize("setting", [dict(kv_dtype="int4"), dict(weight_dtype="fp8")])
def test_unknown_dtypes_raise(weights, setting):
    """As the JAX engine (jax_decode.py:659-663, :709-712): a value outside
    KV_DTYPES / WEIGHT_DTYPES is a ValueError."""
    eng = TorchDecodeEngine(TorchDecodeConfig(**dict(SMALL, **setting)), device="cpu")
    eng.set_model(weights[1], TCFG)
    with pytest.raises(ValueError, match="not in"):
        eng.initialize()


def test_decode_dtype_keeps_the_jax_name_and_default(weights):
    """`decode.dtype` exists under its JAX name, place and default. As in
    the JAX engine (jax_decode.py:646-653) only a `model_path` load reads
    it, so an installed float32 model serves under either value."""
    from areal_tpu.api.cli_args import JaxDecodeConfig

    assert TorchDecodeConfig().dtype == JaxDecodeConfig().dtype == "bfloat16"
    names = [f.name for f in dataclasses.fields(TorchDecodeConfig)]
    assert names.index("dtype") == names.index("random_seed") + 1
    for dtype in ("bfloat16", "float32"):
        eng = _engine(weights[1], dtype=dtype)
        try:
            assert eng._k_pool.dtype == torch.float32
        finally:
            eng.destroy()


def test_int8_pool_ignores_kv_cache_dtype(weights):
    """An int8 pool is int8 with f32 scales whatever kv_cache_dtype says
    (here bfloat16 beside a float32 model)."""
    eng = _engine(weights[1], kv_dtype="int8", kv_cache_dtype="bfloat16")
    try:
        assert eng._k_pool.dtype == torch.int8 and eng._k_scale.dtype == torch.float32
        L, n_blocks, bsz, nKV, _ = eng._k_pool.shape
        assert tuple(eng._v_scale.shape) == (L, n_blocks, nKV, bsz)
        resp = eng.generate(ModelRequest(input_ids=[2, 7, 1], gconfig=_greedy(5)), timeout=120)
        assert resp.output_len == 5 and eng.prefill_calls == 1
    finally:
        eng.destroy()


@pytest.fixture
def int8_engine(weights):
    eng = _engine(weights[1], weight_dtype="int8", kv_dtype="int8")
    yield eng
    eng.destroy()


def _other_weights(weights):
    """Different fp weights of the same geometry: layer 0 and 1 swapped."""
    out = {}
    for k, t in weights[1].items():
        out[k] = t.flip(0).clone() if k.startswith("layers/") else t.clone()
    return out


def test_int8_push_fp_weights_quantized_on_install(weights, int8_engine):
    """The colocated trainer pushes fp tensors: the int8 engine quantizes
    them on install, and then serves exactly what an int8 engine built on
    those weights serves."""
    new = _other_weights(weights)
    int8_engine.update_weights_from_distributed(None, new, TCFG, version=2)
    want = tq.quantize_weights(new)
    assert set(int8_engine.params) == set(want)
    for k, t in want.items():
        assert torch.equal(int8_engine.params[k], t), k
    req = ModelRequest(input_ids=[3, 1, 4], gconfig=_greedy(8))
    got = int8_engine.generate(req.copy(), timeout=120)
    fresh = _engine(new, weight_dtype="int8", kv_dtype="int8")
    try:
        ref = fresh.generate(req.copy(), timeout=120)
    finally:
        fresh.destroy()
    assert got.output_versions == [2] * 8
    assert got.output_tokens == ref.output_tokens
    np.testing.assert_allclose(got.output_logprobs, ref.output_logprobs, atol=0, rtol=0)


def test_int8_push_q_scale_installed_verbatim(weights, int8_engine):
    """`<path>/q` + `<path>/scale` tensors (what an int8 producer ships)
    are installed as they are, in the resident int8 / f32 dtypes."""
    quant = tq.quantize_weights(_other_weights(weights))
    pushed = {k: v.numpy() for k, v in quant.items() if k.endswith(("/q", "/scale"))}
    assert pushed and all(k in int8_engine.params for k in pushed)
    int8_engine.update_weights_from_tensor(pushed, version=5)
    for k, arr in pushed.items():
        t = int8_engine.params[k]
        assert t.dtype == (torch.int8 if k.endswith("/q") else torch.float32)
        np.testing.assert_array_equal(t.numpy(), arr)
    resp = int8_engine.generate(ModelRequest(input_ids=[1, 2], gconfig=_greedy(4)), timeout=120)
    assert resp.output_versions == [5] * 4


def test_int8_push_fp_names_diagnosed(weights, int8_engine):
    """fp kernel names pushed into an int8 engine miss its q/scale names:
    KeyError with the weight_dtype-mismatch diagnosis, and nothing is
    written."""
    before = {k: v.clone() for k, v in int8_engine.params.items()}
    with pytest.raises(KeyError, match="weight_dtype='int8'.*/q"):
        int8_engine.update_weights_from_tensor(dict(weights[1]))
    for k, t in before.items():
        assert torch.equal(int8_engine.params[k], t), k
