"""Speculative decode in the port against the JAX package, on the CPU.

- `_ngram_draft` equals the JAX drafter on seeded random and periodic
  contexts.
- The sampler's PRNG (`ops/threefry`) equals `jax.random` bit for bit
  (threefry2x32, fold_in, bits, uniform); Gumbel values within
  `GUMBEL_TOL` (XLA's and PyTorch's `log` may differ by an ulp).
- `sample` draws the tokens of the JAX `_make_sample_fn` with
  `fold_in(base_key, position)` keys, in greedy, full and top-p rows and
  mixed batches; logprobs within 1e-6.
- `paged_attention_qlen_ref` against the JAX `paged_attention_qlen` (XLA
  path and Pallas kernel in interpret mode), fp and int8 pools: f32 atol
  1e-5 (summation order), bf16 atol 2e-2 (both round scores and
  probabilities to bf16, in different places).
- `verify_step_paged` against the JAX one for (weight_dtype, kv_dtype) in
  {fp, int8}^2: logits atol 1e-4, written fp rows 1e-5, int8 rows within
  one quantization step and scales within 1e-6 relative.
- The engine: spec-on streams equal spec-off streams (greedy and sampled,
  tokens exact, logprobs within 1e-5 in f32) over verify widths 2, 3 and
  5 and every (weight_dtype, kv_dtype); a stop id inside an accepted draft
  cuts there; the counters add up; and the port's spec-off sampled streams
  equal the JAX engine's on the same weights, seed and admission order.
"""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from areal_tpu.api.cli_args import InferenceEngineConfig as JaxInferenceConfig
from areal_tpu.api.cli_args import JaxDecodeConfig
from areal_tpu.api.io_struct import ModelRequest as JaxModelRequest
from areal_tpu.engine.jax_decode import JaxDecodeEngine, _make_sample_fn
from areal_tpu.engine.jax_decode import _ngram_draft as jax_ngram_draft
from areal_tpu.models import qwen2 as jq
from areal_tpu.ops.kv_quant import quantize_kv as jax_quantize_kv
from areal_tpu.ops.paged_attention import paged_attention_qlen as jax_qlen
from areal_tpu_torch.api.cli_args import GenerationHyperparameters, TorchDecodeConfig
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.engine import sampling
from areal_tpu_torch.engine import torch_decode as td
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy
from areal_tpu_torch.models.smoke import SMOKE_MODEL_DICT
from areal_tpu_torch.ops import paged_attention as pa
from areal_tpu_torch.ops import threefry as tf

KW = dict(SMOKE_MODEL_DICT, dtype="float32", param_dtype="float32")
JCFG = jq.ModelConfig(**KW)
TCFG = tq.ModelConfig(**KW)
SMALL = dict(context_length=128, max_running_requests=4, page_size=16,
             new_tokens_per_chunk=8, kv_cache_dtype="float32")
DTYPE_PAIRS = [("fp", "fp"), ("int8", "fp"), ("fp", "int8"), ("int8", "int8")]
KEYS = np.array([[123, 456], [0, 0], [4294967295, 17], [99, 2**31 + 5], [7, 4242]], np.uint32)


def _jkeys(keys):
    return jax.vmap(jax.random.wrap_key_data)(jnp.asarray(keys, jnp.uint32))


# ---------------------------------------------------------------------------
# drafter and PRNG
# ---------------------------------------------------------------------------


def _contexts():
    rng = np.random.default_rng(0)
    out = [[], [5], [3, 3], [1, 2, 3, 1, 2], [7] * 9]
    for n in (6, 20, 64):
        out.append(rng.integers(0, 4, n).tolist())  # small vocab: many matches
        out.append(rng.integers(0, 1000, n).tolist())  # few or none
    period = rng.integers(0, 50, 5).tolist()
    out += [period * 4, (period * 4)[:-2], period * 3 + period[:3]]
    return out


@pytest.mark.parametrize("k,ngram_max", [(1, 1), (4, 3), (8, 2), (3, 5)])
def test_ngram_draft_matches_jax(k, ngram_max):
    for ctx in _contexts():
        assert td._ngram_draft(ctx, k, ngram_max) == jax_ngram_draft(ctx, k, ngram_max), ctx


def test_fold_in_known_value():
    key = torch.tensor([[123, 456]])
    assert tf.fold_in(key, 7).tolist() == [[3069288025, 2881389178]]


@pytest.mark.parametrize("data", [0, 1, 7, 1000, 2**31 - 1])
def test_fold_in_matches_jax(data):
    want = np.asarray(jax.vmap(lambda k: jax.random.key_data(jax.random.fold_in(k, data)))(_jkeys(KEYS)))
    got = tf.fold_in(torch.from_numpy(KEYS.astype(np.int64)), data).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # per-row data, as the engine folds each slot's position
    pos = np.array([0, 3, 2**20, 12345, 9], np.int64)
    want = np.asarray(jax.vmap(lambda k, d: jax.random.key_data(jax.random.fold_in(k, d)))(
        _jkeys(KEYS), jnp.asarray(pos, jnp.int32)))
    got = tf.fold_in(torch.from_numpy(KEYS.astype(np.int64)), torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_threefry2x32_matches_jax():
    from jax._src.prng import threefry_2x32

    rng = np.random.default_rng(1)
    counts = rng.integers(0, 2**32, (2, 64), dtype=np.uint64).astype(np.uint32)
    for key in KEYS:
        want = np.asarray(threefry_2x32(jnp.asarray(key), jnp.asarray(counts.reshape(-1))))
        y0, y1 = tf.threefry2x32(int(key[0]), int(key[1]),
                                 torch.from_numpy(counts[0].astype(np.int64)),
                                 torch.from_numpy(counts[1].astype(np.int64)))
        np.testing.assert_array_equal(np.concatenate([y0.numpy(), y1.numpy()]), want.astype(np.int64))


@pytest.mark.parametrize("n", [1, 2, 63, 64, 1000, 4097])
def test_bits_uniform_gumbel_match_jax(n):
    keys = _jkeys(KEYS)
    tkeys = torch.from_numpy(KEYS.astype(np.int64))
    bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(keys))
    np.testing.assert_array_equal(tf.random_bits(tkeys, n).numpy(), bits.astype(np.int64))
    uni = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (n,), minval=np.finfo(np.float32).tiny, maxval=1.0))(keys))
    np.testing.assert_array_equal(tf.uniform(tkeys, n).numpy().view(np.int32), uni.view(np.int32))
    gum = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(keys))
    atol, rtol = tf.GUMBEL_TOL
    np.testing.assert_allclose(tf.gumbel(tkeys, n).numpy(), gum, atol=atol, rtol=rtol)


@pytest.mark.parametrize("secondary", [False, True])
@pytest.mark.parametrize("kind", tf.KINDS)
def test_gumbel_noise_is_the_folded_draw(kind, secondary):
    """The sampler's noise for (base key, position) is the draw of
    fold_in(base, position) (then fold_in(.., 1)), on the CPU the plain
    version without a launch."""
    tkeys = torch.from_numpy(KEYS.astype(np.int64))
    pos = torch.tensor([0, 5, 17, 1 << 20, 3])
    before = tf.launches
    got = tf.gumbel_noise(tkeys, pos, 50, secondary=secondary, kind=kind)
    assert tf.launches == before
    key = tf.fold_in(tkeys, pos)
    if secondary:
        key = tf.fold_in(key, 1)
    want = {"bits": tf.random_bits, "uniform": tf.uniform, "gumbel": tf.gumbel}[kind](key, 50)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the sampler against the JAX sampler
# ---------------------------------------------------------------------------


def _jax_sample(logits, keys, pos, temps, top_ps, greedy, use_topp):
    subkeys = jax.vmap(jax.random.fold_in)(_jkeys(keys), jnp.asarray(pos, jnp.int32))
    tok, logp = _make_sample_fn(use_topp)(
        jnp.asarray(logits), subkeys, jnp.asarray(temps), jnp.asarray(top_ps), jnp.asarray(greedy)
    )
    return np.asarray(tok), np.asarray(logp)


_SAMPLER_CASES = {
    "full": dict(greedy=[False] * 6, top_p=[1.0] * 6, use_topp=False),
    "greedy": dict(greedy=[True] * 6, top_p=[1.0] * 6, use_topp=False),
    "top_p": dict(greedy=[False] * 6, top_p=[0.9, 0.5, 0.3, 0.95, 0.7, 0.1], use_topp=True),
    "mixed": dict(greedy=[True, False, False, False, True, False],
                  top_p=[1.0, 1.0, 0.8, 0.4, 0.6, 1.0], use_topp=True),
    "mixed_no_topp_rows": dict(greedy=[True, False, False, True, False, False],
                               top_p=[1.0] * 6, use_topp=True),
}


@pytest.mark.parametrize("V", [32, 100, 1000])
@pytest.mark.parametrize("case", list(_SAMPLER_CASES))
def test_sample_matches_jax_sampler(case, V):
    c = _SAMPLER_CASES[case]
    rng = np.random.default_rng(V)
    R = 6
    keys = np.concatenate([KEYS, [[11, 12]]]).astype(np.uint32)
    temps = np.array([1.0, 0.7, 1.3, 1.0, 0.5, 2.0], np.float32)
    greedy = np.array(c["greedy"])
    top_ps = np.array(c["top_p"], np.float32)
    for trial in range(8):
        logits = (rng.standard_normal((R, V)) * 2.0).astype(np.float32)
        pos = rng.integers(0, 5000, R)
        want_tok, want_lp = _jax_sample(logits, keys, pos, temps, top_ps, greedy, c["use_topp"])
        tok, lp = sampling.sample(
            torch.from_numpy(logits), torch.from_numpy(keys.astype(np.int64)),
            torch.from_numpy(pos), torch.from_numpy(temps), torch.from_numpy(top_ps),
            torch.from_numpy(greedy), c["use_topp"],
        )
        np.testing.assert_array_equal(tok.numpy(), want_tok)
        np.testing.assert_allclose(lp.numpy(), want_lp, atol=1e-6, rtol=0)


def test_sample_rows_are_pure_functions_of_key_and_position():
    """A row's token depends only on its logits, key and position: alone,
    in another batch, and beside a top-p row (the top_p == 1 row keeps the
    primary subkey in the top-p variant)."""
    rng = np.random.default_rng(3)
    V = 200
    logits = torch.from_numpy(rng.standard_normal((5, V)).astype(np.float32))
    keys = torch.from_numpy(KEYS.astype(np.int64))
    pos = torch.tensor([4, 9, 1, 77, 3])
    ones = torch.ones(5)
    no = torch.zeros(5, dtype=torch.bool)
    base, _ = sampling.sample(logits, keys, pos, ones, ones, no, use_topp=False)
    tops = ones.clone()
    tops[2] = 0.5  # row 2 top-p; the others keep the full draw
    mixed, _ = sampling.sample(logits, keys, pos, ones, tops, no, use_topp=True)
    assert torch.equal(mixed[[0, 1, 3, 4]], base[[0, 1, 3, 4]])
    for r in range(5):
        alone, _ = sampling.sample(logits[r:r + 1], keys[r:r + 1], pos[r:r + 1], ones[:1],
                                   ones[:1], no[:1], use_topp=False)
        assert alone.item() == base[r].item()
    perm = torch.tensor([3, 0, 4, 1, 2])
    shuffled, _ = sampling.sample(logits[perm], keys[perm], pos[perm], ones, ones, no, use_topp=False)
    assert torch.equal(shuffled, base[perm])


def test_slot_base_key_is_the_jax_engine_key():
    for seed, seq in [(1, 0), (1, 1), (5, 3), (12345, 999)]:
        want = np.random.SeedSequence(entropy=(seed, seq)).generate_state(2, np.uint32)
        got = sampling.slot_base_key(seed, seq)
        assert got.dtype == np.uint32 and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# verify attention and the verify step
# ---------------------------------------------------------------------------

QLEN_CASES = [(1, 16, 16, 2), (2, 64, 16, 3), (7, 16, 128, 5), (7, 64, 128, 4)]  # group, hd, bsz, W
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qlen_inputs(group, hd, bsz, W, seed=0, R=4, nKV=2, nb=3):
    """Random pools and a table with null-block tails; slot r's query w
    attends rows s <= base[r] + w, base = [-W (no valid row for any
    query), -1 (none for query 0 only), mid-page, the span's end - W]."""
    rng = np.random.default_rng(seed)
    n_blocks = R * nb + 2
    span = nb * bsz
    base = np.array([-W, -1, bsz // 2, span - W])[:R]
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((R, nb), np.int32)
    for r in range(R):
        used = -(-max(int(base[r]) + W, 0) // bsz)
        table[r, :used] = perm[r * nb : r * nb + used]
    k = rng.standard_normal((n_blocks, bsz, nKV, hd)).astype(np.float32)
    v = rng.standard_normal((n_blocks, bsz, nKV, hd)).astype(np.float32)
    q = rng.standard_normal((R, W, group * nKV, hd)).astype(np.float32)
    valid = np.arange(span)[None, None, :] <= (base[:, None] + np.arange(W))[:, :, None]
    return q, k, v, table, valid


def _int8_pool(pool):
    q, sc = jax_quantize_kv(jnp.asarray(pool))
    return np.array(q), np.array(jnp.swapaxes(sc, -1, -2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("pool", ["fp", "int8"])
@pytest.mark.parametrize("group,hd,bsz,W", QLEN_CASES)
def test_qlen_ref_matches_jax(group, hd, bsz, W, pool, impl, dtype):
    q, k, v, table, valid = _qlen_inputs(group, hd, bsz, W, seed=hd + W)
    t, j = TORCH_DTYPE[dtype], jnp.dtype(dtype)
    if pool == "int8":
        kq, vq = _int8_pool(k), _int8_pool(v)
        tk, tv = tuple(map(torch.from_numpy, kq)), tuple(map(torch.from_numpy, vq))
        jk, jv = tuple(map(jnp.asarray, kq)), tuple(map(jnp.asarray, vq))
    else:
        tk, tv = torch.from_numpy(k).to(t), torch.from_numpy(v).to(t)
        jk, jv = jnp.asarray(k, j), jnp.asarray(v, j)
    before = (pa.launches_verify, pa.launches_verify_q8)
    ours = pa.paged_attention_qlen(torch.from_numpy(q).to(t), tk, tv,
                                   torch.from_numpy(table), torch.from_numpy(valid))
    assert (pa.launches_verify, pa.launches_verify_q8) == before and ours.dtype == t
    ours = ours.float().numpy()
    kw = dict(impl="pallas", interpret=True) if impl == "pallas" else dict(impl="xla")
    theirs = np.asarray(jax_qlen(jnp.asarray(q, j), jk, jv, jnp.asarray(table),
                                 jnp.asarray(valid), **kw).astype(jnp.float32))
    empty = ~valid.any(-1)  # [R, W]: queries with no valid row give 0
    assert empty[0].all() and empty[1, 0] and not empty[1, 1:].any()
    assert (ours[empty] == 0).all()
    if impl == "pallas":
        assert (theirs[empty] == 0).all()
    np.testing.assert_allclose(ours[~empty], theirs[~empty], atol=TOL[dtype], rtol=0)


def test_qlen_ref_is_paged_attention_per_query():
    """Query w of the verify attention is the decode attention of a slot
    whose valid rows are valid[:, w]."""
    q, k, v, table, valid = _qlen_inputs(7, 16, 16, 4, seed=9)
    args = [torch.from_numpy(a) for a in (k, v, table)]
    out = pa.paged_attention_qlen(torch.from_numpy(q), *args, torch.from_numpy(valid))
    for w in range(q.shape[1]):
        one = pa.paged_attention(torch.from_numpy(q[:, w].copy()), *args,
                                 torch.from_numpy(valid[:, w].copy()))
        torch.testing.assert_close(out[:, w], one, atol=1e-6, rtol=0)


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda a: a.update(q=a["q"][:, 0].contiguous()), ValueError),  # a decode q
        (lambda a: a.update(valid=a["valid"][:, 0].contiguous()), ValueError),
        (lambda a: a.update(q=a["q"].repeat(1, 5, 1, 1), valid=a["valid"].repeat(1, 5, 1)),
         ValueError),  # W 20 > 16
        (lambda a: a.update(q=a["q"].double()), TypeError),
    ],
)
def test_verify_kernel_argument_checks(mutate, err):
    q, k, v, table, valid = _qlen_inputs(2, 16, 16, 4)
    args = dict(q=torch.from_numpy(q), k_pool=torch.from_numpy(k), v_pool=torch.from_numpy(v),
                block_table=torch.from_numpy(table), valid=torch.from_numpy(valid))
    pa._check(**args, verify=True)
    mutate(args)
    with pytest.raises(err):
        pa._check(**args, verify=True)


def test_verify_width_limit():
    pa.check_verify_width(pa.VERIFY_MAX_W, 8)  # W 16 x group 8 = 128 rows
    pa.check_verify_width(9, 8)
    for W, group in [(0, 7), (pa.VERIFY_MAX_W + 1, 1), (10, 16)]:
        with pytest.raises(ValueError, match="verify width"):
            pa.check_verify_width(W, group)


@pytest.fixture(scope="module")
def weights():
    jparams = jq.init_params(JCFG, jax.random.PRNGKey(7))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG)


def _pools(rng, L, n_blocks, bsz, nKV, hd, kv_dtype):
    """Random fp pools, or int8 pools (JAX-quantized) with their scales:
    numpy (k, v) as (data,) or (data, scales [L, n_blocks, nKV, bsz])."""
    k = rng.standard_normal((L, n_blocks, bsz, nKV, hd)).astype(np.float32)
    v = rng.standard_normal((L, n_blocks, bsz, nKV, hd)).astype(np.float32)
    if kv_dtype == "fp":
        return (k,), (v,)
    return _int8_pool(k), _int8_pool(v)


@pytest.mark.parametrize("weight_dtype,kv_dtype", DTYPE_PAIRS)
def test_verify_step_matches_jax(weights, weight_dtype, kv_dtype):
    jparams, tparams = weights
    if weight_dtype == "int8":
        jparams = jq.quantize_weights(jparams)
        tparams = tq.quantize_weights(tparams)
    rng = np.random.default_rng(5)
    L, nKV, hd = JCFG.num_hidden_layers, JCFG.num_key_value_heads, JCFG.head_dim_
    R, W, bsz, nb = 3, 4, 16, 3
    n_blocks = R * nb + 1
    kp, vp = _pools(rng, L, n_blocks, bsz, nKV, hd, kv_dtype)
    table = np.arange(1, n_blocks, dtype=np.int32).reshape(R, nb)
    tokens = rng.integers(0, JCFG.vocab_size, (R, W))
    pos0 = np.array([0, 13, 30])
    active = np.array([True, False, True])
    jl, jk, jv = jq.verify_step_paged(
        jparams, jnp.asarray(tokens, jnp.int32), jnp.asarray(pos0, jnp.int32),
        tuple(map(jnp.asarray, kp)) if kv_dtype == "int8" else jnp.asarray(kp[0]),
        tuple(map(jnp.asarray, vp)) if kv_dtype == "int8" else jnp.asarray(vp[0]),
        jnp.asarray(table), JCFG, active=jnp.asarray(active), attn_impl="xla",
    )
    tk = [torch.from_numpy(a.copy()) for a in kp]
    tv = [torch.from_numpy(a.copy()) for a in vp]
    tl = tq.verify_step_paged(
        tparams, torch.from_numpy(tokens), torch.from_numpy(pos0),
        tuple(tk) if kv_dtype == "int8" else tk[0], tuple(tv) if kv_dtype == "int8" else tv[0],
        torch.from_numpy(table), TCFG, active=torch.from_numpy(active),
    )
    assert tl.shape == (R, W, JCFG.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl[active].numpy(), np.asarray(jl)[active], atol=1e-4, rtol=0)
    # the pools after the step; block 0 (inactive writes, a duplicate
    # index whose winner neither package fixes) is left out
    for ours, theirs in ((tk, jk), (tv, jv)):
        theirs = theirs if isinstance(theirs, tuple) else (theirs,)
        data, want = ours[0].numpy()[:, 1:], np.asarray(theirs[0])[:, 1:]
        if kv_dtype == "fp":
            np.testing.assert_allclose(data, want, atol=1e-5, rtol=0)
        else:
            assert np.abs(data.astype(np.int32) - want.astype(np.int32)).max() <= 1
            np.testing.assert_allclose(ours[1].numpy()[:, 1:], np.asarray(theirs[1])[:, 1:],
                                       rtol=1e-6, atol=0)
    # and the rows it wrote are the active slots' W rows, nowhere else
    before = _pools(np.random.default_rng(5), L, n_blocks, bsz, nKV, hd, kv_dtype)[0][0]
    changed = (tk[0].numpy() != before).any(axis=(0, 3, 4))  # [n_blocks, bsz]
    want = np.zeros_like(changed)
    for r in np.nonzero(active)[0]:
        for p in pos0[r] + np.arange(W):
            want[table[r, p // bsz], p % bsz] = True
    assert (changed[1:] == want[1:]).all()


def test_verify_step_equals_sequential_decode_steps(weights):
    """W columns of one verify forward give the logits and KV rows of W
    decode steps fed the same tokens (f32, plain attention)."""
    tparams = weights[1]
    rng = np.random.default_rng(6)
    L, nKV, hd = TCFG.num_hidden_layers, TCFG.num_key_value_heads, TCFG.head_dim_
    R, W, bsz, nb = 2, 5, 16, 4
    n_blocks = R * nb + 1
    kp = torch.from_numpy(rng.standard_normal((L, n_blocks, bsz, nKV, hd)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((L, n_blocks, bsz, nKV, hd)).astype(np.float32))
    table = torch.arange(1, n_blocks, dtype=torch.int32).reshape(R, nb)
    tokens = torch.from_numpy(rng.integers(0, TCFG.vocab_size, (R, W)))
    pos0 = torch.tensor([14, 40])
    ks, vs = kp.clone(), vp.clone()
    logits = tq.verify_step_paged(tparams, tokens, pos0, kp, vp, table, TCFG)
    for j in range(W):
        lj = tq.decode_step_paged(tparams, tokens[:, j], pos0 + j, ks, vs, table, TCFG)
        torch.testing.assert_close(logits[:, j], lj, atol=1e-5, rtol=0)
    torch.testing.assert_close(kp, ks, atol=1e-6, rtol=0)
    torch.testing.assert_close(vp, vs, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _echo(tparams):
    """The residual-mixing kernels zeroed (as the JAX spec-decode tests
    do): a greedy stream becomes a deterministic map of the last token,
    which enters a short cycle that the drafter then predicts in full."""
    out = dict(tparams)
    for name in ("layers/attn/o_kernel", "layers/mlp/down_kernel"):
        out[name] = torch.zeros_like(tparams[name])
    return out


def _engine(tparams, **over):
    eng = td.TorchDecodeEngine(TorchDecodeConfig(**dict(SMALL, **over)), device="cpu")
    eng.set_model(tparams, TCFG)
    return eng.initialize()


def _requests():
    """Self-quoting prompts: greedy, full-distribution and top-p rows, and
    max_new_tokens that leave 1-3 tokens for the last drafts."""
    rng = np.random.default_rng(11)
    reqs = []
    for i, n_new in enumerate([37, 30, 26, 33, 29, 35]):
        seg = rng.integers(0, TCFG.vocab_size, 4 + i).tolist()
        g = GenerationHyperparameters(max_new_tokens=n_new, greedy=i < 3,
                                      top_p=0.7 if i == 5 else 1.0, temperature=1.0)
        reqs.append(ModelRequest(rid=f"r{i}", input_ids=seg * 3, gconfig=g))
    return reqs


def _serve(eng, reqs):
    async def go():
        return await asyncio.gather(*[eng.agenerate(r.copy()) for r in reqs])

    return asyncio.run(go())


@pytest.mark.parametrize("weight_dtype,kv_dtype", DTYPE_PAIRS)
def test_spec_streams_equal_spec_off_streams(weights, weight_dtype, kv_dtype, monkeypatch):
    params = _echo(weights[1])
    widths = []
    real = td.verify_step_paged

    def spy(params, tokens, *a, **k):
        widths.append(tokens.shape[1])
        return real(params, tokens, *a, **k)

    monkeypatch.setattr(td, "verify_step_paged", spy)
    outs, engines = {}, {}
    for spec in ("off", "ngram"):
        # the synchronous schedule, whose batches draft buckets 1, 2 and 4
        # on this traffic (run-ahead admits a freed slot's successor one
        # pass later); tests/test_torch_decode_runahead.py runs it ahead
        eng = _engine(params, spec_decode=spec, spec_k=4, decode_runahead_chunks=0,
                      weight_dtype=weight_dtype, kv_dtype=kv_dtype)
        try:
            outs[spec] = _serve(eng, _requests())
        finally:
            eng.destroy()
        engines[spec] = eng
    on = engines["ngram"]
    assert {2, 3, 5} <= set(widths)  # draft buckets 1, 2 and 4
    assert on.spec_accepted > 0 and on.verify_dispatches == len(widths)
    for a, b in zip(outs["off"], outs["ngram"]):
        assert b.output_tokens == a.output_tokens, b.rid
        np.testing.assert_allclose(b.output_logprobs, a.output_logprobs, atol=1e-5, rtol=0)
        assert b.stop_reason == a.stop_reason == "length"
    # the counters add up
    assert on.spec_drafted == on.spec_accepted + on.spec_rejected
    assert on.spec_hist.sum() == on.spec_chunk_slots
    delivered = sum(r.output_len for r in outs["ngram"])
    assert on.decode_tokens == delivered
    assert on.spec_chunk_slots + on.spec_accepted + on.chunk_tokens - on.tokens_cut == delivered
    assert engines["off"].verify_dispatches == 0 and engines["off"].spec_chunk_slots == 0


def test_stop_inside_an_accepted_draft(weights, monkeypatch):
    """A stop id that the verify forward emits inside an accepted draft
    ends the request there, as in the spec-off stream."""
    params = _echo(weights[1])
    req = ModelRequest(input_ids=[3, 9, 3, 9, 3, 9, 5], gconfig=GenerationHyperparameters(
        max_new_tokens=40, greedy=True))
    off = _engine(params)
    try:
        full = off.generate(req.copy(), timeout=120).output_tokens
    finally:
        off.destroy()
    passes = []
    real = td.TorchDecodeEngine._emit

    def spy(self, slot, toks, *a):
        passes.append(len(toks))
        return real(self, slot, toks, *a)

    monkeypatch.setattr(td.TorchDecodeEngine, "_emit", spy)
    on = _engine(params, spec_decode="ngram", spec_k=4)
    try:
        on.generate(req.copy(), timeout=120)
        spans = np.cumsum([0] + passes)
        # a position emitted inside an accepted draft (not a pass's bonus),
        # past min_new_tokens, whose token first appears there from then on
        min_new = 12
        cut = next(
            i for i in range(min_new, len(full))
            if any(s <= i < e - 1 for s, e in zip(spans[:-1], spans[1:]) if e - s > 1)
        )
        g = req.gconfig.new(stop_token_ids=[full[cut]], min_new_tokens=cut + 1)
        want = next(i for i in range(cut, len(full)) if full[i] == full[cut]) + 1
        passes.clear()
        resp = on.generate(ModelRequest(input_ids=req.input_ids, gconfig=g), timeout=120)
    finally:
        on.destroy()
    assert resp.stop_reason == "stop" and resp.output_tokens == full[:want]
    assert on.tokens_cut > 0


def test_spec_streams_survive_preemption(weights):
    """Pool pressure requeues a slot mid-stream under speculation; its
    stream (sampled too) still equals the roomy spec-off engine's."""
    params = _echo(weights[1])
    reqs = [
        ModelRequest(input_ids=list(range(1, 20)), gconfig=GenerationHyperparameters(
            max_new_tokens=60, greedy=True)),
        ModelRequest(input_ids=[2, 2, 5] * 2, gconfig=GenerationHyperparameters(
            max_new_tokens=60, temperature=1.0)),
    ]
    roomy = _engine(params)
    tight = _engine(params, kv_pool_tokens=96, spec_decode="ngram")
    try:
        want = _serve(roomy, reqs)
        got = _serve(tight, reqs)
        assert tight.n_preemptions > 0 and tight.verify_dispatches > 0
    finally:
        roomy.destroy()
        tight.destroy()
    for a, b in zip(want, got):
        assert a.output_tokens == b.output_tokens
        np.testing.assert_allclose(a.output_logprobs, b.output_logprobs, atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "setting", [dict(spec_decode="ngram", spec_ngram_max=0),
                dict(spec_decode="ngram", spec_k=pa.VERIFY_MAX_W)],  # W 17
)
def test_bad_spec_settings_raise(weights, setting):
    eng = td.TorchDecodeEngine(TorchDecodeConfig(**dict(SMALL, **setting)), device="cpu")
    eng.set_model(weights[1], TCFG)
    with pytest.raises(ValueError):
        eng.initialize()


def test_spec_off_sampled_streams_equal_the_jax_engine(weights):
    """Same weights, seed and admission order (one request at a time): the
    port draws the JAX engine's tokens, sampled and top-p included."""
    jparams, tparams = weights
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, JCFG.vocab_size, n).tolist() for n in (5, 17, 3, 30)]
    gens = [dict(temperature=1.0), dict(temperature=0.7, top_p=0.8),
            dict(temperature=1.3), dict(greedy=True)]
    n_new = 20
    jeng = JaxDecodeEngine(JaxDecodeConfig(
        context_length=128, max_running_requests=4, page_size=16, new_tokens_per_chunk=8,
        dtype="float32", kv_cache_dtype="float32", random_seed=3,
        enable_prefix_caching=False,
    ), JaxInferenceConfig())
    jeng.set_model(jparams, JCFG)
    jeng.initialize()
    try:
        from areal_tpu.api.cli_args import GenerationHyperparameters as JaxGen

        want = []
        for p, g in zip(prompts, gens):
            r = asyncio.run(jeng.agenerate(JaxModelRequest(
                input_ids=p, gconfig=JaxGen(max_new_tokens=n_new, **g))))
            want.append(r)
    finally:
        jeng.destroy()
    eng = _engine(tparams, random_seed=3)
    try:
        got = [eng.generate(ModelRequest(input_ids=p, gconfig=GenerationHyperparameters(
            max_new_tokens=n_new, **g)), timeout=120) for p, g in zip(prompts, gens)]
    finally:
        eng.destroy()
    for a, b in zip(want, got):
        assert b.output_tokens == list(a.output_tokens)
        np.testing.assert_allclose(b.output_logprobs, a.output_logprobs, atol=1e-5, rtol=0)
