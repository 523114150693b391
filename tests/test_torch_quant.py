"""The port's int8 serving pieces against the JAX package's, on the CPU.

- `ops/quant.py`: `quantize_absmax` / `dequantize_absmax` bit for bit
  against JAX over several reduction axes, all-zero slices included (both
  sides round half to even and divide, so the int8 values and scales are
  identical on the same f32 input).
- `ops/kv_quant.py`: `quantize_kv` and the scale-layout helpers, bit for
  bit.
- `models/qwen2.py`: `quantize_weights` on the same kernel set, with the
  JAX wire names and bit-equal q/scale; the contraction-axis table.
- `ops/quant_matmul.py`: the plain version of `quant_einsum` against JAX
  `quant_einsum` at impl="xla" and at impl="pallas" in interpret mode, f32,
  within 1e-5 + 1e-5 |ref| (f32 sums of 256 products in another order;
  the Pallas kernel sums 128-deep tiles).
- `decode_step_paged` with an int8 KV pool (and int8 or fp weights)
  against JAX's: logits within atol 1e-5 (f32 summation order). The rows
  it writes come from f32 projections that differ from JAX's in the last
  bit, so their scales agree within 1e-6 relative and their int8 values
  within one step; every other pool byte is left as it was.

Every comparison is against a live JAX run on the same numpy inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from areal_tpu.models import qwen2 as jq
from areal_tpu.ops import kv_quant as jkv
from areal_tpu.ops import quant as jquant
from areal_tpu.ops.quant_matmul import quant_einsum as jax_quant_einsum
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy, to_tensor
from areal_tpu_torch.models.smoke import SMOKE_MODEL_DICT
from areal_tpu_torch.ops import kv_quant as tkv
from areal_tpu_torch.ops import quant as tquant
from areal_tpu_torch.ops import quant_matmul as qm

KW = dict(SMOKE_MODEL_DICT, dtype="float32", param_dtype="float32")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _sample(shape, seed):
    """Normal values [A, B, C] with all-zero slices along each reduction
    of the tests (-1, (0,), (0, 1), (1,)), and some values on half-steps
    to exercise round-half-to-even."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 2.0
    x.reshape(-1)[7::11] = 0.5 * x.reshape(-1)[7::11].round()
    x[0, 0, :] = 0.0  # along -1
    x[:, 1, 2] = 0.0  # along 0
    x[:, :, 3] = 0.0  # along (0, 1)
    x[2, :, 4] = 0.0  # along 1
    return x


@pytest.mark.parametrize("axis", [-1, (0,), (0, 1), (1,)], ids=str)
def test_quantize_absmax_bitwise_matches_jax(axis):
    x = _sample((6, 5, 32), seed=0)
    jq_, js = jquant.quantize_absmax(jnp.asarray(x), axis=axis)
    tq_, ts = tquant.quantize_absmax(torch.from_numpy(x), axis=axis)
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(_np(tq_), np.asarray(jq_))
    np.testing.assert_array_equal(_np(ts).view(np.int32), np.asarray(js).view(np.int32))
    # all-zero slices: scale 1, values 0, an exact zero back
    zero = np.abs(x).max(axis=axis) == 0
    assert zero.any() and (np.asarray(js)[zero] == 1.0).all()
    jd = jquant.dequantize_absmax(jq_, js, jnp.float32, axis=axis)
    td = tquant.dequantize_absmax(tq_, ts, torch.float32, axis=axis)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    jb = jquant.dequantize_absmax(jq_, js, jnp.bfloat16, axis=axis)
    tb = tquant.dequantize_absmax(tq_, ts, torch.bfloat16, axis=axis)
    np.testing.assert_array_equal(_np(tb.float()), np.asarray(jb.astype(jnp.float32)))


def test_kv_quant_and_scale_layouts_match_jax():
    x = np.random.default_rng(1).standard_normal((3, 24, 2, 16)).astype(np.float32)
    x[1, 5, 0] = 0.0  # an all-zero row: scale 1
    jq_, js = jkv.quantize_kv(jnp.asarray(x))
    tq_, ts = tkv.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(tq_), np.asarray(jq_))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    blocked_j = jkv.scales_blocked(js, 3, 8)  # [3, 3, 2, 8]
    blocked_t = tkv.scales_blocked(ts, 3, 8)
    np.testing.assert_array_equal(_np(blocked_t), np.asarray(blocked_j))
    np.testing.assert_array_equal(_np(tkv.scales_rowmajor(blocked_t)), _np(ts))
    assert tkv.split_pool(tq_) == (tq_, None)
    assert tkv.join_pool(tq_, ts)[1] is ts and tkv.join_pool(tq_, None) is tq_
    assert tkv.KV_DTYPES == jkv.KV_DTYPES


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "per_layer"])
def test_quantize_weights_matches_jax(scan_layers):
    jcfg = jq.ModelConfig(**KW, scan_layers=scan_layers)
    tcfg = tq.ModelConfig(**KW, scan_layers=scan_layers)
    jparams = jq.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    want = tq.flatten_names(jax.tree.map(np.asarray, jq.quantize_weights(jparams)))
    got = tq.quantize_weights(tparams)
    assert set(got) == set(want)
    fp_shapes = tq.named_shapes(tcfg)
    for name, t in got.items():  # q: the kernel's shape; scale: its output dims
        base, _, part = name.rpartition("/")
        axes = tq.wq_contraction_axes(base.rpartition("/")[2], scan_layers)
        if part == "q":
            assert tuple(t.shape) == fp_shapes[base]
        elif part == "scale":
            assert tuple(t.shape) == tuple(d for i, d in enumerate(fp_shapes[base]) if i not in axes)
        else:
            assert tuple(t.shape) == fp_shapes[name]
    n_quant = 0
    for name, arr in want.items():
        t = got[name]
        if name.endswith("/q"):
            assert t.dtype == torch.int8
            n_quant += 1
        np.testing.assert_array_equal(_np(t), arr, err_msg=name)
    assert n_quant == 7 * (1 if scan_layers else jcfg.num_hidden_layers)
    assert tq.is_weight_quantized(got) and not tq.is_weight_quantized(tparams)
    # idempotent, and dequantize is the JAX inverse
    assert all(got[k] is v for k, v in tq.quantize_weights(got).items())
    jd = tq.flatten_names(jax.tree.map(
        np.asarray, jq.dequantize_weights(jq.quantize_weights(jparams), jnp.float32)))
    td = tq.dequantize_weights(got, torch.float32)
    assert set(td) == set(jd)
    for name, arr in jd.items():
        np.testing.assert_array_equal(_np(td[name]), arr, err_msg=name)


def test_weight_quant_tables_match_jax():
    assert tq.WEIGHT_DTYPES == jq.WEIGHT_DTYPES
    assert tq._WQ_ATTN_AXES == jq._WQ_ATTN_AXES and tq._WQ_MLP_AXES == jq._WQ_MLP_AXES
    for leaf in ("q_kernel", "o_kernel", "down_kernel", "embedding", "q_bias"):
        for stacked in (True, False):
            assert tq.wq_contraction_axes(leaf, stacked) == jq.wq_contraction_axes(leaf, stacked)


def _qmm_inputs(n_contract, seed, T=5):
    """x [T, *K], int8 weight [*K, *out] and f32 scales [*out], 128-aligned
    K and N (the Pallas kernel's tiling)."""
    rng = np.random.default_rng(seed)
    k_dims, out_dims = ((256,), (2, 64)) if n_contract == 1 else ((2, 128), (128,))
    w = rng.standard_normal((*k_dims, *out_dims)).astype(np.float32)
    q, s = jquant.quantize_absmax(jnp.asarray(w), axis=tuple(range(n_contract)))
    x = rng.standard_normal((T, *k_dims)).astype(np.float32)
    return x, np.array(q), np.array(s)


@pytest.mark.parametrize("n_contract", [1, 2])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_quant_einsum_plain_matches_jax(impl, n_contract):
    x, q, s = _qmm_inputs(n_contract, seed=4 + n_contract)
    kw = dict(impl=impl, interpret=True) if impl == "pallas" else dict(impl=impl)
    want = np.asarray(jax_quant_einsum(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                       n_contract, **kw))
    before = qm.launches
    got = qm.quant_einsum(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
                          n_contract)
    assert qm.launches == before  # CPU tensors take the plain version
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-5)
    ref = qm.quant_einsum_ref(torch.from_numpy(x), torch.from_numpy(q),
                              torch.from_numpy(s), n_contract)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_quant_einsum_bf16_and_batch_dims():
    """bf16 x: f32 arithmetic, output rounded to bf16 once (as JAX); a
    1-D x has no batch dim, a 3-D x keeps two."""
    x, q, s = _qmm_inputs(1, seed=9, T=6)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_quant_einsum(xb, jnp.asarray(q), jnp.asarray(s), 1,
                                       impl="xla").astype(jnp.float32))
    got = qm.quant_einsum(to_tensor(np.asarray(xb)), torch.from_numpy(q),
                          torch.from_numpy(s), 1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got.float()), want, atol=0, rtol=2.0 ** -8)
    one = qm.quant_einsum(torch.from_numpy(x[0]), torch.from_numpy(q), torch.from_numpy(s), 1)
    assert tuple(one.shape) == q.shape[1:]
    three = qm.quant_einsum(torch.from_numpy(x.reshape(2, 3, -1)), torch.from_numpy(q),
                            torch.from_numpy(s), 1)
    assert tuple(three.shape) == (2, 3, *q.shape[1:])
    with pytest.raises(ValueError, match="contraction"):
        qm.quant_einsum(torch.from_numpy(x[:, :-1]), torch.from_numpy(q), torch.from_numpy(s), 1)


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda a: a.update(x2=a["x2"].double()), TypeError),
        (lambda a: a.update(q2=a["q2"].float()), TypeError),
        (lambda a: a.update(s_row=a["s_row"].double()), TypeError),
        (lambda a: a.update(x2=a["x2"].t().contiguous().t()), ValueError),
        (lambda a: a.update(s_row=a["s_row"][:-1].contiguous()), ValueError),
    ],
)
def test_quant_matmul_argument_checks(mutate, err):
    """The checks the wrapper runs before a launch (device-independent)."""
    x, q, s = _qmm_inputs(1, seed=10, T=8)
    args = dict(x2=torch.from_numpy(x), q2=torch.from_numpy(q.reshape(256, -1)),
                s_row=torch.from_numpy(s.reshape(-1)))
    qm._check(**args)
    mutate(args)
    with pytest.raises(err):
        qm._check(**args)


@pytest.mark.parametrize("T", [1, 16, 17, 1024])
@pytest.mark.parametrize("K,N", [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584), (100, 30)])
def test_quant_matmul_plan_covers_k(T, K, N):
    """Every launch plan deals each 64-deep k tile to exactly one split and
    leaves no split empty; K is split only for grids of fewer than 4
    blocks per SM."""
    mt, splits, per = qm.plan(T, K, N, n_sms=132)
    k_tiles = -(-K // qm.TILE_K)
    assert mt == (1 if T <= 16 else 4)
    assert splits * per >= k_tiles and (splits - 1) * per < k_tiles
    tiles = -(-N // qm.TILE_N) * -(-T // (16 * mt))
    assert splits == 1 or tiles < 4 * 132


# -- decode_step_paged with an int8 pool -------------------------------


def _int8_step_inputs(seed=0):
    cfg = jq.ModelConfig(**KW)
    L, nKV, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim_
    R, bsz, nb = 3, 8, 4
    n_blocks = R * nb + 1
    rng = np.random.default_rng(seed)
    kf = rng.standard_normal((L, n_blocks, bsz, nKV, hd)).astype(np.float32)
    vf = rng.standard_normal((L, n_blocks, bsz, nKV, hd)).astype(np.float32)
    pools = []
    for f in (kf, vf):
        q, s = jkv.quantize_kv(jnp.asarray(f))
        pools.append((np.asarray(q), np.asarray(jnp.swapaxes(s, -1, -2))))
    table = (1 + rng.permutation(R * nb)).reshape(R, nb).astype(np.int32)
    positions = np.array([0, 13, nb * bsz - 1], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, R).astype(np.int32)
    active = np.array([True, True, False])
    return cfg, pools, table, positions, tokens, active


@pytest.mark.parametrize("weight_dtype", ["fp", "int8"])
def test_decode_step_int8_pool_matches_jax(weight_dtype):
    jcfg, pools, table, positions, tokens, active = _int8_step_inputs()
    tcfg = tq.ModelConfig(**KW)
    jparams = jq.init_params(jcfg, jax.random.PRNGKey(5))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    if weight_dtype == "int8":
        jparams = jq.quantize_weights(jparams)
        tparams = tq.quantize_weights(tparams)
    jk, jv = [tuple(jnp.asarray(a) for a in p) for p in pools]
    logits_j, (jkd, jks), (jvd, jvs) = jq.decode_step_paged(
        jparams, jnp.asarray(tokens), jnp.asarray(positions), jk, jv,
        jnp.asarray(table), jcfg, active=jnp.asarray(active), attn_impl="xla",
    )
    tk, tv = [tuple(torch.from_numpy(a.copy()) for a in p) for p in pools]
    logits_t = tq.decode_step_paged(
        tparams, torch.from_numpy(tokens).long(), torch.from_numpy(positions).long(),
        tk, tv, torch.from_numpy(table), tcfg, active=torch.from_numpy(active),
    )
    np.testing.assert_allclose(_np(logits_t), np.asarray(logits_j), atol=1e-5, rtol=0)
    # the pools were written in place, at the rows JAX wrote: the active
    # slots' rows and the inactive slot's row in null block 0
    bsz = pools[0][0].shape[2]
    written = np.zeros(pools[0][0].shape[:3], bool)  # [L, n_blocks, bsz]
    for r in range(len(tokens)):
        blk = table[r, positions[r] // bsz] if active[r] else 0
        written[:, blk, positions[r] % bsz if active[r] else 0] = True
    for (td, ts), jd, js, (d0, s0) in ((tk, jkd, jks, pools[0]), (tv, jvd, jvs, pools[1])):
        td, ts, jd, js = _np(td), _np(ts), np.asarray(jd), np.asarray(js)
        np.testing.assert_array_equal(td[~written], d0[~written])
        np.testing.assert_array_equal(np.swapaxes(ts, -1, -2)[~written],
                                      np.swapaxes(s0, -1, -2)[~written])
        assert not np.array_equal(td[written], d0[written])
        assert np.abs(td.astype(np.int32) - jd.astype(np.int32)).max() <= 1
        np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)


def test_forward_refuses_a_quantized_tree():
    tcfg = tq.ModelConfig(**KW)
    params = tq.quantize_weights(tq.init_params(tcfg, torch.Generator().manual_seed(0)))
    ids = torch.arange(6)
    with pytest.raises(ValueError, match="int8"):
        tq.forward(params, ids, ids, torch.zeros(6, dtype=torch.int32), tcfg)


def test_prefill_with_int8_weights_matches_jax():
    """Prefill runs the quantized matmuls; its attention stays on the fp
    K/V it has just computed."""
    jcfg, tcfg = jq.ModelConfig(**KW), tq.ModelConfig(**KW)
    jparams = jq.init_params(jcfg, jax.random.PRNGKey(6))
    tparams = tq.quantize_weights(params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg))
    ids = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], np.int32)
    lj, kj, vj = jq.prefill(jq.quantize_weights(jparams), jnp.asarray(ids),
                            jnp.arange(len(ids)), jcfg)
    lt, kt, vt = tq.prefill(tparams, torch.from_numpy(ids).long(),
                            torch.arange(len(ids)), tcfg)
    for a, b in ((lt, lj), (kt, kj), (vt, vj)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5, rtol=0)
