"""The port's paged decode attention against the JAX package's.

`areal_tpu_torch.ops.paged_attention.paged_attention_ref` (the plain
PyTorch version the CUDA kernel is held against on the card) must match
`areal_tpu.ops.paged_attention.paged_attention` on the same numpy inputs:
the XLA gather path (op for op the same arithmetic) and the Pallas
split-KV kernel in interpret mode. Cases cover GQA groups 1, 2 and 7
(Qwen2.5's), head dims 16 and 64, pages of 16 and 128 rows, null-block
table tails, a slot whose valid rows end mid-page, and a slot with no
valid row, whose output must be exactly 0.

Int8 pools, `(int8 data, f32 scales)` tuples made with the JAX
`quantize_kv`, go through both packages the same way (the plain version
dequantizes right after its gather, as the XLA path does).

Tolerances: f32 atol 1e-5 (summation order); bf16 atol 2e-2 (both sides
round scores and probabilities to bf16, in different places).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from areal_tpu.ops.kv_quant import quantize_kv as jax_quantize_kv
from areal_tpu.ops.paged_attention import paged_attention as jax_paged_attention
from areal_tpu_torch.ops import paged_attention as pa

CASES = [(1, 16, 16), (2, 64, 16), (7, 16, 128), (7, 64, 128)]  # group, hd, bsz
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(group, hd, bsz, seed=0, R=4, nKV=2, nb=3):
    """Numpy inputs: random pools, a table whose unallocated tail is the
    null block 0, and lengths [-1 (no valid row), mid-page, page end,
    full span]."""
    rng = np.random.default_rng(seed)
    n_blocks = R * nb + 2
    span = nb * bsz
    lengths = np.array([-1, bsz // 2 + 1, 2 * bsz - 1, span - 1])[:R]
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((R, nb), np.int32)
    for r in range(R):
        used = -(-(int(lengths[r]) + 1) // bsz)
        table[r, :used] = perm[r * nb : r * nb + used]
    k = rng.standard_normal((n_blocks, bsz, nKV, hd)).astype(np.float32)
    v = rng.standard_normal((n_blocks, bsz, nKV, hd)).astype(np.float32)
    q = rng.standard_normal((R, group * nKV, hd)).astype(np.float32)
    valid = np.arange(span)[None, :] <= lengths[:, None]
    return q, k, v, table, valid


def _torch_out(q, k, v, table, valid, dtype):
    t = TORCH_DTYPE[dtype]
    out = pa.paged_attention(
        torch.from_numpy(q).to(t), torch.from_numpy(k).to(t),
        torch.from_numpy(v).to(t), torch.from_numpy(table),
        torch.from_numpy(valid),
    )
    assert out.dtype == t
    return out.float().numpy()


def _jax_out(q, k, v, table, valid, dtype, **kw):
    j = jnp.dtype(dtype)
    out = jax_paged_attention(
        jnp.asarray(q, j), jnp.asarray(k, j), jnp.asarray(v, j),
        jnp.asarray(table), jnp.asarray(valid), **kw,
    )
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,hd,bsz", CASES)
def test_ref_matches_jax_xla(group, hd, bsz, dtype):
    q, k, v, table, valid = _inputs(group, hd, bsz)
    ours = _torch_out(q, k, v, table, valid, dtype)
    theirs = _jax_out(q, k, v, table, valid, dtype, impl="xla")
    # slot 0 has no valid row: the XLA path returns mean(V) there, the
    # kernels (and the port's plain version) return exactly 0
    assert (ours[0] == 0).all()
    np.testing.assert_allclose(ours[1:], theirs[1:], atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,hd,bsz", CASES)
def test_ref_matches_jax_pallas_interpret(group, hd, bsz, dtype):
    q, k, v, table, valid = _inputs(group, hd, bsz, seed=1)
    ours = _torch_out(q, k, v, table, valid, dtype)
    theirs = _jax_out(
        q, k, v, table, valid, dtype, impl="pallas", interpret=True
    )
    assert (theirs[0] == 0).all() and (ours[0] == 0).all()
    np.testing.assert_allclose(ours, theirs, atol=TOL[dtype], rtol=0)


def test_ref_explicit_scale_matches_jax():
    q, k, v, table, valid = _inputs(7, 64, 16, seed=2)
    ours = pa.paged_attention(
        *(torch.from_numpy(a) for a in (q, k, v, table, valid)), sm_scale=0.3
    ).numpy()
    theirs = np.asarray(jax_paged_attention(
        *(jnp.asarray(a) for a in (q, k, v, table, valid)),
        impl="xla", sm_scale=0.3,
    ))
    np.testing.assert_allclose(ours[1:], theirs[1:], atol=1e-5, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, table, valid = _inputs(2, 16, 16)
    before = pa.launches
    args = [torch.from_numpy(a) for a in (q, k, v, table, valid)]
    out = pa.paged_attention(*args)
    assert pa.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(out, pa.paged_attention_ref(*args), rtol=0, atol=0)


def test_empty_table_gives_zero():
    q, k, v, table, valid = _inputs(2, 16, 16)
    out = pa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table[:, :0].copy()), torch.from_numpy(valid[:, :0].copy()),
    )
    assert out.shape == q.shape and (out == 0).all()


def test_block_id_outside_the_pool_raises():
    """A table entry past the pool is an error, not a skipped page (the
    kernel faults its launch on the card; the plain version raises)."""
    q, k, v, table, valid = _inputs(2, 16, 16)
    table[3, 0] = k.shape[0]
    with pytest.raises(IndexError):
        pa.paged_attention(*(torch.from_numpy(a) for a in (q, k, v, table, valid)))


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda a: a.update(q=a["q"].double()), TypeError),
        (lambda a: a.update(k_pool=a["k_pool"].to(torch.bfloat16)), TypeError),
        (lambda a: a.update(block_table=a["block_table"].long()), TypeError),
        (lambda a: a.update(valid=a["valid"].to(torch.uint8)), TypeError),
        (lambda a: a.update(q=a["q"].transpose(0, 1).contiguous().transpose(0, 1)), ValueError),
        (lambda a: a.update(valid=a["valid"][:, :-1].contiguous()), ValueError),
        (lambda a: a.update(q=a["q"][..., :8].contiguous()), ValueError),
    ],
)
def test_kernel_argument_checks(mutate, err):
    """The checks the wrapper runs before a launch refuse what the kernel
    does not take (they are device-independent, so they run here)."""
    q, k, v, table, valid = _inputs(2, 16, 16)
    args = dict(
        q=torch.from_numpy(q), k_pool=torch.from_numpy(k),
        v_pool=torch.from_numpy(v), block_table=torch.from_numpy(table),
        valid=torch.from_numpy(valid),
    )
    pa._check(**args)
    mutate(args)
    with pytest.raises(err):
        pa._check(**args)


def test_group_above_kernel_limit_is_refused():
    q, k, v, table, valid = _inputs(1, 16, 16, nKV=1)
    q = np.repeat(q, 17, axis=1)  # 17 query heads over 1 kv head
    with pytest.raises(ValueError, match="group"):
        pa._check(*(torch.from_numpy(a) for a in (q, k, v, table, valid)))


def _int8_pool(pool):
    """An fp pool [n_blocks, bsz, nKV, hd] -> (int8 data, f32 scales
    [n_blocks, nKV, bsz]) numpy arrays, quantized by the JAX package."""
    q, sc = jax_quantize_kv(jnp.asarray(pool))
    return np.array(q), np.array(jnp.swapaxes(sc, -1, -2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("group,hd,bsz", CASES)
def test_int8_pool_matches_jax(group, hd, bsz, impl, dtype):
    q, k, v, table, valid = _inputs(group, hd, bsz, seed=3)
    kq, vq = _int8_pool(k), _int8_pool(v)
    t = TORCH_DTYPE[dtype]
    before = pa.launches_q8
    ours = pa.paged_attention(
        torch.from_numpy(q).to(t), tuple(map(torch.from_numpy, kq)),
        tuple(map(torch.from_numpy, vq)), torch.from_numpy(table),
        torch.from_numpy(valid),
    )
    assert pa.launches_q8 == before and ours.dtype == t
    ours = ours.float().numpy()
    j = jnp.dtype(dtype)
    kw = dict(impl="pallas", interpret=True) if impl == "pallas" else dict(impl="xla")
    theirs = np.asarray(jax_paged_attention(
        jnp.asarray(q, j), tuple(map(jnp.asarray, kq)), tuple(map(jnp.asarray, vq)),
        jnp.asarray(table), jnp.asarray(valid), **kw,
    ).astype(jnp.float32))
    assert (ours[0] == 0).all()  # no valid row (the XLA path: mean of V)
    np.testing.assert_allclose(ours[1:], theirs[1:], atol=TOL[dtype], rtol=0)


def test_int8_pool_equals_dequantized_fp_pool():
    """In f32 the int8 path is the fp path on the dequantized pool, exactly:
    the plain version dequantizes right after its gather."""
    q, k, v, table, valid = _inputs(7, 64, 16, seed=4)
    kq, vq = _int8_pool(k), _int8_pool(v)

    def deq(data, sc):
        return data.astype(np.float32) * np.swapaxes(sc, -1, -2)[..., None]

    args = [torch.from_numpy(a) for a in (table, valid)]
    a = pa.paged_attention(torch.from_numpy(q), tuple(map(torch.from_numpy, kq)),
                           tuple(map(torch.from_numpy, vq)), *args)
    b = pa.paged_attention(torch.from_numpy(q), torch.from_numpy(deq(*kq)),
                           torch.from_numpy(deq(*vq)), *args)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda a: a.update(v_pool=a["v_pool"][0].float()), TypeError),
        (lambda a: a.update(k_pool=(a["k_pool"][0].float(), a["k_pool"][1])), TypeError),
        (lambda a: a.update(k_pool=(a["k_pool"][0], a["k_pool"][1].double())), TypeError),
        (lambda a: a.update(v_pool=(a["v_pool"][0], a["v_pool"][1].transpose(1, 2).contiguous())),
         ValueError),
    ],
)
def test_int8_kernel_argument_checks(mutate, err):
    q, k, v, table, valid = _inputs(2, 16, 16)
    args = dict(
        q=torch.from_numpy(q), k_pool=tuple(map(torch.from_numpy, _int8_pool(k))),
        v_pool=tuple(map(torch.from_numpy, _int8_pool(v))),
        block_table=torch.from_numpy(table), valid=torch.from_numpy(valid),
    )
    pa._check(**args)
    mutate(args)
    with pytest.raises(err):
        pa._check(**args)
