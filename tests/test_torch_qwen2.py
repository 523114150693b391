"""The port's Qwen2 decoder against the JAX package's, on the CPU in f32.

Same weights in both packages (drawn by the JAX `init_params`, moved by
`params_from_numpy`), same numpy inputs: `prefill` logits and KV, and
`decode_step_paged` logits and the rows it writes, at the smoke geometry
and at `__graft_entry__._tiny_config`. Tolerance: atol 1e-5 on f32
values of order 1 (the two packages sum matmuls in different orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _7b_geometry_config, _tiny_config
from areal_tpu.models import qwen2 as jq
from areal_tpu.models.smoke import SMOKE_MODEL_DICT as JAX_SMOKE_MODEL_DICT
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy, to_numpy
from areal_tpu_torch.models.smoke import QWEN25_7B, QWEN25_7B_HF, SMOKE_MODEL_DICT

ATOL = 1e-5


def _configs():
    smoke = dict(SMOKE_MODEL_DICT, dtype="float32", param_dtype="float32")
    tiny = {
        f.name: getattr(_tiny_config(), f.name)
        for f in dataclasses.fields(jq.ModelConfig)
    }
    return {"smoke": smoke, "tiny": tiny}


CONFIGS = _configs()


def _pair(name, **over):
    kw = dict(CONFIGS[name], **over)
    return jq.ModelConfig(**kw), tq.ModelConfig(**kw)


def _shared_params(jcfg, tcfg, seed=0):
    # jit: one compile instead of an eager compile per op
    jparams = jax.jit(jq.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, params_from_numpy(tree, tcfg)


def test_model_config_fields_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jq.ModelConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tq.ModelConfig)]
    assert tf == jf


def test_smoke_dict_matches():
    assert SMOKE_MODEL_DICT == JAX_SMOKE_MODEL_DICT


def test_qwen25_7b_config_matches_jax_parse():
    want = jq.ModelConfig.from_hf_config(
        QWEN25_7B_HF, dtype="bfloat16", param_dtype="bfloat16"
    )
    assert dataclasses.asdict(QWEN25_7B) == dataclasses.asdict(want)
    geo = _7b_geometry_config()
    for f in ("hidden_size", "intermediate_size", "num_attention_heads",
              "num_key_value_heads", "tie_word_embeddings", "qkv_bias"):
        assert getattr(QWEN25_7B, f) == getattr(geo, f)
    assert (QWEN25_7B.vocab_size, QWEN25_7B.num_hidden_layers) == (152064, 28)
    assert QWEN25_7B.head_dim_ == 128 and QWEN25_7B.rope_theta == 1e6


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("name", ["smoke", "tiny", "7b", "tied-no-bias"])
def test_param_shapes_match(name, scan):
    if name == "7b":
        kw = {f.name: getattr(QWEN25_7B, f.name) for f in dataclasses.fields(QWEN25_7B)}
    elif name == "tied-no-bias":  # Qwen2.5-0.5B's tied head, Llama's bias-free qkv
        kw = dict(CONFIGS["smoke"], tie_word_embeddings=True, qkv_bias=False)
    else:
        kw = dict(CONFIGS[name])
    kw["scan_layers"] = scan
    jshapes = jq.param_shapes(jq.ModelConfig(**kw))
    assert _as_tuples(tq.param_shapes(tq.ModelConfig(**kw))) == _as_tuples(jshapes)


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_round_trip(scan, dtype):
    jcfg, tcfg = _pair("smoke", scan_layers=scan, dtype=dtype, param_dtype=dtype)
    jparams, tparams = _shared_params(jcfg, tcfg)
    flat = tq.flatten_names(jax.tree.map(lambda x: np.asarray(x, np.float32), jparams))
    assert set(tparams) == set(flat)
    for name, t in tparams.items():
        assert t.dtype == tq.torch_dtype(dtype)
        np.testing.assert_array_equal(t.float().numpy(), flat[name])
    back = params_from_numpy(to_numpy(tparams), tcfg)
    for name, t in tparams.items():
        assert torch.equal(back[name], t)


def test_params_from_numpy_rejects_wrong_tree():
    jcfg, tcfg = _pair("smoke")
    jparams, _ = _shared_params(jcfg, tcfg)
    tree = jax.tree.map(np.asarray, jparams)
    del tree["final_norm"]
    with pytest.raises(KeyError):
        params_from_numpy(tree, tcfg)


def test_init_params_distribution():
    jcfg, tcfg = _pair("tiny", scan_layers=True)
    p = tq.init_params(tcfg, torch.Generator().manual_seed(0))
    assert set(p) == set(tq.named_shapes(tcfg))
    assert torch.equal(p["final_norm"], torch.ones(32))
    assert torch.equal(p["layers/attn/q_bias"], torch.zeros_like(p["layers/attn/q_bias"]))
    # truncated standard normal on [-2, 2] has std 0.8796; fan-in 32
    w = p["layers/mlp/up_kernel"]
    assert w.abs().max() <= 2.0 / np.sqrt(32) + 1e-6
    assert abs(w.std().item() * np.sqrt(32) - 0.8796) < 0.05
    # down_kernel [L, M, H]: fan-in M = 64
    assert p["layers/mlp/down_kernel"].abs().max() <= 2.0 / 8.0 + 1e-6


@pytest.mark.parametrize("scaling", [None, ("linear", 4.0), ("llama3", 8.0, 1.0, 4.0, 64)])
def test_rope_table_matches(scaling):
    pos = np.arange(0, 300, 7, dtype=np.int32)
    jc, js = jq.rope_table(jnp.asarray(pos), 16, 10000.0, scaling)
    tc, ts = tq.rope_table(torch.from_numpy(pos), 16, 10000.0, scaling)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("name", ["smoke", "tiny"])
def test_prefill_matches_jax(name, scan):
    jcfg, tcfg = _pair(name, scan_layers=scan)
    jparams, tparams = _shared_params(jcfg, tcfg, seed=1)
    rng = np.random.default_rng(0)
    T = 13
    ids = rng.integers(0, jcfg.vocab_size, T).astype(np.int32)
    pos = np.arange(T, dtype=np.int32)
    jl, jk, jv = jax.jit(jq.prefill, static_argnums=3)(
        jparams, jnp.asarray(ids), jnp.asarray(pos), jcfg
    )
    tl, tk, tv = tq.prefill(tparams, torch.from_numpy(ids).long(), torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    none, k2, _ = tq.prefill(tparams, torch.from_numpy(ids).long(), torch.from_numpy(pos), tcfg, with_logits=False)
    assert none is None and torch.equal(k2, tk)


@pytest.mark.parametrize("name", ["smoke", "tiny"])
def test_decode_step_paged_matches_jax(name):
    """One decode step over a random pool: same logits, same written
    rows, and the blocks of the inactive slot untouched."""
    jcfg, tcfg = _pair(name)
    jparams, tparams = _shared_params(jcfg, tcfg, seed=2)
    rng = np.random.default_rng(1)
    L, nKV, hd = jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.head_dim_
    R, bsz, nb = 4, 16, 3
    n_blocks = R * nb + 1
    pool_shape = (L, n_blocks, bsz, nKV, hd)
    k0 = rng.standard_normal(pool_shape).astype(np.float32)
    v0 = rng.standard_normal(pool_shape).astype(np.float32)
    table = (1 + rng.permutation(R * nb)).reshape(R, nb).astype(np.int32)
    table[0, 2] = 0  # null-block tail of a short slot
    positions = np.array([5, 40, 17, 9], np.int32)  # slot 1 crosses into block 2
    active = np.array([True, True, False, True])
    tokens = rng.integers(0, jcfg.vocab_size, R).astype(np.int32)

    step = jax.jit(
        lambda p, t, pos, k, v, bt, act: jq.decode_step_paged(
            p, t, pos, k, v, bt, jcfg, active=act, attn_impl="xla"
        )
    )
    jl, jkp, jvp = step(
        jparams, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(k0),
        jnp.asarray(v0), jnp.asarray(table), jnp.asarray(active),
    )
    kp, vp = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tl = tq.decode_step_paged(
        tparams, torch.from_numpy(tokens).long(), torch.from_numpy(positions),
        kp, vp, torch.from_numpy(table), tcfg, active=torch.from_numpy(active),
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    # the pools agree everywhere except the null block 0, where the
    # inactive slot's write lands (which of the colliding rows wins is
    # unspecified in both packages)
    np.testing.assert_allclose(kp.numpy()[:, 1:], np.asarray(jkp)[:, 1:], atol=ATOL, rtol=0)
    np.testing.assert_allclose(vp.numpy()[:, 1:], np.asarray(jvp)[:, 1:], atol=ATOL, rtol=0)
    # the inactive slot's blocks are untouched
    for b in table[2]:
        assert np.array_equal(kp.numpy()[:, b], k0[:, b])
        assert np.array_equal(vp.numpy()[:, b], v0[:, b])
    # every active slot wrote exactly its row (block, offset)
    for r in np.nonzero(active)[0]:
        b, off = table[r, positions[r] // bsz], positions[r] % bsz
        assert not np.array_equal(kp.numpy()[:, b, off], k0[:, b, off])


def test_unsupported_model_features_raise():
    for kw in (dict(num_experts=4), dict(sliding_window=8), dict(lora_rank=2),
               dict(norm_type="layernorm"), dict(mlp_style="fc"),
               dict(qk_norm=True), dict(attn_out_bias=True),
               dict(norm_zero_centered=True)):
        cfg = tq.ModelConfig(**dict(CONFIGS["smoke"], **kw))
        with pytest.raises(NotImplementedError):
            tq.param_shapes(cfg)
    with pytest.raises(NotImplementedError):
        tq.ModelConfig.from_hf_config(dict(QWEN25_7B_HF, model_type="qwen2_moe"))
