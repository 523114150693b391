"""The port's vision tower and m-rope model paths (`areal_tpu_torch/models/
qwen2_vl.py`, `models/qwen2.py`) against the JAX package's, on the CPU.

Inputs come from a numpy seed. The host helpers (`window_major_order`,
`patch_grid_coords`, `mrope_positions`) must equal JAX's exactly and
`mrope_table` within 1e-6; `forward_vision` for both families (Qwen2-VL:
LayerNorm + quick-gelu MLP; Qwen2.5-VL: RMSNorm + SwiGLU), with padded
rows masked by `valid`, within 1e-5 in f32 and within `BF16_TOL` of the
output's scale in bf16 (the two packages' bf16 matmuls round their sums
in different orders); `splice_image_embeds` exactly. The JAX vision tree
converts to the port's layout leaf for leaf; `load_hf_vision_params` on a
safetensors directory the test writes equals JAX's loader's tree, and
raises JAX's two errors. `prefill` from embeddings with m-rope tables,
and `decode_step_paged` / `verify_step_paged` with a per-slot
`rope_offset`, agree with JAX's within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from areal_tpu.models import hf_io as j_hf
from areal_tpu.models import qwen2 as jq
from areal_tpu.models import qwen2_vl as jv
from areal_tpu_torch.models import hf_io as t_hf
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models import qwen2_vl as tv
from areal_tpu_torch.models.convert import params_from_numpy, vision_params_from_numpy
from areal_tpu_torch.models.smoke import QWEN25_VL_3B_HF

HF_2VL = dict(embed_dim=16, depth=2, num_heads=2, mlp_ratio=2, patch_size=2,
              temporal_patch_size=1, hidden_size=32, in_channels=3)
HF_25VL = dict(hidden_size=16, depth=2, num_heads=2, intermediate_size=32, patch_size=2,
               temporal_patch_size=1, out_hidden_size=32, in_channels=3)
FAMILIES = {"qwen2_vl": HF_2VL, "qwen2_5_vl": HF_25VL}
# bf16 tower outputs: max |port - JAX| over the output's max |value|, two
# bf16 steps (0.0052 and 0.0060 measured for the two families)
BF16_TOL = 1.6e-2


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("d", [HF_2VL, HF_25VL, {}, QWEN25_VL_3B_HF["vision_config"],
                               dict(embed_dim=32, depth=1, num_heads=4, hidden_act="gelu")],
                         ids=["2vl", "25vl", "empty", "3b", "2vl_gelu"])
def test_config_shapes_and_axes_equal_jax(d):
    t, j = tv.VisionConfig.from_hf_dict(d), jv.VisionConfig.from_hf_dict(d)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.head_dim, t.patch_dim, t.merge_dim) == (j.head_dim, j.patch_dim, j.merge_dim)
    assert tv.vision_param_shapes(t) == _flat(jv.vision_param_shapes(j))
    assert tv.vision_param_logical_axes(t) == _flat(jv.vision_param_logical_axes(j))
    params = tv.init_vision_params(t, torch.Generator().manual_seed(0)) if t.depth < 4 else None
    if params is not None:
        assert {k: tuple(v.shape) for k, v in params.items()} == tv.vision_param_shapes(t)


GRIDS = [np.array([[1, 4, 4]]), np.array([[2, 4, 6]]), np.array([[1, 2, 2], [3, 6, 4]]),
         np.array([[1, 22, 34]])]


@pytest.mark.parametrize("grid", GRIDS, ids=["4x4", "t2", "two", "clevr"])
@pytest.mark.parametrize("merge", [1, 2])
def test_patch_orders_equal_jax(grid, merge):
    np.testing.assert_array_equal(tv.window_major_order(grid, merge),
                                  jv.window_major_order(grid, merge))
    np.testing.assert_array_equal(tv.patch_grid_coords(grid, merge),
                                  jv.patch_grid_coords(grid, merge))


@pytest.mark.parametrize("seed", range(4))
def test_mrope_positions_and_table_equal_jax(seed):
    rng = np.random.RandomState(seed)
    img = 63
    grids, ids = [], [int(x) for x in rng.randint(0, 60, size=rng.randint(1, 6))]
    for _ in range(rng.randint(1, 3)):
        t, h, w = int(rng.randint(1, 3)), 2 * int(rng.randint(1, 4)), 2 * int(rng.randint(1, 4))
        grids.append([t, h, w])
        ids += [img] * (t * (h // 2) * (w // 2))
        ids += [int(x) for x in rng.randint(0, 60, size=rng.randint(0, 5))]
    if seed == 3:
        ids = ids[: len(ids) - 3]  # a truncated last span
    thw = np.array(grids)
    tp, td = tv.mrope_positions(np.array(ids), thw, img, 2)
    jp, jd = jv.mrope_positions(np.array(ids), thw, img, 2)
    np.testing.assert_array_equal(tp, jp)
    assert tp.dtype == jp.dtype and td == jd
    for hd, sections in ((16, (4, 2, 2)), (128, (16, 24, 24))):
        tc, ts = tv.mrope_table(tp, hd, 1e6, sections)
        jc, js = jv.mrope_table(jp, hd, 1e6, sections)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)


def _tower_inputs(cfg, grid, n_pad, seed):
    rng = np.random.RandomState(seed)
    n = int(np.prod(grid, axis=1).sum())
    pv = rng.randn(n + n_pad, cfg.patch_dim).astype(np.float32)
    coords = np.concatenate([jv.patch_grid_coords(grid, cfg.spatial_merge_size),
                             np.zeros((n_pad, 2), np.int64)])
    valid = np.arange(n + n_pad) < n
    return pv, coords, valid, n


def _jax_tower(cfg, seed, dtype=np.float32):
    jparams = jv.init_vision_params(cfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, vision_params_from_numpy(tree, cfg)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_vision_equals_jax(family, dtype):
    """Both families with 8 padded rows under `valid`: f32 within 1e-5,
    bf16 within BF16_TOL of the output's scale; the real rows' outputs
    with padding equal the unpadded ones within the same tolerance."""
    cfg = tv.VisionConfig.from_hf_dict(FAMILIES[family])
    jcfg = jv.VisionConfig.from_hf_dict(FAMILIES[family])
    jparams, tparams = _jax_tower(jcfg, 3)
    grid = np.array([[1, 4, 4], [1, 2, 4]])
    pv, coords, valid, n = _tower_inputs(cfg, grid, 8, 5)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = tq.torch_dtype(dtype)
    jout = np.asarray(jv.forward_vision(jparams, jnp.asarray(pv, jdt), jnp.asarray(coords), jcfg,
                                        valid=jnp.asarray(valid)).astype(jnp.float32))
    tout = tv.forward_vision(tparams, torch.from_numpy(pv).to(tdt), torch.from_numpy(coords), cfg,
                             valid=torch.from_numpy(valid)).float().numpy()
    assert tout.shape == jout.shape == ((n + 8) // 4, cfg.hidden_size)
    bare = tv.forward_vision(tparams, torch.from_numpy(pv[:n]).to(tdt),
                             torch.from_numpy(coords[:n]), cfg).float().numpy()
    k = n // 4
    if dtype == "float32":
        np.testing.assert_allclose(tout[:k], jout[:k], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(bare, tout[:k], atol=1e-5, rtol=1e-5)
    else:
        scale = np.abs(jout[:k]).max()
        assert np.abs(tout[:k] - jout[:k]).max() <= BF16_TOL * scale
        assert np.abs(bare - tout[:k]).max() <= BF16_TOL * scale


def test_splice_image_embeds_equals_jax():
    rng = np.random.RandomState(0)
    tok = rng.randn(9, 8).astype(np.float32)
    img = rng.randn(5, 8).astype(np.float32)
    ids = np.array([7, 63, 63, 9, 63, 11, 63, 2, 3])
    want = np.asarray(jv.splice_image_embeds(jnp.asarray(tok), jnp.asarray(ids),
                                             jnp.asarray(img), 63))
    got = tv.splice_image_embeds(torch.from_numpy(tok), torch.from_numpy(ids),
                                 torch.from_numpy(img), 63).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[1] == img[0]).all() and (got[6] == img[3]).all() and (got[0] == tok[0]).all()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_vision_tree_converts_leaf_for_leaf(family):
    jcfg = jv.VisionConfig.from_hf_dict(FAMILIES[family])
    jparams, tparams = _jax_tower(jcfg, 11)
    for name, arr in _flat(jax.tree.map(np.asarray, jparams)).items():
        np.testing.assert_array_equal(tparams[name].numpy(), arr)
    with pytest.raises(KeyError, match="vision parameter names differ"):
        vision_params_from_numpy({"patch_embed": {"kernel": np.zeros((12, 16))}}, jcfg)


def _hf_visual(cfg, rng):
    """HF `visual.*` tensors of a random tower, as a checkpoint stores them."""
    D, M, L = cfg.embed_dim, cfg.mlp_dim, cfg.depth
    r = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    out = {
        "visual.patch_embed.proj.weight": r(D, cfg.in_channels, cfg.temporal_patch_size,
                                            cfg.patch_size, cfg.patch_size),
        "visual.merger.ln_q.weight": r(D),
        "visual.merger.mlp.0.weight": r(cfg.merge_dim, cfg.merge_dim),
        "visual.merger.mlp.0.bias": r(cfg.merge_dim),
        "visual.merger.mlp.2.weight": r(cfg.hidden_size, cfg.merge_dim),
        "visual.merger.mlp.2.bias": r(cfg.hidden_size),
    }
    if cfg.norm_type == "layer":
        out["visual.merger.ln_q.bias"] = r(D)
    for i in range(L):
        b = f"visual.blocks.{i}."
        out[b + "attn.qkv.weight"] = r(3 * D, D)
        out[b + "attn.qkv.bias"] = r(3 * D)
        out[b + "attn.proj.weight"] = r(D, D)
        out[b + "attn.proj.bias"] = r(D)
        for n in ("norm1", "norm2"):
            out[b + f"{n}.weight"] = r(D)
            if cfg.norm_type == "layer":
                out[b + f"{n}.bias"] = r(D)
        mlp = (("fc1", M, D), ("fc2", D, M)) if cfg.mlp_type == "gelu" else (
            ("gate_proj", M, D), ("up_proj", M, D), ("down_proj", D, M))
        for name, o, i_ in mlp:
            out[b + f"mlp.{name}.weight"] = r(o, i_)
            out[b + f"mlp.{name}.bias"] = r(o)
    # a language-model tensor the vision loader skips
    out["model.embed_tokens.weight"] = r(8, cfg.hidden_size)
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_load_hf_vision_params_equals_jax(family, tmp_path):
    cfg = tv.VisionConfig.from_hf_dict(FAMILIES[family])
    jcfg = jv.VisionConfig.from_hf_dict(FAMILIES[family])
    tensors = _hf_visual(cfg, np.random.RandomState(2))
    t_hf.write_safetensors(tensors, str(tmp_path / "model.safetensors"))
    got = t_hf.load_hf_vision_params(str(tmp_path), cfg)
    want = _flat(j_hf.load_hf_vision_params(str(tmp_path), jcfg))
    assert set(got) == set(want) == set(tv.vision_param_shapes(cfg))
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(arr))
    # the loaded tower runs, and JAX's on the same weights agrees
    pv, coords, _, _ = _tower_inputs(cfg, np.array([[1, 2, 2]]), 0, 1)
    tout = tv.forward_vision(got, torch.from_numpy(pv), torch.from_numpy(coords), cfg).numpy()
    jtree = jax.tree.map(jnp.asarray, j_hf.load_hf_vision_params(str(tmp_path), jcfg))
    jout = np.asarray(jv.forward_vision(jtree, jnp.asarray(pv), jnp.asarray(coords), jcfg))
    np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fault", ["unknown", "missing"])
def test_load_hf_vision_params_raises_as_jax(fault, tmp_path):
    cfg = tv.VisionConfig.from_hf_dict(HF_25VL)
    jcfg = jv.VisionConfig.from_hf_dict(HF_25VL)
    tensors = _hf_visual(cfg, np.random.RandomState(3))
    if fault == "unknown":
        tensors["visual.blocks.0.attn.rope.weight"] = torch.zeros(4)
        match = "unrecognized visual"
    else:
        for k in [k for k in tensors if k.startswith("visual.blocks.1.mlp.up_proj")]:
            del tensors[k]
        match = r"vision blocks missing layer\(s\) \[1\]"
    t_hf.write_safetensors(tensors, str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match=match) as t_err:
        t_hf.load_hf_vision_params(str(tmp_path), cfg)
    with pytest.raises(ValueError, match=match) as j_err:
        j_hf.load_hf_vision_params(str(tmp_path), jcfg)
    assert str(t_err.value) == str(j_err.value)


# ---------------------------------------------------------------------------
# the language model's m-rope paths
# ---------------------------------------------------------------------------

TEXT = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, dtype="float32",
            param_dtype="float32")
JT, TT = jq.ModelConfig(**TEXT), tq.ModelConfig(**TEXT)
SECTIONS = (JT.head_dim_ // 4, JT.head_dim_ // 8, JT.head_dim_ // 8)


@pytest.fixture(scope="module")
def text_weights():
    jparams = jq.init_params(JT, jax.random.PRNGKey(4))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), TT)


def test_prefill_from_embeddings_with_mrope_equals_jax(text_weights):
    jparams, tparams = text_weights
    rng = np.random.RandomState(6)
    ids = np.array([5, 63, 63, 63, 63, 9, 2, 7, 11], dtype=np.int32)
    embeds = rng.randn(len(ids), TEXT["hidden_size"]).astype(np.float32)
    pos3, delta = jv.mrope_positions(ids, np.array([[1, 4, 4]]), 63, 2)
    assert delta == -2
    jc, js = jv.mrope_table(pos3, JT.head_dim_, JT.rope_theta, SECTIONS)
    tc, ts = tv.mrope_table(pos3, TT.head_dim_, TT.rope_theta, SECTIONS)
    jl, jk, jvv = jq.prefill(jparams, jnp.asarray(ids), jnp.arange(len(ids)), JT,
                             input_embeds=jnp.asarray(embeds), rope_cos=jc, rope_sin=js)
    tl, tk, tvv = tq.prefill(tparams, torch.from_numpy(ids).long(), torch.arange(len(ids)), TT,
                             input_embeds=torch.from_numpy(embeds), rope_cos=tc, rope_sin=ts)
    for t, j in ((tl, jl), (tk, jk), (tvv, jvv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)
    # the tables matter: the 1-D rope gives other keys
    _, tk1, _ = tq.prefill(tparams, torch.from_numpy(ids).long(), torch.arange(len(ids)), TT,
                           input_embeds=torch.from_numpy(embeds))
    assert np.abs(tk1.numpy() - tk.numpy()).max() > 1e-3


def _paged_case(seed, R=3, bsz=4, nb=4, n_blocks=16):
    rng = np.random.RandomState(seed)
    L, nKV, hd = TEXT["num_hidden_layers"], TEXT["num_key_value_heads"], JT.head_dim_
    k = rng.randn(L, n_blocks, bsz, nKV, hd).astype(np.float32)
    v = rng.randn(L, n_blocks, bsz, nKV, hd).astype(np.float32)
    table = (1 + rng.permutation(n_blocks - 1)[: R * nb]).reshape(R, nb).astype(np.int32)
    tokens = rng.randint(0, 64, size=R).astype(np.int32)
    positions = np.array([5, 9, 12][:R], dtype=np.int32)
    offset = np.array([-2, 0, -170][:R], dtype=np.int32)
    return k, v, table, tokens, positions, offset


def test_decode_step_paged_with_rope_offset_equals_jax(text_weights):
    jparams, tparams = text_weights
    k, v, table, tokens, positions, offset = _paged_case(8)
    jl, jk, jvp = jq.decode_step_paged(jparams, jnp.asarray(tokens), jnp.asarray(positions),
                                       jnp.asarray(k), jnp.asarray(v), jnp.asarray(table), JT,
                                       rope_offset=jnp.asarray(offset), attn_impl="xla")
    tk, tvp = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tl = tq.decode_step_paged(tparams, torch.from_numpy(tokens).long(),
                              torch.from_numpy(positions).long(), tk, tvp,
                              torch.from_numpy(table), TT,
                              rope_offset=torch.from_numpy(offset))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tvp.numpy(), np.asarray(jvp), atol=1e-5, rtol=1e-5)
    # the offset moves the rotary position only: the rows land where they
    # land without it, and the logits move
    tk0, tv0 = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tl0 = tq.decode_step_paged(tparams, torch.from_numpy(tokens).long(),
                               torch.from_numpy(positions).long(), tk0, tv0,
                               torch.from_numpy(table), TT)
    base = torch.from_numpy(k)
    assert torch.equal(tk0 != base, tk != base)  # the same rows written
    assert torch.equal(tv0[0], tvp[0])  # layer 0's V takes no rotary
    np.testing.assert_allclose(tl0[1].numpy(), tl[1].numpy(), atol=1e-6)  # offset 0
    assert np.abs(tl0[0].numpy() - tl[0].numpy()).max() > 1e-4


def test_verify_step_paged_with_rope_offset_equals_jax(text_weights):
    jparams, tparams = text_weights
    k, v, table, tokens, positions, offset = _paged_case(9)
    W = 3
    drafts = np.random.RandomState(1).randint(0, 64, size=(len(tokens), W)).astype(np.int32)
    drafts[:, 0] = tokens
    jl, jk, _ = jq.verify_step_paged(jparams, jnp.asarray(drafts), jnp.asarray(positions),
                                     jnp.asarray(k), jnp.asarray(v), jnp.asarray(table), JT,
                                     rope_offset=jnp.asarray(offset), attn_impl="xla")
    tk, tvp = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tl = tq.verify_step_paged(tparams, torch.from_numpy(drafts).long(),
                              torch.from_numpy(positions).long(), tk, tvp,
                              torch.from_numpy(table), TT,
                              rope_offset=torch.from_numpy(offset))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("model_type", ["qwen2_vl", "qwen2_5_vl"])
def test_hf_config_mrope_accepted_and_vl_types_refused(model_type):
    hf = {k: v for k, v in QWEN25_VL_3B_HF.items() if k != "vision_config"}
    cfg = tq.ModelConfig.from_hf_config(hf)
    jcfg = jq.ModelConfig.from_hf_config(hf)
    assert (cfg.rope_scaling_, cfg.qkv_bias, cfg.head_dim_) == (None, True, 128)
    assert (jcfg.rope_scaling_, jcfg.qkv_bias) == (None, True)
    # JAX reads the VL types without q/k/v biases; the port refuses them
    assert jq.ModelConfig.from_hf_config(dict(hf, model_type=model_type)).qkv_bias is False
    with pytest.raises(NotImplementedError, match="q/k/v biases"):
        tq.ModelConfig.from_hf_config(dict(hf, model_type=model_type))
    with pytest.raises(NotImplementedError, match="yarn"):
        tq.ModelConfig.from_hf_config(dict(hf, rope_scaling={"type": "yarn"}))
