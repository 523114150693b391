"""The port's training path against the JAX package's, on the CPU in f32.

Same weights in both packages (the JAX `init_params`, moved by
`params_from_numpy`) and the same seeded numpy inputs:

- the packed `forward` (hidden states, logits and every parameter's
  gradient) against JAX `forward` with `attn_impl="flash"` (the Pallas
  kernels in interpret mode) and `"dense"`: atol 1e-5 on values; on
  gradients rtol 1e-4 and atol 1e-4 or 1e-5 of the tensor's largest
  element (f32 sums of thousands of terms taken in another order, and the
  flash path's blockwise softmax against one dense softmax);
- `chunked_label_logprobs` (tied and untied heads, entropy, gradients):
  atol 1e-5 / 1e-4; in bf16, f32 logits as JAX's (logp within 2e-5,
  which bf16-rounded logits miss);
- `gae_padded`, `ppo_actor_loss_fn`, `masked_normalization`,
  `Normalization`, `KLEstimator`: atol 1e-5 (f32 arithmetic, one op order);
- the micro-batch split and packing, `ffd_allocate`: exact;
- `make_lr_schedule` against optax: rtol 1e-6 (float64 here, f32 there);
- one AdamW run against optax `adamw` with bf16 parameters, the decay mask
  and an f32 first moment: parameters and second moment within one bf16
  rounding (2^-8 relative), the first moment to f32 roundoff;
- the Qwen2.5-1.5B config parse and the field names and defaults of the
  training configs.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from areal_tpu.api import cli_args as jargs
from areal_tpu.engine import jax_engine
from areal_tpu.models import qwen2 as jq
from areal_tpu.ops import fused_xent as jfx
from areal_tpu.ops import gae as jgae
from areal_tpu.utils import data as jdata
from areal_tpu.utils import datapack as jpack
from areal_tpu.utils import flops as jflops
from areal_tpu.utils import functional as jfn
from areal_tpu_torch.api import cli_args as targs
from areal_tpu_torch.api.alloc_mode import ParallelStrategy
from areal_tpu_torch.api.io_struct import FinetuneSpec, WeightUpdateMeta
from areal_tpu_torch.engine import torch_engine
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy, unstack_layers
from areal_tpu_torch.models.smoke import QWEN25_1_5B, QWEN25_1_5B_HF
from areal_tpu_torch.ops import fused_xent as tfx
from areal_tpu_torch.ops import gae as tgae
from areal_tpu_torch.utils import data as tdata
from areal_tpu_torch.utils import datapack as tpack
from areal_tpu_torch.utils import flops as tflops
from areal_tpu_torch.utils import functional as tfn

ATOL = 1e-5
GRAD_ATOL = 1e-4
GRAD_SCALE_TOL = 1e-5  # of the gradient's largest element, for large sums

MODEL = dict(
    vocab_size=96, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0,
    dtype="float32", param_dtype="float32",
)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            v = f.default_factory()
            out[f.name] = dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
        else:
            out[f.name] = dataclasses.MISSING
    return out


@pytest.mark.parametrize("name", ["NormConfig", "MicroBatchSpec", "OptimizerConfig",
                                  "TrainEngineConfig", "PPOActorConfig"])
def test_train_config_fields_match(name):
    want = _fields(getattr(jargs, name))
    got = _fields(getattr(targs, name))
    # the JAX sub-config at the same key path (`actor.jax.*`) is carried
    # whole, every knob with its default
    assert list(got) == list(want)
    assert got == want


@pytest.mark.parametrize("on", [True, False])
def test_fused_lm_loss_probe_reads_the_jax_key_path(on):
    """Both engines' probe reads `config.jax.fused_lm_loss`, so a config
    that turns the fused head off at `actor.jax.fused_lm_loss` turns it off
    in both."""
    from types import SimpleNamespace

    tcfg = targs.PPOActorConfig(jax=targs.JaxEngineConfig(fused_lm_loss=on))
    jcfg = jargs.PPOActorConfig(jax=jargs.JaxEngineConfig(fused_lm_loss=on))
    assert torch_engine.fused_lm_loss_enabled(SimpleNamespace(config=tcfg)) == on
    assert jax_engine.fused_lm_loss_enabled(SimpleNamespace(config=jcfg)) == on


def test_qwen25_1_5b_config_matches_jax_parse():
    want = jq.ModelConfig.from_hf_config(QWEN25_1_5B_HF, dtype="bfloat16", param_dtype="bfloat16")
    assert dataclasses.asdict(QWEN25_1_5B) == dataclasses.asdict(want)
    assert (QWEN25_1_5B.vocab_size, QWEN25_1_5B.hidden_size, QWEN25_1_5B.num_hidden_layers) == (
        151936, 1536, 28)
    assert (QWEN25_1_5B.num_attention_heads, QWEN25_1_5B.num_key_value_heads,
            QWEN25_1_5B.head_dim_) == (12, 2, 128)
    assert QWEN25_1_5B.tie_word_embeddings and QWEN25_1_5B.intermediate_size == 8960
    assert QWEN25_1_5B.rope_theta == 1e6 and QWEN25_1_5B.sliding_window is None


def test_flops_copy_matches_jax_and_knows_the_h100():
    for ctx in (1.0, 272.5, 4096.0):
        assert tflops.train_flops_per_token(QWEN25_1_5B, ctx) == jflops.train_flops_per_token(
            QWEN25_1_5B, ctx)
    for kind in ("TPU v5 lite", "TPU v4", "cpu"):
        assert tflops.peak_flops(kind) == jflops.peak_flops(kind)
    # torch.cuda.get_device_name spelling; NVIDIA's bf16 dense figure
    assert tflops.peak_flops("NVIDIA H100 80GB HBM3") == 989e12


# ---------------------------------------------------------------------------
# the packed model forward and backward
# ---------------------------------------------------------------------------


def _packed_batch(seed=0, lens=(37, 50, 21), vocab=96):
    """Three sequences padded (by `pad_packed_tensor_dict`) to 128 tokens:
    the pad tail is a fourth segment."""
    rng = np.random.default_rng(seed)
    B, T = len(lens), max(lens)
    ids = rng.integers(0, vocab, (B, T))
    mask = (np.arange(T)[None] < np.asarray(lens)[:, None]).astype(np.int64)
    packed, _ = tdata.pad_packed_tensor_dict(
        tdata.pack_tensor_dict(dict(input_ids=ids * mask, attention_mask=mask)))
    cu = packed["cu_seqlens"]
    total = int(cu[-1])
    seg = tq.segment_ids_from_cu_seqlens(cu, total)
    pos = np.arange(total) - np.repeat(cu[:-1], np.diff(cu))
    return packed["input_ids"].astype(np.int32), pos.astype(np.int32), seg


def _weights(tie: bool):
    kw = dict(MODEL, tie_word_embeddings=tie)
    jcfg = jq.ModelConfig(**kw)
    jparams = jax.jit(jq.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(3))
    return kw, jparams, jax.tree.map(np.asarray, jparams)


@pytest.mark.parametrize("attn,tie", [("flash", True), ("dense", False)],
                         ids=["flash-tied", "dense-untied"])
def test_forward_and_param_grads_match_jax(attn, tie):
    kw, jparams, tree = _weights(tie)
    ids, pos, seg = _packed_batch()
    T, V, H = len(ids), kw["vocab_size"], kw["hidden_size"]
    rng = np.random.default_rng(1)
    w_logits = rng.standard_normal((T, V)).astype(np.float32)
    w_hidden = rng.standard_normal((T, H)).astype(np.float32)
    jcfg = jq.ModelConfig(**kw, attn_impl=attn)

    def jloss(p):
        logits = jq.forward(p, ids, pos, seg, jcfg)
        hidden = jq.forward(p, ids, pos, seg, jcfg, return_hidden=True)
        return jnp.sum(logits * w_logits) + jnp.sum(hidden * w_hidden), (logits, hidden)

    (_, (jlogits, jhidden)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)

    # the trainer's layout: one tensor per layer leaf, remat on
    tcfg = tq.ModelConfig(**kw, attn_impl=attn, scan_layers=False, remat=True)
    params = {k: v.requires_grad_() for k, v in params_from_numpy(tree, tcfg).items()}
    args = (params, torch.from_numpy(ids).long(), torch.from_numpy(pos).long(),
            torch.from_numpy(seg), tcfg)
    logits = tq.forward(*args)
    hidden = tq.forward(*args, return_hidden=True)
    ((logits * torch.from_numpy(w_logits)).sum()
     + (hidden * torch.from_numpy(w_hidden)).sum()).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(hidden.detach().numpy(), np.asarray(jhidden), atol=ATOL, rtol=ATOL)
    want = tq.flatten_names(unstack_layers(jax.tree.map(np.asarray, jgrads)))
    assert set(want) == set(params)
    for name, p in params.items():
        atol = max(GRAD_ATOL, GRAD_SCALE_TOL * np.abs(want[name]).max())
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=atol, rtol=GRAD_ATOL,
                                   err_msg=name)


def test_remat_and_scanned_layout_do_not_change_grads():
    kw, _, tree = _weights(True)
    ids, pos, seg = _packed_batch(seed=2)
    grads = {}
    for remat, scan in ((False, False), (True, False), (False, True)):
        cfg = tq.ModelConfig(**kw, remat=remat, scan_layers=scan)
        params = {k: v.requires_grad_() for k, v in params_from_numpy(tree, cfg).items()}
        out = tq.forward(params, torch.from_numpy(ids).long(), torch.from_numpy(pos).long(),
                         torch.from_numpy(seg), cfg)
        out.square().mean().backward()
        g = {k: v.grad for k, v in params.items()}
        if scan:  # per-layer names, as the unscanned layout has them
            g = tq.flatten_names(unstack_layers(_nest(g)))
        grads[(remat, scan)] = g
    base = grads[(False, False)]
    for key, g in grads.items():
        for name, t in base.items():
            np.testing.assert_allclose(g[name].numpy(), t.numpy(), atol=1e-6, rtol=1e-6,
                                       err_msg=f"{key} {name}")


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, t in flat.items():
        node = out
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def test_attn_impl_and_remat_policy_refusals():
    assert tq.resolve_attn_impl(tq.ModelConfig(**MODEL)) == "flash"
    assert tq.resolve_attn_impl(tq.ModelConfig(**MODEL, attn_impl="dense")) == "dense"
    for impl in ("ring", "chunked"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tq.resolve_attn_impl(tq.ModelConfig(**MODEL, attn_impl=impl))
    cfg = tq.ModelConfig(**MODEL, remat=True, remat_policy="dots_saveable", scan_layers=False)
    params = tq.init_params(cfg, torch.Generator().manual_seed(0))
    ids = torch.zeros(8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tq.forward(params, ids, ids, ids.int(), cfg)


def test_segment_helpers_match_jax():
    cu = np.array([0, 5, 9, 9, 16], np.int32)
    np.testing.assert_array_equal(tq.segment_ids_from_cu_seqlens(cu, 16),
                                  jq.segment_ids_from_cu_seqlens(cu, 16))
    seg = np.array([0, 0, 1, 1, 1, -1, -1], np.int32)
    np.testing.assert_array_equal(tq.segment_causal_mask(torch.from_numpy(seg)).numpy(),
                                  np.asarray(jq.segment_causal_mask(jnp.asarray(seg))))


# ---------------------------------------------------------------------------
# the vocab-chunked LM-head loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_is_vh,temperature", [(True, 1.0), (False, 0.7)],
                         ids=["tied", "untied-t0.7"])
def test_chunked_label_logprobs_matches_jax(head_is_vh, temperature):
    rng = np.random.default_rng(4)
    T, H, V, chunk = 40, 24, 100, 32  # 4 chunks, the last one partial
    hidden = rng.standard_normal((T, H)).astype(np.float32)
    w = (rng.standard_normal((V, H) if head_is_vh else (H, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, T).astype(np.int32)
    c_lp, c_ent = rng.standard_normal(T).astype(np.float32), rng.standard_normal(T).astype(np.float32)

    def jloss(h, w):
        lp, ent = jfx.chunked_label_logprobs(h, w, labels, head_is_vh=head_is_vh,
                                             temperature=temperature, with_entropy=True,
                                             vocab_chunk=chunk)
        return jnp.sum(lp * c_lp) + jnp.sum(ent * c_ent), (lp, ent)

    (_, (jlp, jent)), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(hidden, w)
    th, tw = torch.from_numpy(hidden).requires_grad_(), torch.from_numpy(w).requires_grad_()
    lp, ent = tfx.chunked_label_logprobs(th, tw, torch.from_numpy(labels), head_is_vh=head_is_vh,
                                         temperature=temperature, with_entropy=True,
                                         vocab_chunk=chunk)
    ((lp * torch.from_numpy(c_lp)).sum() + (ent * torch.from_numpy(c_ent)).sum()).backward()
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(ent.detach().numpy(), np.asarray(jent), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg[0]), atol=GRAD_ATOL, rtol=GRAD_ATOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg[1]), atol=GRAD_ATOL, rtol=GRAD_ATOL)
    # the label-only entry agrees with the entropy one, and with dense logits
    only = tfx.chunked_label_logprobs(th, tw, torch.from_numpy(labels), head_is_vh=head_is_vh,
                                      temperature=temperature, vocab_chunk=chunk)
    np.testing.assert_allclose(only.detach().numpy(), lp.detach().numpy(), atol=1e-6)
    logits = th @ (tw.t() if head_is_vh else tw)
    dense = tfn.gather_logprobs(logits, torch.from_numpy(labels), temperature)
    np.testing.assert_allclose(dense.detach().numpy(), lp.detach().numpy(), atol=ATOL)


@pytest.mark.parametrize("head_is_vh", [True, False], ids=["tied", "untied"])
def test_chunked_label_logprobs_bf16_keeps_f32_logits(head_is_vh):
    """bf16 hidden states and head against JAX, whose chunk matmuls give f32
    logits (`preferred_element_type`). logp and entropy within 2e-5 (f32
    sums in another order): logits rounded to bf16 first miss by ~1e-2,
    which the test also shows. Gradients come back in bf16 on both sides,
    each summing the chunks' bf16 gradients in bf16 in its own order:
    within 2^-7 relative plus 2^-7 of the largest element."""
    rng = np.random.default_rng(9)
    T, H, V, chunk = 40, 64, 100, 32
    hidden = rng.standard_normal((T, H)).astype(jnp.bfloat16)
    w = (rng.standard_normal((V, H) if head_is_vh else (H, V)) * 0.5).astype(jnp.bfloat16)
    labels = rng.integers(0, V, T).astype(np.int32)
    c_lp = rng.standard_normal(T).astype(np.float32)

    def jloss(h, w):
        lp, ent = jfx.chunked_label_logprobs(h, w, labels, head_is_vh=head_is_vh,
                                             with_entropy=True, vocab_chunk=chunk)
        return jnp.sum(lp * c_lp) + jnp.sum(ent), (lp, ent)

    (_, (jlp, jent)), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(w))
    th = torch.from_numpy(hidden.astype(np.float32)).bfloat16().requires_grad_()
    tw = torch.from_numpy(w.astype(np.float32)).bfloat16().requires_grad_()
    tl = torch.from_numpy(labels)
    lp, ent = tfx.chunked_label_logprobs(th, tw, tl, head_is_vh=head_is_vh, with_entropy=True,
                                         vocab_chunk=chunk)
    ((lp * torch.from_numpy(c_lp)).sum() + ent.sum()).backward()
    assert lp.dtype == ent.dtype == torch.float32
    tol = 2e-5
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), atol=tol, rtol=0)
    np.testing.assert_allclose(ent.detach().numpy(), np.asarray(jent), atol=tol, rtol=0)
    rounded = (th @ (tw.t() if head_is_vh else tw)).float()  # a bf16 matmul's logits
    miss = tfn.gather_logprobs(rounded, tl, 1.0).detach().numpy() - np.asarray(jlp)
    assert np.abs(miss).max() > 100 * tol
    for got, want in ((th.grad, jg[0]), (tw.grad, jg[1])):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        want = np.asarray(want).astype(np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                                   atol=2.0 ** -7 * np.abs(want).max())


# ---------------------------------------------------------------------------
# GRPO arithmetic
# ---------------------------------------------------------------------------


def _gae_inputs(seed=5, B=4, T=23):
    rng = np.random.default_rng(seed)
    rewards = rng.standard_normal((B, T)).astype(np.float32)
    values = rng.standard_normal((B, T)).astype(np.float32)
    mask = (rng.random((B, T)) > 0.3).astype(np.float32)
    no_eos = np.array([1, 0, 1, 0], np.float32)[:B]
    return rewards, values, mask, no_eos


@pytest.mark.parametrize("gamma,lam", [(1.0, 1.0), (0.99, 0.95)])
def test_gae_matches_jax_and_reference(gamma, lam):
    args = _gae_inputs()
    adv, ret = tgae.gae_padded(*(torch.from_numpy(a) for a in args), gamma, lam)
    jadv, jret = jgae.gae_padded(*(jnp.asarray(a) for a in args), gamma, lam)
    radv, rret = jgae.gae_padded_reference(*args, gamma, lam)
    for got, want in ((adv, jadv), (ret, jret), (adv, radv), (ret, rret)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)
    assert (adv[:, -1] == 0).all()


@pytest.mark.parametrize("c_clip,cap,higher", [(None, None, None), (3.0, 2.0, 0.28)])
def test_ppo_actor_loss_matches_jax(c_clip, cap, higher):
    rng = np.random.default_rng(6)
    T = 64
    lp = (rng.standard_normal(T) * 0.3 - 1).astype(np.float32)
    prox = (lp + rng.standard_normal(T) * 0.8).astype(np.float32)
    old = (prox + rng.standard_normal(T) * 0.5).astype(np.float32)
    adv = rng.standard_normal(T).astype(np.float32)
    mask = rng.random(T) > 0.2
    kw = dict(eps_clip=0.2, eps_clip_higher=higher, c_clip=c_clip, behav_imp_weight_cap=cap)

    jloss, jstat = jfn.ppo_actor_loss_fn(jnp.asarray(lp), prox, old, adv, loss_mask=mask, **kw)
    jgrad = jax.grad(lambda x: jfn.ppo_actor_loss_fn(x, prox, old, adv, loss_mask=mask, **kw)[0])(
        jnp.asarray(lp))
    t = torch.from_numpy(lp).requires_grad_()
    loss, stat = tfn.ppo_actor_loss_fn(t, *(torch.from_numpy(a) for a in (prox, old, adv)),
                                       loss_mask=torch.from_numpy(mask), **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), atol=ATOL, rtol=ATOL)
    for k, v in jstat.items():
        np.testing.assert_allclose(stat[k].detach().numpy().astype(np.float32),
                                   np.asarray(v).astype(np.float32), atol=ATOL, err_msg=k)
    if c_clip is not None:
        assert stat["dual_clip_mask"].any() and stat["clip_mask"].any()


def test_masked_normalization_normalization_and_kl_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 9)).astype(np.float32)
    mask = (rng.random((6, 9)) > 0.3).astype(np.float32)
    for m in (None, mask):
        for unbiased in (False, True):
            got = tfn.masked_normalization(torch.from_numpy(x),
                                           None if m is None else torch.from_numpy(m),
                                           unbiased=unbiased)
            want = jfn.masked_normalization(jnp.asarray(x), None if m is None else jnp.asarray(m),
                                            unbiased=unbiased)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)
    for level in ("batch", "group"):
        for loo in (False, True):
            cfg = dict(mean_level=level, std_level=level, mean_leave1out=loo, group_size=3)
            got = tdata.Normalization(targs.NormConfig(**cfg))(x, mask)
            want = jdata.Normalization(jargs.NormConfig(**cfg))(x, mask)
            np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=ATOL)
    y = (x + rng.standard_normal(x.shape) * 0.1).astype(np.float32)
    for est in ("k1", "k2", "k3"):
        np.testing.assert_allclose(
            np.asarray(tdata.KLEstimator(est)(x, y)),
            np.asarray(jdata.KLEstimator(est)(jnp.asarray(x), jnp.asarray(y))), atol=ATOL)
        np.testing.assert_allclose(
            tdata.KLEstimator(est)(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
            np.asarray(jdata.KLEstimator(est)(jnp.asarray(x), jnp.asarray(y))), atol=ATOL)


def test_dynamic_sampling_and_overlong_penalty_match_jax():
    rng = np.random.default_rng(8)
    data = dict(rewards=np.array([1, 1, 0, 1, 0, 0, 1, 1], np.float32),
                input_ids=rng.integers(0, 9, (8, 5)),
                loss_mask=(rng.random((8, 5)) > 0.4).astype(np.int32))
    got, gstat = tfn.dynamic_sampling(dict(data), 2)
    want, wstat = jfn.dynamic_sampling(dict(data), 2)
    assert gstat == wstat
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    kw = dict(overlong_tokens=2, overlong_penalty_factor=0.5, max_response_length=4)
    np.testing.assert_allclose(tfn.reward_overlong_penalty(data, **kw)["rewards"],
                               np.asarray(jfn.reward_overlong_penalty(data, **kw)["rewards"]))


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def test_ffd_allocate_matches_jax():
    rng = np.random.default_rng(9)
    for _ in range(20):
        vals = rng.integers(1, 300, int(rng.integers(1, 30))).tolist()
        cap = int(rng.integers(300, 1200))
        groups = int(rng.integers(1, 6))
        assert tpack.ffd_allocate(vals, cap, groups) == jpack.ffd_allocate(vals, cap, groups)
    assert tpack.flat2d([[1], [2, 3]]) == jpack.flat2d([[1], [2, 3]])


@pytest.mark.parametrize("spec", [dict(max_tokens_per_mb=60), dict(n_mbs=3), dict(granularity=2)])
def test_micro_batch_split_and_packing_match_jax(spec):
    rng = np.random.default_rng(10)
    B, T = 8, 31
    lens = rng.integers(3, T + 1, B)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
    data = dict(input_ids=rng.integers(0, 50, (B, T)) * mask, attention_mask=mask,
                loss_mask=mask.astype(np.int32), rewards=rng.standard_normal(B).astype(np.float32),
                logprobs=rng.standard_normal((B, T)).astype(np.float32))
    got = tdata.split_padded_tensor_dict_into_mb_list(data, targs.MicroBatchSpec(**spec))
    want = jdata.split_padded_tensor_dict_into_mb_list(data, jargs.MicroBatchSpec(**spec))
    assert got.forward_indices == want.forward_indices
    assert got.group_lens == want.group_lens and got.padded_to == want.padded_to
    assert len(got.mbs) == len(want.mbs)
    for g, w in zip(got.mbs, want.mbs):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
    packed = tdata.pack_tensor_dict(data)
    jpacked = jdata.pack_tensor_dict(data)
    for k in jpacked:
        np.testing.assert_array_equal(np.asarray(packed[k]), np.asarray(jpacked[k]), err_msg=k)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("warmup", [0.0, 0.2])
def test_lr_schedule_matches_optax(kind, warmup):
    cfg = dict(lr=3e-4, lr_scheduler_type=kind, warmup_steps_proportion=warmup, min_lr_ratio=0.1)
    total = 20
    got = torch_engine.make_lr_schedule(targs.OptimizerConfig(**cfg), total)
    want = jax_engine.make_lr_schedule(jargs.OptimizerConfig(**cfg), total)
    for count in range(total + 3):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)
    assert got(0) == 0.0  # the reference's first update has learning rate 0


def test_adamw_matches_optax_bf16():
    rng = np.random.default_rng(11)
    shapes = {"w": (8, 16), "b": (16,), "k3": (4, 2, 8)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    cfg = dict(lr=1e-2, weight_decay=0.1, beta1=0.9, beta2=0.95, eps=1e-5,
               warmup_steps_proportion=0.0, lr_scheduler_type="constant")
    opt, _ = jax_engine.make_optimizer(jargs.OptimizerConfig(**cfg), 10)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p0.items()}
    mask = torch_engine.decay_mask(tp)
    assert mask == [True, False, True]
    topt = torch_engine.Optimizer(targs.OptimizerConfig(**cfg), 10, list(tp.values()), mask)
    for step in range(4):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jg = {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}
        updates, state = opt.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        before = {k: v.clone() for k, v in tp.items()}
        topt.step(list(tp.values()), [torch.from_numpy(g[k]).to(torch.bfloat16) for k in tp])
        adam = state[0]
        for i, k in enumerate(tp):
            want = np.asarray(jp[k].astype(jnp.float32))
            np.testing.assert_allclose(tp[k].float().numpy(), want, rtol=2.0 ** -8, atol=0,
                                       err_msg=f"step {step} {k}")
            np.testing.assert_allclose(topt.mu[i].numpy(), np.asarray(adam.mu[k]), rtol=1e-6,
                                       atol=1e-9)
            np.testing.assert_allclose(topt.nu[i].float().numpy(),
                                       np.asarray(adam.nu[k].astype(jnp.float32)),
                                       rtol=2.0 ** -8, atol=0)
            assert topt.mu[i].dtype == torch.float32 and topt.nu[i].dtype == torch.bfloat16
            if step == 0:  # learning rate 0: bit for bit unchanged
                assert torch.equal(tp[k].view(torch.int16), before[k].view(torch.int16))


def test_sgd_matches_optax_bf16():
    rng = np.random.default_rng(12)
    p0 = rng.standard_normal((8, 16)).astype(np.float32)
    cfg = dict(type="sgd", lr=0.1, warmup_steps_proportion=0.0, lr_scheduler_type="linear")
    opt, _ = jax_engine.make_optimizer(jargs.OptimizerConfig(**cfg), 10)
    jp = jnp.asarray(p0, jnp.bfloat16)
    state = opt.init(jp)
    tp = torch.from_numpy(p0).to(torch.bfloat16)
    topt = torch_engine.Optimizer(targs.OptimizerConfig(**cfg), 10, [tp], [True])
    for _ in range(3):
        g = rng.standard_normal((8, 16)).astype(np.float32)
        updates, state = opt.update(jnp.asarray(g, jnp.bfloat16), state, jp)
        jp = optax.apply_updates(jp, updates)
        topt.step([tp], [torch.from_numpy(g).to(torch.bfloat16)])
        np.testing.assert_allclose(tp.float().numpy(), np.asarray(jp.astype(jnp.float32)),
                                   rtol=2.0 ** -8, atol=0)


def test_decay_mask_is_the_reference_mask_on_its_stacked_layout():
    """The JAX engine's optax mask on its default (scanned) tree: per-layer
    norms and biases are stacked into matrices and decay; final_norm does
    not."""
    kw = dict(MODEL, tie_word_embeddings=False)
    shapes = jq.param_shapes(jq.ModelConfig(**kw, scan_layers=True))
    want = tq.flatten_names(jax.tree.map(lambda s: len(s) > 1, shapes,
                                         is_leaf=lambda x: isinstance(x, tuple)))
    for scan in (True, False):
        cfg = tq.ModelConfig(**kw, scan_layers=scan)
        named = tq.init_params(cfg, torch.Generator().manual_seed(0))
        got = dict(zip(named, torch_engine.decay_mask(named)))
        for name, flag in got.items():
            key = name if scan else "layers/" + name.split("/", 1)[1] if name.startswith("layers_") else name
            assert flag == want[key], name
    assert not got["final_norm"] and got["layers_0/input_norm"] and got["layers_1/attn/q_bias"]


# ---------------------------------------------------------------------------
# engine plumbing
# ---------------------------------------------------------------------------


class _RecordingRemote:
    """The push surface of a `RemoteInfEngine`, recording what it gets."""

    config = targs.InferenceEngineConfig()

    def __init__(self):
        self.frames, self.commits, self.disk = [], [], []

    def init_weights_update_group(self, meta):
        pass

    def _new_push_id(self):
        return "push-1"

    def stage_weights(self, named, push_id, chunk_mb, inflight):
        from areal_tpu_torch.core.weight_transfer import pack_buckets

        self.frames += list(pack_buckets(named, chunk_mb=chunk_mb))

    def commit_staged(self, push_id, version=None):
        self.commits.append((push_id, version))

    def abort_push(self, push_id):
        raise AssertionError("no push is aborted here")

    def update_weights_from_disk(self, meta):
        self.disk.append(meta.path)


def test_engine_refuses_what_the_port_lacks(tmp_path):
    """More than one device (item 5) and the LoRA delta push (item 6) are
    refused; the disk and dcn pushes run (a recording remote engine)."""
    from areal_tpu_torch.core.weight_transfer import WeightStaging
    from areal_tpu_torch.models import hf_io

    eng = torch_engine.TorchTrainEngine(targs.TrainEngineConfig(init_from_scratch=True,
                                                                dtype="float32"), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        eng.create_process_group(ParallelStrategy(data_parallel_size=2))
    eng.create_process_group(ParallelStrategy())
    eng.model_config = tq.ModelConfig(**MODEL)
    eng.initialize(None, None)
    remote = _RecordingRemote()
    eng.connect_engine(remote, WeightUpdateMeta(type="dcn"))
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        eng.update_weights(WeightUpdateMeta(type="dcn", use_lora=True))
    with pytest.raises(NotImplementedError, match="weight update type"):
        eng.update_weights(WeightUpdateMeta(type="nccl"))
    eng.set_version(3)
    eng.update_weights(WeightUpdateMeta(type="dcn", weight_chunked_mem_mb=1))
    assert remote.commits == [("push-1", 3)]
    st = WeightStaging()
    for frame in remote.frames:
        st.add_bucket(frame)
    wire = st.finalize()
    # the configured scan_layers (True) names the wire: layers stacked
    scanned = tq.ModelConfig(**MODEL)
    assert {k: tuple(v.shape) for k, v in wire.items()} == tq.named_shapes(scanned)
    L = scanned.num_hidden_layers
    for name, t in wire.items():
        want = (torch.stack([eng.params[f"layers_{i}/{name[7:]}"] for i in range(L)])
                if name.startswith("layers/") else eng.params[name])
        assert t.dtype == torch.bfloat16 and torch.equal(t, want.detach().to(torch.bfloat16))
    path = str(tmp_path / "disk")
    eng.update_weights(WeightUpdateMeta(type="disk", path=path))
    assert remote.disk == [path]
    back = hf_io.load_hf_params(path, eng.model_config)
    for k, v in eng.params.items():
        assert torch.equal(back[k], v.detach()), k


class _SlowStagingRemote(_RecordingRemote):
    """Staging that starts only once the trainer's next step has run its
    loss, then lingers: the step's optimizer update must wait for it."""

    def __init__(self, fail: bool = False):
        super().__init__()
        self.loss_ran = threading.Event()
        self.fail = fail
        self.aborted = []

    def stage_weights(self, named, push_id, chunk_mb, inflight):
        assert self.loss_ran.wait(60)
        time.sleep(0.3)
        if self.fail:
            raise ConnectionError("server gone")
        super().stage_weights(named, push_id, chunk_mb, inflight)

    def abort_push(self, push_id):
        self.aborted.append(push_id)


def _trained_engine():
    eng = torch_engine.TorchTrainEngine(targs.TrainEngineConfig(
        init_from_scratch=True, dtype="float32",
        mb_spec=targs.MicroBatchSpec(max_tokens_per_mb=64),
        optimizer=targs.OptimizerConfig(lr=1e-2, warmup_steps_proportion=0.0,
                                        lr_scheduler_type="constant")), device="cpu")
    eng.create_process_group(ParallelStrategy())
    eng.model_config = tq.ModelConfig(**MODEL)
    eng.initialize(None, FinetuneSpec(1, 8, 4))
    # the schedule's first update has lr 0 (as optax's): take it here
    eng.train_batch(_lm_batch(), lambda logits, mb: logits.float().square().mean(),
                    lambda mb: 1.0)
    return eng


def _lm_batch():
    rng = np.random.default_rng(2)
    return tdata.pad_sequences_to_tensors(
        [dict(input_ids=rng.integers(1, MODEL["vocab_size"], n)) for n in (9, 13, 7)])


def _step_beside(eng, remote, handle) -> list[bool]:
    """One train step while `handle` stages; whether staging had ended at
    each optimizer update."""
    staged_at_update, step = [], eng.optimizer.step

    def spy(plist, grads):
        staged_at_update.append(not handle._thread.is_alive())
        return step(plist, grads)

    def loss_fn(logits, mb):
        remote.loss_ran.set()
        return logits.float().square().mean()

    eng.optimizer.step = spy
    stats = eng.train_batch(_lm_batch(), loss_fn, lambda mb: 1.0)
    assert np.isfinite(stats["loss"])
    return staged_at_update


def test_dcn_push_async_stages_beside_a_train_step():
    """`update_weights_async` (JAX :1070-1130): the trainer runs its next
    step while the push stages; the step's optimizer update waits for
    staging, so the frames hold the weights of the push's version, and
    only `commit` (idempotent) installs them."""
    from areal_tpu_torch.core.weight_transfer import WeightStaging

    eng = _trained_engine()
    remote = _SlowStagingRemote()
    eng.connect_engine(remote, WeightUpdateMeta(type="dcn", weight_chunked_mem_mb=1))
    before = {k: v.detach().clone() for k, v in eng.params.items()}
    eng.set_version(4)
    handle = eng.update_weights_async()
    assert _step_beside(eng, remote, handle) == [True]
    assert remote.commits == [] and not handle.committed
    handle.commit()
    handle.commit()
    assert remote.commits == [("push-1", 4)] and handle.committed
    assert any(not torch.equal(before[k], eng.params[k]) for k in before)
    st = WeightStaging()
    for frame in remote.frames:
        st.add_bucket(frame)
    L = MODEL["num_hidden_layers"]
    for name, t in st.finalize().items():
        want = (torch.stack([before[f"layers_{i}/{name[7:]}"] for i in range(L)])
                if name.startswith("layers/") else before[name])
        assert torch.equal(t, want.to(torch.bfloat16)), name


def test_dcn_push_async_abort_and_staging_error():
    """A push that will not commit is aborted (its staging dropped on the
    servers); a staging error comes out of `commit`, which then installs
    nothing; the optimizer update waits for a failing stage too."""
    eng = _trained_engine()
    remote = _SlowStagingRemote()
    eng.connect_engine(remote, WeightUpdateMeta(type="dcn", weight_chunked_mem_mb=1))
    handle = eng.update_weights_async()
    remote.loss_ran.set()
    handle.abort()
    assert remote.aborted == ["push-1"] and remote.commits == [] and remote.frames
    failing = _SlowStagingRemote(fail=True)
    eng.connect_engine(failing, WeightUpdateMeta(type="dcn"))
    handle = eng.update_weights_async()
    assert _step_beside(eng, failing, handle) == [True]
    with pytest.raises(ConnectionError, match="server gone"):
        handle.commit()
    assert failing.commits == [] and not handle.committed
