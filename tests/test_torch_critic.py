"""The port's PPO critic against the JAX package's, on the CPU in f32.

A `JaxPPOCritic` and a `TorchPPOCritic` on `tests/test_critic_rw.py`'s
TINY_CRITIC geometry (2 layers, hidden 32, a value head), with the same
weights moved across by `models/convert.py`, take the same batch through
`compute_values` and three `ppo_update` calls over two minibatches of
several micro-batches. Tolerances are `tests/test_torch_ppo_actor.py`'s:
atol 1e-5 on values and on each update's loss and `value_clip_ratio`,
rtol 1e-4 on the gradient norm, parameters atol 2e-5 after each update.
The first optimizer step has learning rate 0 in both packages, so parity
that expects moved weights takes the later updates. `ppo_critic_loss_fn` is held
against JAX's for both loss types, with and without a mask, atol 1e-6 on
the loss and its gradient. Then a critic's HF export is read across
packages both ways, and the critic's refusals on the serving path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api import cli_args as jargs
from areal_tpu.api.alloc_mode import ParallelStrategy as JaxParallelStrategy
from areal_tpu.api.io_struct import FinetuneSpec as JaxFinetuneSpec
from areal_tpu.engine.ppo.critic import JaxPPOCritic
from areal_tpu.models import hf_io as j_hf
from areal_tpu.models import qwen2 as jq
from areal_tpu.utils import flops as jflops
from areal_tpu.utils import functional as jfn
from areal_tpu_torch.api import cli_args as targs
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.engine.ppo.critic import TorchPPOCritic
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.models import hf_io as t_hf
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy, unstack_layers
from areal_tpu_torch.models.smoke import QWEN25_1_5B, smoke_model_config
from areal_tpu_torch.utils import flops as tflops
from areal_tpu_torch.utils import functional as tfn

TINY_CRITIC = dict(
    vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, dtype="float32", param_dtype="float32",
    is_critic=True,
)
STATS = ("critic_loss", "critic_value_clip_ratio", "critic_grad_norm", "critic_lr",
         "critic_n_mbs")


def _cfg(mod):
    return mod.PPOCriticConfig(
        experiment_name="t", trial_name="t", path="", init_from_scratch=True, dtype="float32",
        gradient_checkpointing=False, ppo_n_minibatches=2, eps_clip=0.02,
        mb_spec=mod.MicroBatchSpec(max_tokens_per_mb=32),
        optimizer=mod.OptimizerConfig(lr=5e-3, warmup_steps_proportion=0.0,
                                      lr_scheduler_type="constant", gradient_clipping=1.0),
    )


def _batch(seed=0, B=6, T=16):
    """Rows of 8-16 tokens; the loss mask covers each row's answer (from
    a prompt of 3-5 tokens), returns drawn around 1."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(T // 2, T + 1, B)
    plens = rng.integers(3, 6, B)
    attn = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
    loss_mask = (attn * (np.arange(T)[None] >= plens[:, None])).astype(np.float32)
    return dict(
        input_ids=rng.integers(1, 64, (B, T)) * attn,
        attention_mask=attn,
        loss_mask=loss_mask,
        returns=((1.0 + rng.standard_normal((B, T))) * loss_mask).astype(np.float32),
    )


@pytest.fixture(scope="module")
def critics(cpu_devices):
    jcritic = JaxPPOCritic(_cfg(jargs))
    jcritic.model_config = jq.ModelConfig(**TINY_CRITIC)
    jcritic.create_process_group(JaxParallelStrategy(data_parallel_size=8))
    jcritic.initialize(None, JaxFinetuneSpec(1, 24, 6))
    tcritic = TorchPPOCritic(_cfg(targs), device="cpu")
    assert tcritic.config.is_critic
    tcritic.model_config = tq.ModelConfig(**TINY_CRITIC, scan_layers=False)
    tcritic.create_process_group()
    tree = jax.tree.map(np.asarray, jcritic.params)
    tcritic.initialize(None, FinetuneSpec(1, 24, 6),
                       params=params_from_numpy(tree, tcritic.model_config))
    return jcritic, tcritic


def _jax_params(jcritic) -> dict[str, np.ndarray]:
    return tq.flatten_names(unstack_layers(jax.tree.map(np.asarray, jcritic.params)))


def _assert_params_close(jcritic, tcritic, atol):
    want = _jax_params(jcritic)
    assert set(want) == set(tcritic.params)
    assert "value_head/kernel" in want and "lm_head/kernel" not in want
    for name, t in tcritic.params.items():
        np.testing.assert_allclose(t.detach().numpy(), want[name], atol=atol, rtol=0,
                                   err_msg=name)


def test_compute_values_and_three_updates_match_jax(critics):
    jcritic, tcritic = critics
    batch = _batch()
    jv = jcritic.compute_values(dict(batch))
    tv = tcritic.compute_values(dict(batch))
    assert tv.shape == batch["input_ids"].shape and tv.dtype == np.float32
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    assert np.all(tv[batch["attention_mask"] == 0] == 0)
    # the actor's keys ride along and are dropped before the split
    data = dict(batch, values=tv, rewards=np.ones(6, np.float32), versions=np.zeros_like(tv),
                advantages=np.ones_like(tv), logprobs=np.zeros_like(tv))
    clipped = []
    for step in range(3):
        jstats = jcritic.ppo_update(dict(data))
        tstats = tcritic.ppo_update(dict(data))
        assert len(tstats) == len(jstats) == 2
        for js, ts in zip(jstats, tstats):
            for k in STATS:
                tol = dict(rtol=1e-4) if k == "critic_grad_norm" else dict(atol=1e-5)
                np.testing.assert_allclose(ts[k], js[k], err_msg=f"step {step} {k}", **tol)
            clipped.append(ts["critic_value_clip_ratio"])
        _assert_params_close(jcritic, tcritic, atol=2e-5)
    # the first optimizer step (lr 0) leaves the values at the old ones; the
    # old values stay put, so the later steps clip
    assert clipped[:2] == [0.0, 0.0] and max(clipped) > 0.1
    np.testing.assert_allclose(tcritic.compute_values(dict(batch)),
                               jcritic.compute_values(dict(batch)), atol=1e-5)
    assert np.abs(tcritic.compute_values(dict(batch)) - tv).max() > 1e-3


@pytest.mark.parametrize("loss_fn_type", ["mse", "huber"])
@pytest.mark.parametrize("masked", [True, False])
def test_ppo_critic_loss_fn_matches_jax(loss_fn_type, masked):
    rng = np.random.default_rng(3)
    T = 64
    value = rng.standard_normal(T).astype(np.float32)
    old = (value + rng.standard_normal(T)).astype(np.float32)
    target = rng.standard_normal(T).astype(np.float32)
    # two targets 11 away, so the huber loss (delta 10) takes both branches
    target[[5, 40]] = value[[5, 40]] + 11.0
    mask = (rng.random(T) > 0.3).astype(np.float32) if masked else None

    def jloss(v):
        return jfn.ppo_critic_loss_fn(v, jnp.asarray(old), jnp.asarray(target), 0.5,
                                      None if mask is None else jnp.asarray(mask),
                                      loss_fn_type=loss_fn_type)

    (jl, jstat), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(value))
    tv = torch.tensor(value, requires_grad=True)
    tl, tstat = tfn.ppo_critic_loss_fn(tv, torch.tensor(old), torch.tensor(target), 0.5,
                                       None if mask is None else torch.tensor(mask),
                                       loss_fn_type=loss_fn_type)
    (tg,) = torch.autograd.grad(tl, tv)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tstat["clip_mask"].numpy(), np.asarray(jstat["clip_mask"]))
    assert 0 < int(tstat["clip_mask"].sum()) < T
    assert not tstat["clip_mask"].requires_grad and not tstat["loss"].requires_grad
    if loss_fn_type == "huber":
        assert (np.abs(value - target) >= 10).any() and (np.abs(value - target) < 10).any()
    with pytest.raises(NotImplementedError, match="loss fn type"):
        tfn.ppo_critic_loss_fn(tv, tv, tv, 0.5, loss_fn_type="l1")


@pytest.mark.parametrize("scan", [False, True])
def test_critic_hf_export_cross_read(scan, tmp_path):
    jcfg = jq.ModelConfig(**TINY_CRITIC)
    jparams = jax.jit(jq.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(5))
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = tq.ModelConfig(**TINY_CRITIC, scan_layers=scan)
    params = params_from_numpy(tree, tcfg)
    # the port's export, read by JAX
    t_hf.save_hf_params(params, tcfg, str(tmp_path / "port"))
    back = jax.tree.map(np.asarray, j_hf.load_hf_params(str(tmp_path / "port"), jcfg))
    for k, t in params_from_numpy(back, tcfg).items():
        assert torch.equal(t, params[k]), k
    # JAX's export, read by the port: the same tensors under the same names
    j_hf.save_hf_params(jparams, jcfg, str(tmp_path / "jax"))
    for k, t in t_hf.load_hf_params(str(tmp_path / "jax"), tcfg).items():
        assert torch.equal(t, params[k]), k
    a = t_hf.read_safetensors(str(tmp_path / "jax" / "model.safetensors"))
    b = t_hf.read_safetensors(str(tmp_path / "port" / "model.safetensors"))
    assert set(a) == set(b) and "score.weight" in b and "lm_head.weight" not in b
    assert tuple(b["score.weight"].shape) == (1, 32) and tuple(b["score.bias"].shape) == (1,)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # a causal-LM checkpoint read as a critic: no lm_head, a zero value head
    lm_kw = dict(TINY_CRITIC, is_critic=False)
    lm_tree = jax.tree.map(np.asarray, jq.init_params(jq.ModelConfig(**lm_kw),
                                                      jax.random.PRNGKey(6)))
    lm_cfg = tq.ModelConfig(**lm_kw, scan_layers=scan)
    t_hf.save_hf_params(params_from_numpy(lm_tree, lm_cfg), lm_cfg, str(tmp_path / "lm"))
    got = t_hf.load_hf_params(str(tmp_path / "lm"), tcfg)
    want = jax.tree.map(np.asarray, j_hf.load_hf_params(str(tmp_path / "lm"), jcfg))
    for k, t in params_from_numpy(want, tcfg).items():
        assert torch.equal(got[k], t), k
    assert not got["value_head/kernel"].any() and "lm_head/kernel" not in got
    # and a critic's checkpoint read as a tied causal LM drops the value head
    tied_kw = dict(lm_kw, tie_word_embeddings=True)
    tied = t_hf.load_hf_params(str(tmp_path / "port"), tq.ModelConfig(**tied_kw, scan_layers=scan))
    want = jax.tree.map(np.asarray, j_hf.load_hf_params(str(tmp_path / "port"),
                                                        jq.ModelConfig(**tied_kw)))
    assert "value_head/kernel" not in tied and set(tied) == set(
        tq.flatten_names(unstack_layers(want) if not scan else want))


def test_critic_is_refused_on_the_serving_path():
    cfg = smoke_model_config(is_critic=True)
    assert cfg.is_critic and not smoke_model_config().is_critic
    params = tq.init_params(cfg, torch.Generator().manual_seed(0))
    assert tuple(params["value_head/kernel"].shape) == (64, 1)
    assert not params["value_head/bias"].any() and "lm_head/kernel" not in params
    eng = TorchDecodeEngine(targs.TorchDecodeConfig(), targs.InferenceEngineConfig(),
                            device="cpu")
    with pytest.raises(ValueError, match="is_critic"):
        eng.set_model(params, cfg)
    ids = torch.arange(8)
    with pytest.raises(ValueError, match="is_critic"):
        tq.prefill(params, ids, ids, cfg)
    with pytest.raises(ValueError, match="critic"):
        tq.forward(params, ids, ids, torch.zeros(8, dtype=torch.long), cfg, return_hidden=True)
    values = tq.forward(params, ids, ids, torch.zeros(8, dtype=torch.long), cfg)
    assert values.shape == (8,) and values.dtype == torch.float32
    # the engine refuses a fused-head (hidden_loss) function on a critic
    crit = TorchPPOCritic(_cfg(targs), device="cpu")
    crit.model_config = tq.ModelConfig(**TINY_CRITIC, scan_layers=False)
    crit.initialize(None, FinetuneSpec(1, 24, 6))

    def hidden(x, mb):
        return x.sum()

    hidden.hidden_loss = True
    with pytest.raises(ValueError, match="critic"):
        crit.forward(dict(_batch(B=2)), post_hook=hidden, aggregate_fn=list)


def test_flops_count_the_value_head():
    """The port counts what a critic computes, 2·d at the head, where the
    JAX copy counts the LM head for every model."""
    import dataclasses

    crit = dataclasses.replace(QWEN25_1_5B, is_critic=True)
    d, V = QWEN25_1_5B.hidden_size, QWEN25_1_5B.vocab_size
    lm = tflops.forward_flops_per_token(QWEN25_1_5B, 256.0)
    assert lm == jflops.forward_flops_per_token(QWEN25_1_5B, 256.0)
    assert lm - tflops.forward_flops_per_token(crit, 256.0) == 2 * d * (V - 1)
    assert 2 * d * (V - 1) == pytest.approx(0.467e9, rel=1e-3)
