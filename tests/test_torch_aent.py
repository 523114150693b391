"""The AEnt clamped entropy of the port against the JAX package's, on the
CPU in f32 (`tests/test_aent.py`'s cases).

- `clamped_softmax_entropy` against the numpy oracle of the reference
  recipe (rtol 1e-4, atol 1e-5, as the JAX test) and against the JAX
  function (atol 1e-5: f32 sums in another order).
- `chunked_clamped_entropy` (T not a multiple of the chunk, both head
  layouts), values and gradients for the hidden states and the head, on
  `tests/test_aent.py`'s inputs, whose logits reach ~15: within 2e-5 of
  the dense clamped entropy evaluated in float64, and within 1e-4 of the
  JAX chunked and dense versions. The JAX f32 gradients themselves sit
  6.7e-5 from the float64 values (the port's 1.2e-5): `lse - E[x]` cancels
  two numbers near the largest logit, and the f32 sums go in another
  order.
- The gradient reaches the kept logits only, as in JAX; the two packages'
  gradients agree to atol 1e-6.
- `grpo_loss_fn` with `entropy_clamp > 0`, on dense logits and through the
  `LMHead`: the loss and every stat within 1e-5 of JAX's, and the logged
  entropy is the clamped one.
- `TorchPPOActor` against `JaxPPOActor` from the same weights, with the
  clamp, the entropy bonus and the adaptive coefficient, over three
  updates: the logged entropy within 1e-5 and the coefficient's path
  within 1e-9; and the controller's rule on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api import cli_args as j_cli
from areal_tpu.api.alloc_mode import ParallelStrategy as JParallelStrategy
from areal_tpu.api.io_struct import FinetuneSpec as JFinetuneSpec
from areal_tpu.engine.ppo import actor as j_actor
from areal_tpu.models import qwen2 as jq
from areal_tpu.ops import fused_xent as j_fx
from areal_tpu.utils import functional as j_fn
from areal_tpu_torch.api import cli_args as t_cli
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.engine.ppo import actor as t_actor
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy
from areal_tpu_torch.ops import fused_xent as t_fx
from areal_tpu_torch.utils import functional as t_fn

TINY = dict(vocab_size=32, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, dtype="float32",
            param_dtype="float32")


def _oracle(logits: np.ndarray, clamp: float, temp: float = 1.0):
    """recipe/AEnt/functional.py:16: the floor(V * clamp) smallest logits
    to -inf, renormalise, entropy (`tests/test_aent.py`)."""
    x = logits.astype(np.float64) / temp
    k = int(x.shape[-1] * clamp)
    out = np.empty(x.shape[:-1])
    for idx in np.ndindex(*x.shape[:-1]):
        row = x[idx].copy()
        row[np.argsort(row, kind="stable")[:k]] = -np.inf
        row -= row.max()
        p = np.exp(row)
        p /= p.sum()
        lp = np.where(p > 0, np.log(np.clip(p, 1e-300, None)), 0.0)
        out[idx] = -np.sum(p * lp)
    return out


@pytest.mark.parametrize("clamp,temp", [(0.2, 1.0), (0.5, 0.7), (0.0, 1.0)])
def test_clamped_entropy_matches_oracle_and_jax(clamp, temp):
    logits = np.random.RandomState(0).randn(5, 40).astype(np.float32) * 3
    got = t_fn.clamped_softmax_entropy(torch.from_numpy(logits), clamp, temp).numpy()
    np.testing.assert_allclose(got, _oracle(logits, clamp, temp), rtol=1e-4, atol=1e-5)
    want = np.asarray(j_fn.clamped_softmax_entropy(jnp.asarray(logits), clamp, temp))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_clamp_out_of_range_is_refused():
    with pytest.raises(ValueError, match="entropy_clamp"):
        t_fn.clamped_softmax_entropy(torch.zeros(2, 4), 1.0)


F64_ATOL, JAX_ATOL = 2e-5, 1e-4


@pytest.mark.parametrize("vh", [False, True], ids=["hv", "vh"])
def test_chunked_clamped_entropy_matches_dense(vh):
    rng = np.random.RandomState(1)
    T, H, V = 50, 16, 64  # T not a multiple of the token chunk
    hidden = rng.randn(T, H).astype(np.float32)
    w_hv = rng.randn(H, V).astype(np.float32)
    g = rng.randn(T).astype(np.float32)
    w = w_hv.T.copy() if vh else w_hv

    def jdense(h, w_hv):
        return (j_fn.clamped_softmax_entropy(h @ w_hv, 0.25) * g).sum()

    jdh, jdw = jax.grad(jdense, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(w_hv))
    jax_out = dict(
        ent=np.asarray(j_fn.clamped_softmax_entropy(jnp.asarray(hidden @ w_hv), 0.25)),
        chunk=np.asarray(j_fx.chunked_clamped_entropy(
            jnp.asarray(hidden), jnp.asarray(w), head_is_vh=vh, entropy_clamp=0.25,
            token_chunk=16)),
        dh=np.asarray(jdh), dw=np.asarray(jdw).T if vh else np.asarray(jdw))
    h64 = torch.from_numpy(hidden).double().requires_grad_()
    w64 = torch.from_numpy(w).double().requires_grad_()
    e64 = t_fn.clamped_softmax_entropy(h64 @ (w64.t() if vh else w64), 0.25)
    f64 = dict(ent=e64.detach().numpy(), **dict(zip(("dh", "dw"), (
        x.numpy() for x in torch.autograd.grad(e64, (h64, w64), torch.from_numpy(g).double())))))
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ent = t_fx.chunked_clamped_entropy(th, tw, head_is_vh=vh, entropy_clamp=0.25,
                                       token_chunk=16)
    dh, dw = torch.autograd.grad(ent, (th, tw), torch.from_numpy(g))
    got = dict(ent=ent.detach().numpy(), dh=dh.numpy(), dw=dw.numpy())
    for k, v in got.items():
        np.testing.assert_allclose(v, f64[k], rtol=0, atol=F64_ATOL, err_msg=k)
        np.testing.assert_allclose(v, jax_out[k], rtol=0, atol=JAX_ATOL, err_msg=k)
    np.testing.assert_allclose(got["ent"], jax_out["chunk"], rtol=0, atol=JAX_ATOL)


def test_gradient_only_through_kept_logits():
    x = np.linspace(-4, 4, 8, dtype=np.float32)[None, :]
    tx = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(t_fn.clamped_softmax_entropy(tx, 0.25).sum(), tx)
    g = g.numpy()[0]
    assert np.all(g[:2] == 0.0), g  # the two smallest logits were clamped out
    assert np.any(g[2:] != 0.0), g
    jg = np.asarray(jax.grad(lambda v: j_fn.clamped_softmax_entropy(v, 0.25).sum())(
        jnp.asarray(x)))[0]
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-6)


def _packed(seed=0, T=30, V=32):
    rng = np.random.RandomState(seed)
    mb = dict(
        input_ids=rng.randint(0, V, T).astype(np.int64),
        loss_mask=(rng.rand(T) > 0.3).astype(np.int64),
        logprobs=(-2.0 - rng.rand(T)).astype(np.float32),
        prox_logp=(-2.0 - rng.rand(T)).astype(np.float32),
        advantages=rng.randn(T).astype(np.float32),
    )
    return mb, rng.randn(T, V).astype(np.float32) * 2


LOSS_KW = dict(temperature=1.0, eps_clip=0.2, eps_clip_higher=None, c_clip=None,
               behav_imp_weight_cap=None, entropy_coeff=0.3, entropy_clamp=0.25)


@pytest.mark.parametrize("head", ["dense", "lmhead"])
def test_grpo_loss_with_clamp_matches_jax(head):
    mb, logits = _packed()
    tmb = {k: torch.from_numpy(v) for k, v in mb.items()}
    if head == "dense":
        jx, tx = jnp.asarray(logits), torch.from_numpy(logits)
    else:
        jcfg = jq.ModelConfig(**TINY)
        jparams = jax.jit(jq.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(4))
        tcfg = tq.ModelConfig(**TINY, scan_layers=False)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
        hidden = np.random.RandomState(5).randn(len(mb["input_ids"]), 32).astype(np.float32)
        jx = jq.LMHead(jnp.asarray(hidden), jparams, jcfg)
        tx = tq.LMHead(torch.from_numpy(hidden), tparams, tcfg)
    jloss, jstats = j_actor.grpo_loss_fn(jx, {k: jnp.asarray(v) for k, v in mb.items()},
                                         **LOSS_KW)
    tloss, tstats = t_actor.grpo_loss_fn(tx, tmb, **LOSS_KW)
    assert abs(float(tloss) - float(jloss)) <= 1e-5
    assert set(tstats) == set(jstats)
    for k in jstats:
        assert abs(float(tstats[k]) - float(jstats[k])) <= 1e-5, k
    # the logged entropy is the clamped one
    if head == "dense":
        ent = t_fn.clamped_softmax_entropy(tx, 0.25)
        m = tmb["loss_mask"].bool()
        assert float(tstats["entropy"]) == pytest.approx(float(ent[m].mean()), abs=1e-6)
        unclamped = t_fn.gather_logprobs_entropy(tx, torch.roll(tmb["input_ids"], -1))[1]
        assert abs(float(unclamped[m].mean()) - float(tstats["entropy"])) > 0.01


def _batch(V=32):
    """`tests/test_aent.py`'s synthetic batch: two answers, rewarded 1 / 0."""
    B, T = 4, 8
    ids = np.zeros((B, T), dtype=np.int64)
    ids[:, :3] = [1, 2, 3]
    ids[0, 3:], ids[1, 3:], ids[2, 3:], ids[3, 3:] = 16, 5, 16, 5
    return dict(
        input_ids=ids, attention_mask=np.ones((B, T), dtype=np.int64),
        loss_mask=np.pad(np.ones((B, 5), np.int64), ((0, 0), (3, 0))),
        rewards=np.array([1.0, 0.0, 1.0, 0.0], dtype=np.float32),
        logprobs=np.zeros((B, T), dtype=np.float32),
    )


ACTOR = dict(
    experiment_name="", trial_name="", path="", init_from_scratch=True, dtype="float32",
    gradient_checkpointing=False, group_size=2, ppo_n_minibatches=1, eps_clip=0.2,
    kl_ctl=0.0, use_decoupled_loss=False, recompute_logprob=True, temperature=1.0,
    entropy_coeff=5e-3, entropy_clamp=0.25, adaptive_entropy_coeff=True, entropy_low=5.0,
    entropy_high=50.0, entropy_coeff_lr=1e-3, entropy_coeff_box_high=0.05,
)


def test_actor_with_clamp_and_adaptive_coeff_matches_jax(cpu_devices):
    def cfg(mod):
        return mod.PPOActorConfig(
            **ACTOR, mb_spec=mod.MicroBatchSpec(max_tokens_per_mb=512),
            optimizer=mod.OptimizerConfig(lr=5e-3, warmup_steps_proportion=0.0,
                                          lr_scheduler_type="constant"))

    ja = j_actor.JaxPPOActor(cfg(j_cli))
    ja.model_config = jq.ModelConfig(**TINY)
    ja.create_process_group(JParallelStrategy(data_parallel_size=8))
    ja.initialize(None, JFinetuneSpec(1, 64, 8))
    ta = t_actor.TorchPPOActor(cfg(t_cli), device="cpu")
    ta.model_config = tq.ModelConfig(**TINY, scan_layers=False)
    ta.create_process_group()
    ta.initialize(None, FinetuneSpec(1, 64, 8),
                  params=params_from_numpy(jax.tree.map(np.asarray, ja.params), ta.model_config))
    coeffs = []
    for _ in range(3):
        out = []
        for a in (ja, ta):
            batch = _batch()
            batch["prox_logp"] = a.compute_logp(batch)
            a.compute_advantages(batch)
            stats = a.ppo_update(batch)[0]
            out.append((next(v for k, v in stats.items() if k.endswith("/entropy")
                             or k == "entropy"), a.actor.entropy_coeff))
        (je, jc), (te, tc) = out
        assert np.isfinite(te) and abs(te - je) <= 1e-5, (te, je)
        assert abs(tc - jc) <= 1e-9, (tc, jc)
        coeffs.append(tc)
    # entropy below the band raises the coefficient, within the box
    assert coeffs[0] < coeffs[1] < coeffs[2] <= 0.05, coeffs


def test_adaptive_coeff_controller():
    kw = dict(entropy_coeff=5e-3, adaptive_entropy_coeff=True, entropy_low=0.1,
              entropy_high=0.5, entropy_coeff_lr=0.01, entropy_coeff_box_low=1e-5,
              entropy_coeff_box_high=0.01, entropy_warmup_steps=1)
    jc = j_actor.PPOActor(j_cli.PPOActorConfig(**kw), None)
    tc = t_actor.PPOActor(t_cli.PPOActorConfig(**kw), None)
    path = []
    for steps, ent in [(1, 0.01), (2, 0.0), (2, 5.0), (3, 0.3)]:
        for a in (jc, tc):
            a._update_steps = steps
            a._adapt_entropy_coeff(ent)
        assert tc.entropy_coeff == jc.entropy_coeff
        path.append(tc.entropy_coeff)
    assert path[0] == 5e-3  # warm-up: no change
    assert path[1] == pytest.approx(6e-3)  # low entropy: up
    assert path[2] == pytest.approx(1e-5)  # high entropy: down to the box
