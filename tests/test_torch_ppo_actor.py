"""The port's GRPO actor against the JAX package's, on the CPU in f32.

A `JaxPPOActor` and a `TorchPPOActor` built as `tests/test_ppo_actor.py`
builds its actor (tiny Qwen2 geometry, constant lr after the one-step
warm-up, decoupled loss), with the same weights, take the same batch
through `compute_logp`, `compute_advantages` and three `ppo_update` calls.
Tolerances: atol 1e-5 on logprobs, advantages and per-update losses and
stats (f32, sums in another order); rtol 1e-4 on the gradient norm;
parameters atol 2e-5 after each update (an Adam step is about lr in size
whatever the gradient, so f32 noise in tiny gradients moves a parameter
by at most lr * noise / eps). The first update has learning rate 0 in
both packages and leaves every parameter bit for bit.

Then the trainer pushes its weights into a CPU `TorchDecodeEngine`, whose
responses carry the pushed version and whose behaviour logprobs match
`compute_logp` on the same sequences (atol 1e-4: the decode engine's
dense prefill and paged steps against one packed forward).
"""


import jax
import numpy as np
import pytest
import torch

from areal_tpu.api import cli_args as jargs
from areal_tpu.api.alloc_mode import ParallelStrategy as JaxParallelStrategy
from areal_tpu.api.io_struct import FinetuneSpec as JaxFinetuneSpec
from areal_tpu.engine.ppo.actor import JaxPPOActor
from areal_tpu.models import qwen2 as jq
from areal_tpu_torch.api import cli_args as targs
from areal_tpu_torch.api.io_struct import FinetuneSpec, ModelRequest, WeightUpdateMeta
from areal_tpu_torch.engine.ppo.actor import TorchPPOActor, _split_minibatches
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy, unstack_layers

TINY = dict(
    vocab_size=48, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, dtype="float32", param_dtype="float32",
)
ACTOR = dict(
    experiment_name="", trial_name="", path="", init_from_scratch=True, dtype="float32",
    gradient_checkpointing=False, group_size=2, ppo_n_minibatches=1, eps_clip=0.2,
    kl_ctl=0.0, use_decoupled_loss=True, recompute_logprob=True, temperature=1.0,
    behav_imp_weight_cap=5.0,
)
STATS = ("loss", "grad_norm", "lr", "n_mbs", "entropy", "importance_weight", "approx_kl",
         "clip_ratio", "dual_clip_ratio", "behave_imp_weight", "behave_approx_kl")


def _batch(seed=0, B=6, T=14, vocab=48):
    """Prompts of 3-5 tokens, answers to the row's length; rows 0-3 are
    two GRPO groups, rows 4-5 a third; behaviour logprobs off the policy."""
    rng = np.random.default_rng(seed)
    lens = np.array([14, 11, 9, 14, 12, 8])[:B]
    plens = rng.integers(3, 6, B)
    attn = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
    loss_mask = (attn * (np.arange(T)[None] >= plens[:, None])).astype(np.int32)
    return dict(
        input_ids=rng.integers(0, vocab, (B, T)) * attn,
        attention_mask=attn,
        loss_mask=loss_mask,
        rewards=np.array([1.0, 0.0, 0.0, 1.0, 1.0, 0.0], np.float32)[:B],
        logprobs=(-2.0 - rng.random((B, T)) * loss_mask).astype(np.float32),
    )


@pytest.fixture(scope="module")
def actors(cpu_devices):
    common = dict(
        mb_spec=dict(max_tokens_per_mb=48),
        optimizer=dict(lr=5e-3, warmup_steps_proportion=0.0, lr_scheduler_type="constant"),
        adv_norm=dict(mean_level="group", std_level="group", group_size=2),
    )

    def cfg(mod):
        return mod.PPOActorConfig(
            **ACTOR, mb_spec=mod.MicroBatchSpec(**common["mb_spec"]),
            optimizer=mod.OptimizerConfig(**common["optimizer"]),
            adv_norm=mod.NormConfig(**common["adv_norm"]),
        )

    jactor = JaxPPOActor(cfg(jargs))
    jactor.model_config = jq.ModelConfig(**TINY)
    jactor.create_process_group(JaxParallelStrategy(data_parallel_size=8))
    jactor.initialize(None, JaxFinetuneSpec(1, 24, 6))
    tactor = TorchPPOActor(cfg(targs), device="cpu")
    tactor.model_config = tq.ModelConfig(**TINY, scan_layers=False)
    tactor.create_process_group()
    tree = jax.tree.map(np.asarray, jactor.params)
    tactor.initialize(None, FinetuneSpec(1, 24, 6),
                      params=params_from_numpy(tree, tactor.model_config))
    return jactor, tactor


def _jax_params(jactor) -> dict[str, np.ndarray]:
    return tq.flatten_names(unstack_layers(jax.tree.map(np.asarray, jactor.params)))


def _assert_params_close(jactor, tactor, atol):
    want = _jax_params(jactor)
    for name, t in tactor.params.items():
        np.testing.assert_allclose(t.detach().numpy(), want[name], atol=atol, rtol=0,
                                   err_msg=name)


def test_logp_advantages_and_three_updates_match_jax(actors):
    jactor, tactor = actors
    batch = _batch()
    jb, tb = dict(batch), dict(batch)
    jb["prox_logp"] = jactor.compute_logp(jb)
    tb["prox_logp"] = tactor.compute_logp(tb)
    np.testing.assert_allclose(tb["prox_logp"], jb["prox_logp"], atol=1e-5)
    jactor.compute_advantages(jb)
    tactor.compute_advantages(tb)
    for k in ("advantages", "returns", "loss_mask", "logprobs", "kl_rewards", "tot_rewards"):
        np.testing.assert_allclose(tb[k], np.asarray(jb[k]), atol=1e-5, err_msg=k)
    assert np.abs(tb["advantages"]).max() > 0.5
    before = {k: v.detach().clone() for k, v in tactor.params.items()}
    jbefore = _jax_params(jactor)
    for step in range(3):
        jstats = jactor.ppo_update(dict(jb))[0]
        tstats = tactor.ppo_update(dict(tb))[0]
        for k in STATS:
            tol = dict(rtol=1e-4) if k == "grad_norm" else dict(atol=1e-5)
            np.testing.assert_allclose(tstats[k], jstats[k], err_msg=f"step {step} {k}", **tol)
        if step == 0:  # lr 0 at the first update, in both packages
            assert tstats["lr"] == pytest.approx(5e-3) and tstats["grad_norm"] > 0
            for name, t in tactor.params.items():
                assert torch.equal(t, before[name]), name
                np.testing.assert_array_equal(_jax_params(jactor)[name], jbefore[name])
        _assert_params_close(jactor, tactor, atol=2e-5)
    moved = max((t - before[k]).abs().max().item() for k, t in tactor.params.items())
    assert moved > 1e-3


def test_split_minibatches_is_the_jax_split():
    from areal_tpu.engine.ppo.actor import _split_minibatches as jsplit

    batch = _batch(seed=3)
    for n in (1, 2, 3):
        got, want = _split_minibatches(batch, n), jsplit(batch, n)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_push_into_decode_engine_stamps_version_and_matches_logp(actors):
    _, tactor = actors
    cfg = tactor.model_config
    engine = TorchDecodeEngine(
        targs.TorchDecodeConfig(max_running_requests=2, context_length=64, page_size=16,
                                new_tokens_per_chunk=4, kv_cache_dtype="float32"),
        device="cpu",
    )
    engine.set_model({k: torch.zeros_like(v) for k, v in tactor.params.items()}, cfg)
    engine.initialize()
    try:
        tactor.connect_engine(engine, WeightUpdateMeta.from_memory())
        tactor.set_version(7)
        tactor.update_weights()
        assert engine.get_version() == 7
        for name, t in tactor.params.items():
            assert torch.equal(engine.params[name], t.detach())
        prompt = [3, 17, 5, 40, 9]
        gconfig = targs.GenerationHyperparameters(max_new_tokens=6, greedy=True)
        resp = engine.generate(ModelRequest(rid="r", input_ids=prompt, gconfig=gconfig))
        assert resp.output_versions == [7] * 6
        seq = prompt + resp.output_tokens
        data = dict(input_ids=np.asarray([seq]), attention_mask=np.ones((1, len(seq)), np.int64))
        logp = tactor.compute_logp(data)[0]
        np.testing.assert_allclose(resp.output_logprobs, logp[len(prompt) - 1 : -1], atol=1e-4)
    finally:
        engine.destroy()
