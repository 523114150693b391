"""The port's PPO entry point (actor and critic) on the CPU, at the smoke
geometry.

- For one fixed batch, `examples/configs/arith_ppo_smoke.yaml`'s actor
  and critic loaded by each package's own loader, with the same weights
  (moved from JAX): the critic's values, then the actor's advantages and
  returns through GAE on those values, within atol 1e-5; then one actor
  and one critic update on the batch, the critic's stats within atol
  1e-5.
- The entry point `main` for 2 steps on the yaml: the critic's stats
  under `ppo_critic/`, its throughput under `critic/`, each batch trained
  with the critic's values, the version lag within 2.
- One step of the DECOUPLED branch (`allocation_mode=jax:d1t1+d1`)
  against the port's decode server in this process, as
  `tests/test_torch_grpo_loop.py` runs the GRPO entry point.
- The refusals: recovery (one recovery point cannot hold two engines).
"""

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api import cli_args as j_cli
from areal_tpu.api.alloc_mode import ParallelStrategy as JaxParallelStrategy
from areal_tpu.api.io_struct import FinetuneSpec as JaxFinetuneSpec
from areal_tpu.engine.ppo.actor import JaxPPOActor
from areal_tpu.engine.ppo.critic import JaxPPOCritic
from areal_tpu.models import smoke as j_smoke
from areal_tpu_torch.api import cli_args as t_cli
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.engine.ppo.actor import TorchPPOActor
from areal_tpu_torch.engine.ppo.critic import TorchPPOCritic
from areal_tpu_torch.examples.gsm8k_ppo import main
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy
from areal_tpu_torch.models.smoke import smoke_model_config

YAML = "examples/configs/arith_ppo_smoke.yaml"
DECODE = dict(context_length=64, max_running_requests=16, new_tokens_per_chunk=8,
              dtype="float32", kv_cache_dtype="float32")


def _batch(seed=0, B=8, T=14, vocab=21):
    """Two groups of 4 rows: prompts of 3-5 tokens, answers to the row's
    length, behaviour logprobs on the answers."""
    rng = np.random.default_rng(seed)
    lens = np.array([14, 11, 9, 14, 12, 8, 13, 10])[:B]
    plens = rng.integers(3, 6, B)
    attn = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
    loss_mask = (attn * (np.arange(T)[None] >= plens[:, None])).astype(np.int32)
    return dict(
        input_ids=rng.integers(3, vocab, (B, T)) * attn,
        attention_mask=attn,
        loss_mask=loss_mask,
        rewards=np.array([1, 0, 0, 1, 1, 0, 1, 1], np.float32)[:B],
        logprobs=(-2.0 - rng.random((B, T)) * loss_mask).astype(np.float32),
        versions=np.where(loss_mask > 0, 0, -1).astype(np.int32),
    )


def _pair(jcls, tcls, jcfg, tcfg, jmodel):
    ft = (JaxFinetuneSpec(1, 16, 8), FinetuneSpec(1, 16, 8))
    j = jcls(jcfg)
    j.model_config = jmodel
    j.create_process_group(JaxParallelStrategy(data_parallel_size=8))
    j.initialize(None, ft[0])
    t = tcls(tcfg, device="cpu")
    t.model_config = tq.ModelConfig(**{f: getattr(jmodel, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "dtype", "param_dtype", "is_critic")},
        scan_layers=False)
    t.create_process_group()
    t.initialize(None, ft[1], params=params_from_numpy(jax.tree.map(np.asarray, j.params),
                                                        t.model_config))
    return j, t


def test_values_advantages_and_returns_match_jax(cpu_devices, tmp_path):
    argv = ["--config", YAML, f"cluster.fileroot={tmp_path}"]
    jconf, _ = j_cli.load_expr_config(argv, j_cli.PPOConfig)
    tconf, _ = t_cli.load_expr_config(argv, t_cli.PPOConfig)
    ja, ta = _pair(JaxPPOActor, TorchPPOActor, jconf.actor, tconf.actor,
                   j_smoke.smoke_model_config(dtype="float32", vocab_size=21))
    jc, tc = _pair(JaxPPOCritic, TorchPPOCritic, jconf.critic, tconf.critic,
                   j_smoke.smoke_model_config(dtype="float32", vocab_size=21, is_critic=True))
    jb, tb = _batch(), _batch()
    jb["prox_logp"], tb["prox_logp"] = ja.compute_logp(jb), ta.compute_logp(tb)
    jb["values"], tb["values"] = jc.compute_values(jb), tc.compute_values(tb)
    np.testing.assert_allclose(tb["values"], jb["values"], atol=1e-5)
    assert np.abs(tb["values"]).max() > 0.1
    ja.compute_advantages(jb)
    ta.compute_advantages(tb)
    for k in ("advantages", "returns", "loss_mask"):
        np.testing.assert_allclose(tb[k], np.asarray(jb[k]), atol=1e-5, err_msg=k)
    # GAE read the values: with values 0 the returns differ
    zero = dict(_batch(), prox_logp=tb["prox_logp"], values=np.zeros_like(tb["values"]))
    ta.compute_advantages(zero)
    assert np.abs(zero["returns"] - tb["returns"]).max() > 0.1
    ja.ppo_update(dict(jb))
    ta.ppo_update(dict(tb))
    # old values 1 above the current ones: every clip decision is far from
    # the tie that an unmoved critic's values sit on (where the last bit
    # of a differently packed forward decides it)
    jb["values"] = tb["values"] = tb["values"] + 1.0
    js, ts = jc.ppo_update(dict(jb)), tc.ppo_update(dict(tb))
    assert len(ts) == len(js)
    for a, b in zip(js, ts):
        for k in ("critic_loss", "critic_value_clip_ratio", "critic_n_mbs"):
            np.testing.assert_allclose(b[k], a[k], atol=1e-5, err_msg=k)
        np.testing.assert_allclose(b["critic_grad_norm"], a["critic_grad_norm"], rtol=1e-4)
    assert max(b["critic_value_clip_ratio"] for b in ts) > 0.1


def test_entry_point_two_steps(tmp_path):
    history = main(["--config", YAML, "total_train_steps=2", f"cluster.fileroot={tmp_path}"],
                   device="cpu")
    assert len(history) == 2
    for step, rec in enumerate(history):
        st, batch = rec["stats"][0], rec["batch"]
        assert np.isfinite(st["ppo_actor/loss"]) and np.isfinite(st["ppo_critic/critic_loss"])
        assert 0.0 <= st["ppo_critic/critic_value_clip_ratio"] <= 1.0
        assert st["ppo_critic/critic/throughput/n_tokens"] > 0
        assert not any(k.startswith("ppo_actor/critic") for k in st)
        for k in ("rollout", "critic_values", "compute_advantage",
                  "train_step", "critic_step", "update_weights"):
            assert st[f"timeperf/{k}"] >= 0
        assert batch["values"].shape == batch["input_ids"].shape
        assert np.abs(batch["values"]).max() > 0
        gen = batch["attention_mask"].astype(bool) & (batch["versions"] >= 0)
        assert 0 <= step - batch["versions"][gen].min() <= 2
    with pytest.raises(NotImplementedError, match="recover.mode=disabled"):
        main(["--config", YAML, "recover.mode=auto", f"cluster.fileroot={tmp_path}"],
             device="cpu")


def test_decoupled_step(tmp_path):
    from areal_tpu_torch.launcher.decode_server import DecodeServer
    from areal_tpu_torch.utils import name_resolve

    nr = f"{tmp_path}/nr"
    name_resolve.reconfigure(t_cli.NameResolveConfig(type="nfs", nfs_record_root=nr))
    srv = DecodeServer(t_cli.TorchDecodeConfig(**DECODE), device="cpu")
    mc = smoke_model_config(dtype="float32")
    srv.engine.set_model(tq.init_params(mc, torch.Generator().manual_seed(1)), mc)
    srv.start("127.0.0.1", 0)
    srv.register("arith-ppo-smoke", "run0", srv.addr)
    try:
        history = main(["--config", YAML, f"cluster.fileroot={tmp_path}",
                        "cluster.name_resolve.type=nfs",
                        f"cluster.name_resolve.nfs_record_root={nr}",
                        "allocation_mode=jax:d1t1+d1", "total_train_steps=1"], device="cpu")
        assert len(history) == 1 and srv.engine.get_version() == 1
        st = history[0]["stats"][0]
        assert np.isfinite(st["ppo_critic/critic_loss"])
    finally:
        srv.stop()
        name_resolve.reconfigure(t_cli.NameResolveConfig(type="memory"))
