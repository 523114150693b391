"""The port's GRPO loop on the CPU, at the smoke geometry.

- `prepare_batch` with greedy sampling on `TorchDecodeEngine` and on
  `JaxDecodeEngine`, the same weights (moved from JAX) and the same
  prompts: the rows, sorted by (prompt, completion), have equal tokens
  and masks, logprobs within 1e-5 (the tolerance of
  `test_torch_decode.py`), and equal rewards and version stamps.
- The port's entry point `main` for 2 steps on
  `examples/configs/arith_grpo_smoke.yaml` (as `test_examples_smoke.py`
  runs the JAX example).
- The learning check of `tests/test_grpo_learning.py` through the same
  `main` (the dense first-token reward, that test's settings as overrides
  of the yaml), and its lr=0 control, which must fail the check. The
  first update has lr 0 (a reference behaviour), so the check counts the
  rewards of 12 steps. The evaluation stays off: the yaml's would fire at
  step 9, inside the executor's pause, and wait out its deadline.
- Recovery through `main`: 2 steps with `recover.mode=auto` and a dump
  every step, then a resume to 4 steps in the same file root, which
  restores global step 1 and starts at step 2 with version 2 on both
  engines and the trainer's restored weights served bit for bit.
"""

import json
import logging
import time

import numpy as np
import pytest
import torch

import jax

from areal_tpu.api import cli_args as j_cli
from areal_tpu.dataset import SimpleDataLoader as JLoader
from areal_tpu.dataset import get_custom_dataset as j_dataset
from areal_tpu.dataset.arith import ArithTokenizer as JTok
from areal_tpu.dataset.arith import arith_reward_fn as j_reward
from areal_tpu.engine.jax_decode import JaxDecodeEngine
from areal_tpu.models import qwen2 as jq
from areal_tpu.workflow.rlvr import RLVRWorkflow as JRLVR
from areal_tpu_torch.api import cli_args as t_cli
from areal_tpu_torch.dataset import SimpleDataLoader as TLoader
from areal_tpu_torch.dataset import get_custom_dataset as t_dataset
from areal_tpu_torch.dataset.arith import ArithTokenizer as TTok
from areal_tpu_torch.dataset.arith import arith_reward_fn as t_reward
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.examples.gsm8k_grpo import main
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy
from areal_tpu_torch.models.smoke import SMOKE_MODEL_DICT, smoke_model_config
from areal_tpu_torch.workflow.rlvr import RLVRWorkflow as TRLVR

YAML = "examples/configs/arith_grpo_smoke.yaml"
KW = dict(SMOKE_MODEL_DICT, dtype="float32", param_dtype="float32")
DECODE = dict(context_length=64, max_running_requests=16, new_tokens_per_chunk=8,
              dtype="float32", kv_cache_dtype="float32")
# only the first batch is admitted at version 0: both engines serve the
# same episodes
ROLLOUT = dict(max_concurrent_rollouts=8, consumer_batch_size=4, max_head_offpolicyness=0)
LOGP_ATOL = 1e-5

TARGET_TOKEN = 16
LEARN = [
    "async_training=false", "gconfig.n_samples=8", "actor.group_size=8",
    "actor.adv_norm.group_size=8", "train_dataset.batch_size=8",
    "rollout.consumer_batch_size=8", "gconfig.max_new_tokens=2",
    "actor.ppo_n_minibatches=1", "total_train_steps=12", "evaluator.freq_steps=null",
]


def dense_reward(prompt, completion, prompt_ids, completion_ids, **kwargs):
    """Dense verifiable reward pulling the first generated token to 16
    (`tests/test_grpo_learning.py:49`)."""
    return 1.0 - abs(completion_ids[0] - TARGET_TOKEN) / 32.0


def _rows(batch):
    """(prompt, completion, logprobs, rest) per row, sorted by tokens."""
    rows = []
    for i in range(batch["input_ids"].shape[0]):
        n = int(batch["attention_mask"][i].sum())
        p = int(batch["begin_of_answer"][i])
        ids = batch["input_ids"][i, :n].tolist()
        rows.append((ids[:p], ids[p:], batch["logprobs"][i, :n],
                     dict(loss_mask=batch["loss_mask"][i, :n].tolist(),
                          versions=batch["versions"][i, :n].tolist(),
                          reward=float(batch["rewards"][i]),
                          rollout_version=int(batch["rollout_version"][i]))))
    return sorted(rows, key=lambda r: (r[0], r[1]))


def test_prepare_batch_matches_jax_engine(tmp_path):
    jparams = jq.init_params(jq.ModelConfig(**KW), jax.random.PRNGKey(3))
    tcfg = tq.ModelConfig(**KW)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    gj = j_cli.GenerationHyperparameters(n_samples=3, max_new_tokens=6, greedy=True,
                                         stop_token_ids=[2])
    gt = t_cli.GenerationHyperparameters(n_samples=3, max_new_tokens=6, greedy=True,
                                         stop_token_ids=[2])
    batches = {}
    jeng = JaxDecodeEngine(j_cli.JaxDecodeConfig(**DECODE), j_cli.InferenceEngineConfig(**ROLLOUT),
                           tokenizer=JTok())
    jeng.set_model(jparams, jq.ModelConfig(**KW))
    jeng.initialize()
    try:
        loader = JLoader(j_dataset("synthetic-arith", split="train"), batch_size=4, seed=1)
        batches["jax"] = jeng.prepare_batch(loader, workflow=JRLVR(j_reward, gj, tokenizer=JTok()))
    finally:
        jeng.destroy()
    teng = TorchDecodeEngine(t_cli.TorchDecodeConfig(**DECODE),
                             t_cli.InferenceEngineConfig(**ROLLOUT), tokenizer=TTok(), device="cpu")
    teng.set_model(tparams, tcfg)
    teng.initialize()
    try:
        loader = TLoader(t_dataset("synthetic-arith", split="train"), batch_size=4, seed=1)
        batches["torch"] = teng.prepare_batch(loader, workflow=TRLVR(t_reward, gt, tokenizer=TTok()))
        # the second batch waits at the staleness gate
        assert teng.state_dict()["staleness"]["submitted"] == 4
    finally:
        teng.destroy()
    assert sorted(batches["jax"]) == sorted(batches["torch"])
    assert batches["torch"]["input_ids"].shape[0] == 12
    assert sorted(batches["torch"]["rollout_id"].tolist()) == [0] * 3 + [1] * 3 + [2] * 3 + [3] * 3
    rj, rt = _rows(batches["jax"]), _rows(batches["torch"])
    for (pj, cj, lj, xj), (pt, ct, lt, xt) in zip(rj, rt):
        assert (pj, cj, xj) == (pt, ct, xt)
        np.testing.assert_allclose(lt, lj, atol=LOGP_ATOL, rtol=0)
    assert any(len(c) > 0 for _, c, _, _ in rt)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_entry_point_two_steps(tmp_path):
    """The yaml unchanged but for the step count and the run's paths; as
    `test_examples_smoke.py::test_grpo_example_smoke` checks the JAX
    example's output. Under the yaml's decoupled loss, step 0's trained
    batch pairs each token's decode-engine logprob (`logprobs`, rolled by
    `compute_advantages`) with the trainer's (`prox_logp`) at the same
    position, where the rolled loss mask marks it: both score the same
    token under the same weights (atol 1e-5), and a one-token shift
    does not."""
    records = _Records()
    log = logging.getLogger("areal_tpu_torch.stats_logger")
    log.addHandler(records)
    try:
        history = main(["--config", YAML, "total_train_steps=2", f"cluster.fileroot={tmp_path}",
                        "experiment_name=grpo-smoke-test"], device="cpu")
    finally:
        log.removeHandler(records)
    assert "grpo_actor/loss" in "\n".join(records.lines)
    assert len(history) == 2
    for step, rec in enumerate(history):
        st, batch = rec["stats"][0], rec["batch"]
        assert np.isfinite(st["grpo_actor/loss"])
        for k in ("rollout", "recompute_logp", "compute_advantage", "train_step",
                  "update_weights"):
            assert st[f"timeperf/{k}"] >= 0
        assert batch["input_ids"].shape[0] == 16  # 4 prompts x 4 samples
        assert batch["rollout_version"].max() <= step
        gen = batch["attention_mask"].astype(bool) & (batch["versions"] >= 0)
        assert 0 <= step - batch["versions"][gen].min() <= 2
    b0 = history[0]["batch"]
    trained = b0["loss_mask"] > 0
    assert trained.any()
    np.testing.assert_allclose(b0["logprobs"][trained], b0["prox_logp"][trained],
                               atol=1e-5, rtol=0)
    for shift in (1, -1):
        moved = np.roll(b0["prox_logp"], shift, axis=-1)[trained]
        assert np.abs(b0["logprobs"][trained] - moved).mean() > 0.1
    assert (tmp_path / "logs" / "grpo-smoke-test" / "run0" / "config.yaml").exists()


def _learn(lr: float, tmp_path) -> list[float]:
    history = main(["--config", YAML, *LEARN, f"actor.optimizer.lr={lr}",
                    f"cluster.fileroot={tmp_path}", f"experiment_name=learn{lr}"],
                   reward_fn=dense_reward, device="cpu")
    return [float(np.mean(rec["batch"]["rewards"])) for rec in history]


def _learned(rewards: list[float]) -> bool:
    start, end = float(np.mean(rewards[:3])), float(np.mean(rewards[-3:]))
    return end - start > 0.05 and end > 0.9


def test_grpo_learns_dense_reward(tmp_path):
    rewards = _learn(3e-2, tmp_path)
    assert len(rewards) == 12
    assert _learned(rewards), f"no learning: {rewards}"


def test_grpo_lr_zero_does_not_learn(tmp_path):
    rewards = _learn(0.0, tmp_path)
    assert not _learned(rewards), f"lr=0 run 'learned': {rewards}"


def _smoke_server(nfs_root: str):
    """The port's decode server in this process on the CPU, serving the
    smoke model, registered under the yaml's names in an nfs store."""
    from areal_tpu_torch.launcher.decode_server import DecodeServer
    from areal_tpu_torch.utils import name_resolve

    name_resolve.reconfigure(t_cli.NameResolveConfig(type="nfs", nfs_record_root=nfs_root))
    cfg = t_cli.TorchDecodeConfig(**{**DECODE, "new_tokens_per_chunk": 8})
    srv = DecodeServer(cfg, device="cpu")
    mc = smoke_model_config(dtype="float32")
    srv.engine.set_model(tq.init_params(mc, torch.Generator().manual_seed(1)), mc)
    srv.start("127.0.0.1", 0)
    srv.register("arith-grpo-smoke", "run0", srv.addr)
    return srv


def test_entry_point_refusals(tmp_path):
    """The DECOUPLED branch runs against a decode server (one device per
    side), and through a registered fleet router (item 4.2) when there is
    one; `launcher.supervisor.enabled` is accepted (the supervisor runs as
    its own process). More than one device is item 5, prefill replicas
    item 4.1 (they need more than one generation server). The vision
    workflow is one of the entry point's workflows, and the vision
    datasets have JAX's rewards (`tests/test_torch_vision.py` runs
    `clevr_grpo.py`)."""
    from areal_tpu_torch.api.cli_args import RouterConfig
    from areal_tpu_torch.launcher.router import DecodeRouter
    from areal_tpu_torch.utils import name_resolve, names

    base = ["--config", YAML, f"cluster.fileroot={tmp_path}"]
    nfs = ["cluster.name_resolve.type=nfs", f"cluster.name_resolve.nfs_record_root={tmp_path}/nr"]
    srv = _smoke_server(f"{tmp_path}/nr")
    try:
        history = main(base + nfs + ["allocation_mode=jax:d1t1+d1", "total_train_steps=2",
                                     "evaluator.freq_steps=null"], device="cpu")
        assert len(history) == 2 and srv.engine.get_version() == 2
        for step, rec in enumerate(history):
            batch = rec["batch"]
            gen = batch["attention_mask"].astype(bool) & (batch["versions"] >= 0)
            assert 0 <= step - batch["versions"][gen].min() <= 2
        with pytest.raises(NotImplementedError, match="item 5"):
            main(base + nfs + ["allocation_mode=jax:d2t1+d1"], device="cpu")
        with pytest.raises(NotImplementedError, match="item 4.1"):
            main(base + nfs + ["allocation_mode=jax:d1t1+d1", "launcher.prefill_replicas=1"],
                 device="cpu")
        # a registered router places every generation, and the supervisor
        # switch is accepted
        router = DecodeRouter("arith-grpo-smoke", "run0",
                              config=RouterConfig(health_poll_interval=0.2))
        router.start("127.0.0.1", 0)
        try:
            time.sleep(0.5)
            history = main(base + nfs + ["allocation_mode=jax:d1t1+d1", "total_train_steps=1",
                                         "evaluator.freq_steps=null",
                                         "launcher.supervisor.enabled=true"], device="cpu")
            # rollouts still in flight when the step ends are cancelled at
            # shutdown; their `/finish_request`s may land a moment after
            # `main` returns (the runner's join waits 5 s)
            deadline = time.monotonic() + 30
            while router._metrics()["tracked_qids"] and time.monotonic() < deadline:
                time.sleep(0.05)
            m = router._metrics()
        finally:
            router.stop()
        assert len(history) == 1
        assert m["servers"] == [srv.addr] and m["schedules_total"] > 0
        assert m["tracked_qids"] == 0  # every placement released
    finally:
        srv.stop()
        name_resolve.reconfigure(t_cli.NameResolveConfig(type="memory"))
    from areal_tpu_torch.examples.gsm8k_grpo import WORKFLOWS, pick_reward_fn
    from areal_tpu_torch.reward import vqa

    assert "vision_rlvr" in WORKFLOWS
    with pytest.raises(ValueError, match="workflow"):
        main(base + ["workflow=nope"], device="cpu")
    for path, fn in (("clevr_count_70k", vqa.clevr_count_reward),
                     ("/data/geometry3k", vqa.geometry3k_reward),
                     ("synthetic-vision", vqa.synthetic_vision_reward)):
        assert pick_reward_fn(path) is fn
    with pytest.raises(ValueError, match="vocab is fixed at 32"):
        smoke_model_config(vocab_size=33)
    assert smoke_model_config(vocab_size=21).vocab_size == 32


def test_reference_policy_from_a_checkpoint(tmp_path, monkeypatch):
    """`actor.path` and `ref.path` at one HF checkpoint of the smoke
    model, `actor.kl_ctl=0.1`, 2 steps: the actor and the frozen reference
    load the same weights, so step 0's `ref_logp` equals the actor's
    recomputed logp (atol 1e-6); each step's KL-shaped rewards, total
    rewards and advantages equal what the JAX `PPOActor` computes from the
    same batch (atol 1e-5), and after step 0's second minibatch (the
    first has lr 0) the actor has moved off the reference."""
    from areal_tpu.engine.ppo.actor import PPOActor as JaxPPOActorCore
    from areal_tpu_torch.engine.ppo.actor import PPOActor
    from areal_tpu_torch.models import hf_io

    mc = smoke_model_config(dtype="float32")
    ckpt = tmp_path / "ckpt"
    hf_io.save_hf_params(tq.init_params(mc, torch.Generator().manual_seed(5)), mc, str(ckpt))
    (ckpt / "config.json").write_text(json.dumps(dict(
        model_type="qwen2", **SMOKE_MODEL_DICT, rope_theta=mc.rope_theta,
        rms_norm_eps=mc.rms_norm_eps, max_position_embeddings=mc.max_position_embeddings,
        tie_word_embeddings=False, torch_dtype="float32")))
    argv = ["--config", YAML, f"cluster.fileroot={tmp_path}", "total_train_steps=2",
            "evaluator.freq_steps=null", f"actor.path={ckpt}", "actor.init_from_scratch=false",
            f"ref.path={ckpt}", "actor.kl_ctl=0.1"]
    jconf, _ = j_cli.load_expr_config(argv, j_cli.GRPOConfig)
    before = []
    compute = PPOActor.compute_advantages

    def compute_advantages(self, data):
        before.append({k: np.array(v, copy=True) for k, v in data.items()})
        compute(self, data)

    monkeypatch.setattr(PPOActor, "compute_advantages", compute_advantages)
    history = main(argv, device="cpu")
    assert len(history) == len(before) == 2
    b0 = before[0]
    mask = np.roll(b0["loss_mask"], -1, axis=-1) > 0
    assert mask.any()
    np.testing.assert_allclose(b0["ref_logp"][mask], b0["prox_logp"][mask], atol=1e-6, rtol=0)
    for step, (pre, rec) in enumerate(zip(before, history)):
        jb = dict(pre)
        JaxPPOActorCore(jconf.actor, None).compute_advantages(jb)
        for k in ("kl_rewards", "tot_rewards", "advantages", "returns"):
            np.testing.assert_allclose(rec["batch"][k], np.asarray(jb[k]), atol=1e-5, rtol=0,
                                       err_msg=f"step {step}: {k}")
    pre1 = before[1]
    m1 = np.roll(pre1["loss_mask"], -1, axis=-1) > 0
    assert np.abs(pre1["ref_logp"][m1] - pre1["prox_logp"][m1]).max() > 1e-4
    assert np.abs(history[1]["batch"]["kl_rewards"]).max() > 0


def test_recover_resumes_at_step_two(tmp_path, monkeypatch):
    from areal_tpu_torch.utils.recover import RecoverHandler

    seen = []
    load = RecoverHandler.load

    def load_(self, engine, *args, inference_engine=None, **kwargs):
        info = load(self, engine, *args, inference_engine=inference_engine, **kwargs)
        if info is not None:
            served = inference_engine.params
            seen.append(dict(
                step=info.last_step_info.global_step, trainer=engine.get_version(),
                decode=inference_engine.get_version(),
                equal=all(torch.equal(v, served[k]) for k, v in engine.params.items())))
        return info

    monkeypatch.setattr(RecoverHandler, "load", load_)
    base = ["--config", YAML, f"cluster.fileroot={tmp_path}", "evaluator.freq_steps=null",
            "recover.mode=auto", "recover.freq_steps=1"]
    first = main(base + ["total_train_steps=2"], device="cpu")
    assert len(first) == 2 and not seen
    assert (tmp_path / "recover" / "arith-grpo-smoke" / "run0" / "step-1").is_dir()
    resumed = main(base + ["total_train_steps=4"], device="cpu")
    assert seen == [dict(step=1, trainer=2, decode=2, equal=True)]
    assert len(resumed) == 2  # global steps 2 and 3
    for step, rec in enumerate(resumed, start=2):
        batch = rec["batch"]
        gen = batch["attention_mask"].astype(bool) & (batch["versions"] >= 0)
        assert 0 <= step - batch["versions"][gen].min() <= 2
