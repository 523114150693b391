"""Trainer chaos on the CPU: `chip_smoke.chaos_train` (the port's
counterpart of `bench.py` chaostrain) on a tiny f32 model, and the GRPO
entry point killed by a configured fault and resumed.

`chaos_train` runs an unfaulted colocated GRPO loop as the oracle. Then
the kill legs (`recover.dump.save`, `recover.dump.marker`, `train.step`,
`train.weights.push`) run in a chain on a copy of the oracle's recovery
point of step 1: each is a trainer restarted from the newest committed
point and killed at step 2 by an `InjectedFault`, and the next leg's new
trainer and decode engine are its resume, the last the "resume" leg's,
which runs to the end. A last leg's newest committed step is torn (a
`recover.load` abort) and it resumes from its predecessor. Each kill leg
restarts at the committed step and version with the committed steps'
journal, and trains step 2 to the oracle's loss unless killed before the
update; the legs that run to the end hold one WAL entry per step with
every trajectory once, versions that never go back, and per-step losses
and final weights (sha256) equal to the oracle's bit for bit. The CPU
embedding backward adds from threads in no fixed order, so the test runs
under `torch.use_deterministic_algorithms` (the card's path needs no
switch). The launch counts are checked on the card only: the plain
versions do not count.

The same legs on the JAX package (its `JaxPPOActor`, `JaxDecodeEngine`,
`RecoverHandler`, `SampleWAL` and injector, under the same plans, on the
same tiny model and data) kill the same step, resume at the same step and
version, journal the same WAL entries and versions and train the same
micro-batches per leg as the port's.

The entry point: `fault_injection.enabled=true` with a `train.step` abort
stops the GRPO entry point with `InjectedFault`, and a rerun under
`recover.mode=auto` resumes after the last committed step.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from areal_tpu_torch.core import fault_injection
from areal_tpu_torch.core.fault_injection import InjectedFault
from areal_tpu_torch.examples.gsm8k_grpo import main
from areal_tpu_torch.models import qwen2 as tq

YAML = "examples/configs/arith_grpo_smoke.yaml"
TINY_KW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, dtype="float32",
               param_dtype="float32", tie_word_embeddings=True, scan_layers=False, remat=True)
TINY = tq.ModelConfig(**TINY_KW)
SIZES = dict(n_prompts=4, group=2, prompt_len=8, new_tokens=8, steps=4, mb_tokens=64,
             decode=dict(max_running_requests=8, context_length=64, page_size=16,
                         new_tokens_per_chunk=8))


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    fault_injection.deactivate()
    yield
    fault_injection.deactivate()


def test_chaos_train_legs_equal_the_oracle(tmp_path, deterministic):
    out = chip_smoke.chaos_train(torch.device("cpu"), TINY, str(tmp_path), sizes=SIZES)
    legs = {r["leg"]: r for r in out["legs"]}
    assert list(legs) == ["oracle", *chip_smoke.CHAOS_KILL_SITES, "resume",
                          "recover.load (newest torn)"]
    oracle = legs["oracle"]
    kill = chip_smoke.CHAOS_KILL_STEP
    for tag in ("oracle", "resume", "recover.load (newest torn)"):
        r = legs[tag]
        assert r["wal"] == dict(entries=4, versions=[0, 1, 2, 3], lost=0, duplicated=0), tag
        assert r["losses"] == oracle["losses"] and r["fingerprint"] == oracle["fingerprint"]
        assert r["mbs"]["train_mbs"] > 0 and r["mbs"]["decode_steps"] > 0, tag
    for site in chip_smoke.CHAOS_KILL_SITES:
        r = legs[site]
        assert r["crashed_at"] == r["resumed_at"] == r["resumed_version"] == kill, site
        assert r["wal_at_resume"] == dict(entries=kill, versions=[0, 1], lost=0, duplicated=0)
        assert r["loss_steps_differing"] == [] and "wal" not in r, site
    resume = legs["resume"]
    assert resume["resumed_at"] == resume["resumed_version"] == kill
    torn = legs["recover.load (newest torn)"]
    assert torn["resumed_at"] == 3 and torn["torn_skipped"] == 1
    # the torn leg replays only the last step, the resume steps 2-3
    per_step = oracle["mbs"]["train_mbs"] // 4
    assert torn["mbs"]["train_mbs"] == per_step and resume["mbs"]["train_mbs"] == 2 * per_step
    # a kill leg trains step 2 unless a train.step kill came before its
    # update; the dump kills and the push kill come after it
    assert [legs[s]["mbs"]["train_mbs"] for s in chip_smoke.CHAOS_KILL_SITES] == \
        [per_step, per_step, 0, per_step]
    assert [legs[s]["trained_steps"] for s in chip_smoke.CHAOS_KILL_SITES] == \
        [[2], [2], [], [2]]


def test_grpo_entry_point_killed_by_a_plan_then_resumed(tmp_path):
    base = ["--config", YAML, f"cluster.fileroot={tmp_path}", "evaluator.freq_steps=null",
            "recover.mode=auto", "recover.freq_steps=1", "total_train_steps=4"]
    # the yaml trains two minibatches a step: hit 2 is step 1's first
    plan = '[{"site": "train.step", "mode": "abort", "at": [2]}]'
    with pytest.raises(InjectedFault) as ei:
        main(base + ["rollout.fault_injection.enabled=true",
                     f"rollout.fault_injection.plan={plan}"], device="cpu")
    assert ei.value.site == "train.step"
    assert fault_injection.snapshot() == {"train.step|abort": 1}
    fault_injection.deactivate()
    root = tmp_path / "recover" / "arith-grpo-smoke" / "run0"
    assert sorted(n for n in os.listdir(root) if n.startswith("step-")) == ["step-0"]
    resumed = main(base, device="cpu")
    assert len(resumed) == 3  # global steps 1, 2 and 3
    assert sorted(n for n in os.listdir(root) if n.startswith("step-")) == ["step-2", "step-3"]


def _jax_chaos_legs(root: str, sizes: dict) -> dict:
    """`chip_smoke.chaos_train`'s legs on the JAX package: the oracle, the
    chain of kill legs on a copy of its recovery point of the step before
    the kill and the resume that ends it, and the torn-newest leg, each
    with the port leg's plan. Per leg: where it crashed and resumed, the
    resumed version, the WAL at the resume and (for a leg that ran to the
    end) at the end, and the micro-batches its `ppo_update`s trained."""
    from areal_tpu.api import cli_args as jc
    from areal_tpu.api.alloc_mode import ParallelStrategy
    from areal_tpu.api.io_struct import FinetuneSpec, StepInfo, WeightUpdateMeta
    from areal_tpu.core import fault_injection as jfi
    from areal_tpu.core.sample_ledger import SampleWAL
    from areal_tpu.dataset import SimpleDataLoader
    from areal_tpu.engine.jax_decode import JaxDecodeEngine
    from areal_tpu.engine.ppo.actor import JaxPPOActor
    from areal_tpu.models import qwen2 as jq
    from areal_tpu.utils import recover as jrec
    from areal_tpu.workflow.rlvr import RLVRWorkflow

    model = jq.ModelConfig(**TINY_KW)
    sz = dict(chip_smoke.CHAOS_TRAIN, **sizes)
    n_prompts, group, steps = sz["n_prompts"], sz["group"], sz["steps"]
    kill, samples = chip_smoke.CHAOS_KILL_STEP, n_prompts * group
    rng = np.random.RandomState(chip_smoke.SEED + 11)
    dataset = [dict(input_ids=rng.randint(1, model.vocab_size, (sz["prompt_len"],)).tolist())
               for _ in range(n_prompts * steps)]
    ft_spec = FinetuneSpec(1, len(dataset), samples)
    decode = dict(chip_smoke.CHAOS_DECODE, **sz["decode"])

    def trainer(fileroot, resume, plan=None, load_plan=None, snapshot=None):
        rcfg = jc.RecoverConfig(experiment_name="chip-smoke", trial_name="chaos",
                                fileroot=fileroot, mode="fault", freq_steps=1, keep_last=2)
        actor = JaxPPOActor(jc.PPOActorConfig(
            experiment_name="chip-smoke", trial_name="chaos", path="", init_from_scratch=True,
            dtype=model.dtype, gradient_checkpointing=model.remat,
            mb_spec=jc.MicroBatchSpec(max_tokens_per_mb=sz["mb_tokens"]),
            optimizer=jc.OptimizerConfig(lr=chip_smoke.CHAOS_LR, warmup_steps_proportion=0.0,
                                         lr_scheduler_type="constant", gradient_clipping=1.0,
                                         moment_dtype=model.dtype),
            group_size=group, ppo_n_minibatches=1, eps_clip=0.2, kl_ctl=0.0,
            adv_norm=jc.NormConfig(mean_level="batch", std_level="batch", group_size=group),
            use_decoupled_loss=True, temperature=1.0))
        actor.model_config = model
        # the 8 virtual CPU devices of the JAX tests, data parallel
        actor.create_process_group(ParallelStrategy(data_parallel_size=8))
        actor.initialize(None, ft_spec)
        rollout = JaxDecodeEngine(
            jc.JaxDecodeConfig(random_seed=chip_smoke.SEED, dtype=model.dtype,
                               kv_cache_dtype=model.dtype, **decode),
            jc.InferenceEngineConfig(max_concurrent_rollouts=samples * 2,
                                     consumer_batch_size=samples,
                                     max_head_offpolicyness=steps + 2, request_timeout=3600))
        rollout.set_model(actor.params, model)
        rollout.initialize()
        actor.connect_engine(rollout, WeightUpdateMeta.from_memory())
        rollout.attach_ledger_wal(jrec.ledger_wal_path(rcfg))
        workflow = RLVRWorkflow(chip_smoke.chaos_reward, jc.GenerationHyperparameters(
            n_samples=group, max_new_tokens=sz["new_tokens"], greedy=True))
        loader = SimpleDataLoader(dataset, batch_size=n_prompts, shuffle=False)
        handler = jrec.RecoverHandler(rcfg, ft_spec)
        out = dict(start=0, crashed_at=None, train_mbs=0)
        try:
            if resume:
                jfi.configure(load_plan)
                try:
                    info = handler.load(actor, dataloader=loader, inference_engine=rollout,
                                        weight_update_meta=WeightUpdateMeta.from_memory())
                finally:
                    jfi.deactivate()
                out.update(start=info.last_step_info.next().global_step,
                           resumed_version=actor.get_version(),
                           wal_at_resume=wal_of(SampleWAL(jrec.ledger_wal_path(rcfg)).replay()))
            data_iter = iter(loader)
            jfi.configure(plan)
            for g in range(out["start"], steps):
                try:
                    batch = chip_smoke._wave_rollout(rollout, next(data_iter), workflow, samples)
                    order = np.argsort(np.asarray(batch["rollout_id"]), kind="stable")
                    batch = {k: np.asarray(v)[order] for k, v in batch.items()}
                    batch["prox_logp"] = actor.compute_logp(batch)
                    actor.compute_advantages(batch)
                    out["train_mbs"] += int(chip_smoke._stat(actor.ppo_update(batch), "n_mbs"))
                    actor.set_version(g + 1)
                    rollout.pause()
                    actor.update_weights(None)
                    rollout.set_version(g + 1)
                    rollout.resume()
                except jfi.InjectedFault:
                    out["crashed_at"] = g
                    break
                before = jfi.snapshot()
                handler.dump(actor, StepInfo(epoch=0, epoch_step=g, global_step=g,
                                             steps_per_epoch=steps),
                             dataloader=loader, rollout=rollout)
                if jfi.snapshot() != before:
                    out["crashed_at"] = g
                    break
                if snapshot is not None and g == kill - 1:
                    chip_smoke._link_tree(fileroot, snapshot)
            out["wal"] = SampleWAL(jrec.ledger_wal_path(rcfg)).replay()
        finally:
            jfi.deactivate()
            rollout.destroy()
            actor.destroy()
        return out

    def wal_of(wal):
        rids = [r for e in wal for r in e["rids"]]
        return dict(entries=len(wal), versions=[e["version"] for e in wal],
                    lost=len(wal) * n_prompts - len(set(rids)),
                    duplicated=len(rids) - len(set(rids)))

    def row(res):
        out = dict(crashed_at=res["crashed_at"], resumed_at=res["start"],
                   resumed_version=res.get("resumed_version"),
                   wal_at_resume=res.get("wal_at_resume"), train_mbs=res["train_mbs"])
        if res["crashed_at"] is None:
            out["wal"] = wal_of(res["wal"])
        return out

    oracle_root, chain = os.path.join(root, "oracle"), os.path.join(root, "chain")
    oracle = trainer(oracle_root, False, snapshot=chain)
    legs = {"oracle": row(oracle)}
    for site in chip_smoke.CHAOS_KILL_SITES:
        legs[site] = row(trainer(chain, True, jfi.FaultPlan(seed=5, points=[
            jfi.FaultPoint(site=site, mode="abort", at=(0,), times=1)])))
    legs["resume"] = row(trainer(chain, True))
    jrec.reset_metrics()
    torn_plan = jfi.FaultPlan(seed=5, points=[jfi.FaultPoint(site="recover.load", mode="abort",
                                                             at=(0,), times=1)])
    legs["recover.load (newest torn)"] = dict(
        row(trainer(oracle_root, True, load_plan=torn_plan)),
        torn_skipped=jrec.get_metrics().get("recover_torn_skipped_total", 0))
    return legs


def test_chaos_train_legs_equal_jax(tmp_path, deterministic):
    """Each leg of the port's trainer chaos against the same leg on the JAX
    package: the step the seam kills, where the resume starts, the resumed
    version, the WAL's entries and versions (0 lost, 0 duplicated) and the
    micro-batches trained per leg, all equal."""
    port = chip_smoke.chaos_train(torch.device("cpu"), TINY, str(tmp_path / "port"), sizes=SIZES)
    jax_legs = _jax_chaos_legs(str(tmp_path / "jax"), SIZES)
    assert list(jax_legs) == [r["leg"] for r in port["legs"]]
    for r in port["legs"]:
        got = dict(crashed_at=r["crashed_at"], resumed_at=r["resumed_at"],
                   resumed_version=r["resumed_version"], wal_at_resume=r["wal_at_resume"],
                   train_mbs=r["mbs"]["train_mbs"])
        if "wal" in r:
            got["wal"] = r["wal"]
        if "torn_skipped" in r:
            got["torn_skipped"] = r["torn_skipped"]
        assert got == jax_legs[r["leg"]], r["leg"]
    assert jax_legs["train.step"]["crashed_at"] == chip_smoke.CHAOS_KILL_STEP
    assert jax_legs["recover.load (newest torn)"]["torn_skipped"] == 1
