"""Async GRPO on one CUDA card: the port's GRPO entry point (counterpart
of `examples/gsm8k_grpo.py`).

The trainer (`TorchPPOActor`) recomputes logprobs, computes advantages and
takes the decoupled-PPO update while a `WorkflowExecutor` runs episodes
behind the staleness gate; then the weights are pushed and the version
goes up. `workflow` picks the episode: "rlvr" (`workflow/rlvr.py`, a
group of `n_samples` answers per prompt) or "multi_turn"
(`workflow/multi_turn.py`: a wrong answer gets feedback and another try,
up to `max_turns`, the reward discounted by `turn_discount` per extra
turn) or "tir" (`workflow/tir.py`: ```python blocks run in a sandbox
mid-generation and their output is spliced back as context, up to
`max_tool_calls` per sample); "vision_rlvr" is refused (ROADMAP queue 1,
item 6).
`allocation_mode` says where rollouts decode:

- empty (COLOCATE): a `TorchDecodeEngine` in process on the trainer's
  card; weights go to it in memory.
- `jax:d1+d1` (DECOUPLED_TRAIN): a decode server
  (`launcher/decode_server.py`) the local launcher started, found through
  name_resolve; the trainer talks to it through `RemoteInfEngine`, and
  weights go over the staged HTTP push (`WeightUpdateMeta(type="dcn")`).

Usage, from the repository root:

  python -m areal_tpu_torch.examples.gsm8k_grpo \\
      --config examples/configs/arith_grpo_smoke.yaml [key=value ...]

  python -m areal_tpu_torch.launcher.local \\
      areal_tpu_torch/examples/gsm8k_grpo.py \\
      --config examples/configs/arith_grpo_smoke.yaml allocation_mode=jax:d1+d1

Override any config field with key=value, e.g. `actor.optimizer.lr=1e-5`.
With `actor.path` (and `actor.init_from_scratch=false`) the actor loads
that HF checkpoint, its model config from its `config.json`; with
`actor.kl_ctl > 0` and `ref.path`, a frozen reference policy loads
`ref.path` and its `compute_logp` gives each step's `ref_logp`.
It runs on `cuda:0`. From Python, `main([...], device="cpu")` runs the
same loop on the CPU with the kernels' plain versions (a decoupled run
also needs its server started with `--device cpu`).

As in the JAX example, the evaluation runs between `rollout.pause()` and
`rollout.resume()`, where the executor admits nothing, so the first step
at which `evaluator` fires waits out the executor's deadline and raises
`TimeoutError` (a reference behaviour; ROADMAP queue 3).
"""

from __future__ import annotations

import os
import sys
from typing import Any, Callable

from areal_tpu_torch.api.alloc_mode import AllocationMode, AllocationType
from areal_tpu_torch.api.cli_args import GRPOConfig, load_expr_config, save_config
from areal_tpu_torch.api.io_struct import FinetuneSpec, StepInfo, WeightUpdateMeta
from areal_tpu_torch.core import fault_injection
from areal_tpu_torch.dataset import SimpleDataLoader, get_custom_dataset, load_tokenizer
from areal_tpu_torch.engine.ppo.actor import TorchPPOActor
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.models.qwen2 import ModelConfig
from areal_tpu_torch.utils import name_resolve, seeding, stats_tracker
from areal_tpu_torch.utils.evaluator import Evaluator
from areal_tpu_torch.utils.recover import RecoverHandler, ledger_wal_path
from areal_tpu_torch.utils.saver import Saver
from areal_tpu_torch.utils.stats_logger import StatsLogger
from areal_tpu_torch.workflow.multi_turn import MultiTurnWorkflow
from areal_tpu_torch.workflow.rlvr import RLVRWorkflow
from areal_tpu_torch.workflow.tir import TIRWorkflow

WORKFLOWS = ("rlvr", "multi_turn", "vision_rlvr", "tir")


def gsm8k_reward_fn(prompt, completion, prompt_ids, completion_ids, **data):
    from areal_tpu_torch.reward.math_parser import math_verify_reward

    return math_verify_reward(prompt, completion, prompt_ids, completion_ids, **data)


def pick_reward_fn(dataset_path: str):
    """The dataset's reward (JAX :52-82): `countdown` and `synthetic-arith`
    their own, the vision datasets refused (ROADMAP.md queue 1, item 6),
    any other name the math grader."""
    name = dataset_path.split("/")[-1].lower()
    if name == "countdown":
        from areal_tpu_torch.reward.countdown import countdown_reward

        return countdown_reward
    if name == "synthetic-arith":
        from areal_tpu_torch.dataset.arith import arith_reward_fn

        return arith_reward_fn
    if name in ("clevr_count_70k", "geometry3k", "synthetic-vision"):
        raise NotImplementedError(
            f"the reward function of dataset {dataset_path!r} is not in the PyTorch "
            "port yet: ROADMAP.md queue 1, item 6"
        )
    return gsm8k_reward_fn


def check_allocation(allocation_mode: str) -> AllocationMode:
    """COLOCATE (the decode engine in process) or DECOUPLED_TRAIN (one
    decode server); `AllocationMode.from_str` refuses more than one device
    per side (ROADMAP.md queue 1, item 5)."""
    return AllocationMode.from_str(allocation_mode)


def build_rollout(config: GRPOConfig, alloc: AllocationMode, actor: TorchPPOActor, tokenizer,
                  device):
    """DECOUPLED: the HTTP client over the launcher's decode server, dcn
    weight pushes (JAX `examples/gsm8k_grpo.py:84-100`). COLOCATE: the
    decode engine on the trainer's card, memory weight pushes; an enabled
    `rollout.fault_injection` arms the process's injector in both (the
    client does it at construction)."""
    if alloc.type_ == AllocationType.DECOUPLED_TRAIN:
        from areal_tpu_torch.core.remote_inf_engine import JaxDecodeBackend, RemoteInfEngine

        # the store the launcher and the servers share
        name_resolve.reconfigure(config.cluster.name_resolve)
        rollout = RemoteInfEngine(config.rollout, JaxDecodeBackend(), tokenizer=tokenizer)
        rollout.initialize(train_data_parallel_size=1)
        return rollout, WeightUpdateMeta(type="dcn")
    # no remote client arms `rollout.fault_injection` here (JAX's colocated
    # run leaves it unarmed), so the entry point does
    fault_injection.configure_from_config(config.rollout.fault_injection)
    rollout = TorchDecodeEngine(config.decode, config.rollout, tokenizer=tokenizer,
                                device=device)
    rollout.set_model(actor.params, actor.model_config)
    rollout.initialize()
    return rollout, WeightUpdateMeta.from_memory(alloc)


def main(
    argv: list[str],
    model_config: ModelConfig | None = None,
    reward_fn: Callable[..., float] | None = None,
    device: Any = None,
) -> list[dict[str, Any]]:
    """Run the loop of `argv` (`--config file.yaml key=value ...`).

    `model_config` replaces the default model (the HF checkpoint's
    config at `actor.path`, the smoke decoder when it is empty),
    `reward_fn` the dataset's reward, and `device`
    the card (`"cpu"` runs the plain versions). Returns one record per
    step: the stats it committed (`stats`) and the batch it trained on
    (`batch`)."""
    config, _ = load_expr_config(argv, GRPOConfig)
    config: GRPOConfig
    config.check_supported()

    rank = 0
    seeding.set_random_seed(config.seed, key=f"trainer{rank}")
    tokenizer = load_tokenizer(config.tokenizer_path)
    alloc = check_allocation(config.allocation_mode)
    if config.workflow not in WORKFLOWS:
        raise ValueError(f"workflow={config.workflow!r} not in {WORKFLOWS}")
    if config.workflow == "vision_rlvr":
        raise NotImplementedError(
            f"workflow={config.workflow!r} is not in the PyTorch port yet: "
            "ROADMAP.md queue 1, item 6"
        )

    actor = TorchPPOActor(config.actor, device=device)
    if model_config is not None:
        actor.model_config = model_config
    elif not config.actor.path:
        # offline smoke mode: the canonical tiny from-scratch decoder
        from areal_tpu_torch.models.smoke import smoke_model_config

        actor.model_config = smoke_model_config(
            dtype=config.actor.dtype,
            vocab_size=getattr(tokenizer, "vocab_size", None),
        )
    actor.create_process_group()

    valid_cfg = config.valid_dataset or config.train_dataset
    train_dataset = get_custom_dataset(
        path=config.train_dataset.path,
        split="train",
        type=config.train_dataset.type or "rl",
        tokenizer=tokenizer,
        max_length=config.train_dataset.max_length,
    )
    valid_dataset = get_custom_dataset(
        path=valid_cfg.path,
        split="test",
        type=valid_cfg.type or "rl",
        tokenizer=tokenizer,
        max_length=valid_cfg.max_length,
    )
    train_dataloader = SimpleDataLoader(
        train_dataset,
        batch_size=config.train_dataset.batch_size,
        shuffle=config.train_dataset.shuffle,
        seed=config.seed,
        drop_last=config.train_dataset.drop_last,
    )
    valid_dataloader = SimpleDataLoader(
        valid_dataset, batch_size=valid_cfg.batch_size, shuffle=False
    )
    steps_per_epoch = len(train_dataloader)
    ft_spec = FinetuneSpec(
        total_train_epochs=config.total_train_epochs,
        dataset_size=steps_per_epoch * config.train_dataset.batch_size,
        train_batch_size=config.train_dataset.batch_size,
    )
    actor.initialize(None, ft_spec)

    rollout, weight_update_meta = build_rollout(config, alloc, actor, tokenizer, device)
    ref = None
    try:
        actor.connect_engine(rollout, weight_update_meta)

        if config.actor.kl_ctl > 0 and config.ref is not None and config.ref.path:
            ref = TorchPPOActor(config.ref, device=device)
            ref.model_config = actor.model_config
            ref.create_process_group()
            ref.initialize(None, ft_spec)

        if reward_fn is None:
            reward_fn = pick_reward_fn(config.train_dataset.path)
        if getattr(tokenizer, "eos_token_id", None) is not None:
            if tokenizer.eos_token_id not in config.gconfig.stop_token_ids:
                config.gconfig.stop_token_ids.append(tokenizer.eos_token_id)

        def make_workflow(gconfig, dump_dir=None):
            if config.workflow == "multi_turn":
                # the self-correction loop: a wrong answer gets a feedback
                # prompt and a retry, rewards discounted per extra turn
                return MultiTurnWorkflow(
                    reward_fn=reward_fn,
                    gconfig=gconfig,
                    tokenizer=tokenizer,
                    max_turns=config.max_turns,
                    turn_discount=config.turn_discount,
                    dump_dir=dump_dir,
                )
            if config.workflow == "tir":
                # tool-integrated reasoning: ```python blocks run in a
                # sandbox mid-generation (JAX :241-252)
                return TIRWorkflow(
                    reward_fn=reward_fn,
                    gconfig=gconfig,
                    tokenizer=tokenizer,
                    max_tool_calls=config.max_tool_calls,
                    tool_timeout_seconds=config.tool_timeout_seconds,
                    dump_dir=dump_dir,
                )
            return RLVRWorkflow(
                reward_fn=reward_fn,
                gconfig=gconfig,
                tokenizer=tokenizer,
                dump_dir=dump_dir,
            )

        workflow = make_workflow(
            config.gconfig,
            dump_dir=os.path.join(StatsLogger.get_log_path(config.stats_logger), "generated"),
        )
        eval_workflow = make_workflow(config.gconfig.new(temperature=0.6))

        saver = Saver(config.saver, ft_spec)
        stats_logger = StatsLogger(config.stats_logger, ft_spec)
        evaluator = Evaluator(config.evaluator, ft_spec)
        recover_handler = RecoverHandler(config.recover, ft_spec)
        # exactly-once sample accounting: journal consumed batches to a WAL
        # colocated with the recovery state
        rollout.attach_ledger_wal(ledger_wal_path(config.recover))
        recover_info = recover_handler.load(
            actor,
            saver,
            evaluator,
            train_dataloader,
            inference_engine=rollout,
            weight_update_meta=weight_update_meta,
        )
        start_step = (
            recover_info.last_step_info.next().global_step
            if recover_info is not None
            else 0
        )
        if rank == 0:
            save_config(config, StatsLogger.get_log_path(config.stats_logger))

        max_steps = config.total_train_steps or (
            config.total_train_epochs * steps_per_epoch
        )

        history = []
        for global_step in range(start_step, max_steps):
            epoch = global_step // steps_per_epoch
            step = global_step % steps_per_epoch
            step_info = StepInfo(
                global_step=global_step,
                epoch=epoch,
                epoch_step=step,
                steps_per_epoch=steps_per_epoch,
            )

            with stats_tracker.record_timing("rollout"):
                if config.async_training:
                    batch = rollout.prepare_batch(train_dataloader, workflow=workflow)
                else:
                    batch = rollout.rollout_batch(
                        next(iter(train_dataloader)), workflow=workflow
                    )

            if config.actor.recompute_logprob or config.actor.use_decoupled_loss:
                with stats_tracker.record_timing("recompute_logp"):
                    batch["prox_logp"] = actor.compute_logp(batch)

            if ref is not None:
                with stats_tracker.record_timing("ref_logp"):
                    batch["ref_logp"] = ref.compute_logp(batch)

            with stats_tracker.record_timing("compute_advantage"):
                actor.compute_advantages(batch)

            with (
                stats_tracker.record_timing("train_step"),
                stats_tracker.scope("grpo_actor"),
            ):
                stats = actor.ppo_update(batch)

            rollout.pause()
            with stats_tracker.record_timing("update_weights"):
                actor.set_version(global_step + 1)
                actor.update_weights(weight_update_meta)
                rollout.set_version(global_step + 1)

            with stats_tracker.record_timing("save"):
                saver.save(actor, epoch, step, global_step, tokenizer=tokenizer)

            with stats_tracker.record_timing("checkpoint_for_recover"):
                recover_handler.dump(
                    actor,
                    step_info,
                    saver,
                    evaluator,
                    train_dataloader,
                    tokenizer=tokenizer,
                    rollout=rollout,
                )

            with stats_tracker.record_timing("eval"):

                def evaluate_fn():
                    cnt = 0
                    for items in valid_dataloader:
                        for item in items:
                            rollout.submit(item, eval_workflow)
                            cnt += 1
                    rollout.wait(cnt, timeout=None)

                evaluator.evaluate(evaluate_fn, epoch, step, global_step)

            stats[0].update(stats_tracker.export_all())
            stats_logger.commit(epoch, step, global_step, stats)
            history.append(dict(stats=stats, batch=batch))
            rollout.resume()
        stats_logger.close()
    finally:
        rollout.destroy()
        if ref is not None:
            ref.destroy()
        actor.destroy()
    return history


if __name__ == "__main__":
    from areal_tpu_torch.utils.experiment import run_with_status

    run_with_status(main, sys.argv[1:])
