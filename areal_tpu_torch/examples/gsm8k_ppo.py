"""PPO with a critic on one CUDA card: the port's PPO entry point
(counterpart of `examples/gsm8k_ppo.py`).

The loop of the GRPO entry point (`examples/gsm8k_grpo.py`, whose
`build_rollout`, `load_tokenizer` and `pick_reward_fn` it reuses, the
DECOUPLED branch included) with a critic: each step a `TorchPPOCritic`
computes per-token values before the advantage pass, so GAE reads them in
place of a group baseline, and takes its own update after the actor's.

Usage, from the repository root:

  python -m areal_tpu_torch.examples.gsm8k_ppo \\
      --config examples/configs/arith_ppo_smoke.yaml [key=value ...]

`critic.*` keys configure the value model (the smoke decoder with a value
head when `critic.path` is empty). It runs on `cuda:0`. From Python,
`main([...], device="cpu")` runs the same loop on the CPU with the
kernels' plain versions. A recovery point would cover the actor only, so
`recover.mode` other than "disabled" is refused, as in the JAX example.
"""

from __future__ import annotations

import sys
from typing import Any, Callable

from areal_tpu_torch.api.cli_args import PPOConfig, load_expr_config, save_config
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.dataset import SimpleDataLoader, get_custom_dataset, load_tokenizer
from areal_tpu_torch.engine.ppo.actor import TorchPPOActor
from areal_tpu_torch.engine.ppo.critic import TorchPPOCritic
from areal_tpu_torch.examples.gsm8k_grpo import build_rollout, check_allocation, pick_reward_fn
from areal_tpu_torch.models.qwen2 import ModelConfig
from areal_tpu_torch.utils import seeding, stats_tracker
from areal_tpu_torch.utils.saver import Saver
from areal_tpu_torch.utils.stats_logger import StatsLogger
from areal_tpu_torch.workflow.rlvr import RLVRWorkflow


def main(
    argv: list[str],
    model_config: ModelConfig | None = None,
    critic_model_config: ModelConfig | None = None,
    reward_fn: Callable[..., float] | None = None,
    device: Any = None,
) -> list[dict[str, Any]]:
    """Run the PPO loop of `argv` (`--config file.yaml key=value ...`).

    `model_config` and `critic_model_config` replace the actor's and the
    critic's default models (the smoke decoder, with a value head for the
    critic, when the path is empty), `reward_fn` the dataset's reward, and
    `device` the card (`"cpu"` runs the plain versions). Returns one
    record per step: the stats it committed (`stats`) and the batch it
    trained on (`batch`, with the critic's `values`)."""
    config, _ = load_expr_config(argv, PPOConfig)
    config: PPOConfig
    config.check_supported()
    # RecoverHandler checkpoints one engine per recovery root: restoring the
    # actor beside a fresh critic would corrupt GAE's baselines
    if config.recover.mode != "disabled":
        raise NotImplementedError(
            "gsm8k_ppo does not support recover yet: the recover checkpoint "
            "covers the actor only and a restored run would pair it with a "
            "fresh critic; set recover.mode=disabled"
        )

    rank = 0
    seeding.set_random_seed(config.seed, key=f"trainer{rank}")
    tokenizer = load_tokenizer(config.tokenizer_path)
    alloc = check_allocation(config.allocation_mode)

    from areal_tpu_torch.models.smoke import smoke_model_config

    vocab = getattr(tokenizer, "vocab_size", None)
    actor = TorchPPOActor(config.actor, device=device)
    critic = TorchPPOCritic(config.critic, device=device)
    if model_config is not None:
        actor.model_config = model_config
    elif not config.actor.path:
        actor.model_config = smoke_model_config(dtype=config.actor.dtype, vocab_size=vocab)
    if critic_model_config is not None:
        critic.model_config = critic_model_config
    elif not config.critic.path:
        critic.model_config = smoke_model_config(dtype=config.critic.dtype, vocab_size=vocab,
                                                 is_critic=True)
    actor.create_process_group()
    critic.create_process_group()

    train_dataset = get_custom_dataset(
        path=config.train_dataset.path,
        split="train",
        type=config.train_dataset.type or "rl",
        tokenizer=tokenizer,
        max_length=config.train_dataset.max_length,
    )
    train_dataloader = SimpleDataLoader(
        train_dataset,
        batch_size=config.train_dataset.batch_size,
        shuffle=config.train_dataset.shuffle,
        seed=config.seed,
    )
    steps_per_epoch = len(train_dataloader)
    ft_spec = FinetuneSpec(
        total_train_epochs=config.total_train_epochs,
        dataset_size=steps_per_epoch * config.train_dataset.batch_size,
        train_batch_size=config.train_dataset.batch_size,
    )
    actor.initialize(None, ft_spec)
    critic.initialize(None, ft_spec)

    rollout, weight_update_meta = build_rollout(config, alloc, actor, tokenizer, device)
    try:
        actor.connect_engine(rollout, weight_update_meta)

        if reward_fn is None:
            reward_fn = pick_reward_fn(config.train_dataset.path)
        if getattr(tokenizer, "eos_token_id", None) is not None:
            if tokenizer.eos_token_id not in config.gconfig.stop_token_ids:
                config.gconfig.stop_token_ids.append(tokenizer.eos_token_id)
        workflow = RLVRWorkflow(reward_fn=reward_fn, gconfig=config.gconfig, tokenizer=tokenizer)

        saver = Saver(config.saver, ft_spec)
        critic_saver = Saver(config.saver, ft_spec)
        stats_logger = StatsLogger(config.stats_logger, ft_spec)
        if rank == 0:
            save_config(config, StatsLogger.get_log_path(config.stats_logger))
        max_steps = config.total_train_steps or (config.total_train_epochs * steps_per_epoch)

        history = []
        for global_step in range(max_steps):
            epoch = global_step // steps_per_epoch
            step = global_step % steps_per_epoch

            with stats_tracker.record_timing("rollout"):
                batch = rollout.prepare_batch(train_dataloader, workflow=workflow)

            if config.actor.recompute_logprob or config.actor.use_decoupled_loss:
                with stats_tracker.record_timing("recompute_logp"):
                    batch["prox_logp"] = actor.compute_logp(batch)

            with stats_tracker.record_timing("critic_values"):
                batch["values"] = critic.compute_values(batch)

            with stats_tracker.record_timing("compute_advantage"):
                actor.compute_advantages(batch)

            with (
                stats_tracker.record_timing("train_step"),
                stats_tracker.scope("ppo_actor"),
            ):
                stats = actor.ppo_update(batch)

            with (
                stats_tracker.record_timing("critic_step"),
                stats_tracker.scope("ppo_critic"),
            ):
                critic_stats = critic.ppo_update(batch)
                stats[0].update(critic_stats[0])

            rollout.pause()
            with stats_tracker.record_timing("update_weights"):
                actor.set_version(global_step + 1)
                actor.update_weights(weight_update_meta)
                rollout.set_version(global_step + 1)
                critic.set_version(global_step + 1)

            saver.save(actor, epoch, step, global_step, tokenizer=tokenizer)
            critic_saver.save(critic, epoch, step, global_step, name="critic",
                              tokenizer=tokenizer)
            stats[0].update(stats_tracker.export_all())
            stats_logger.commit(epoch, step, global_step, stats)
            history.append(dict(stats=stats, batch=batch))
            rollout.resume()
        stats_logger.close()
    finally:
        rollout.destroy()
        critic.destroy()
        actor.destroy()
    return history


if __name__ == "__main__":
    from areal_tpu_torch.utils.experiment import run_with_status

    run_with_status(main, sys.argv[1:])
