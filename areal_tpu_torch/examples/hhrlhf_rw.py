"""Pairwise reward-model training on one CUDA card: the port's reward-model
entry point (counterpart of `examples/hhrlhf_rw.py`).

A Bradley-Terry loss over (chosen, rejected) pairs on the critic's scalar
value head (`TorchRWEngine`), with the saver, the evaluator (the mean
`eval_rw` loss over the validation set) and crash recovery wired as in the
JAX example.

Usage, from the repository root:

  python -m areal_tpu_torch.examples.hhrlhf_rw \\
      --config examples/configs/arith_rw_smoke.yaml [key=value ...]

On `synthetic-arith` the pairs are a well-formed answer (chosen) and the
same answer with a dangling `+` (rejected). It runs on `cuda:0`. From
Python, `main([...], device="cpu")` runs the same loop on the CPU with the
kernels' plain versions.
"""

from __future__ import annotations

import sys
from typing import Any

import numpy as np

from areal_tpu_torch.api.cli_args import RWConfig, load_expr_config, save_config
from areal_tpu_torch.api.io_struct import FinetuneSpec, StepInfo
from areal_tpu_torch.dataset import SimpleDataLoader, get_custom_dataset, load_tokenizer
from areal_tpu_torch.engine.rw.rw_engine import TorchRWEngine
from areal_tpu_torch.models.qwen2 import ModelConfig
from areal_tpu_torch.utils import seeding, stats_tracker
from areal_tpu_torch.utils.data import pad_sequences_to_tensors
from areal_tpu_torch.utils.evaluator import Evaluator
from areal_tpu_torch.utils.recover import RecoverHandler
from areal_tpu_torch.utils.saver import Saver
from areal_tpu_torch.utils.stats_logger import StatsLogger


def to_pair_batch(items) -> dict:
    """Pairs as rows (2i, 2i+1) = (chosen, rejected), the layout
    `TorchRWEngine.train_rw` takes (JAX :47)."""
    seqs = []
    for x in items:
        for key in ("chosen_input_ids", "rejected_input_ids"):
            ids = np.asarray(x[key], dtype=np.int32)
            seqs.append(dict(input_ids=ids, loss_mask=np.ones_like(ids)))
    return pad_sequences_to_tensors(seqs)


def main(argv: list[str], model_config: ModelConfig | None = None,
         device: Any = None) -> list[dict[str, float]]:
    """Run the reward-model loop of `argv` (`--config file.yaml
    key=value ...`).

    `model_config` replaces the default model (the smoke decoder with a
    value head when `model.path` is empty) and `device` the card (`"cpu"`
    runs the plain versions). Returns each step's committed stats,
    `global_step` included."""
    config, _ = load_expr_config(argv, RWConfig)
    config: RWConfig
    config.check_supported()
    if (config.allocation_mode or "").strip():
        raise NotImplementedError(
            f"allocation_mode={config.allocation_mode!r} (a parallel strategy over "
            "several devices) is not in the PyTorch port yet: ROADMAP.md queue 1, item 5"
        )

    rank = 0
    seeding.set_random_seed(config.seed, key=f"trainer{rank}")
    tokenizer = load_tokenizer(config.tokenizer_path)

    engine = TorchRWEngine(config.model, device=device)
    if model_config is not None:
        engine.model_config = model_config
    elif not config.model.path:
        from areal_tpu_torch.models.smoke import smoke_model_config

        engine.model_config = smoke_model_config(
            dtype=config.model.dtype, vocab_size=getattr(tokenizer, "vocab_size", None),
            is_critic=True,
        )
    engine.create_process_group()

    def make_ds(dcfg, split):
        return get_custom_dataset(path=dcfg.path, split=split, type="rw", tokenizer=tokenizer,
                                  max_length=dcfg.max_length)

    valid_cfg = config.valid_dataset or config.train_dataset
    train_dataloader = SimpleDataLoader(
        make_ds(config.train_dataset, "train"), batch_size=config.train_dataset.batch_size,
        shuffle=config.train_dataset.shuffle, seed=config.seed,
    )
    valid_dataloader = SimpleDataLoader(make_ds(valid_cfg, "test"),
                                        batch_size=valid_cfg.batch_size, shuffle=False)
    steps_per_epoch = len(train_dataloader)
    ft_spec = FinetuneSpec(
        total_train_epochs=config.total_train_epochs,
        dataset_size=steps_per_epoch * config.train_dataset.batch_size,
        train_batch_size=config.train_dataset.batch_size,
    )
    engine.initialize(None, ft_spec)
    history = []
    try:
        saver = Saver(config.saver, ft_spec)
        stats_logger = StatsLogger(config.stats_logger, ft_spec)
        evaluator = Evaluator(config.evaluator, ft_spec)
        recover_handler = RecoverHandler(config.recover, ft_spec)
        recover_info = recover_handler.load(engine, saver, evaluator, train_dataloader)
        start_step = (
            recover_info.last_step_info.next().global_step if recover_info is not None else 0
        )
        if rank == 0:
            save_config(config, StatsLogger.get_log_path(config.stats_logger))

        max_steps = config.total_train_steps or (config.total_train_epochs * steps_per_epoch)

        global_step = start_step
        data_iter = iter(train_dataloader)
        while global_step < max_steps:
            try:
                items = next(data_iter)
            except StopIteration:
                data_iter = iter(train_dataloader)
                items = next(data_iter)
            epoch = global_step // steps_per_epoch
            step = global_step % steps_per_epoch

            with stats_tracker.record_timing("train_step"):
                stats = engine.train_rw(to_pair_batch(items))
            engine.set_version(global_step + 1)

            saver.save(engine, epoch, step, global_step, tokenizer=tokenizer)
            recover_handler.dump(
                engine,
                StepInfo(global_step=global_step, epoch=epoch, epoch_step=step,
                         steps_per_epoch=steps_per_epoch),
                saver, evaluator, train_dataloader, tokenizer=tokenizer,
            )

            def evaluate_fn():
                losses = [engine.eval_rw(to_pair_batch(v_items)) for v_items in valid_dataloader]
                stats_tracker.scalar(eval_loss=float(np.mean(losses)))

            evaluator.evaluate(evaluate_fn, epoch, step, global_step)

            stats.update(stats_tracker.export_all())
            stats_logger.commit(epoch, step, global_step, stats)
            history.append(dict(stats, global_step=global_step))
            global_step += 1
        stats_logger.close()
    finally:
        engine.destroy()
    return history


if __name__ == "__main__":
    from areal_tpu_torch.utils.experiment import run_with_status

    run_with_status(main, sys.argv[1:])
