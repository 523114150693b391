"""Freq-gated model checkpointing (counterpart of `areal_tpu/utils/saver.py`):
periodic HF-format saves under
{fileroot}/checkpoints/{experiment}/{trial}/{name}/epoch{E}epochstep{S}globalstep{G}.

A failed save (a full disk, a flaky store) degrades to a log line and the
`save_failures` counter; the training loop goes on and the gate fires
again at its next cadence.
"""

from __future__ import annotations

import os

from areal_tpu_torch.api.cli_args import SaverConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec, SaveLoadMeta
from areal_tpu_torch.utils import logging
from areal_tpu_torch.utils.timeutil import FrequencyControl

logger = logging.getLogger("saver")


class Saver:
    def __init__(self, config: SaverConfig, ft_spec: FinetuneSpec, for_recover: bool = False):
        self.config = config
        self.ft_spec = ft_spec
        self.for_recover = for_recover
        self.freq_ctl = FrequencyControl(
            freq_epoch=config.freq_epochs,
            freq_step=config.freq_steps,
            freq_sec=config.freq_secs,
        )
        # periodic-save failures observed by this process
        self.save_failures = 0

    @staticmethod
    def get_save_checkpoint_root(config: SaverConfig, name: str = "default") -> str:
        return os.path.join(
            config.fileroot, "checkpoints", config.experiment_name, config.trial_name, name
        )

    @staticmethod
    def get_save_checkpoint_path(config: SaverConfig, epoch: int, step: int, global_step: int,
                                 name: str = "default") -> str:
        path = os.path.join(
            Saver.get_save_checkpoint_root(config, name),
            f"epoch{epoch}epochstep{step}globalstep{global_step}",
        )
        os.makedirs(path, exist_ok=True)
        return path

    def save(self, engine, epoch: int, step: int, global_step: int, name: str = "default",
             tokenizer=None, base_model_path: str | None = None,
             force: bool = False) -> str | None:
        """Save if a frequency gate fires (or `force`); returns the path
        saved to, else None."""
        if not force and not self.freq_ctl.check(
            epochs=int(step == self.ft_spec.steps_per_epoch - 1), steps=1
        ):
            return None
        path = self.get_save_checkpoint_path(self.config, epoch, step, global_step, name)
        try:
            engine.save(SaveLoadMeta(
                path=path,
                weight_format="hf",
                with_optim=self.for_recover,
                tokenizer=tokenizer,
                base_model_path=base_model_path,
            ))
        except Exception as e:  # noqa: BLE001 — a failed save must not kill training
            self.save_failures += 1
            logger.error(
                f"checkpoint save failed at global_step {global_step} ({e!r}); "
                f"retrying at the next frequency gate (failures so far: "
                f"{self.save_failures})"
            )
            return None
        logger.info(f"saved checkpoint at global_step {global_step} -> {path}")
        return path

    def state_dict(self) -> dict:
        return self.freq_ctl.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.freq_ctl.load_state_dict(state)
