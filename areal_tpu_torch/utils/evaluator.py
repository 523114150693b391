"""Freq-gated evaluation callback runner (a copy of
`areal_tpu/utils/evaluator.py`)."""

from __future__ import annotations

from typing import Callable

from areal_tpu_torch.api.cli_args import EvaluatorConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.utils import logging
from areal_tpu_torch.utils.timeutil import FrequencyControl

logger = logging.getLogger("evaluator")


class Evaluator:
    def __init__(self, config: EvaluatorConfig, ft_spec: FinetuneSpec):
        self.config = config
        self.ft_spec = ft_spec
        self.freq_ctl = FrequencyControl(
            freq_epoch=config.freq_epochs,
            freq_step=config.freq_steps,
            freq_sec=config.freq_secs,
        )

    def evaluate(
        self,
        evaluate_fn: Callable[[], None],
        epoch: int,
        step: int,
        global_step: int,
        force: bool = False,
    ) -> bool:
        """Run `evaluate_fn` if a frequency gate fires; returns whether it ran."""
        if not force and not self.freq_ctl.check(
            epochs=int(step == self.ft_spec.steps_per_epoch - 1), steps=1
        ):
            return False
        logger.info(f"evaluating at global_step {global_step}")
        evaluate_fn()
        return True

    def state_dict(self) -> dict:
        return self.freq_ctl.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.freq_ctl.load_state_dict(state)
