"""Freq-gated model checkpointing (counterpart of `areal_tpu/utils/saver.py`).

The port has no save path yet (ROADMAP.md queue 1, item 2b): `save` with
no frequency set never fires, as the smoke config's `saver: {}`, and a
save that would fire raises.
"""

from __future__ import annotations

from areal_tpu_torch.api.cli_args import SaverConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.utils.timeutil import FrequencyControl


class Saver:
    def __init__(self, config: SaverConfig, ft_spec: FinetuneSpec):
        self.config = config
        self.ft_spec = ft_spec
        self.freq_ctl = FrequencyControl(
            freq_epoch=config.freq_epochs,
            freq_step=config.freq_steps,
            freq_sec=config.freq_secs,
        )

    def save(self, engine, epoch: int, step: int, global_step: int, name: str = "default",
             tokenizer=None, base_model_path: str | None = None, force: bool = False) -> None:
        """Raise if a frequency gate fires (or `force`): saving is not
        ported yet."""
        if force or self.freq_ctl.check(
            epochs=int(step == self.ft_spec.steps_per_epoch - 1), steps=1
        ):
            raise NotImplementedError(
                "checkpoint saves are not in the PyTorch port yet: ROADMAP.md "
                "queue 1, item 2b (save/load through a torch state dict)"
            )

    def state_dict(self) -> dict:
        return self.freq_ctl.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.freq_ctl.load_state_dict(state)
