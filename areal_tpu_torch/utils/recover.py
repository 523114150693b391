"""Step-level fault recovery (counterpart of `areal_tpu/utils/recover.py`),
trimmed to what the GRPO loop touches with `recover.mode: disabled`:
`load` returns None and `dump` does nothing. Any other mode raises
(ROADMAP.md queue 1, item 2b). `ledger_wal_path` places the sample
ledger's journal where the JAX package does.
"""

from __future__ import annotations

import os

from areal_tpu_torch.api.cli_args import RecoverConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec

# name of the sample-ledger write-ahead journal colocated with the steps
LEDGER_WAL = "ledger.wal"


def recover_root(config: RecoverConfig) -> str:
    return os.path.join(
        config.fileroot, "recover", config.experiment_name, config.trial_name
    )


def ledger_wal_path(config: RecoverConfig) -> str:
    """The sample-ledger WAL colocated with the recovery state."""
    return os.path.join(recover_root(config), LEDGER_WAL)


class RecoverHandler:
    def __init__(self, config: RecoverConfig, ft_spec: FinetuneSpec):
        if config.mode != "disabled":
            raise NotImplementedError(
                f"recover.mode={config.mode!r} is not in the PyTorch port yet: "
                "ROADMAP.md queue 1, item 2b (save/load through a torch state dict)"
            )
        self.config = config
        self.ft_spec = ft_spec

    def dump(self, engine, step_info, saver=None, evaluator=None, dataloader=None,
             tokenizer=None, force: bool = False, rollout=None) -> None:
        return None

    def load(self, engine, saver=None, evaluator=None, dataloader=None,
             inference_engine=None, weight_update_meta=None) -> None:
        return None
