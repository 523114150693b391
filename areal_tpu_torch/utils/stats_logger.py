"""Per-step metrics to the console (counterpart of
`areal_tpu/utils/stats_logger.py`; its tensorboard, wandb and swanlab
backends are not in the port, and switching one on is refused)."""

from __future__ import annotations

import os
from typing import Any

from areal_tpu_torch.api.cli_args import StatsLoggerConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.utils import logging

logger = logging.getLogger("stats_logger")


class StatsLogger:
    def __init__(self, config: StatsLoggerConfig, ft_spec: FinetuneSpec | None = None):
        config.check_supported()
        self.config = config
        self.ft_spec = ft_spec

    @staticmethod
    def get_log_path(config: StatsLoggerConfig) -> str:
        """Run log directory: {fileroot}/logs/{experiment}/{trial}."""
        return os.path.join(
            config.fileroot or "/tmp/areal_tpu",
            "logs",
            config.experiment_name,
            config.trial_name,
        )

    def commit(self, epoch: int, step: int, global_step: int, data: dict[str, Any] | list) -> None:
        """Log one training step's stats. `data` may be one dict or a list
        of per-minibatch dicts; keys appearing in several minibatch dicts
        log their MEAN across the step."""
        if isinstance(data, (list, tuple)):
            sums: dict[str, float] = {}
            counts: dict[str, int] = {}
            for d in data:
                for k, v in d.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
                    counts[k] = counts.get(k, 0) + 1
            data = {k: sums[k] / counts[k] for k in sums}
        flat = {k: float(v) for k, v in data.items()}
        lines = [f"Epoch {epoch} step {step} (global step {global_step}):"]
        width = max((len(k) for k in flat), default=0)
        for k in sorted(flat):
            lines.append(f"  {k:<{width}} = {flat[k]:.6g}")
        logger.info("\n".join(lines))

    def close(self) -> None:
        pass
