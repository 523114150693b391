"""Parallel strategy record (counterpart of
`areal_tpu/api/alloc_mode.py:57`), trimmed to its sizes: the port's
trainer runs on one card and `TorchTrainEngine.create_process_group`
refuses any strategy of more than one device (ROADMAP.md queue 1, item 5).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ParallelStrategy:
    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    data_parallel_size: int = 1
    context_parallel_size: int = 1
    expert_parallel_size: int = 1
    expert_tensor_parallel_size: int = 1

    @property
    def world_size(self) -> int:
        return (
            self.tensor_parallel_size
            * self.pipeline_parallel_size
            * self.data_parallel_size
            * self.context_parallel_size
        )
