"""Request, response and training records (counterpart of
`areal_tpu/api/io_struct.py:23, :47, :74, :106`)."""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Literal

from areal_tpu_torch.api.cli_args import GenerationHyperparameters


@dataclass
class ModelRequest:
    rid: str = field(default_factory=lambda: str(uuid.uuid4()))
    input_ids: list[int] = field(default_factory=list)
    gconfig: GenerationHyperparameters = field(
        default_factory=GenerationHyperparameters
    )
    metadata: dict[str, Any] = field(default_factory=dict)
    tokenizer: Any = None

    def copy(self) -> "ModelRequest":
        return ModelRequest(
            rid=self.rid,
            input_ids=list(self.input_ids),
            gconfig=self.gconfig.new(),
            metadata=dict(self.metadata),
            tokenizer=self.tokenizer,
        )


@dataclass
class ModelResponse:
    input_tokens: list[int] = field(default_factory=list)
    output_tokens: list[int] = field(default_factory=list)
    output_logprobs: list[float] = field(default_factory=list)
    # weight version that produced each output token
    output_versions: list[int] = field(default_factory=list)
    stop_reason: Literal["length", "stop", "interrupt"] = "stop"
    tokenizer: Any = None

    # statistics (seconds)
    latency: float = float("inf")
    ttft: float = float("inf")
    itl: list[float] = field(default_factory=list)

    @property
    def input_len(self) -> int:
        return len(self.input_tokens)

    @property
    def output_len(self) -> int:
        return len(self.output_tokens)


@dataclass
class FinetuneSpec:
    total_train_epochs: int
    dataset_size: int
    train_batch_size: int

    @property
    def total_train_steps(self) -> int:
        return self.total_train_epochs * (self.dataset_size // self.train_batch_size)

    @property
    def steps_per_epoch(self) -> int:
        return self.dataset_size // self.train_batch_size


@dataclass
class WeightUpdateMeta:
    """How trainer weights reach the decode engine. The port implements
    "memory": the colocated trainer hands its tensors to the decode engine
    on the same card, which copies them in place. "disk" and "dcn" are
    refused by `TorchTrainEngine.update_weights` (ROADMAP.md queue 1,
    item 4)."""

    type: Literal["disk", "memory", "dcn"] = "memory"
    path: str | None = None
    alloc_mode: Any = None
    transfer_addr: str | None = None
    transfer_port: int = 29500
    group_name: str = "update_weight_group"
    weight_chunked_mem_mb: int = 1024
    use_lora: bool = False
    weight_dtype: str = "fp"

    @classmethod
    def from_memory(cls, alloc_mode: Any = None) -> "WeightUpdateMeta":
        return cls(type="memory", alloc_mode=alloc_mode)
