"""Request, response and training records (counterpart of
`areal_tpu/api/io_struct.py:23, :47, :74, :106, :173-202`)."""

from __future__ import annotations

import os
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
    # VLM inputs (JAX :32-42): the decode engine's tower takes processed
    # patch dicts {"pixel_values", "image_grid_thw"}; the HTTP client
    # base64-encodes each entry
    image_data: list[Any] | None = None

    def copy(self) -> "ModelRequest":
        return ModelRequest(
            rid=self.rid,
            input_ids=list(self.input_ids),
            gconfig=self.gconfig.new(),
            metadata=dict(self.metadata),
            tokenizer=self.tokenizer,
            image_data=list(self.image_data) if self.image_data else None,
        )


@dataclass
class ModelResponse:
    input_tokens: list[int] = field(default_factory=list)
    output_tokens: list[int] = field(default_factory=list)
    output_logprobs: list[float] = field(default_factory=list)
    # weight version that produced each output token
    output_versions: list[int] = field(default_factory=list)
    # "prefill": a prefill-only request (the prefill role); its KV is
    # parked or exported and no token was generated
    stop_reason: Literal["length", "stop", "interrupt", "prefill"] = "stop"
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
    """How trainer weights reach the decode engine
    (`TorchTrainEngine.update_weights`):

    - "memory": the colocated trainer hands its tensors to the decode
      engine on the same card, which copies them in place.
    - "disk": an HF safetensors checkpoint at `path`, loaded by every
      decode server, with name_resolve's timestamp handshake.
    - "dcn": the staged HTTP push to the decode servers
      (`core/weight_transfer.py`), in frames of at most
      `weight_chunked_mem_mb`; `weight_dtype` "int8" quantizes the dense
      kernels at the trainer and must match the servers' `weight_dtype`.

    `use_lora` (a LoRA delta push) is refused (ROADMAP.md queue 1,
    item 6.7)."""

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
    def from_disk(cls, experiment_name: str, trial_name: str, file_root: str,
                  name: str = "default", use_lora: bool = False) -> "WeightUpdateMeta":
        path = os.path.join(file_root, "checkpoints", experiment_name, trial_name, name,
                            "weight_update")
        return cls(type="disk", path=path, use_lora=use_lora)

    @classmethod
    def from_memory(cls, alloc_mode: Any = None) -> "WeightUpdateMeta":
        return cls(type="memory", alloc_mode=alloc_mode)


@dataclass
class SaveLoadMeta:
    path: str
    # "hf" (safetensors) | "torch" (the port's recovery format, in place of
    # the JAX package's "orbax")
    weight_format: str = "hf"
    with_optim: bool = False
    tokenizer: Any = None
    base_model_path: str | None = None


@dataclass
class RolloutStat:
    submitted: int = 0
    accepted: int = 0
    running: int = 0


@dataclass
class StepInfo:
    epoch: int
    epoch_step: int
    global_step: int
    steps_per_epoch: int

    def next(self) -> "StepInfo":
        last_in_epoch = self.epoch_step == self.steps_per_epoch - 1
        return StepInfo(
            epoch=self.epoch + last_in_epoch,
            epoch_step=0 if last_in_epoch else self.epoch_step + 1,
            global_step=self.global_step + 1,
            steps_per_epoch=self.steps_per_epoch,
        )
