"""Request and response records (counterpart of
`areal_tpu/api/io_struct.py:23, :47`)."""

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
