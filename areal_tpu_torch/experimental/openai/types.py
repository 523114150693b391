"""Types of the OpenAI-compatible client (counterpart of
`areal_tpu/experimental/openai/types.py`; parity:
areal/experimental/openai/types.py `InteractionWithTokenLogpReward`).

The client records one `InteractionWithTokenLogpReward` per completion
call: the token-level view (ids, logprobs, weight versions) that RL
training needs and the OpenAI response hides. Multi-turn conversations
link interactions by `parent_id` (found by token-prefix matching), so
turn-discounted credit can flow back along the chain.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class InteractionWithTokenLogpReward:
    id: str
    messages: list[dict[str, Any]]
    input_tokens: list[int]
    output_tokens: list[int]
    output_logprobs: list[float]
    output_versions: list[int]
    reward: float | None = None
    parent_id: str | None = None

    @property
    def seq(self) -> list[int]:
        return list(self.input_tokens) + list(self.output_tokens)

    def to_training_row(self) -> dict[str, Any]:
        import numpy as np

        seq = self.seq
        il, ol = len(self.input_tokens), len(self.output_tokens)
        return dict(
            input_ids=np.array(seq, dtype=np.int32),
            loss_mask=np.array([0] * il + [1] * ol, dtype=np.int32),
            logprobs=np.array(
                [0.0] * il + list(self.output_logprobs), dtype=np.float32
            ),
            versions=np.array(
                [-1] * il + list(self.output_versions), dtype=np.int32
            ),
            rewards=np.float32(self.reward if self.reward is not None else 0.0),
            begin_of_answer=np.int32(il),
        )


@dataclasses.dataclass
class ChatMessage:
    role: str
    content: str

    def model_dump(self) -> dict[str, str]:
        return {"role": self.role, "content": self.content}


@dataclasses.dataclass
class Choice:
    index: int
    message: ChatMessage
    finish_reason: str


@dataclasses.dataclass
class Usage:
    prompt_tokens: int
    completion_tokens: int

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.completion_tokens


@dataclasses.dataclass
class ChatCompletion:
    """Minimal OpenAI-shaped chat completion (we do not depend on the
    `openai` package; this mirrors the fields user code reads)."""

    id: str
    choices: list[Choice]
    usage: Usage
    model: str = "areal-tpu"
    object: str = "chat.completion"
