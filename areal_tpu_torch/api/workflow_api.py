"""Rollout workflow contract (a copy of `areal_tpu/api/workflow_api.py`).

A workflow is one agentic episode: given an inference engine and one dataset
item, produce a training trajectory (padded dict-of-arrays with batch dim =
number of samples, e.g. a GRPO group) or None to reject the episode.
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from areal_tpu_torch.api.engine_api import InferenceEngine


class RolloutWorkflow(abc.ABC):
    @abc.abstractmethod
    async def arun_episode(
        self, engine: "InferenceEngine", data: dict[str, Any]
    ) -> dict[str, Any] | None:
        """Run one episode; return a padded trajectory batch or None.

        Returning None marks the episode rejected (filtered out); the
        executor decrements running without incrementing accepted.
        """
        raise NotImplementedError()


def encode_prompt(
    tokenizer, data: dict, enable_thinking: bool | None = None
) -> list:
    """Shared prompt encoding for workflows: pre-tokenized input_ids win,
    else chat-template messages, else raw prompt text. `enable_thinking`
    is forwarded to the chat template whenever set (False matters: Qwen3
    templates default thinking ON); None omits the kwarg entirely."""
    import numpy as np

    if "input_ids" in data:
        return list(np.asarray(data["input_ids"]).reshape(-1))
    if tokenizer is None:
        raise ValueError("need a tokenizer to encode messages/prompt")
    if "messages" in data:
        kw = dict(add_generation_prompt=True, tokenize=True)
        if enable_thinking is not None:
            kw["enable_thinking"] = enable_thinking
        return tokenizer.apply_chat_template(data["messages"], **kw)
    return tokenizer.encode(data["prompt"])
