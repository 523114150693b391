"""RLVR (RL with verifiable rewards) workflow (a copy of
`areal_tpu/workflow/rlvr.py`): generate `n_samples` completions per prompt
concurrently, score each with an async-wrapped reward function, and emit
one padded training batch (the GRPO group) with per-token `logprobs` and
`versions` plus per-sequence `rewards` and `begin_of_answer`.
"""

from __future__ import annotations

import asyncio
import json
import os
import uuid
from typing import Any, Callable

import numpy as np

from areal_tpu_torch.api.cli_args import GenerationHyperparameters
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.api.reward_api import AsyncRewardWrapper
from areal_tpu_torch.api.reward_api import reward_kwargs as _reward_kwargs
from areal_tpu_torch.api.workflow_api import RolloutWorkflow, encode_prompt
from areal_tpu_torch.utils.data import pad_sequences_to_tensors


class RLVRWorkflow(RolloutWorkflow):
    def __init__(
        self,
        reward_fn: Callable[..., float],
        gconfig: GenerationHyperparameters,
        tokenizer: Any = None,
        enable_thinking: bool = False,
        dump_dir: str | None = None,
        reward_timeout_seconds: float = 15.0,
    ):
        self.reward_fn = AsyncRewardWrapper(
            reward_fn, timeout_seconds=reward_timeout_seconds
        )
        self.gconfig = gconfig
        self.tokenizer = tokenizer
        self.enable_thinking = enable_thinking
        self.dump_dir = dump_dir

    def _encode_prompt(self, data: dict[str, Any]) -> list[int]:
        return encode_prompt(
            self.tokenizer, data, enable_thinking=self.enable_thinking
        )

    def _build_request(
        self, data: dict[str, Any], prompt_ids: list[int]
    ) -> ModelRequest:
        """Request-construction hook (JAX's VisionRLVRWorkflow adds
        image_data)."""
        return ModelRequest(
            rid=str(uuid.uuid4()),
            input_ids=prompt_ids,
            gconfig=self.gconfig.new(n_samples=1),
            tokenizer=self.tokenizer,
        )

    async def arun_episode(self, engine, data: dict[str, Any]):
        prompt_ids = self._encode_prompt(data)
        n = self.gconfig.n_samples
        req = self._build_request(data, prompt_ids)
        resps = await asyncio.gather(
            *[engine.agenerate(req.copy()) for _ in range(n)]
        )

        version = engine.get_version()
        results = []
        for resp in resps:
            seq = resp.input_tokens + resp.output_tokens
            logprobs = [0.0] * resp.input_len + resp.output_logprobs
            loss_mask = [0] * resp.input_len + [1] * resp.output_len
            versions = [-1] * resp.input_len + resp.output_versions

            prompt_str, completion_str = None, None
            if self.tokenizer is not None:
                prompt_str = self.tokenizer.decode(resp.input_tokens)
                completion_str = self.tokenizer.decode(resp.output_tokens)
            reward = await self.reward_fn(
                prompt_str,
                completion_str,
                resp.input_tokens,
                resp.output_tokens,
                **_reward_kwargs(data),
            )
            results.append(
                dict(
                    input_ids=np.array(seq, dtype=np.int32),
                    loss_mask=np.array(loss_mask, dtype=np.int32),
                    logprobs=np.array(logprobs, dtype=np.float32),
                    versions=np.array(versions, dtype=np.int32),
                    rewards=np.float32(reward),
                    begin_of_answer=np.int32(resp.input_len),
                )
            )
        if self.dump_dir is not None and self.tokenizer is not None:
            self._dump(version, prompt_ids, resps, results)
        return pad_sequences_to_tensors(results)

    def _dump(self, version, prompt_ids, resps, results):
        os.makedirs(os.path.join(self.dump_dir, str(version)), exist_ok=True)
        path = os.path.join(
            self.dump_dir, str(version), f"{uuid.uuid4().hex}.jsonl"
        )
        with open(path, "a") as f:
            for resp, r in zip(resps, results):
                f.write(
                    json.dumps(
                        dict(
                            prompt=self.tokenizer.decode(prompt_ids),
                            completion=self.tokenizer.decode(resp.output_tokens),
                            reward=float(r["rewards"]),
                            stop_reason=resp.stop_reason,
                        )
                    )
                    + "\n"
                )
