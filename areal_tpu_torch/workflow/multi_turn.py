"""Multi-turn self-correction workflow (counterpart of
`areal_tpu/workflow/multi_turn.py`).

One episode is up to `max_turns` rounds of: generate an answer on the
whole conversation so far, score it, and if it is wrong append a feedback
prompt and try again. The final reward is discounted by `turn_discount`
per extra turn, and the loss mask covers only the model's own completions
(prompt and feedback tokens are context: loss mask 0, logprob 0, version
-1). The whole conversation is one padded row, so the trainer sees one
long sequence. Each retry re-sends the conversation, which the decode
engine serves from its prefix registry by a fork or a suffix prefill.
"""

from __future__ import annotations

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

DEFAULT_FEEDBACK = (
    "\nYour answer is either wrong or not parsable to the reward function. "
    "You may misunderstand the original question. Please carefully read the "
    "original question, check the preceding errors, and try to answer it again.\n"
)


class MultiTurnWorkflow(RolloutWorkflow):
    def __init__(
        self,
        reward_fn: Callable[..., float],
        gconfig: GenerationHyperparameters,
        tokenizer: Any,
        max_turns: int = 3,
        turn_discount: float = 0.9,
        feedback_text: str = DEFAULT_FEEDBACK,
        reward_timeout_seconds: float = 15.0,
        dump_dir: str | None = None,
    ):
        self.reward_fn = AsyncRewardWrapper(reward_fn, timeout_seconds=reward_timeout_seconds)
        self.gconfig = gconfig
        self.tokenizer = tokenizer
        self.max_turns = max_turns
        self.turn_discount = turn_discount
        self.feedback_text = feedback_text
        self.dump_dir = dump_dir

    async def arun_episode(self, engine, data: dict[str, Any]):
        prompt_ids = encode_prompt(self.tokenizer, data)
        seq = list(prompt_ids)
        loss_mask = [0] * len(seq)
        logprobs = [0.0] * len(seq)
        versions = [-1] * len(seq)

        discount = 1.0
        reward = 0.0
        feedback_ids = self.tokenizer.encode(self.feedback_text)
        for turn in range(self.max_turns):
            req = ModelRequest(
                rid=str(uuid.uuid4()),
                input_ids=list(seq),
                gconfig=self.gconfig.new(n_samples=1),
                tokenizer=self.tokenizer,
            )
            resp = await engine.agenerate(req)
            seq += resp.output_tokens
            loss_mask += [1] * resp.output_len
            logprobs += resp.output_logprobs
            versions += resp.output_versions

            completion_str = self.tokenizer.decode(resp.output_tokens)
            reward = await self.reward_fn(
                None, completion_str, resp.input_tokens, resp.output_tokens,
                **_reward_kwargs(data),
            )
            if reward > 0 or turn == self.max_turns - 1:
                break
            # a wrong answer: the feedback (context only), then a retry
            seq += feedback_ids
            loss_mask += [0] * len(feedback_ids)
            logprobs += [0.0] * len(feedback_ids)
            versions += [-1] * len(feedback_ids)
            discount *= self.turn_discount

        if self.dump_dir is not None:
            # one file per episode under its newest version, as RLVR dumps
            d = os.path.join(self.dump_dir, str(max(versions + [0])))
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"{uuid.uuid4().hex}.jsonl"), "w") as f:
                f.write(json.dumps(dict(text=self.tokenizer.decode(seq),
                                        reward=float(reward) * discount,
                                        turns=turn + 1)) + "\n")
        row = dict(
            input_ids=np.array(seq, dtype=np.int32),
            loss_mask=np.array(loss_mask, dtype=np.int32),
            logprobs=np.array(logprobs, dtype=np.float32),
            versions=np.array(versions, dtype=np.int32),
            rewards=np.float32(float(reward) * discount),
            begin_of_answer=np.int32(len(prompt_ids)),
        )
        return pad_sequences_to_tensors([row])
