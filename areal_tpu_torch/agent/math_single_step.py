"""Math single-step agent and environment (counterpart of
`areal_tpu/agent/math_single_step.py`; parity:
realhf/impl/agent/math_single_step_agent.py,
realhf/impl/environment/math_code_single_step_env.py).

One step: the agent samples `n_samples` answers to the prompt, the
environment grades each against the reference answer (the math grader,
`reward/math_parser.py`), and the episode becomes one GRPO group of
training rows. `AgentWorkflow` turns any agent and environment factory
into a `RolloutWorkflow`.
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any

import numpy as np

from areal_tpu_torch.api.agent_api import Agent, EnvironmentService
from areal_tpu_torch.api.cli_args import GenerationHyperparameters
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.api.workflow_api import RolloutWorkflow
from areal_tpu_torch.utils.data import pad_sequences_to_tensors


class MathSingleStepEnv(EnvironmentService):
    """Stateless verifier env: step(answers) scores them against the
    prompt's reference answer."""

    def __init__(self, answer: str | None = None, reward_fn=None):
        self.answer = answer
        if reward_fn is None:
            from areal_tpu_torch.reward.math_parser import math_verify_reward

            reward_fn = lambda completion, answer: math_verify_reward(  # noqa: E731
                None, completion, answer=answer
            )
        self.reward_fn = reward_fn

    async def reset(self, seed=None, options=None):
        if options and "answer" in options:
            self.answer = options["answer"]
        return None

    async def step(self, action: list[str]):
        loop = asyncio.get_running_loop()
        rewards = await asyncio.gather(
            *[
                loop.run_in_executor(None, self.reward_fn, a, self.answer)
                for a in action
            ]
        )
        return None, [float(r) for r in rewards], True, False, {}


class MathSingleStepAgent(Agent):
    def __init__(
        self,
        gconfig: GenerationHyperparameters,
        tokenizer: Any,
        success_rate_lb: float = 0.0,
        success_rate_ub: float = 1.0,
    ):
        self.gconfig = gconfig
        self.tokenizer = tokenizer
        # Episode filters (parity: the reference agent rejects prompt groups
        # that are all-solved or all-failed beyond these bounds).
        self.success_rate_lb = success_rate_lb
        self.success_rate_ub = success_rate_ub

    def _encode(self, prompt: dict[str, Any]) -> list[int]:
        if "input_ids" in prompt:
            return list(np.asarray(prompt["input_ids"]).reshape(-1))
        if "messages" in prompt:
            return self.tokenizer.apply_chat_template(
                prompt["messages"], add_generation_prompt=True, tokenize=True
            )
        return self.tokenizer.encode(prompt["question"])

    async def collect_trajectory(self, engine, prompt, env):
        await env.reset(options={"answer": prompt.get("answer")})
        ids = self._encode(prompt)
        n = self.gconfig.n_samples
        req = ModelRequest(
            rid=str(uuid.uuid4()),
            input_ids=ids,
            gconfig=self.gconfig.new(n_samples=1),
            tokenizer=self.tokenizer,
        )
        resps = await asyncio.gather(
            *[engine.agenerate(req.copy()) for _ in range(n)]
        )
        answers = [
            self.tokenizer.decode(r.output_tokens) if self.tokenizer else ""
            for r in resps
        ]
        _, rewards, *_ = await env.step(answers)
        rate = float(np.mean([r > 0 for r in rewards]))
        if not (self.success_rate_lb <= rate <= self.success_rate_ub):
            return []  # rejected episode
        rows = []
        for resp, reward in zip(resps, rewards):
            rows.append(
                dict(
                    input_ids=np.array(
                        resp.input_tokens + resp.output_tokens, dtype=np.int32
                    ),
                    loss_mask=np.array(
                        [0] * resp.input_len + [1] * resp.output_len,
                        dtype=np.int32,
                    ),
                    logprobs=np.array(
                        [0.0] * resp.input_len + resp.output_logprobs,
                        dtype=np.float32,
                    ),
                    versions=np.array(
                        [-1] * resp.input_len + resp.output_versions,
                        dtype=np.int32,
                    ),
                    rewards=np.float32(reward),
                    begin_of_answer=np.int32(resp.input_len),
                )
            )
        return rows


class AgentWorkflow(RolloutWorkflow):
    """Adapter: any Agent + env factory becomes a RolloutWorkflow, inheriting
    the async executor's staleness/capacity/interrupt machinery."""

    def __init__(self, agent: Agent, env_factory):
        self.agent = agent
        self.env_factory = env_factory

    async def arun_episode(self, engine, data):
        env = self.env_factory()
        try:
            rows = await self.agent.collect_trajectory(engine, data, env)
        finally:
            await env.close()
        if not rows:
            return None  # rejected
        return pad_sequences_to_tensors(rows)
