"""Agent and environment APIs (counterpart of `areal_tpu/api/agent_api.py`;
parity: realhf/api/core/agent_api.py `Agent`, realhf's
`EnvironmentService`).

The agent contract is written against `InferenceEngine.agenerate`, and
`agent/math_single_step.AgentWorkflow` plugs any agent and environment
pair into the rollout pipeline (submit/wait/prepare_batch, the staleness
gate, interrupt and resume). Environments register by name
(`register_environment`) and configs build them with `make_env`.
"""

from __future__ import annotations

import abc
from typing import Any


class EnvironmentService(abc.ABC):
    """Gym-style async environment (parity: realhf EnvironmentService)."""

    @abc.abstractmethod
    async def reset(self, seed: int | None = None, options: dict | None = None):
        """-> observation"""

    @abc.abstractmethod
    async def step(self, action: Any):
        """-> (observation, reward, terminated, truncated, info)"""

    async def close(self) -> None:
        pass


class Agent(abc.ABC):
    """Collects one trajectory for one prompt (parity: agent_api.py:15
    `collect_trajectory`; obs/act queues are subsumed by direct async calls)."""

    @abc.abstractmethod
    async def collect_trajectory(
        self,
        engine: Any,  # InferenceEngine
        prompt: dict[str, Any],
        env: EnvironmentService,
    ) -> list[dict[str, Any]]:
        """-> list of training rows (input_ids/loss_mask/logprobs/versions/
        rewards per row), possibly empty to reject the episode."""


# ---------------------------------------------------------------------------
# Env registry (parity: realhf/api/core/env_api.py register_environment /
# make_env) — configs name an env by string; implementations self-register
# at import time.
# ---------------------------------------------------------------------------

ALL_ENV_CLASSES: dict[str, type] = {}


def register_environment(name: str, env_cls: type) -> None:
    assert name not in ALL_ENV_CLASSES, f"env {name!r} already registered"
    assert "/" not in name
    ALL_ENV_CLASSES[name] = env_cls


def make_env(name: str, **kwargs) -> EnvironmentService:
    """Instantiate a registered environment by name. Built-in envs
    (agent/ modules) self-register on import; imported lazily here so
    config-driven callers need no import side effects."""
    import importlib

    for mod in ("areal_tpu_torch.agent.math_single_step",
                "areal_tpu_torch.agent.math_code_env"):
        importlib.import_module(mod)
    return ALL_ENV_CLASSES[name](**kwargs)


class NullEnvironment(EnvironmentService):
    """No-op env (parity: env_api.py NullEnvironment) for pure-generation
    agents: step() terminates immediately with zero reward."""

    async def reset(self, seed: int | None = None, options: dict | None = None):
        return None

    async def step(self, action: Any):
        return None, 0.0, True, False, {}


register_environment("null", NullEnvironment)
