"""Reward function plumbing (a copy of `areal_tpu/api/reward_api.py`).

`AsyncRewardWrapper` turns a synchronous reward function (rule-based math
verification, sandboxed code execution, ...) into an awaitable that runs in
a thread pool with a timeout, so slow verifier calls never stall the rollout
event loop.
"""

from __future__ import annotations

import asyncio
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

from areal_tpu_torch.utils import logging

logger = logging.getLogger("reward_api")

_DEFAULT_POOL: ThreadPoolExecutor | None = None


def _pool() -> ThreadPoolExecutor:
    global _DEFAULT_POOL
    if _DEFAULT_POOL is None:
        _DEFAULT_POOL = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="reward"
        )
    return _DEFAULT_POOL


# Positional parameters of the reward-fn contract
# (prompt, completion, prompt_ids, completion_ids). Dataset items carrying
# same-named keys (a "prompt" text field is common) must be filtered from the
# **kwargs or the call raises TypeError("got multiple values") — which the
# wrapper's failure path would silently turn into 0 reward.
REWARD_POSITIONAL = (
    "prompt",
    "completion",
    "completions",
    "prompt_ids",
    "completion_ids",
)


def reward_kwargs(data: dict) -> dict:
    return {k: v for k, v in data.items() if k not in REWARD_POSITIONAL}


class AsyncRewardWrapper:
    """Wrap a sync reward fn into an async callable with timeout.

    The wrapped function signature follows the reference convention:
    reward_fn(prompt, completion, prompt_ids, completion_ids, **data) -> float
    """

    def __init__(
        self,
        reward_fn: Callable[..., float],
        timeout_seconds: float = 15.0,
        executor: ThreadPoolExecutor | None = None,
    ):
        self.reward_fn = reward_fn
        self.timeout_seconds = timeout_seconds
        self.executor = executor

    async def __call__(self, *args: Any, **kwargs: Any) -> float:
        loop = asyncio.get_running_loop()
        fn = functools.partial(self.reward_fn, *args, **kwargs)
        try:
            return float(
                await asyncio.wait_for(
                    loop.run_in_executor(self.executor or _pool(), fn),
                    timeout=self.timeout_seconds,
                )
            )
        except asyncio.TimeoutError:
            logger.warning(
                f"reward fn {getattr(self.reward_fn, '__name__', '?')} timed "
                f"out after {self.timeout_seconds}s; returning 0"
            )
            return 0.0
        except Exception as e:  # noqa: BLE001
            logger.warning(f"reward fn raised {e!r}; returning 0")
            return 0.0
