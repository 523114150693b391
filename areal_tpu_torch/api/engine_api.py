"""Inference engine contract (counterpart of `areal_tpu/api/engine_api.py`).

Only the methods the serving slice implements; method names match the
JAX package's `InferenceEngine` so callers port mechanically. The
rollout-queue delegation (`submit` / `wait` / `prepare_batch`) comes with
the `WorkflowExecutor` port (ROADMAP queue 3).
"""

from __future__ import annotations

import abc

from areal_tpu_torch.api.io_struct import ModelRequest, ModelResponse


class InferenceEngine(abc.ABC):
    @abc.abstractmethod
    def initialize(self) -> "InferenceEngine":
        """Allocate device state and start serving."""

    def destroy(self) -> None:
        """Stop serving and release device state."""

    @abc.abstractmethod
    async def agenerate(self, req: ModelRequest) -> ModelResponse:
        """Generate a response for one request."""

    @abc.abstractmethod
    def generate(
        self, req: ModelRequest, timeout: float | None = None
    ) -> ModelResponse:
        """Blocking form of `agenerate`."""

    @abc.abstractmethod
    def pause_generation(self) -> None:
        """Stop decoding at the next chunk boundary; returns once no chunk
        runs."""

    @abc.abstractmethod
    def continue_generation(self) -> None:
        """Resume decoding after `pause_generation`."""

    @abc.abstractmethod
    def update_weights_from_tensor(
        self, named: dict, version: int | None = None
    ) -> None:
        """Install tensors keyed by `/`-joined parameter names."""

    @abc.abstractmethod
    def set_version(self, version: int) -> None:
        """Set the weight version stamped on every token generated next."""

    @abc.abstractmethod
    def get_version(self) -> int:
        """The current weight version."""
