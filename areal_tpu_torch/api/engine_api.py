"""Engine contracts (counterpart of `areal_tpu/api/engine_api.py`).

Only the methods the ported slices implement; method names match the JAX
package's `TrainEngine` (:50) and `InferenceEngine` so callers port
mechanically. The rollout-queue delegation (`submit` / `wait` /
`prepare_batch`) comes with the `WorkflowExecutor` port (ROADMAP queue 1,
item 3).
"""

from __future__ import annotations

import abc
from typing import Any, Callable

from areal_tpu_torch.api.alloc_mode import ParallelStrategy
from areal_tpu_torch.api.io_struct import (
    FinetuneSpec,
    ModelRequest,
    ModelResponse,
    WeightUpdateMeta,
)


class TrainEngine(abc.ABC):
    """Training engine contract (`areal_tpu/api/engine_api.py:50`)."""

    # -- lifecycle ------------------------------------------------------
    def create_process_group(
        self, parallel_strategy: ParallelStrategy | None = None
    ) -> None:
        """Set up the devices the engine trains on."""
        raise NotImplementedError()

    def initialize(
        self,
        addr: str | None = None,
        ft_spec: FinetuneSpec | None = None,
    ) -> None:
        """Load the model onto the device and build the optimizer."""
        raise NotImplementedError()

    def destroy(self) -> None:
        """Release device buffers."""

    # -- mode -----------------------------------------------------------
    def train(self, mode: bool = True):
        return self

    def eval(self):
        return self.train(False)

    # -- weights --------------------------------------------------------
    def update_weights(self, meta: WeightUpdateMeta) -> None:
        """Push current weights to the connected inference engine."""
        raise NotImplementedError()

    def connect_engine(self, engine: "InferenceEngine", meta: WeightUpdateMeta):
        """Wire an inference engine for weight updates."""
        raise NotImplementedError()

    def set_version(self, version: int) -> None:
        raise NotImplementedError()

    def get_version(self) -> int:
        raise NotImplementedError()

    # -- compute --------------------------------------------------------
    def train_batch(
        self,
        input_: dict[str, Any],
        loss_fn: Callable[[Any, dict[str, Any]], Any],
        loss_weight_fn: Callable[[dict[str, Any]], Any],
    ) -> dict[str, float]:
        """One optimizer step over a padded batch, internally split into
        FFD-balanced packed micro-batches. loss_fn consumes packed 1-D
        inputs; loss_weight_fn supplies each micro-batch's weight for global
        loss normalization."""
        raise NotImplementedError()

    def eval_batch(
        self,
        input_: dict[str, Any],
        loss_fn: Callable[[Any, dict[str, Any]], Any],
        loss_weight_fn: Callable[[dict[str, Any]], Any],
    ):
        raise NotImplementedError()

    def forward(
        self,
        input_: dict[str, Any],
        output_seqlens: list[int] | None = None,
        post_hook: Callable[[Any, dict[str, Any]], Any] | None = None,
        aggregate_fn: Callable[[list[Any]], Any] | None = None,
    ):
        """Gradient-free forward over micro-batches; results are un-padded,
        re-ordered to input order, and aggregated."""
        raise NotImplementedError()


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

    def init_weights_update_group(self, meta: WeightUpdateMeta) -> None:
        """Prepare for weight pushes described by `meta` (nothing to set
        up for an in-memory push on the same card)."""

    @abc.abstractmethod
    def update_weights_from_distributed(
        self, meta: WeightUpdateMeta, params=None, model_config=None
    ) -> None:
        """Colocated push: install the trainer's parameter tensors."""

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
