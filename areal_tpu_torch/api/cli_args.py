"""Configuration dataclasses (counterpart of `areal_tpu/api/cli_args.py`).

Trimmed to the fields the PyTorch serving slice reads, under the same
names and defaults as the JAX package, so a config that drives
`JaxDecodeEngine` drives `TorchDecodeEngine` unchanged. A setting whose
feature the slice does not implement yet is refused by
`TorchDecodeConfig.check_supported` with the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class GenerationHyperparameters:
    """Sampling hyperparameters (`areal_tpu/api/cli_args.py:82`)."""

    max_new_tokens: int = 16384
    min_new_tokens: int = 0
    greedy: bool = False
    top_p: float = 1.0
    temperature: float = 1.0
    stop_token_ids: list[int] = field(default_factory=list)
    stop: list[str] | None = None
    frequency_penalty: float = 0.0

    def new(self, **kwargs) -> "GenerationHyperparameters":
        out = dataclasses.replace(self)
        for k, v in kwargs.items():
            setattr(out, k, v)
        return out


@dataclass
class InferenceEngineConfig:
    """Rollout-side engine config (`areal_tpu/api/cli_args.py:682`)."""

    # seconds `generate` waits for one request before raising TimeoutError
    request_timeout: float = 3600.0


@dataclass
class TorchDecodeConfig:
    """Decode engine config, mirroring `JaxDecodeConfig`
    (`areal_tpu/api/cli_args.py:298`).

    The slice schedules synchronously (dispatch a chunk, then consume it)
    and prefills every request in full. `decode_runahead_chunks` and
    `enable_prefix_caching` keep their JAX defaults because in the JAX
    engine they change scheduling only, never output
    (`areal_tpu/engine/jax_decode.py:28-39, :447-453`); here they are
    accepted and not acted on.

    The serving dtype is the installed model's (`ModelConfig.dtype`); the
    JAX field `dtype` only matters with `model_path`, which the slice
    refuses, so it is left out. `kv_cache_dtype` must equal the model's
    dtype (checked in `TorchDecodeEngine.initialize`).
    """

    model_path: str = ""
    random_seed: int = 1
    kv_cache_dtype: str = "bfloat16"
    kv_dtype: str = "fp"  # "fp" | "int8"
    weight_dtype: str = "fp"  # "fp" | "int8"
    tensor_parallel_size: int = 1
    context_length: int = 32768
    max_running_requests: int = 64
    page_size: int = 128  # tokens per KV page
    # Paged-pool budget in tokens; None provisions the dense worst case
    # (max_running_requests x context_length). A smaller budget makes
    # dispatch preempt (requeue) the longest slot when the pool runs dry.
    kv_pool_tokens: int | None = None
    kv_host_pool_mb: float = 0.0  # > 0: not in the port yet
    kv_layout: str = "paged"  # "workspace": not in the port yet
    # prefill tokens admitted per scheduler pass before the next decode
    # chunk runs (the first admission always goes through)
    max_prefill_tokens: int = 8192
    new_tokens_per_chunk: int = 128
    decode_runahead_chunks: int = 1
    spec_decode: str = "off"  # "ngram": not in the port yet
    enable_prefix_caching: bool = True

    def check_supported(self) -> None:
        """Raise NotImplementedError for a setting this slice does not
        implement, naming the ROADMAP item that ports it."""
        todo = {
            "kv_dtype": (self.kv_dtype != "fp", "item 3, int8 KV (K5a/K5b)"),
            "weight_dtype": (self.weight_dtype != "fp", "item 3, int8 weights (K6)"),
            "spec_decode": (self.spec_decode != "off", "item 3, speculative decode (K4)"),
            "kv_host_pool_mb": (float(self.kv_host_pool_mb) > 0, "item 3, host KV tier"),
            "tensor_parallel_size": (
                int(self.tensor_parallel_size) > 1, "item 5, multi-GPU serving"
            ),
            "kv_layout": (self.kv_layout != "paged", "item 3, workspace KV layout"),
            "model_path": (
                bool(self.model_path),
                "item 6, safetensors loading; install weights with set_model",
            ),
        }
        for name, (unsupported, item) in todo.items():
            if unsupported:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not in the PyTorch "
                    f"port yet: ROADMAP.md queue 1, {item}"
                )
