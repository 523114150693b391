"""Configuration dataclasses (counterpart of `areal_tpu/api/cli_args.py`).

Trimmed to the dataclasses the PyTorch serving and training slices read,
under the same names and defaults as the JAX package, so a config that
drives `JaxDecodeEngine` / `JaxPPOActor` drives `TorchDecodeEngine` /
`TorchPPOActor` unchanged. A setting whose feature the port does not
implement yet is refused with the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class NormConfig:
    """Normalization spec for rewards/advantages (`areal_tpu/api/cli_args.py:61`)."""

    mean_level: str | None = "batch"  # "batch" | "group" | None
    mean_leave1out: bool = False
    std_level: str | None = "batch"  # "batch" | "group" | None
    std_unbiased: bool = False
    eps: float = 1e-5
    group_size: int = 1


@dataclass
class MicroBatchSpec:
    """Micro-batch splitting spec (`areal_tpu/api/cli_args.py:73`)."""

    n_mbs: int | None = 1
    granularity: int = 1
    max_tokens_per_mb: int | None = None


@dataclass
class OptimizerConfig:
    """Optimizer + schedule spec (`areal_tpu/api/cli_args.py:105`): "adamw"
    (parameters in their dtype, first moment in `moment_dtype`) or "sgd";
    cosine/linear/constant schedules after a linear warm-up."""

    type: str = "adamw"
    lr: float = 2e-5
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-5
    min_lr_ratio: float = 0.0
    lr_scheduler_type: str = "constant"  # "cosine" | "linear" | "constant"
    warmup_steps_proportion: float = 0.001
    offload: bool = False
    gradient_clipping: float = 1.0
    moment_dtype: str = "float32"


@dataclass
class TrainEngineConfig:
    """Train engine config (`areal_tpu/api/cli_args.py:194`).

    The JAX `jax: JaxEngineConfig` sub-config (mesh, scan, pipeline and
    ZeRO knobs) has no counterpart on one card; of it the port keeps
    `remat_policy` and `fused_lm_loss`, with the same names and defaults,
    as fields of this class."""

    experiment_name: str = ""
    trial_name: str = ""
    path: str = ""
    attn_impl: str = "auto"
    init_from_scratch: bool = False
    is_critic: bool = False
    mb_spec: MicroBatchSpec = field(default_factory=MicroBatchSpec)
    pad_to_maximum: bool = False
    disable_dropout: bool = True
    gradient_checkpointing: bool = True
    dtype: str = "bfloat16"
    grad_reduce_dtype: str = "float32"
    optimizer: OptimizerConfig | None = None
    weight_update_mode: str = "memory"
    weight_sync_delta: bool = True
    backend: str = "jax"
    use_lora: bool = False
    lora_rank: int = 32
    lora_alpha: int = 16
    target_modules: list[str] = field(default_factory=list)
    # from JaxEngineConfig: the layer-checkpointing policy ("full" is the
    # one the port implements) and the vocab-chunked fused LM-head loss
    remat_policy: str = "full"
    fused_lm_loss: bool = True


@dataclass
class PPOActorConfig(TrainEngineConfig):
    """PPO/GRPO actor config (`areal_tpu/api/cli_args.py:238`)."""

    group_size: int = 1
    ppo_n_minibatches: int = 4
    eps_clip: float = 0.2
    eps_clip_higher: float | None = None
    c_clip: float | None = None
    temperature: float = 1.0
    # reward shaping
    reward_norm: NormConfig | None = None
    reward_scaling: float = 1.0
    reward_bias: float = 0.0
    reward_clip: float = 20.0
    overlong_reward_penalty: bool = False
    overlong_tokens: int | None = None
    overlong_penalty_factor: float | None = None
    mask_no_eos_with_zero: bool = False
    # advantage estimation
    discount: float = 1.0
    gae_lambda: float = 1.0
    adv_norm: NormConfig | None = None
    # KL regularization
    kl_ctl: float = 0.1
    kl_estimator: str = "k1"  # "k1" | "k2" | "k3"
    # asynchronous / decoupled-PPO controls
    recompute_logprob: bool = False
    use_decoupled_loss: bool = False
    behav_imp_weight_cap: float | None = None
    dynamic_sampling: bool = False
    log_agent_stats: bool = False
    log_agent_stats_keys: list[str] = field(default_factory=list)
    max_new_tokens: int = 1024
    # AEnt entropy regularization; entropy_clamp > 0 is not in the port yet
    entropy_coeff: float = 0.0
    entropy_clamp: float = 0.0
    adaptive_entropy_coeff: bool = False
    entropy_high: float = 0.5
    entropy_low: float = 0.1
    entropy_coeff_lr: float = 0.001
    entropy_coeff_box_high: float = 0.01
    entropy_coeff_box_low: float = 1e-5
    entropy_warmup_steps: int = 0


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
