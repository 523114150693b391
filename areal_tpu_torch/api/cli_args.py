"""Configuration dataclasses and the YAML + `key=value` loader
(counterpart of `areal_tpu/api/cli_args.py`).

Trimmed to the dataclasses the PyTorch serving and training slices and
the GRPO entry point read, under the same names, key paths and defaults
as the JAX package, so a config that drives `JaxDecodeEngine` /
`JaxPPOActor` drives `TorchDecodeEngine` / `TorchPPOActor` unchanged; the
decode engine's config sits under the same `decode` key. A setting whose
feature the port does not implement yet is refused with the ROADMAP item
that ports it; a key the port does not have raises at load.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field

import yaml

from areal_tpu_torch.utils import structured


SPEC_DECODES = ("off", "ngram")


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
class JaxEngineConfig:
    """The port's copy of the engine sub-config
    (`areal_tpu/api/cli_args.py:129`), kept under its JAX name and key path
    (`actor.jax.*`). Of it the port keeps the two knobs it acts on, with
    the same names and defaults; the mesh, scan, pipeline and ZeRO knobs
    have no counterpart on one card."""

    # layer-checkpointing policy; the port implements "full", and
    # `models/qwen2.forward` refuses the others
    remat_policy: str = "full"
    # the vocab-chunked fused LM-head loss (`ops/fused_xent.py`)
    fused_lm_loss: bool = True


@dataclass
class TrainEngineConfig:
    """Train engine config (`areal_tpu/api/cli_args.py:194`)."""

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
    jax: JaxEngineConfig = field(default_factory=JaxEngineConfig)
    use_lora: bool = False
    lora_rank: int = 32
    lora_alpha: int = 16
    target_modules: list[str] = field(default_factory=list)


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

    n_samples: int = 1
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
    """Rollout-side engine config (`areal_tpu/api/cli_args.py:682`): the
    fields `WorkflowExecutor` and the engines read. Capacity is counted in
    episodes (one GRPO group each)."""

    experiment_name: str | None = None
    trial_name: str | None = None
    max_concurrent_rollouts: None | int = None
    queue_size: None | int = None
    consumer_batch_size: int = 1
    max_head_offpolicyness: int = 0
    enable_rollout_tracing: bool = False
    check_trajectory_format: bool = False
    # seconds `generate` waits for one request before raising TimeoutError
    request_timeout: float = 3600.0


@dataclass
class TorchDecodeConfig:
    """Decode engine config, mirroring `JaxDecodeConfig`
    (`areal_tpu/api/cli_args.py:298`).

    The slice schedules synchronously (dispatch a chunk, then consume it)
    and prefills every request in full. `spec_decode="ngram"` turns on
    draft-free speculative decode with `spec_k` and `spec_ngram_max` as in
    the JAX engine; `TorchDecodeEngine.initialize` refuses a verify width
    `spec_k + 1` past the verify kernels' limit
    (`ops.paged_attention.check_verify_width`). `decode_runahead_chunks` and
    `enable_prefix_caching` keep their JAX defaults because in the JAX
    engine they change scheduling only, never output
    (`areal_tpu/engine/jax_decode.py:28-39, :447-453`); here they are
    accepted and not acted on.

    The serving dtype is the installed model's (`ModelConfig.dtype`).
    `dtype` keeps its JAX name and default; as in the JAX engine
    (`jax_decode.py:646-653`) it is read only to load `model_path`, which
    the port still refuses, so nothing reads it yet. An fp pool's
    `kv_cache_dtype` must equal the model's dtype; `kv_dtype="int8"`
    stores the pool as int8 with f32 scales whatever `kv_cache_dtype`
    says, and `weight_dtype="int8"` serves the dense matmul kernels as int8
    (both checked in `TorchDecodeEngine.initialize`, which raises
    ValueError for a value outside `KV_DTYPES` / `WEIGHT_DTYPES`).
    """

    model_path: str = ""
    random_seed: int = 1
    dtype: str = "bfloat16"
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
    # draft-free speculative decode: "off" | "ngram" (prompt lookup of up
    # to spec_k tokens by the trailing n-gram, n <= spec_ngram_max, verified
    # in one forward; jax_decode.py:42-51)
    spec_decode: str = "off"
    spec_k: int = 4
    spec_ngram_max: int = 3
    enable_prefix_caching: bool = True

    def check_supported(self) -> None:
        """Raise ValueError for an invalid speculative-decode setting (as
        jax_decode.py:731-742), and NotImplementedError for a setting this
        slice does not implement, naming the ROADMAP item that ports it."""
        if self.spec_decode not in SPEC_DECODES:
            raise ValueError(f"spec_decode={self.spec_decode!r} not in {SPEC_DECODES}")
        if self.spec_decode == "ngram":
            if int(self.spec_k) < 1 or int(self.spec_ngram_max) < 1:
                raise ValueError(
                    "spec_decode='ngram' needs spec_k >= 1 and "
                    f"spec_ngram_max >= 1 (got spec_k={self.spec_k}, "
                    f"spec_ngram_max={self.spec_ngram_max})"
                )
        todo = {
            "kv_host_pool_mb":(float(self.kv_host_pool_mb) > 0, "item 3, host KV tier"),
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


@dataclass
class _Timer:
    experiment_name: str = ""
    trial_name: str = ""
    fileroot: str = ""
    freq_epochs: int | None = None
    freq_steps: int | None = None
    freq_secs: int | None = None


@dataclass
class EvaluatorConfig(_Timer):
    pass


@dataclass
class SaverConfig(_Timer):
    pass


@dataclass
class RecoverConfig(_Timer):
    """Step-level crash recovery (`utils/recover.py`). The port implements
    `mode="disabled"`; the other modes are refused there."""

    mode: str = "disabled"  # "disabled" | "auto" | "fault" | "resume"


@dataclass
class StatsLoggerConfig:
    """Run-log location (`areal_tpu/api/cli_args.py:810`); the port logs
    to the console only."""

    experiment_name: str = ""
    trial_name: str = ""
    fileroot: str = ""


@dataclass
class ClusterSpecConfig:
    fileroot: str = "/tmp/areal_tpu"


@dataclass
class DatasetConfig:
    path: str = ""
    type: str = ""
    batch_size: int = 1
    shuffle: bool = True
    drop_last: bool = True
    max_length: int | None = None


@dataclass
class BaseExperimentConfig:
    """Root experiment config (`areal_tpu/api/cli_args.py:872`)."""

    experiment_name: str = "experiment"
    trial_name: str = "trial"
    cluster: ClusterSpecConfig = field(default_factory=ClusterSpecConfig)
    allocation_mode: str = ""
    seed: int = 1
    total_train_epochs: int = 1
    total_train_steps: int | None = None
    tokenizer_path: str = ""
    train_dataset: DatasetConfig = field(default_factory=DatasetConfig)
    valid_dataset: DatasetConfig | None = None
    saver: SaverConfig = field(default_factory=SaverConfig)
    evaluator: EvaluatorConfig = field(default_factory=EvaluatorConfig)
    stats_logger: StatsLoggerConfig = field(default_factory=StatsLoggerConfig)
    recover: RecoverConfig = field(default_factory=RecoverConfig)
    decode: TorchDecodeConfig = field(default_factory=TorchDecodeConfig)


@dataclass
class GRPOConfig(BaseExperimentConfig):
    """GRPO experiment (`areal_tpu/api/cli_args.py:905`)."""

    async_training: bool = True
    gconfig: GenerationHyperparameters = field(
        default_factory=GenerationHyperparameters
    )
    rollout: InferenceEngineConfig = field(default_factory=InferenceEngineConfig)
    actor: PPOActorConfig = field(default_factory=PPOActorConfig)
    ref: PPOActorConfig = field(default_factory=PPOActorConfig)
    workflow: str = "rlvr"  # the port runs "rlvr"


def parse_cli_args(argv: list[str]):
    """Parse ``--config file.yaml key=value ...`` into (dict, overrides)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None, help="YAML config file")
    args, overrides = parser.parse_known_args(argv)
    cfg_dict = {}
    if args.config is not None:
        with open(args.config) as f:
            cfg_dict = yaml.safe_load(f) or {}
    kv = []
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must be of the form key=value")
        k, v = item.split("=", 1)
        kv.append((k, v))
    return cfg_dict, kv


def load_expr_config(argv: list[str], config_cls):
    """Load a structured experiment config from CLI argv: the YAML file,
    then the `key=value` overrides; then the experiment and trial names
    (and the cluster's file root) flow into the sub-configs that leave
    them empty (JAX :953-996). Returns (config, the file's dict)."""
    cfg_dict, overrides = parse_cli_args(argv)
    config = structured.from_dict(config_cls, cfg_dict)
    for k, v in overrides:
        structured.apply_override(config, k, v)
    for attr in ("saver", "evaluator", "stats_logger", "recover"):
        sub = getattr(config, attr, None)
        if sub is not None:
            if not sub.experiment_name:
                sub.experiment_name = config.experiment_name
            if not sub.trial_name:
                sub.trial_name = config.trial_name
            if not sub.fileroot:
                sub.fileroot = config.cluster.fileroot
    sub = getattr(config, "rollout", None)
    if sub is not None:
        if sub.experiment_name is None:
            sub.experiment_name = config.experiment_name
        if sub.trial_name is None:
            sub.trial_name = config.trial_name
    for attr in ("actor", "ref"):
        sub = getattr(config, attr, None)
        if sub is not None:
            if not sub.experiment_name:
                sub.experiment_name = config.experiment_name
            if not sub.trial_name:
                sub.trial_name = config.trial_name
    return config, cfg_dict


def save_config(config, save_dir: str) -> str:
    """Persist the resolved config as YAML in the run directory."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(structured.to_dict(config), f, sort_keys=False)
    return path
