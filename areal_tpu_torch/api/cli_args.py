"""Configuration dataclasses and the YAML + `key=value` loader
(counterpart of `areal_tpu/api/cli_args.py`).

Every dataclass of the JAX module is here with every field, under the
same names, types, key paths and defaults, so any config the JAX loader
accepts loads here too and drives `TorchDecodeEngine` / `TorchPPOActor` /
`TorchLMEngine` unchanged; the decode engine's config sits under the same
`decode` key (`TorchDecodeConfig`, the counterpart of `JaxDecodeConfig`).
A value that only steers something the port does not have (the launcher's
resources, the router's knobs, mesh axes on one card) is accepted and not
acted on. A value that selects a feature the port does not implement yet
is refused with `NotImplementedError` naming the ROADMAP item that ports
it, where the value would act: the `check_supported` methods, called by
the engines and the entry points, never at load time. A key neither
package has raises at load.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field

import yaml

from areal_tpu_torch.utils import structured


SPEC_DECODES = ("off", "ngram")
PAGED_ATTN_IMPLS = ("auto", "pallas", "xla")


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
    (`actor.jax.*`), every field with its default. The port acts on
    `remat_policy` and `fused_lm_loss`. On one card the mesh and layout
    knobs have nothing to steer: `fsdp_axes`, `mesh_dcn_axes`, `cp_zigzag`
    (ring attention only), `pipeline_schedule` (pp > 1 only),
    `zero1_optimizer` (bit for bit the replicated update) and `scan_layers`
    (the port's trainer keeps per-layer tensors either way) are accepted
    and not acted on. `check_supported` refuses what selects a feature:
    more than one virtual stage or slice (item 5), optimizer offload
    (item 7)."""

    fsdp_axes: list[str] = field(default_factory=lambda: ["fsdp"])
    # layer-checkpointing policy; the port implements "full", and
    # `models/qwen2.forward` refuses the others
    remat_policy: str = "full"
    # the vocab-chunked fused LM-head loss (`ops/fused_xent.py`)
    fused_lm_loss: bool = True
    scan_layers: bool = True
    offload_params: bool = False
    pipeline_schedule: str = "1f1b"
    virtual_pp_size: int = 1
    zero1_optimizer: bool = True
    mesh_num_slices: int = 1
    mesh_dcn_axes: list[str] = field(default_factory=lambda: ["pp"])
    cp_zigzag: bool = True

    def check_supported(self) -> None:
        _refuse(self, {
            "offload_params": (self.offload_params, "item 7, optimizer offload to host"),
            "virtual_pp_size": (int(self.virtual_pp_size) > 1,
                                "item 5, pipeline parallelism"),
            "mesh_num_slices": (int(self.mesh_num_slices) > 1, "item 5, multi-slice meshes"),
        })


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
    # AEnt entropy regularization: entropy_coeff > 0 adds the entropy bonus,
    # entropy_clamp > 0 leaves that fraction of the vocab (the lowest
    # logits) out of it; the adaptive coefficient keeps the measured
    # entropy inside [entropy_low, entropy_high]
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
class PPOCriticConfig(TrainEngineConfig):
    """PPO critic config (`areal_tpu/api/cli_args.py:289`), read by
    `engine/ppo/critic.py`: `eps_clip` clips the value update around the
    old values and `ppo_n_minibatches` splits each update, as in JAX; the
    loss is `ppo_critic_loss_fn`'s default, "mse"."""

    ppo_n_minibatches: int = 4
    eps_clip: float = 0.5
    mask_no_eos_with_zero: bool = False


@dataclass
class GenerationHyperparameters:
    """Sampling hyperparameters (`areal_tpu/api/cli_args.py:82`)."""

    n_samples: int = 1
    max_new_tokens: int = 16384
    min_new_tokens: int = 0
    # a total-length cap the JAX decode engine does not read either
    max_tokens: int | None = None
    greedy: bool = False
    top_p: float = 1.0
    # accepted and not read, as in the JAX engine (its sampler has no top-k)
    top_k: int = int(1e8)
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
class FaultInjectionConfig:
    """Deterministic fault injection (`areal_tpu/api/cli_args.py:492`):
    `enabled` arms `core/fault_injection.py` with `plan`, a JSON list of
    fault points (or `{"seed": ..., "points": [...]}`), drawn from `seed`."""

    enabled: bool = False
    seed: int = 0
    plan: str = ""


@dataclass
class RouterConfig:
    """Fleet router policy (`areal_tpu/api/cli_args.py:515`). The router
    is ROADMAP queue 1, item 4; a colocated run has none, so these are
    accepted and not acted on."""

    schedule_policy: str = "prefix_affinity"
    max_concurrent_rollouts: int = 1024
    max_head_offpolicyness: int = 1_000_000_000
    train_batch_size: int = 1
    health_poll_interval: float = 5.0
    prefix_block_tokens: int = 64
    prefix_max_blocks: int = 4
    affinity_load_factor: float = 1.5
    kv_pressure_high: float = 0.9
    max_inflight_per_server: int = 0
    queue_max: int = 1024
    queue_timeout_s: float = 30.0
    retry_after_s: float = 1.0
    dead_after_failures: int = 2
    breaker_enabled: bool = True
    breaker_trip_after: int = 3
    breaker_slow_s: float = 0.0
    breaker_probe_requests: int = 1
    breaker_probe_ttl_s: float = 60.0
    route_ttl_s: float = 600.0
    route_max_entries: int = 65536
    kv_fabric: bool = True
    kv_fabric_fetch_cost_factor: float = 0.25


@dataclass
class SupervisorConfig:
    """Fleet supervisor policy (`areal_tpu/api/cli_args.py:604`); the
    supervisor is ROADMAP queue 1, item 4 (`enabled` is refused by
    `LauncherConfig.check_supported`)."""

    enabled: bool = False
    tick_interval_s: float = 1.0
    min_replicas: int = 1
    max_replicas: int = 8
    util_inflight_target: int = 8
    scale_up_util: float = 0.85
    scale_down_util: float = 0.30
    scale_up_queue_depth: int = 4
    scale_up_cooldown_s: float = 2.0
    scale_down_cooldown_s: float = 20.0
    replace_cooldown_s: float = 2.0
    rerole_cooldown_s: float = 30.0
    spawn_max_attempts: int = 3
    spawn_backoff_s: float = 0.5
    spawn_backoff_max_s: float = 10.0
    spawn_backoff_jitter: float = 0.25
    drain_deadline_s: float = 30.0
    health_fail_threshold: int = 2
    health_timeout_s: float = 5.0
    rerole_enabled: bool = True
    rerole_band: float = 0.25
    kv_fabric: bool = True
    warm_start_sessions: int = 4


@dataclass
class InferenceEngineConfig:
    """Rollout-side engine config (`areal_tpu/api/cli_args.py:682`).
    Capacity is counted in episodes (one GRPO group each). The port's
    `WorkflowExecutor` and engines read the first nine fields;
    `RemoteInfEngine` also reads the discovery, retry, failover and
    staged-push fields. The router's (`router`, `router_request_timeout`)
    steer the fleet router, ROADMAP queue 1, item 4, and are accepted and
    not acted on. An enabled `fault_injection` arms the process-global
    injector (`core/fault_injection.py`) when the remote client is built,
    and in the GRPO entry point's colocated branch (`build_rollout`)."""

    experiment_name: str | None = None
    trial_name: str | None = None
    max_concurrent_rollouts: None | int = None
    queue_size: None | int = None
    consumer_batch_size: int = 1
    max_head_offpolicyness: int = 0
    enable_rollout_tracing: bool = False
    check_trajectory_format: bool = False
    schedule_policy: str = "round_robin"
    setup_timeout: float = 120.0
    # seconds `generate` waits for one request before raising TimeoutError
    request_timeout: float = 3600.0
    request_retries: int = 3
    retry_jitter: float = 0.25
    pause_grace_period: float = 0.0
    weight_sync_overlap: bool = True
    weight_sync_inflight_buckets: int = 2
    fleet_failover_retries: int = 2
    router_request_timeout: float = 60.0
    router: RouterConfig = field(default_factory=RouterConfig)
    fault_injection: FaultInjectionConfig = field(default_factory=FaultInjectionConfig)

    def check_supported(self) -> None:
        """Every value here is accepted; a registered router is refused
        where it would be used (`RemoteInfEngine.initialize`)."""


@dataclass
class TorchDecodeConfig:
    """Decode engine config, mirroring `JaxDecodeConfig`
    (`areal_tpu/api/cli_args.py:298`) field for field.

    The scheduling knobs act as in the JAX engine: `decode_runahead_chunks`
    (default 1) keeps that many dispatched chunks in flight while the host
    consumes the one before (0: dispatch a chunk, then consume it), and
    `max_prefill_tokens` caps prefill work per scheduler pass. Prefix-KV
    reuse (forks of a group's shared prompt, suffix prefill of a follow-up
    turn, parked-KV resume) is unconditional, as in the JAX engine, which
    never reads `enable_prefix_caching` either; `disable_radix_cache` and
    `schedule_policy` are not read by it and are accepted here.
    `spec_decode="ngram"` turns on draft-free speculative decode with
    `spec_k` and `spec_ngram_max` as in the JAX engine;
    `TorchDecodeEngine.initialize` refuses a verify width `spec_k + 1` past
    the verify kernels' limit (`ops.paged_attention.check_verify_width`).
    `kv_fabric` is accepted and not acted on: the fabric's content index and
    peer fetch come with the fleet router, ROADMAP queue 1, item 4. Its device rung also acts in a lone JAX engine: a prompt that
    shares only a block-aligned head with a registered conversation that
    diverges later forks those blocks there, and prefills in full here
    unless the registry holds that head as a key of its own. The decode
    server (`launcher/decode_server.py`) reads `idempotency_*` and
    `weight_staging_ttl_s`; its other knobs (`log_level`,
    `enable_metrics`, `decode_log_interval`, `kv_migrate_chunk_mb`,
    `kv_import_pool_mb`, `skip_tokenizer_init`, the `kv_fabric_*` limits)
    and `hbm_utilization` are accepted and not acted on: the pool is sized
    by `kv_pool_tokens`, or the dense worst case.

    The serving dtype is the installed model's (`ModelConfig.dtype`).
    `dtype` keeps its JAX name and default; as in the JAX engine
    (`jax_decode.py:646-653`) it is read only to load `model_path` (the
    HF checkpoint `initialize` reads when no model is installed). An fp
    pool's
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
    # replica role in a disaggregated fleet; the port serves "unified"
    role: str = "unified"  # "unified" | "prefill" | "decode"
    kv_migrate_chunk_mb: float = 64.0
    kv_import_pool_mb: float = 256.0
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
    # "auto" and "pallas" run the hand-written kernels; "xla" (the JAX
    # engine's gather path, the workspace layout's oracle) is not ported
    paged_attn_impl: str = "auto"
    hbm_utilization: float = 0.85
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
    disable_radix_cache: bool = False
    schedule_policy: str = "fcfs"
    skip_tokenizer_init: bool = False
    log_level: str = "info"
    enable_metrics: bool = False
    decode_log_interval: int = 40
    idempotency_entries: int = 4096
    idempotency_ttl_s: float = 600.0
    weight_staging_ttl_s: float = 600.0
    kv_fabric: bool = True
    kv_fabric_digest_max: int = 512
    kv_fabric_min_blocks: int = 1
    kv_fabric_fetch_timeout_s: float = 30.0

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
        if self.paged_attn_impl not in PAGED_ATTN_IMPLS:
            raise ValueError(
                f"paged_attn_impl={self.paged_attn_impl!r} not in {PAGED_ATTN_IMPLS}"
            )
        _refuse(self, {
            "kv_host_pool_mb": (float(self.kv_host_pool_mb) > 0, "item 3, host KV tier"),
            "tensor_parallel_size": (
                int(self.tensor_parallel_size) > 1, "item 5, multi-GPU serving"
            ),
            "kv_layout": (self.kv_layout != "paged", "item 3, workspace KV layout"),
            "paged_attn_impl": (
                self.paged_attn_impl == "xla", "item 3, the workspace layout's gather path"
            ),
            "role": (self.role != "unified", "item 4, disaggregated prefill/decode roles"),
        })


def _refuse(cfg, todo: dict, prefix: str = "") -> None:
    """Raise NotImplementedError for the first `name: (selected, item)` of
    `todo` whose value selects a feature the port does not have yet."""
    for name, (unsupported, item) in todo.items():
        if unsupported:
            raise NotImplementedError(
                f"{prefix}{name}={getattr(cfg, name)!r} is not in the PyTorch "
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
    """Step-level crash recovery (`utils/recover.py`): each dump is
    written to a fresh `step-{G}.tmp`, sealed with a checksummed, fsynced
    MANIFEST.json, renamed to `step-{G}`, and only then pruned to the
    newest `keep_last` (>= 1). `retries` is the local launcher's restart
    count (`launcher/local.py`, as `areal_tpu/launcher/local.py:425`)
    when `mode` is "auto" or "fault"."""

    mode: str = "disabled"  # "disabled" | "auto" | "fault" | "resume"
    retries: int = 3
    keep_last: int = 2


@dataclass
class WandBConfig:
    mode: str = "disabled"
    wandb_base_url: str = ""
    wandb_api_key: str = ""
    entity: str | None = None
    project: str | None = None
    name: str | None = None
    job_type: str | None = None
    group: str | None = None
    notes: str | None = None
    tags: list[str] | None = None
    config: dict | None = None
    id_suffix: str | None = "train"


@dataclass
class SwanlabConfig:
    project: str | None = None
    name: str | None = None
    config: dict | None = None
    logdir: str | None = None
    mode: str | None = "disabled"
    api_key: str | None = None


@dataclass
class TensorBoardConfig:
    path: str | None = None


@dataclass
class StatsLoggerConfig:
    """Run-log location and trackers (`areal_tpu/api/cli_args.py:810`).
    The port logs to the console; `check_supported` (called by
    `StatsLogger`) refuses a tracker that is switched on (item 7)."""

    experiment_name: str = ""
    trial_name: str = ""
    fileroot: str = ""
    wandb: WandBConfig = field(default_factory=WandBConfig)
    swanlab: SwanlabConfig = field(default_factory=SwanlabConfig)
    tensorboard: TensorBoardConfig = field(default_factory=TensorBoardConfig)

    def check_supported(self) -> None:
        item = "item 7, experiment trackers"
        _refuse(self.wandb, {"mode": (self.wandb.mode != "disabled", item)}, "wandb.")
        _refuse(self.swanlab, {"mode": (self.swanlab.mode not in (None, "disabled"), item)},
                "swanlab.")
        _refuse(self.tensorboard, {"path": (self.tensorboard.path is not None, item)},
                "tensorboard.")


@dataclass
class NameResolveConfig:
    """Name-resolve backend (`areal_tpu/utils/name_resolve.py:40`): service
    discovery for decode servers and trainers (`utils/name_resolve.py`),
    read by the launcher and the DECOUPLED entry point; "memory" and
    "nfs" are ported, "etcd3" and "ray" are refused (ROADMAP queue 1,
    item 5)."""

    type: str = "nfs"  # "memory" | "nfs"
    nfs_record_root: str = "/tmp/areal_tpu/name_resolve"
    etcd3_addr: str = "localhost:2379"
    ray_actor_name: str = "name_resolve"


@dataclass
class ClusterSpecConfig:
    name_resolve: NameResolveConfig = field(default_factory=NameResolveConfig)
    cluster_name: str = "local"
    fileroot: str = "/tmp/areal_tpu"
    n_nodes: int = 1
    n_accelerators_per_node: int = 8


@dataclass
class DatasetConfig:
    path: str = ""
    type: str = ""
    batch_size: int = 1
    shuffle: bool = True
    # read by neither package's `SimpleDataLoader`
    pin_memory: bool = False
    num_workers: int = 0
    drop_last: bool = True
    max_length: int | None = None


@dataclass
class SlurmLauncherConfig:
    srun_additional_args: str = ""
    additional_bash_cmds: list[str] | None = None
    container_type: str = "none"
    mount: str = ""
    trainer_image: str | None = None
    inference_server_image: str | None = None


@dataclass
class LauncherConfig:
    """Launcher resources (`areal_tpu/api/cli_args.py:851`). The local
    launcher (`launcher/local.py`) runs one server and one trainer on one
    host and sets no resources, so these are accepted and not acted on
    (the slurm and ray launchers are ROADMAP queue 1, item 5);
    `check_supported` refuses the fleet features of item 4, prefill
    replicas and the supervisor."""

    inference_server_cpus_per_accelerator: int = 4
    inference_server_mem_per_accelerator: int = 32 * 1024
    trainer_cpus_per_accelerator: int = 4
    trainer_mem_per_accelerator: int = 32 * 1024
    inference_server_env_vars: str = ""
    trainer_env_vars: str = ""
    prefill_replicas: int = 0
    supervisor: SupervisorConfig = field(default_factory=SupervisorConfig)
    slurm: SlurmLauncherConfig = field(default_factory=SlurmLauncherConfig)

    def check_supported(self) -> None:
        _refuse(self, {"prefill_replicas": (
            int(self.prefill_replicas) > 0, "item 4, the prefill/decode roles")})
        _refuse(self.supervisor, {"enabled": (
            self.supervisor.enabled, "item 4, the fleet supervisor")}, "supervisor.")


@dataclass
class BaseExperimentConfig:
    """Root experiment config (`areal_tpu/api/cli_args.py:872`).
    `total_train_n_seqs` is read by no JAX entry point either."""

    experiment_name: str = "experiment"
    trial_name: str = "trial"
    cluster: ClusterSpecConfig = field(default_factory=ClusterSpecConfig)
    allocation_mode: str = ""
    seed: int = 1
    total_train_epochs: int = 1
    total_train_steps: int | None = None
    total_train_n_seqs: int | None = None
    tokenizer_path: str = ""
    train_dataset: DatasetConfig = field(default_factory=DatasetConfig)
    valid_dataset: DatasetConfig | None = None
    saver: SaverConfig = field(default_factory=SaverConfig)
    evaluator: EvaluatorConfig = field(default_factory=EvaluatorConfig)
    stats_logger: StatsLoggerConfig = field(default_factory=StatsLoggerConfig)
    recover: RecoverConfig = field(default_factory=RecoverConfig)
    decode: TorchDecodeConfig = field(default_factory=TorchDecodeConfig)
    launcher: LauncherConfig = field(default_factory=LauncherConfig)

    def check_supported(self) -> None:
        """What an entry point refuses before it builds anything: more than
        one node (item 5) and the launcher's fleet features, prefill
        replicas and the supervisor (item 4)."""
        _refuse(self.cluster, {
            "n_nodes": (int(self.cluster.n_nodes) > 1, "item 5, multi-node runs"),
        }, "cluster.")
        self.launcher.check_supported()


@dataclass
class SFTConfig(BaseExperimentConfig):
    """SFT experiment (`areal_tpu/api/cli_args.py:895`)."""

    model: TrainEngineConfig = field(default_factory=TrainEngineConfig)


@dataclass
class RWConfig(BaseExperimentConfig):
    """Reward-model experiment (`areal_tpu/api/cli_args.py:900`), run by
    `examples/hhrlhf_rw.py`."""

    model: TrainEngineConfig = field(default_factory=TrainEngineConfig)


@dataclass
class GRPOConfig(BaseExperimentConfig):
    """GRPO experiment (`areal_tpu/api/cli_args.py:905`). `max_turns` and
    `turn_discount` configure the `multi_turn` workflow, `max_tool_calls`
    and `tool_timeout_seconds` the `tir` workflow."""

    async_training: bool = True
    gconfig: GenerationHyperparameters = field(
        default_factory=GenerationHyperparameters
    )
    rollout: InferenceEngineConfig = field(default_factory=InferenceEngineConfig)
    actor: PPOActorConfig = field(default_factory=PPOActorConfig)
    ref: PPOActorConfig = field(default_factory=PPOActorConfig)
    workflow: str = "rlvr"  # the port runs "rlvr", "multi_turn" and "tir"
    max_turns: int = 3
    turn_discount: float = 0.9
    max_tool_calls: int = 4
    tool_timeout_seconds: float = 8.0


@dataclass
class PPOConfig(GRPOConfig):
    """PPO with a critic (`areal_tpu/api/cli_args.py:926`), run by
    `examples/gsm8k_ppo.py`."""

    critic: PPOCriticConfig = field(default_factory=PPOCriticConfig)


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


def load_expr_config(argv: list[str], config_cls, ignore_unknown: bool = False):
    """Load a structured experiment config from CLI argv: the YAML file,
    then the `key=value` overrides; then the experiment and trial names
    (and the cluster's file root) flow into the sub-configs that leave
    them empty (JAX :953-996). `ignore_unknown` skips the keys and
    overrides `config_cls` lacks (a subset view, as the launcher reads an
    entry point's config). Returns (config, the file's dict)."""
    cfg_dict, overrides = parse_cli_args(argv)
    config = structured.from_dict(config_cls, cfg_dict, ignore_unknown=ignore_unknown)
    for k, v in overrides:
        try:
            structured.apply_override(config, k, v)
        except structured.UnknownFieldError:
            if not ignore_unknown:
                raise
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
    for attr in ("actor", "ref", "critic", "model"):
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
