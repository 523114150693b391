"""TorchTrainEngine: the training engine on one CUDA card (counterpart of
`areal_tpu/engine/jax_engine.py::JaxTrainEngine`, :340).

- `train_batch` keeps the JAX contract (:1569): the padded batch is split
  into FFD-balanced packed micro-batches under `mb_spec`; each
  micro-batch's gradient (in the parameter dtype) is added into an f32
  accumulator weighted by `loss_weight_fn`; then one update divides by the
  total weight, clips by the global norm, casts to the parameter dtype
  and applies AdamW (:1531).
- The optimizer is written out here to match optax `adamw` as
  `make_optimizer` (:135) configures it, rounding step for rounding step:
  first moment in `moment_dtype`, second moment in the parameter dtype,
  bias correction, eps outside the square root, weight decay added
  before the learning rate scales the update, under optax's mask
  `p.ndim > 1` as the JAX engine applies it to its stacked `[L, ...]`
  layer leaves (`decay_mask`).
  `torch.optim.AdamW` keeps both moments in the parameter dtype and
  applies decay in another order.
- `make_lr_schedule` (:115) has optax's semantics: the schedule is read
  at the update count before it increments, so the first update of a run
  has learning rate 0 (the warm-up has at least one step).
- One device, no mesh: the parameters are a flat dict of leaf tensors,
  one per layer leaf (`layers_{i}/...`), because eager autograd through
  views of a stacked `[L, ...]` leaf would write a whole-stack gradient
  for every layer.
- Weights reach the decode side three ways (`update_weights`, JAX
  :947-990). "memory": a colocated `TorchDecodeEngine` copies them in
  place on the same card. "disk": an HF checkpoint at `meta.path`, then
  the connected engine (a `RemoteInfEngine`) has every server load it.
  "dcn": the staged HTTP push (`update_weights_async`, :1070-1130): the
  bf16 cast of the parameters (int8 kernels with
  `meta.weight_dtype="int8"`), streamed leaf by leaf in the JAX wire
  layout of the model's configured `scan_layers` (each `layers_{i}` leaf
  stacked into its `[L, ...]` wire form one leaf at a time), copied to
  the host on a side stream and framed while the servers keep
  generating; only the commit pauses them.
- `save` / `load` (JAX :791, :823) take two formats. "hf" is one HF
  `model.safetensors` (`models/hf_io.py`), with the optimizer beside it
  under `optim/` when `with_optim`. "torch" is the recovery format that
  replaces JAX's orbax one: `torch_state.pt`, a dict of tensors and ints
  written by `torch.save` and read with `torch.load(weights_only=True)`
  (the parameters, AdamW's `mu` and `nu`, its update `count`), and
  `train_meta.json` (`step_count`, `version`, the layout tag) as JAX
  writes it (:885-895). A load copies into the engine's tensors in place,
  so the optimizer state stays on the device and the next `train_batch`
  takes the step an uninterrupted run would have taken.
- Seams and tracing (JAX :948-954, :1580-1596): `train.step` fires at the
  top of `train_batch`, `train.weights.push` at the entry of
  `update_weights` (`core/fault_injection.py`); `train_batch` calls
  `maybe_xprof_step` (the env-gated device-trace window) and runs its
  micro-batches and update inside an `annotate("train_batch")` range
  (`utils/perf_tracer.py`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from areal_tpu_torch.api.alloc_mode import ParallelStrategy
from areal_tpu_torch.api.cli_args import OptimizerConfig, TrainEngineConfig
from areal_tpu_torch.api.engine_api import InferenceEngine, TrainEngine
from areal_tpu_torch.api.io_struct import FinetuneSpec, SaveLoadMeta, WeightUpdateMeta
from areal_tpu_torch.core import fault_injection
from areal_tpu_torch.models import hf_io
from areal_tpu_torch.models.qwen2 import (
    WEIGHT_DTYPES,
    LMHead,
    ModelConfig,
    check_supported,
    forward as model_forward,
    init_params,
    layer_views,
    named_shapes,
    quantize_weights,
    segment_ids_from_cu_seqlens,
    torch_dtype,
)
from areal_tpu_torch.ops.quant import quantize_absmax_compiled
from areal_tpu_torch.platforms import resolve_device
from areal_tpu_torch.utils import logging, name_resolve, names, stats_tracker
from areal_tpu_torch.utils.data import (
    split_padded_tensor_dict_into_mb_list,
    unpack_sequence,
)
from areal_tpu_torch.utils.flops import peak_flops, train_flops_per_token
from areal_tpu_torch.utils.perf_tracer import annotate, maybe_xprof_step

logger = logging.getLogger("torch_engine")

# the recovery format's files (weight_format="torch")
STATE_FILE = "torch_state.pt"
TRAIN_META = "train_meta.json"
# the JAX engine's layer-layout tag for a model-order layer stack
LAYER_LAYOUT = "model"


def make_lr_schedule(cfg: OptimizerConfig, total_steps: int) -> Callable[[int], float]:
    """lr at update count `count` (JAX :115, optax's join of a linear
    warm-up of at least one step and a constant, linear or cosine decay)."""
    warmup = max(int(cfg.warmup_steps_proportion * total_steps), 1)
    decay_steps = max(total_steps - warmup, 1)
    end = cfg.lr * cfg.min_lr_ratio
    if cfg.lr_scheduler_type not in ("cosine", "linear", "constant"):
        raise ValueError(f"unknown lr_scheduler_type {cfg.lr_scheduler_type}")

    def linear(init: float, final: float, steps: int, count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - final) * (1 - c / steps) + final

    def decay(count: int) -> float:
        if cfg.lr_scheduler_type == "cosine":
            c = min(count, decay_steps)
            cos = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
            return cfg.lr * ((1 - cfg.min_lr_ratio) * cos + cfg.min_lr_ratio)
        if cfg.lr_scheduler_type == "linear":
            return linear(cfg.lr, end, decay_steps, count)
        return cfg.lr

    def schedule(count: int) -> float:
        if count < warmup:
            return linear(0.0, cfg.lr, warmup, count)
        return decay(count - warmup)

    return schedule


def decay_mask(named: dict[str, torch.Tensor]) -> list[bool]:
    """Which tensors AdamW decays: optax's `p.ndim > 1` (JAX :149) on the
    JAX engine's default layout, where every layer leaf is stacked
    `[L, ...]` (`scan_layers=True`). Stacking makes each per-layer norm
    and bias a matrix, so the reference decays every per-layer tensor;
    of the others (embedding, final norm, untied head) only the matrices.
    Names are the port's: `layers_{i}/...` per layer, or `layers/...`
    already stacked."""
    return [t.dim() + name.startswith("layers_") > 1 for name, t in named.items()]


class Optimizer:
    """optax `adamw` (or `sgd`) as `make_optimizer` (JAX :135) builds it,
    applied in place to a list of parameter tensors, `decay` (one flag per
    tensor, see `decay_mask`) choosing which take weight decay. `step`
    reads the schedule at the update count, then increments it."""

    def __init__(self, cfg: OptimizerConfig, total_steps: int, params: list[torch.Tensor],
                 decay: list[bool]):
        if cfg.type not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer type {cfg.type}")
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg, total_steps)
        self.count = 0
        if cfg.type == "adamw":
            mu_dtype = torch_dtype(cfg.moment_dtype)
            self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in params]
            self.nu = [torch.zeros_like(p) for p in params]
            self.decay = list(decay)

    def state_dict(self, names: list[str]) -> dict:
        """The update count and, for AdamW, `mu` and `nu` keyed by the
        parameter names (host tensors)."""
        out: dict = {"count": int(self.count)}
        if self.cfg.type == "adamw":
            out["mu"] = {n: t.detach().cpu() for n, t in zip(names, self.mu)}
            out["nu"] = {n: t.detach().cpu() for n, t in zip(names, self.nu)}
        return out

    def load_state_dict(self, state: dict, names: list[str]) -> None:
        """Copy `state` into the moments in place (a changed `moment_dtype`
        is an error, not a cast)."""
        if self.cfg.type == "adamw":
            for key, moments in (("mu", self.mu), ("nu", self.nu)):
                for n, t in zip(names, moments):
                    _copy_into(t, state[key][n], f"optimizer {key}[{n}]")
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self, params: list[torch.Tensor], grads: list[torch.Tensor]) -> None:
        """`grads` in the parameters' dtype, already clipped."""
        cfg = self.cfg
        dev = params[0].device
        neg_lr = torch.tensor(-self.schedule(self.count), dtype=torch.float32, device=dev)
        self.count += 1
        if cfg.type == "sgd":
            for p, g in zip(params, grads):
                p.add_(g * neg_lr.to(g.dtype))
            return
        b1, b2 = cfg.beta1, cfg.beta2
        c = torch.tensor(float(self.count), dtype=torch.float32)
        bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** c).to(dev)
        bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** c).to(dev)

        def weak(x: float, like: torch.Tensor) -> torch.Tensor:
            # a Python scalar against a JAX array takes the array's dtype
            # before the product: in bf16, b2 = 0.95 is 0.94921875
            return torch.tensor(x, dtype=like.dtype, device=dev)

        for p, g, mu, nu, decay in zip(params, grads, self.mu, self.nu, self.decay):
            # optax's dtype steps: (1 - b1) * g is taken in g's dtype and the
            # first moment sums in its own; the second moment stays in the
            # parameter dtype throughout, and so does its bias correction
            mu.mul_(b1).add_((g * weak(1 - b1, g)).to(mu.dtype))
            nu.mul_(weak(b2, nu)).add_((g * g) * weak(1 - b2, g))
            denom = (nu / bc2.to(nu.dtype)).sqrt_().add_(weak(cfg.eps, nu))
            u = (mu / bc1).div_(denom)
            del denom
            if decay and cfg.weight_decay:
                u.add_(p * weak(cfg.weight_decay, p))
            u.mul_(neg_lr)
            p.copy_(p.float().add_(u))


@torch.no_grad()
def _copy_into(dst: torch.Tensor, src: torch.Tensor, what: str) -> None:
    """`dst.copy_(src)` for a stored tensor of `dst`'s dtype and shape."""
    if src.dtype != dst.dtype or src.shape != dst.shape:
        raise ValueError(f"{what}: stored {src.dtype} {tuple(src.shape)}, engine "
                         f"{dst.dtype} {tuple(dst.shape)}")
    dst.copy_(src)


def _format_message(fmt: str) -> str:
    if fmt == "orbax":
        return ("weight_format='orbax' is the JAX package's recovery format; the "
                "port's is a torch state dict: weight_format='torch'")
    return f"weight_format={fmt!r} not in ('hf', 'torch')"


def fused_lm_loss_enabled(engine) -> bool:
    """Whether `engine` wants `hidden_loss`-tagged loss functions (the
    vocab-chunked fused head; JAX :253)."""
    cfg = getattr(engine, "config", None)
    return bool(getattr(getattr(cfg, "jax", None), "fused_lm_loss", False))


class DcnWeightPush:
    """Handle of a staged "dcn" weight push in flight (JAX :261-330).

    `stage_fn` (framing and streaming, generation live) runs on a daemon
    thread started here; the trainer goes on meanwhile. `commit()` joins
    the staging thread, re-raising its error, then runs `commit_fn`: the
    only pause the decode servers see. `abort()` drops the servers'
    staging of a push that will not commit."""

    def __init__(self, stage_fn: Callable[[], None] | None,
                 commit_fn: Callable[[], None] | None,
                 abort_fn: Callable[[], None] | None = None):
        self._error: BaseException | None = None
        self._commit_fn = commit_fn
        self._abort_fn = abort_fn
        self._t0 = time.monotonic()
        self.stage_secs = 0.0
        self.commit_secs = 0.0
        self.committed = False
        self._thread = None
        if stage_fn is not None:

            def _run():
                try:
                    stage_fn()
                except BaseException as e:  # noqa: BLE001 — raised at join
                    self._error = e
                finally:
                    self.stage_secs = time.monotonic() - self._t0

            self._thread = threading.Thread(target=_run, daemon=True, name="dcn-weight-push")
            self._thread.start()

    def wait_staged(self) -> None:
        """Wait for staging to end, whatever its outcome (an error comes
        out of `join` or `commit`)."""
        if self._thread is not None:
            self._thread.join()

    def join(self, timeout: float | None = None) -> None:
        """Wait for staging to finish; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("dcn weight push still staging")
        if self._error is not None:
            raise self._error

    def commit(self) -> None:
        """`join`, then the pause window and the commit (once)."""
        if self.committed:
            return
        self.join()
        if self._commit_fn is not None:
            t0 = time.monotonic()
            self._commit_fn()
            self.commit_secs = time.monotonic() - t0
        self.committed = True
        logger.info(f"dcn weight push: staged {self.stage_secs:.2f}s (generation live) "
                    f"+ commit pause {self.commit_secs:.2f}s")

    def abort(self) -> None:
        """Best effort: drop the servers' staging of this push."""
        self.wait_staged()
        if self._abort_fn is not None and not self.committed:
            self._abort_fn()


class TorchTrainEngine(TrainEngine):
    """Training engine for the dense decoder on one card."""

    def __init__(self, config: TrainEngineConfig, device: str | torch.device | None = None):
        self.config = config
        # cuda:0 unless the caller names the CPU; raises without a card
        self.device = resolve_device(device)
        self.parallel_strategy: ParallelStrategy | None = None
        self.model_config: ModelConfig | None = None
        self.params: dict[str, torch.Tensor] | None = None
        self.optimizer: Optimizer | None = None
        self.lr_schedule = None
        self.ft_spec: FinetuneSpec | None = None
        self._layers: list[dict] | None = None
        self._version = 0
        self._step_count = 0
        self._train_mode = True
        self.rollout_engine: InferenceEngine | None = None
        self.weight_update_meta: WeightUpdateMeta | None = None
        # the layer layout weight pushes name: the model's configured
        # scan_layers (the engine itself keeps its layers unscanned)
        self._wire_scan = True
        # a dcn push whose staging may still read the parameters: the
        # next optimizer step waits for it
        self._push_in_flight: DcnWeightPush | None = None

    # -- lifecycle ------------------------------------------------------
    def create_process_group(self, parallel_strategy: ParallelStrategy | None = None) -> None:
        if parallel_strategy is not None and parallel_strategy.world_size != 1:
            raise NotImplementedError(
                f"a parallel strategy over {parallel_strategy.world_size} devices "
                "is not in the PyTorch port yet: ROADMAP.md queue 1, item 5"
            )
        self.parallel_strategy = parallel_strategy or ParallelStrategy()

    def initialize(
        self,
        addr: str | None = None,
        ft_spec: FinetuneSpec | None = None,
        params: dict[str, torch.Tensor] | None = None,
    ) -> None:
        """Build the model and the optimizer. The weights are `params`
        (the port's flat name -> tensor dict, any device, copied onto the
        engine's device), else a random init (`init_from_scratch` or no
        `path`), else the HF checkpoint at `path`, whose `config.json`
        also gives the model config when none is set."""
        cfg = self.config
        if cfg.use_lora:
            raise NotImplementedError(
                "use_lora=True is not in the PyTorch port yet: ROADMAP.md queue 1, item 6.7"
            )
        self.ft_spec = ft_spec
        if self.model_config is None:
            attn_impl = {"pallas": "flash", "xla": "dense"}.get(cfg.attn_impl, cfg.attn_impl)
            self.model_config = ModelConfig.from_hf_config(
                cfg.path,
                dtype=cfg.dtype,
                param_dtype=cfg.dtype,
                remat=cfg.gradient_checkpointing,
                remat_policy=cfg.jax.remat_policy,
                attn_impl=attn_impl,
                is_critic=cfg.is_critic,
            )
        self._wire_scan = self.model_config.scan_layers
        self.model_config = dataclasses.replace(self.model_config, scan_layers=False)
        cfg.jax.check_supported()
        mcfg = self.model_config
        check_supported(mcfg)
        want = named_shapes(mcfg)
        dtype = torch_dtype(mcfg.param_dtype)
        if params is not None:
            if set(params) != set(want):
                missing = sorted(set(want) - set(params))[:5]
                extra = sorted(set(params) - set(want))[:5]
                raise KeyError(f"parameter names differ: missing {missing}, extra {extra}")
            for name, t in params.items():
                if tuple(t.shape) != tuple(want[name]):
                    raise ValueError(f"{name}: shape {tuple(t.shape)} != {want[name]}")
            self.params = {
                k: v.detach().to(device=self.device, dtype=dtype, copy=True)
                for k, v in params.items()
            }
        elif cfg.init_from_scratch or not cfg.path:
            gen = torch.Generator(device=self.device).manual_seed(1)
            self.params = init_params(mcfg, gen, self.device)
        else:
            # the HF checkpoint at `path` (JAX :439-448); a critic read from
            # a causal LM starts from a zero value head
            self.params = hf_io.load_hf_params(cfg.path, mcfg, device=self.device)
        for p in self.params.values():
            p.requires_grad_(True)
        self._layers = layer_views(self.params, mcfg)
        if cfg.optimizer is not None:
            total_steps = ft_spec.total_train_steps if ft_spec else 1000
            self.optimizer = Optimizer(cfg.optimizer, total_steps, list(self.params.values()),
                                       decay_mask(self.params))
            self.lr_schedule = self.optimizer.schedule

    def destroy(self) -> None:
        self.params = self._layers = None
        self.optimizer = None

    # -- mode and versions ---------------------------------------------
    def train(self, mode: bool = True):
        self._train_mode = mode
        return self

    def set_version(self, version: int) -> None:
        self._version = version

    def get_version(self) -> int:
        return self._version

    # -- save / load ----------------------------------------------------
    def save(self, meta: SaveLoadMeta) -> None:
        """Write the weights as an HF checkpoint ("hf") or the whole
        training state in the recovery format ("torch")."""
        if meta.weight_format == "hf":
            hf_io.save_hf_params(self.params, self.model_config, meta.path)
            src = os.path.join(self.config.path, "config.json") if self.config.path else ""
            if src and os.path.exists(src):
                shutil.copy(src, os.path.join(meta.path, "config.json"))
            self._save_tokenizer(meta)
            if meta.with_optim:
                self._state_save(os.path.join(meta.path, "optim"), with_params=False,
                                 with_optim=True)
        elif meta.weight_format == "torch":
            self._state_save(meta.path, with_params=True, with_optim=meta.with_optim)
            self._save_tokenizer(meta)
        else:
            raise NotImplementedError(_format_message(meta.weight_format))

    def load(self, meta: SaveLoadMeta) -> None:
        """Install a checkpoint `save` wrote: the recovery format when asked
        for or found, else an HF directory (and its `optim/` with
        `with_optim`)."""
        if meta.weight_format not in ("hf", "torch"):
            raise NotImplementedError(_format_message(meta.weight_format))
        if meta.weight_format == "torch" or os.path.exists(os.path.join(meta.path, STATE_FILE)):
            self._state_load(meta.path, with_params=True, with_optim=meta.with_optim)
            return
        host = hf_io.load_hf_params(meta.path, self.model_config)
        self._copy_params(host)
        optim_dir = os.path.join(meta.path, "optim")
        if meta.with_optim and os.path.isdir(optim_dir):
            self._state_load(optim_dir, with_params=False, with_optim=True)

    @staticmethod
    def _save_tokenizer(meta: SaveLoadMeta) -> None:
        # the built-in arithmetic tokenizer has no files and no
        # save_pretrained (the JAX engine calls it on any tokenizer)
        if meta.tokenizer is not None and hasattr(meta.tokenizer, "save_pretrained"):
            meta.tokenizer.save_pretrained(meta.path)

    def _state_save(self, path: str, *, with_params: bool, with_optim: bool) -> None:
        os.makedirs(path, exist_ok=True)
        state: dict = {}
        if with_params:
            state["params"] = {k: v.detach().cpu() for k, v in self.params.items()}
        if with_optim and self.optimizer is not None:
            state["optim"] = self.optimizer.state_dict(list(self.params))
        torch.save(state, os.path.join(path, STATE_FILE))
        with open(os.path.join(path, TRAIN_META), "w") as f:
            json.dump(dict(step_count=self._step_count, version=self._version,
                           layer_layout=LAYER_LAYOUT), f)

    def _state_load(self, path: str, *, with_params: bool, with_optim: bool) -> None:
        with open(os.path.join(path, TRAIN_META)) as f:
            meta = json.load(f)
        if meta.get("layer_layout", LAYER_LAYOUT) != LAYER_LAYOUT:
            raise ValueError(
                f"checkpoint layer layout {meta['layer_layout']!r} does not match "
                f"the engine's {LAYER_LAYOUT!r}"
            )
        state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                           weights_only=True)
        if with_params:
            self._copy_params(state["params"])
        if with_optim and self.optimizer is not None:
            if "optim" not in state:
                raise KeyError(f"{path} holds no optimizer state")
            self.optimizer.load_state_dict(state["optim"], list(self.params))
        self._step_count = int(meta["step_count"])
        self._version = int(meta["version"])

    def _copy_params(self, named: dict[str, torch.Tensor]) -> None:
        """Copy `named` into the engine's parameters in place; names,
        shapes and dtypes must be the engine's."""
        if set(named) != set(self.params):
            missing = sorted(set(self.params) - set(named))[:5]
            extra = sorted(set(named) - set(self.params))[:5]
            raise KeyError(f"parameter names differ: missing {missing}, extra {extra}")
        for k, p in self.params.items():
            _copy_into(p, named[k], k)

    # -- weight updates -------------------------------------------------
    def connect_engine(self, engine: InferenceEngine, meta: WeightUpdateMeta):
        self.rollout_engine = engine
        self.weight_update_meta = meta
        engine.init_weights_update_group(meta)
        return self

    def update_weights(self, meta: WeightUpdateMeta | None = None) -> None:
        """Push the current weights to the connected decode engine, stamped
        with this engine's version (JAX :947-990): "memory" copies them
        into a colocated engine in place; "disk" writes an HF checkpoint
        to `meta.path`, records the push under name_resolve's
        `update_weights_from_disk` key and has the engine load it; "dcn"
        stages and commits an HTTP push (`update_weights_async`)."""
        meta = meta or self.weight_update_meta
        if meta is None or self.rollout_engine is None:
            raise RuntimeError("no decode engine connected: call connect_engine first")
        # chaos seam (JAX :948-954): death in the middle of a push; the
        # decode side keeps the old version until the restored trainer
        # pushes again. `update_weights_async` has none, as in JAX.
        fault_injection.fire("train.weights.push", version=self.get_version())
        if meta.use_lora:
            raise NotImplementedError(
                "LoRA delta push is not in the PyTorch port yet: ROADMAP.md queue 1, item 6.7"
            )
        if meta.type == "memory":
            named = {k: v.detach() for k, v in self.params.items()}
            self.rollout_engine.update_weights_from_distributed(
                meta, named, self.model_config, version=self.get_version()
            )
        elif meta.type == "disk":
            if meta.path is None:
                raise ValueError("a disk weight update needs meta.path")
            start = time.monotonic()
            hf_io.save_hf_params(self.params, self.model_config, meta.path)
            # the timestamp handshake of the reference's disk push
            name_resolve.add(
                names.update_weights_from_disk(
                    self.config.experiment_name, self.config.trial_name, self.get_version()),
                str(time.time_ns()), replace=True,
            )
            self.rollout_engine.update_weights_from_disk(meta)
            logger.info(f"disk weight update took {time.monotonic() - start:.2f}s")
        elif meta.type == "dcn":
            self.update_weights_async(meta).commit()
        else:
            raise NotImplementedError(f"weight update type {meta.type}")

    def _wire_leaves(self, weight_dtype: str):
        """(wire name, device tensor) of the push, one leaf at a time, in
        the order the JAX trainer pushes (its jitted cast returns the tree
        with sorted keys) for the configured layout: each floating
        tensor cast to bf16, each `layers_{i}` leaf stacked into
        `layers/<leaf>` `[L, ...]` when the layout is scanned, and the
        dense kernels quantized to `<path>/q` (int8) and `<path>/scale`
        (f32) for `weight_dtype="int8"`, with the arithmetic of the JAX
        trainer's jitted quantizer (`quantize_absmax_compiled`)."""
        if weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype={weight_dtype!r} not in {WEIGHT_DTYPES}")
        cfg = dataclasses.replace(self.model_config, scan_layers=self._wire_scan)
        L = cfg.num_hidden_layers
        with torch.no_grad():
            for name in sorted(named_shapes(cfg), key=lambda n: n.split("/")):
                if name.startswith("layers/"):
                    leaf = name[len("layers/"):]
                    t = torch.stack([self.params[f"layers_{i}/{leaf}"] for i in range(L)])
                else:
                    t = self.params[name]
                t = t.detach()
                if t.is_floating_point():
                    t = t.to(torch.bfloat16)
                if weight_dtype == "int8":
                    yield from quantize_weights({name: t}, quantize_absmax_compiled).items()
                else:
                    yield name, t

    def _dcn_payload(self, inflight: int, weight_dtype: str = "fp"):
        """The push's lazy (name, host tensor) producer (JAX :992-1068):
        `_wire_leaves` with the copies of the next `inflight` (at least 2)
        leaves to pinned host memory running on a side stream while the
        earlier ones are framed and sent."""
        from areal_tpu_torch.core.weight_transfer import iter_prefetched

        return iter_prefetched(self._wire_leaves(weight_dtype), window=max(inflight, 2))

    def update_weights_async(self, meta: WeightUpdateMeta | None = None) -> DcnWeightPush:
        """Start a dcn push without blocking the trainer (JAX :1070-1130):
        framing and streaming run on the handle's thread, generation goes
        on, and `.commit()` on the handle pauses the servers only for the
        install. The staging thread reads the parameters leaf by leaf, so
        this engine's next optimizer step waits until it has finished."""
        meta = meta or self.weight_update_meta
        if meta is None or meta.type != "dcn":
            raise ValueError("update_weights_async takes a 'dcn' WeightUpdateMeta")
        if meta.use_lora:
            raise NotImplementedError(
                "LoRA delta push is not in the PyTorch port yet: ROADMAP.md queue 1, item 6.7"
            )
        engine = self.rollout_engine
        if engine is None:
            raise RuntimeError("no decode engine connected: call connect_engine first")
        inflight = getattr(getattr(engine, "config", None), "weight_sync_inflight_buckets", 2)
        chunk_mb = meta.weight_chunked_mem_mb or 512
        named = self._dcn_payload(inflight, meta.weight_dtype)
        version = self.get_version()
        push_id = engine._new_push_id()

        def _stage():
            engine.stage_weights(named, push_id=push_id, chunk_mb=chunk_mb, inflight=inflight)

        push = DcnWeightPush(
            _stage,
            lambda: engine.commit_staged(push_id, version=version),
            lambda: engine.abort_push(push_id),
        )
        self._push_in_flight = push
        return push

    # -- compute --------------------------------------------------------
    def _device_mb(self, mb: dict[str, Any]) -> dict[str, torch.Tensor]:
        """One packed micro-batch on the device: its token-aligned arrays
        plus segment and position ids (JAX :1139)."""
        cu = np.asarray(mb["cu_seqlens"])
        total = int(cu[-1])
        out = {}
        for k, v in mb.items():
            if k in ("cu_seqlens", "max_seqlen"):
                continue
            if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == total:
                out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
        out["input_ids"] = out["input_ids"].long()
        out["segment_ids"] = torch.from_numpy(segment_ids_from_cu_seqlens(cu, total)).to(self.device)
        pos = np.arange(total, dtype=np.int64) - np.repeat(cu[:-1], np.diff(cu)).astype(np.int64)
        out["position_ids"] = torch.from_numpy(pos).to(self.device)
        return out

    def _model_out(self, mb: dict[str, torch.Tensor], fn: Callable | None):
        """Logits (a critic's values `[T]`), or an `LMHead` for
        `hidden_loss`-tagged functions, which a critic refuses."""
        hidden = bool(getattr(fn, "hidden_loss", False))
        if hidden and self.model_config.is_critic:
            raise ValueError(
                "a hidden_loss-tagged function reads the LM head; a critic has a value head"
            )
        x = model_forward(
            self.params, mb["input_ids"], mb["position_ids"], mb["segment_ids"],
            self.model_config, return_hidden=hidden, layers=self._layers,
        )
        return LMHead(x, self.params, self.model_config) if hidden else x

    def train_batch(
        self,
        input_: dict[str, Any],
        loss_fn: Callable,
        loss_weight_fn: Callable,
    ) -> dict[str, float]:
        if self.optimizer is None:
            raise RuntimeError("engine has no optimizer")
        # chaos seam (JAX :1580-1585): death inside an optimizer step, with
        # nothing durable written
        fault_injection.fire("train.step", step=self._step_count)
        t_start = time.perf_counter()
        # the env-gated device-trace window (AREAL_TPU_XPROF_DIR, _STEPS)
        maybe_xprof_step(self._step_count, owner=id(self), device=self.device)
        mb_list = split_padded_tensor_dict_into_mb_list(input_, self.config.mb_spec)
        weights = [float(loss_weight_fn(mb)) for mb in mb_list.mbs]
        total_weight = float(sum(weights)) or 1.0
        aux_mode = bool(getattr(loss_fn, "returns_aux", False))
        plist = list(self.params.values())
        grad_dtype = torch_dtype(self.config.grad_reduce_dtype)
        losses, mb_stat_list = [], []
        with annotate("train_batch", device=self.device):
            acc = [torch.zeros_like(p, dtype=grad_dtype) for p in plist]
            for mb, w in zip(mb_list.mbs, weights):
                dev_mb = self._device_mb(mb)
                res = loss_fn(self._model_out(dev_mb, loss_fn), dev_mb)
                loss, stats = res if aux_mode else (res, {})
                grads = torch.autograd.grad(loss, plist, allow_unused=True)
                with torch.no_grad():
                    for a, g in zip(acc, grads):
                        if g is not None:
                            a.add_(g.to(grad_dtype) * w)
                del grads
                # device scalars: read once after the update, no sync per mb
                losses.append(loss.detach())
                mb_stat_list.append({k: v.detach() for k, v in stats.items()})
            gnorm = self._apply_update(plist, acc, total_weight)
            gnorm_f = float(gnorm)  # waits for the step on the device
        step_time = time.perf_counter() - t_start
        self._step_count += 1
        aux_stats: dict[str, float] = {}
        for mb_stats, w in zip(mb_stat_list, weights):
            for k, v in mb_stats.items():
                aux_stats[k] = aux_stats.get(k, 0.0) + float(v) * w
        aux_stats = {k: v / total_weight for k, v in aux_stats.items()}
        stats = dict(
            loss=float(sum(float(l) * w for l, w in zip(losses, weights)) / total_weight),
            grad_norm=gnorm_f,
            lr=float(self.lr_schedule(self._step_count)),
            n_mbs=len(mb_list.mbs),
            update_steps=self._step_count,
            **aux_stats,
        )
        stats.update(self._throughput_stats(input_, step_time))
        return stats

    @torch.no_grad()
    def _apply_update(self, plist, acc, total_weight: float):
        """grads / total_weight, global-norm clip, cast to the parameter
        dtype, optimizer step (JAX :1531). Consumes `acc`. A dcn push still
        reading the parameters finishes first."""
        if self._push_in_flight is not None:
            self._push_in_flight.wait_staged()
            self._push_in_flight = None
        torch._foreach_div_(acc, total_weight)
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(acc)))
        clip = self.config.optimizer.gradient_clipping
        if clip and clip > 0:
            torch._foreach_mul_(acc, torch.clamp(clip / (gnorm + 1e-6), max=1.0))
        grads = [a.to(p.dtype) for a, p in zip(acc, plist)]
        acc.clear()
        self.optimizer.step(plist, grads)
        return gnorm

    def _throughput_stats(self, input_: dict[str, Any], step_time: float) -> dict[str, float]:
        """Tokens, step time, TFLOP/s and MFU against the card's bf16 dense
        peak (JAX :1654). A critic's series are prefixed `critic/`, so a
        colocated actor's and critic's never average into one stream (JAX
        :1680-1682)."""
        mask = input_.get("attention_mask")
        if mask is not None:
            lens = np.asarray(mask).sum(axis=-1).astype(np.int64)
        else:
            lens = np.asarray([input_["input_ids"].shape[-1]])
        n_tokens = int(lens.sum())
        avg_ctx = float((lens * (lens + 1) / 2).sum() / max(n_tokens, 1))
        tflops = train_flops_per_token(self.model_config, avg_ctx) * n_tokens / step_time / 1e12
        kind = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        mfu = tflops * 1e12 / peak_flops(kind)
        p = "critic/" if self.config.is_critic else ""
        stats_tracker.scalar(**{
            f"{p}time_perf/train_batch": step_time,
            f"{p}throughput/n_tokens": float(n_tokens),
            f"{p}throughput/tokens_per_sec_per_chip": n_tokens / step_time,
            f"{p}throughput/tflops_per_chip": tflops,
            f"{p}throughput/mfu": mfu,
        })
        return dict(
            n_tokens=float(n_tokens),
            train_batch_time=step_time,
            tokens_per_sec_per_chip=n_tokens / step_time,
            tflops_per_chip=tflops,
            mfu=mfu,
        )

    @torch.no_grad()
    def eval_batch(self, input_: dict[str, Any], loss_fn: Callable, loss_weight_fn: Callable):
        mb_list = split_padded_tensor_dict_into_mb_list(input_, self.config.mb_spec)
        aux_mode = bool(getattr(loss_fn, "returns_aux", False))
        total_loss, total_w = 0.0, 0.0
        for mb in mb_list.mbs:
            w = float(loss_weight_fn(mb))
            dev_mb = self._device_mb(mb)
            res = loss_fn(self._model_out(dev_mb, loss_fn), dev_mb)
            total_loss += float(res[0] if aux_mode else res) * w
            total_w += w
        return total_loss / (total_w or 1.0)

    @torch.no_grad()
    def forward(
        self,
        input_: dict[str, Any],
        output_seqlens: list[int] | None = None,
        post_hook: Callable | None = None,
        aggregate_fn: Callable | None = None,
    ):
        """No-grad forward over micro-batches; per-sequence outputs
        (numpy) in input order, then `aggregate_fn` (JAX :1742)."""
        mb_list = split_padded_tensor_dict_into_mb_list(input_, self.config.mb_spec)
        per_seq: list = [None] * input_["attention_mask"].shape[0]
        if aggregate_fn is None:
            aggregate_fn = lambda xs: np.concatenate(xs, axis=0)  # noqa: E731
        for mb, sample_idx in zip(mb_list.mbs, mb_list.forward_indices):
            dev_mb = self._device_mb(mb)
            x = self._model_out(dev_mb, post_hook)
            out = post_hook(x, dev_mb) if post_hook is not None else x
            out = out.float().cpu().numpy()
            # drop the pad tail: the appended fake sequence comes last
            seqs = unpack_sequence(out, np.asarray(mb["cu_seqlens"]))[: len(sample_idx)]
            for i, s in zip(sample_idx, seqs):
                per_seq[i] = s
        return aggregate_fn(per_seq)
