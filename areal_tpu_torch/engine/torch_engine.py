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
- Weights reach a colocated `TorchDecodeEngine` in memory
  (`update_weights`, "memory" only): the decode engine copies them in
  place on the same card.
Save/load and the SFT engine are later ROADMAP items (queue 1, item 2).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from areal_tpu_torch.api.alloc_mode import ParallelStrategy
from areal_tpu_torch.api.cli_args import OptimizerConfig, TrainEngineConfig
from areal_tpu_torch.api.engine_api import InferenceEngine, TrainEngine
from areal_tpu_torch.api.io_struct import FinetuneSpec, WeightUpdateMeta
from areal_tpu_torch.models.qwen2 import (
    LMHead,
    ModelConfig,
    check_supported,
    forward as model_forward,
    init_params,
    layer_views,
    named_shapes,
    segment_ids_from_cu_seqlens,
    torch_dtype,
)
from areal_tpu_torch.platforms import resolve_device
from areal_tpu_torch.utils import logging, stats_tracker
from areal_tpu_torch.utils.data import (
    split_padded_tensor_dict_into_mb_list,
    unpack_sequence,
)
from areal_tpu_torch.utils.flops import peak_flops, train_flops_per_token

logger = logging.getLogger("torch_engine")


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


def fused_lm_loss_enabled(engine) -> bool:
    """Whether `engine` wants `hidden_loss`-tagged loss functions (the
    vocab-chunked fused head; JAX :253)."""
    return bool(getattr(getattr(engine, "config", None), "fused_lm_loss", False))


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
        """Build the model and the optimizer. `params` (the port's flat
        name -> tensor dict, any device) installs given weights instead of
        a random init; they are copied onto the engine's device."""
        cfg = self.config
        for name, unsupported, item in (
            ("is_critic", cfg.is_critic, "item 6"),
            ("use_lora", cfg.use_lora, "item 6"),
        ):
            if unsupported:
                raise NotImplementedError(
                    f"{name}=True is not in the PyTorch port yet: ROADMAP.md queue 1, {item}"
                )
        self.ft_spec = ft_spec
        if self.model_config is None:
            attn_impl = {"pallas": "flash", "xla": "dense"}.get(cfg.attn_impl, cfg.attn_impl)
            self.model_config = ModelConfig.from_hf_config(
                cfg.path,
                dtype=cfg.dtype,
                param_dtype=cfg.dtype,
                remat=cfg.gradient_checkpointing,
                remat_policy=cfg.remat_policy,
                attn_impl=attn_impl,
            )
        self.model_config = dataclasses.replace(self.model_config, scan_layers=False)
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
            raise NotImplementedError(
                "loading weights from a checkpoint path is not in the PyTorch "
                "port yet (ROADMAP.md queue 1, item 6); pass params= or "
                "init_from_scratch=True"
            )
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

    # -- weight updates -------------------------------------------------
    def connect_engine(self, engine: InferenceEngine, meta: WeightUpdateMeta):
        self.rollout_engine = engine
        self.weight_update_meta = meta
        engine.init_weights_update_group(meta)
        return self

    def update_weights(self, meta: WeightUpdateMeta | None = None) -> None:
        """Push the current weights to the connected decode engine, which
        copies them in place and stamps this engine's version on every
        token it generates next (JAX :947-963)."""
        meta = meta or self.weight_update_meta
        if meta is None or self.rollout_engine is None:
            raise RuntimeError("no decode engine connected: call connect_engine first")
        if meta.type != "memory":
            raise NotImplementedError(
                f"weight update type {meta.type!r} is not in the PyTorch port "
                "yet: ROADMAP.md queue 1, item 4"
            )
        named = {k: v.detach() for k, v in self.params.items()}
        self.rollout_engine.update_weights_from_distributed(
            meta, named, self.model_config, version=self.get_version()
        )

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
        """Logits, or an `LMHead` for `hidden_loss`-tagged functions."""
        hidden = bool(getattr(fn, "hidden_loss", False))
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
        t_start = time.perf_counter()
        mb_list = split_padded_tensor_dict_into_mb_list(input_, self.config.mb_spec)
        weights = [float(loss_weight_fn(mb)) for mb in mb_list.mbs]
        total_weight = float(sum(weights)) or 1.0
        aux_mode = bool(getattr(loss_fn, "returns_aux", False))
        plist = list(self.params.values())
        grad_dtype = torch_dtype(self.config.grad_reduce_dtype)
        acc = [torch.zeros_like(p, dtype=grad_dtype) for p in plist]
        losses, mb_stat_list = [], []
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
        dtype, optimizer step (JAX :1531). Consumes `acc`."""
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
        peak (JAX :1654)."""
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
        stats_tracker.scalar(**{
            "time_perf/train_batch": step_time,
            "throughput/n_tokens": float(n_tokens),
            "throughput/tokens_per_sec_per_chip": n_tokens / step_time,
            "throughput/tflops_per_chip": tflops,
            "throughput/mfu": mfu,
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
