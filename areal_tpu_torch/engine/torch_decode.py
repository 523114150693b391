"""TorchDecodeEngine: the in-process decode engine on one CUDA card
(counterpart of `areal_tpu/engine/jax_decode.py::JaxDecodeEngine`, its
serving core).

- **Continuous batching over a paged KV pool.** R fixed decode slots over
  one pool `[L, n_blocks, page_size, nKV, hd]` per K/V with host-side block
  tables (engine/kv_pool.py). Requests hot-swap in and out of slots.
- **Admission** takes a free slot, reserves blocks for the prompt, and
  prefills `prompt[:-1]` (bucketed to 64 tokens) into the slot's blocks;
  the prompt's last token is the first decode input, so every generated
  token, the first included, is sampled by the decode loop.
- **Chunked, interruptible decode.** The scheduler thread runs
  `new_tokens_per_chunk` steps of `decode_step_paged` plus sampling on the
  device, then copies the chunk's tokens and logprobs to the host once.
  `pause_generation` takes effect on chunk boundaries, and each token
  carries the weight version it was generated under.

This slice schedules synchronously (dispatch a chunk, then consume it) and
prefills every request in full: the JAX engine's run-ahead, prefix forks,
host KV tier, speculative decode and int8 paths are later ROADMAP items
(`TorchDecodeConfig.check_supported` refuses their settings).
"""

from __future__ import annotations

import asyncio
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from areal_tpu_torch.api.cli_args import (
    GenerationHyperparameters,
    InferenceEngineConfig,
    TorchDecodeConfig,
)
from areal_tpu_torch.api.engine_api import InferenceEngine
from areal_tpu_torch.api.io_struct import ModelRequest, ModelResponse
from areal_tpu_torch.engine.kv_pool import KVBlockAllocator, PoolDry
from areal_tpu_torch.engine.sampling import sample
from areal_tpu_torch.models.convert import to_tensor
from areal_tpu_torch.models.qwen2 import (
    ModelConfig,
    check_supported,
    decode_step_paged,
    layer_views,
    named_shapes,
    prefill,
    torch_dtype,
)
from areal_tpu_torch.platforms import resolve_device
from areal_tpu_torch.utils import logging

logger = logging.getLogger("torch_decode")

_PREFILL_BUCKET = 64


def _next_bucket(n: int, bucket: int = _PREFILL_BUCKET) -> int:
    return max(((n + bucket - 1) // bucket) * bucket, bucket)


@dataclass
class _Slot:
    rid: str
    prompt: list[int]
    gconfig: GenerationHyperparameters
    future: "asyncio.Future | None"
    loop: Any
    tokens: list[int] = field(default_factory=list)
    logprobs: list[float] = field(default_factory=list)
    versions: list[int] = field(default_factory=list)
    itl: list[float] = field(default_factory=list)
    start_time: float = field(default_factory=time.monotonic)
    ttft: float = float("inf")
    stop_reason: str | None = None


def _resolve(fut: asyncio.Future, resp: ModelResponse) -> None:
    if not fut.done():
        fut.set_result(resp)


def _fail(fut: asyncio.Future, exc: BaseException) -> None:
    if not fut.done():
        fut.set_exception(exc)


class TorchDecodeEngine(InferenceEngine):
    def __init__(
        self,
        config: TorchDecodeConfig,
        inference_config: InferenceEngineConfig | None = None,
        tokenizer: Any = None,
        device: str | torch.device | None = None,
    ):
        self.config = config
        self.inference_config = inference_config or InferenceEngineConfig()
        self.tokenizer = tokenizer
        # cuda:0 unless the caller names the CPU; raises without a card
        self.device = resolve_device(device)
        self.model_config: ModelConfig | None = None
        self.params: dict[str, torch.Tensor] | None = None
        self._layers: list[dict[str, torch.Tensor]] | None = None
        self._version = 0

        self._request_q: queue.Queue = queue.Queue()
        self._shutdown = threading.Event()
        self._gen_paused = threading.Event()
        # Serializes scheduler passes (admission + one chunk) against
        # pause_generation: a pause sets the flag, then takes this lock
        # once, after which no chunk runs until continue_generation.
        self._sched_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._thread_exc: BaseException | None = None

        # device and slot state (created in initialize)
        self._k_pool: torch.Tensor | None = None
        self._v_pool: torch.Tensor | None = None
        self._alloc: KVBlockAllocator | None = None
        self._slots: list[_Slot | None] = []
        self._slot_lengths: np.ndarray | None = None  # KV rows each slot holds
        self._overflow: list[_Slot] = []  # popped, waiting for capacity
        self._generator: torch.Generator | None = None

        # counters (written by the scheduler thread only)
        self.decode_steps = 0
        self.decode_seconds = 0.0  # chunk walls, each ending in its host copy
        self.decode_tokens = 0  # tokens delivered to requests
        self.prefill_tokens = 0
        self.prefill_seconds = 0.0
        self.n_preemptions = 0

    # -- lifecycle ------------------------------------------------------
    def set_model(self, params: dict[str, torch.Tensor], model_config: ModelConfig) -> None:
        """Install weights (the port's flat name -> tensor dict). Always
        copies onto the engine's device: the caller keeps its tensors."""
        check_supported(model_config)
        want = named_shapes(model_config)
        if set(params) != set(want):
            missing = sorted(set(want) - set(params))[:5]
            extra = sorted(set(params) - set(want))[:5]
            raise KeyError(f"parameter names differ: missing {missing}, extra {extra}")
        for name, t in params.items():
            if tuple(t.shape) != tuple(want[name]):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {want[name]}")
        self.model_config = model_config
        self.params = {
            k: v.detach().to(self.device, copy=True) for k, v in params.items()
        }
        # per-layer views, built once: weight pushes copy in place
        self._layers = layer_views(self.params, model_config)

    def initialize(self) -> "TorchDecodeEngine":
        self.config.check_supported()
        if self.params is None:
            raise RuntimeError("no model installed: call set_model first")
        cfg = self.model_config
        if self.config.kv_cache_dtype != cfg.dtype:
            # the kernel reads the pool in q's dtype; refuse the mismatch
            # here, on the CPU and the card alike, not at the first step
            raise NotImplementedError(
                f"kv_cache_dtype={self.config.kv_cache_dtype!r} differs from "
                f"the model dtype {cfg.dtype!r}: a KV pool in another dtype "
                "is not in the PyTorch port yet: ROADMAP.md queue 1, item 3"
            )
        R = int(self.config.max_running_requests)
        S = int(self.config.context_length)
        # pool sizing as jax_decode.py:692-802: page-size blocks, and either
        # the dense worst case (R x S) or the kv_pool_tokens budget
        bs = min(int(self.config.page_size), S)
        max_bps = -(-S // bs)
        if self.config.kv_pool_tokens:
            n_blocks = max(-(-int(self.config.kv_pool_tokens) // bs), max_bps) + 1
        else:
            n_blocks = R * max_bps + 1
        self._alloc = KVBlockAllocator(R, n_blocks, bs, max_bps)
        shape = (
            cfg.num_hidden_layers, n_blocks, bs,
            cfg.num_key_value_heads, cfg.head_dim_,
        )
        kv_dtype = torch_dtype(self.config.kv_cache_dtype)
        self._k_pool = torch.zeros(shape, dtype=kv_dtype, device=self.device)
        self._v_pool = torch.zeros(shape, dtype=kv_dtype, device=self.device)
        self._slots = [None] * R
        self._slot_lengths = np.zeros(R, dtype=np.int64)
        self._overflow = []
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(self.config.random_seed))
        self._thread_exc = None
        self._shutdown.clear()
        self._thread = threading.Thread(
            target=self._scheduler_loop, daemon=True, name="torch-decode-scheduler"
        )
        self._thread.start()
        return self

    def destroy(self) -> None:
        self._shutdown.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None
        self.params = self._layers = None
        self._k_pool = self._v_pool = None
        self._alloc = None

    # -- scheduler ------------------------------------------------------
    def _scheduler_loop(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.no_grad():
                while not self._shutdown.is_set():
                    with self._sched_lock:
                        paused = self._gen_paused.is_set()
                        worked = False
                        if not paused:
                            worked = self._admit()
                            active = self._active_mask()
                            if active.any():
                                worked = self._run_chunk(active) or worked
                    if paused:
                        time.sleep(0.005)
                    elif not worked:
                        time.sleep(0.002)
        except BaseException as e:  # noqa: BLE001 — fail every waiter, then stop
            self._thread_exc = e
            logger.error(f"decode scheduler died: {e}\n{traceback.format_exc()}")
            pending = [s for s in self._slots if s is not None] + self._overflow
            while True:
                try:
                    pending.append(self._request_q.get_nowait())
                except queue.Empty:
                    break
            for item in pending:
                if item.future is not None:
                    item.loop.call_soon_threadsafe(_fail, item.future, e)
            self._slots = [None] * len(self._slots)
            self._overflow = []

    def _next_request(self) -> _Slot | None:
        if self._overflow:
            return self._overflow.pop(0)
        try:
            return self._request_q.get_nowait()
        except queue.Empty:
            return None

    def _active_mask(self) -> np.ndarray:
        return np.array([s is not None for s in self._slots], dtype=bool)

    def _admit(self) -> bool:
        """Admit queued requests into free slots, prefilling their prompts.
        Prefill per pass is capped at `max_prefill_tokens` (the first
        admission always goes through), so a burst of long prompts cannot
        hold running slots for more than one budget before the next chunk."""
        S = int(self.config.context_length)
        budget = max(int(self.config.max_prefill_tokens), _PREFILL_BUCKET)
        did_prefill = admitted = False
        while True:
            item = self._next_request()
            if item is None:
                break
            # a preempted request comes back with its tokens: its coverage
            # is the whole conversation so far
            prompt = item.prompt + item.tokens
            P = len(prompt)
            if len(item.prompt) + item.gconfig.max_new_tokens > S:
                self._complete(item, "length")
                continue
            bucket = min(_next_bucket(P - 1), S) if P > 1 else 0
            if did_prefill and bucket > budget:
                self._overflow.insert(0, item)
                break
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free:
                self._overflow.insert(0, item)
                break
            slot = free[0]
            self._alloc.free_slot(slot)
            if P > 1:
                if not self._alloc.ensure(slot, bucket):
                    self._overflow.insert(0, item)
                    break
                self._prefill(slot, prompt[:-1], bucket)
                budget -= bucket
                did_prefill = True
            self._slots[slot] = item
            self._slot_lengths[slot] = P - 1
            admitted = True
        return admitted

    def _prefill(self, slot: int, ids: list[int], bucket: int) -> None:
        """Cache-warm prefill of `ids` into the slot's first blocks. Rows
        past len(ids) hold the pad tokens' KV; decode overwrites each of
        them before the validity mask ever lets it be read."""
        cfg = self.model_config
        t0 = time.perf_counter()
        padded = torch.zeros(bucket, dtype=torch.long)
        padded[: len(ids)] = torch.tensor(ids, dtype=torch.long)
        _, k, v = prefill(
            self.params,
            padded.to(self.device),
            torch.arange(bucket, device=self.device),
            cfg,
            with_logits=False,
            layers=self._layers,
        )  # [L, bucket, nKV, hd]
        bsz = self._alloc.block_size
        nb_w = -(-bucket // bsz)
        pad = nb_w * bsz - bucket
        if pad:
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
        rows = torch.from_numpy(self._alloc.row(slot, nb_w)).long().to(self.device)
        shape = (cfg.num_hidden_layers, nb_w, bsz, cfg.num_key_value_heads, cfg.head_dim_)
        self._k_pool[:, rows] = k.reshape(shape).to(self._k_pool.dtype)
        self._v_pool[:, rows] = v.reshape(shape).to(self._v_pool.dtype)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prefill_seconds += time.perf_counter() - t0
        self.prefill_tokens += len(ids)

    def _chunk_bucket(self, active: np.ndarray) -> int:
        """Smallest KV span (256 x 2^k, capped at the context) covering
        every active slot through this chunk: attention reads only the
        table columns of this span."""
        needed = int(self._slot_lengths[active].max()) + int(self.config.new_tokens_per_chunk) + 1
        b = 256
        while b < needed:
            b *= 2
        return min(b, int(self.config.context_length))

    def _preempt(self, slot: int) -> None:
        """Pool pressure: requeue the slot's request at the front (it
        re-admits with its tokens so far) and free its blocks."""
        item = self._slots[slot]
        self._slots[slot] = None
        self._alloc.free_slot(slot)
        self._slot_lengths[slot] = 0
        self._overflow.insert(0, item)
        self.n_preemptions += 1

    def _run_chunk(self, active: np.ndarray) -> bool:
        """Run one chunk of `new_tokens_per_chunk` decode steps over the
        active slots and consume it. False when pool pressure left no
        slot to run."""
        cfg = self.model_config
        R = int(self.config.max_running_requests)
        S = int(self.config.context_length)
        n_chunk = int(self.config.new_tokens_per_chunk)
        dev = self.device
        # every active slot needs blocks through this chunk; shortest
        # first, so pool pressure preempts as few slots as possible
        order = sorted(np.nonzero(active)[0], key=lambda i: self._slot_lengths[i])
        for i in order:
            if self._slots[i] is None:
                continue
            need = min(int(self._slot_lengths[i]) + n_chunk + 1, S)
            while not self._alloc.ensure(i, need):
                victims = [j for j in order if j != i and self._slots[j] is not None]
                if not victims:  # the pool always fits one full-context slot
                    raise PoolDry("KV pool cannot back a single active slot")
                self._preempt(max(victims, key=lambda j: self._slot_lengths[j]))
        active = self._active_mask()
        if not active.any():
            return False

        nb = -(-self._chunk_bucket(active) // self._alloc.block_size)
        last = np.zeros(R, dtype=np.int64)
        temps = np.ones(R, dtype=np.float32)
        top_ps = np.ones(R, dtype=np.float32)
        greedy = np.zeros(R, dtype=bool)
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            last[i] = s.tokens[-1] if s.tokens else s.prompt[-1]
            temps[i] = max(s.gconfig.temperature, 1e-6)
            top_ps[i] = s.gconfig.top_p
            greedy[i] = s.gconfig.greedy
        use_topp = bool(np.any(~greedy & active & (top_ps < 1.0)))
        tokens = torch.from_numpy(last).to(dev)
        lengths = torch.from_numpy(self._slot_lengths.copy()).to(dev)
        active_t = torch.from_numpy(active.copy()).to(dev)
        table = torch.from_numpy(self._alloc.table_slice(nb)).to(dev)
        temps_t = torch.from_numpy(temps).to(dev)
        top_ps_t = torch.from_numpy(top_ps).to(dev)
        greedy_t = torch.from_numpy(greedy).to(dev)
        toks = torch.empty((n_chunk, R), dtype=torch.long, device=dev)
        logps = torch.empty((n_chunk, R), dtype=torch.float32, device=dev)
        version = self._version

        t0 = time.perf_counter()
        for step in range(n_chunk):
            logits = decode_step_paged(
                self.params, tokens, lengths, self._k_pool, self._v_pool,
                table, cfg, active=active_t, layers=self._layers,
            )
            tok, logp = sample(
                logits, temps_t, top_ps_t, greedy_t, self._generator, use_topp
            )
            tok = torch.where(active_t, tok, tokens)
            toks[step] = tok
            logps[step] = logp
            lengths = lengths + active_t
            tokens = tok
        # the chunk's one device-to-host copy (and its only sync)
        toks_h = toks.cpu().numpy()
        logps_h = logps.cpu().numpy()
        dt = time.perf_counter() - t0
        self.decode_steps += n_chunk
        self.decode_seconds += dt

        now = time.monotonic()
        for i in np.nonzero(active)[0]:
            s = self._slots[i]
            if s.ttft == float("inf"):
                s.ttft = now - s.start_time
            n_before = len(s.tokens)
            s.tokens.extend(toks_h[:, i].tolist())
            s.logprobs.extend(logps_h[:, i].tolist())
            s.versions.extend([version] * n_chunk)
            s.itl.extend([dt / n_chunk] * n_chunk)
            self._truncate_at_stop(s)
            self.decode_tokens += len(s.tokens) - n_before
            if s.stop_reason is not None:
                self._retire(i)
            else:
                self._slot_lengths[i] += n_chunk
        return True

    def _truncate_at_stop(self, item: _Slot) -> None:
        """Trim tokens generated past the first stop id (after
        min_new_tokens) or past max_new_tokens, and set the stop reason."""
        g = item.gconfig
        stop_ids = set(g.stop_token_ids or [])
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is not None:
            stop_ids.add(eos)
        cut, reason = None, None
        for i, t in enumerate(item.tokens):
            if t in stop_ids and i + 1 >= g.min_new_tokens:
                cut, reason = i + 1, "stop"
                break
        if cut is None and len(item.tokens) >= g.max_new_tokens:
            cut, reason = g.max_new_tokens, "length"
        if cut is not None:
            del item.tokens[cut:]
            del item.logprobs[cut:]
            del item.versions[cut:]
            del item.itl[cut:]
            item.stop_reason = reason

    def _retire(self, slot: int) -> None:
        item = self._slots[slot]
        self._slots[slot] = None
        self._alloc.free_slot(slot)
        self._slot_lengths[slot] = 0
        self._complete(item, item.stop_reason or "stop")

    def _complete(self, item: _Slot, stop_reason: str) -> None:
        resp = ModelResponse(
            input_tokens=list(item.prompt),
            output_tokens=list(item.tokens),
            output_logprobs=list(item.logprobs),
            output_versions=list(item.versions),
            stop_reason=stop_reason,  # type: ignore[arg-type]
            latency=time.monotonic() - item.start_time,
            ttft=item.ttft,
            itl=list(item.itl),
            tokenizer=self.tokenizer,
        )
        if item.future is not None:
            item.loop.call_soon_threadsafe(_resolve, item.future, resp)

    # -- InferenceEngine surface ---------------------------------------
    async def agenerate(self, req: ModelRequest) -> ModelResponse:
        if self._thread_exc is not None:
            raise RuntimeError("decode engine crashed") from self._thread_exc
        if self._thread is None:
            raise RuntimeError("engine not initialized: call initialize()")
        if not req.input_ids:
            raise ValueError("empty prompt")
        if req.gconfig.stop:
            raise NotImplementedError(
                "stop strings are not in the PyTorch port yet (ROADMAP.md "
                "queue 1, item 3); use stop_token_ids"
            )
        if req.gconfig.frequency_penalty:
            raise NotImplementedError(
                "frequency_penalty is not in the PyTorch port yet "
                "(ROADMAP.md queue 1, item 3)"
            )
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        item = _Slot(
            rid=req.rid,
            prompt=list(req.input_ids),
            gconfig=req.gconfig,
            future=future,
            loop=loop,
        )
        self._request_q.put(item)
        # the death handler sets _thread_exc before draining the queue, so
        # a put that raced past the drain is caught here
        if self._thread_exc is not None:
            raise RuntimeError("decode engine crashed") from self._thread_exc
        return await future

    def generate(self, req: ModelRequest, timeout: float | None = None) -> ModelResponse:
        """Blocking wrapper over `agenerate` (its own event loop thread)."""
        done = threading.Event()
        result: list = [None, None]

        async def _run():
            try:
                result[0] = await self.agenerate(req)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                result[1] = e
            finally:
                done.set()

        t = threading.Thread(target=lambda: asyncio.run(_run()), daemon=True)
        t.start()
        if not done.wait(timeout or self.inference_config.request_timeout):
            raise TimeoutError("generate timed out")
        if result[1] is not None:
            raise result[1]
        return result[0]

    def pause_generation(self) -> None:
        """Pause on the next chunk boundary; returns once no chunk runs."""
        self._gen_paused.set()
        with self._sched_lock:
            pass

    def continue_generation(self) -> None:
        self._gen_paused.clear()

    def update_weights_from_tensor(self, named, version: int | None = None) -> None:
        """Install tensors keyed by `/`-joined parameter names (a dict, or
        (name, array) pairs; numpy or torch, any device), copied in place
        into the served weights and cast to their dtype. Every name and
        shape is checked before anything is written. Runs inside a pause
        window (an external pause is preserved), and stamps `version`
        inside the same window, so no token mixes new weights with the old
        version."""
        items = list(named.items() if isinstance(named, dict) else named)
        for name, val in items:
            if name.startswith("lora/"):
                raise NotImplementedError(
                    "LoRA delta push is not in the PyTorch port yet "
                    "(ROADMAP.md queue 1, item 6)"
                )
            if name not in self.params:
                raise KeyError(f"weight name not in the served model: {name}")
            if tuple(val.shape) != tuple(self.params[name].shape):
                raise ValueError(
                    f"{name}: shape {tuple(val.shape)} != "
                    f"{tuple(self.params[name].shape)}"
                )
        was_paused = self._gen_paused.is_set()
        self.pause_generation()
        try:
            with torch.no_grad():
                for name, val in items:
                    src = val if isinstance(val, torch.Tensor) else to_tensor(val)
                    self.params[name].copy_(src)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if version is not None:
                self._version = int(version)
        finally:
            if not was_paused:
                self.continue_generation()

    def update_weights_from_distributed(
        self, meta, params=None, model_config=None, version: int | None = None
    ) -> None:
        """Colocated push (the JAX name, `jax_decode.py:4842`): install the
        trainer's parameter tensors in place, as `update_weights_from_tensor`
        does, and stamp `version` inside the same pause window. The trainer
        keeps its tensors; the served ones are copies."""
        if params is None:
            raise ValueError("update_weights_from_distributed needs params")
        if model_config is not None and (
            model_config.num_hidden_layers, model_config.hidden_size,
            model_config.num_key_value_heads, model_config.head_dim_,
        ) != (
            self.model_config.num_hidden_layers, self.model_config.hidden_size,
            self.model_config.num_key_value_heads, self.model_config.head_dim_,
        ):
            raise ValueError("the pushed model's geometry differs from the served one")
        self.update_weights_from_tensor(params, version=version)

    def set_version(self, version: int) -> None:
        self._version = int(version)

    def get_version(self) -> int:
        return self._version
