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

- **Int8 serving.** `weight_dtype="int8"` quantizes the installed dense
  matmul kernels per output channel (`models/qwen2.quantize_weights`), and
  every prefill and decode matmul of the layers runs on the int8-weight
  kernel. `kv_dtype="int8"` keeps the paged pool as int8 with one f32
  scale per (row, kv head) in a scale pool paged like it
  (`ops/kv_quant.py`); rows are quantized where they are written (prefill
  scatter, decode step) and attention reads them through the int8 kernel.

- **Position-keyed sampling.** Each request gets a base key at its first
  admission (`slot_base_key(random_seed, admission index)`, kept across
  preemption), and the token at position p is drawn with `fold_in(base
  key, p)` (`engine/sampling.py`), so a stream depends on nothing but its
  key and its positions: not on batchmates, chunking, preemption or
  speculation.
- **Speculative decode** (`spec_decode="ngram"`, jax_decode.py:42-51).
  Before each pass the host drafts up to `spec_k` tokens per slot by
  prompt lookup (`_ngram_draft`). If some slot drafted, the pass is one
  verify forward (`verify_step_paged`, W = draft bucket + 1 positions per
  slot), which samples all W positions with their own keys and keeps the
  longest draft prefix sampling would have emitted anyway plus a bonus
  token; otherwise it is the normal chunk.

- **Rollout queue.** The engine owns a `WorkflowExecutor` built from its
  `inference_config` (staleness gate, sample ledger, async episodes) and
  delegates `submit` / `wait` / `rollout_batch` / `prepare_batch`,
  `pause` / `resume` (the executor's admission gate, not
  `pause_generation`) and the ledger's checkpoint calls to it, as
  `jax_decode.py:3814-3848` does; a new weight version reaches both.

This slice schedules synchronously (dispatch a chunk, then consume it) and
prefills every request in full: the JAX engine's run-ahead, prefix forks
and host KV tier are later ROADMAP items (`TorchDecodeConfig.
check_supported` refuses their settings). Without run-ahead, the JAX
verify path's freshness drain (:3316-3330) has nothing to drain, and its
rewind reconcile (:3653-3660) is the plain bookkeeping of advancing each
slot by the tokens it emitted.
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
from areal_tpu_torch.core.workflow_executor import WorkflowExecutor
from areal_tpu_torch.engine.kv_pool import KVBlockAllocator, PoolDry
from areal_tpu_torch.engine.sampling import sample, slot_base_key
from areal_tpu_torch.models.convert import to_tensor
from areal_tpu_torch.models.qwen2 import (
    WEIGHT_DTYPES,
    ModelConfig,
    check_supported,
    decode_step_paged,
    layer_views,
    named_shapes,
    prefill,
    quantize_weights,
    torch_dtype,
    verify_step_paged,
)
from areal_tpu_torch.ops.kv_quant import KV_DTYPES, join_pool, quantize_kv, scales_blocked
from areal_tpu_torch.ops.paged_attention import check_verify_width
from areal_tpu_torch.platforms import resolve_device
from areal_tpu_torch.utils import logging

logger = logging.getLogger("torch_decode")

_PREFILL_BUCKET = 64


def _next_bucket(n: int, bucket: int = _PREFILL_BUCKET) -> int:
    return max(((n + bucket - 1) // bucket) * bucket, bucket)


def _ngram_draft(context: list[int], k: int, ngram_max: int) -> list[int]:
    """Prompt-lookup drafter: match the trailing n-gram of `context`
    against its own earlier tokens and propose up to `k` continuation
    tokens (the tokens that followed the MOST RECENT earlier occurrence).

    Draft-model-free speculation (PLD / LLMA class): math and code
    rollouts quote their prompts heavily, and repetition loops quote
    themselves, so the request's own context is a strong cheap draft
    source. Longest n wins (more context → better continuation); the
    proposed span may overlap the suffix itself (self-extension — exactly
    what makes periodic repetition fully accepted). Correctness never
    depends on the draft: the verify chunk accepts only tokens sampling
    would have emitted anyway.
    """
    n_ctx = len(context)
    if k <= 0 or n_ctx < 2:
        return []
    arr = np.asarray(context, dtype=np.int64)
    for n in range(min(int(ngram_max), n_ctx - 1), 0, -1):
        pat = arr[n_ctx - n :]
        n_starts = n_ctx - n  # candidate starts 0..n_ctx-n-1 (suffix excluded)
        eq = np.ones(n_starts, dtype=bool)
        for j in range(n):
            eq &= arr[j : j + n_starts] == pat[j]
        starts = np.nonzero(eq)[0]
        if starts.size == 0:
            continue
        # most recent occurrence with a FULL k-token continuation if one
        # exists (periodic contexts: an earlier period gives the whole
        # draft), else the most recent overall (truncated continuation)
        full = starts[starts + n + k <= n_ctx]
        s = int(full[-1]) if full.size else int(starts[-1])
        cont = arr[s + n : s + n + k]
        if cont.size:
            return cont.tolist()
    return []


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
    # [2] uint32 sampling key, set at the first admission and kept across
    # pool-pressure preemption (jax_decode.py:2959-2960)
    base_key: np.ndarray | None = None


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
        self._executor: WorkflowExecutor | None = None  # created on initialize

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
        self._k_pool: torch.Tensor | None = None  # int8 when kv_dtype="int8"
        self._v_pool: torch.Tensor | None = None
        # f32 [L, n_blocks, nKV, page_size] scales of an int8 pool, else None
        self._k_scale: torch.Tensor | None = None
        self._v_scale: torch.Tensor | None = None
        self._w_quant = False  # weight_dtype == "int8"
        self._kv_quant = False  # kv_dtype == "int8"
        self._alloc: KVBlockAllocator | None = None
        self._slots: list[_Slot | None] = []
        self._slot_lengths: np.ndarray | None = None  # KV rows each slot holds
        self._overflow: list[_Slot] = []  # popped, waiting for capacity
        self._slot_keys: np.ndarray | None = None  # [R, 2] base keys (uint32 values)
        self._admission_seq = 0  # first admissions so far: the key index

        # counters (written by the scheduler thread only)
        self.decode_steps = 0  # normal decode steps (R slots each)
        self.decode_seconds = 0.0  # chunk walls (verify forwards included)
        self.decode_tokens = 0  # tokens delivered to requests
        self.chunk_tokens = 0  # tokens the normal chunks sampled for live slots
        self.tokens_cut = 0  # sampled tokens cut at a stop or max_new_tokens
        self.prefill_tokens = 0
        self.prefill_seconds = 0.0
        self.prefill_calls = 0  # one model prefill (all layers) each
        self.n_preemptions = 0
        self._reset_spec_counters(1)

    def _reset_spec_counters(self, spec_k: int) -> None:
        """Speculative-decode counters, named as the JAX engine's
        (jax_decode.py:852-858) without the underscore."""
        self.verify_dispatches = 0  # verify forwards
        self.verify_seconds = 0.0  # their walls, each ending in its host copy
        self.spec_chunk_slots = 0  # (slot, verify forward) pairs consumed
        self.spec_hist = np.zeros(max(int(spec_k), 1) + 1, dtype=np.int64)  # by accepted
        self.spec_drafted = 0  # draft tokens dispatched to verify
        self.spec_accepted = 0  # draft tokens accepted
        self.spec_rejected = 0  # draft tokens rejected (drafted - accepted)

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
        self.inference_config.check_supported()
        if self.params is None:
            raise RuntimeError("no model installed: call set_model first")
        cfg = self.model_config
        if self.config.weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(
                f"weight_dtype={self.config.weight_dtype!r} not in {WEIGHT_DTYPES}"
            )
        if self.config.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype={self.config.kv_dtype!r} not in {KV_DTYPES}")
        self._w_quant = self.config.weight_dtype == "int8"
        self._kv_quant = self.config.kv_dtype == "int8"
        if self.config.spec_decode == "ngram":
            # the verify kernels' limits on W and W x group
            check_verify_width(
                int(self.config.spec_k) + 1,
                cfg.num_attention_heads // cfg.num_key_value_heads,
            )
        if not self._kv_quant and self.config.kv_cache_dtype != cfg.dtype:
            # the fp kernel reads the pool in q's dtype; refuse the mismatch
            # here, on the CPU and the card alike, not at the first step
            raise NotImplementedError(
                f"kv_cache_dtype={self.config.kv_cache_dtype!r} differs from "
                f"the model dtype {cfg.dtype!r}: an fp KV pool in another "
                "dtype is not in the PyTorch port yet: ROADMAP.md queue 1, item 3"
            )
        if self._w_quant:
            # the installed fp kernels become q/scale pairs (idempotent)
            self.params = quantize_weights(self.params)
            self._layers = layer_views(self.params, cfg)
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
        kv_dtype = torch.int8 if self._kv_quant else torch_dtype(self.config.kv_cache_dtype)
        self._k_pool = torch.zeros(shape, dtype=kv_dtype, device=self.device)
        self._v_pool = torch.zeros(shape, dtype=kv_dtype, device=self.device)
        self._k_scale = self._v_scale = None
        if self._kv_quant:
            # per-(row, kv head) scales, paged like the data pool; the kv
            # head precedes the page row (jax_decode.py:807-815)
            sshape = (cfg.num_hidden_layers, n_blocks, cfg.num_key_value_heads, bs)
            self._k_scale = torch.zeros(sshape, dtype=torch.float32, device=self.device)
            self._v_scale = torch.zeros(sshape, dtype=torch.float32, device=self.device)
        self._slots = [None] * R
        self._slot_lengths = np.zeros(R, dtype=np.int64)
        self._overflow = []
        self._slot_keys = np.zeros((R, 2), dtype=np.int64)
        self._admission_seq = 0
        self._reset_spec_counters(self.config.spec_k)
        self._executor = WorkflowExecutor(self.inference_config, self)
        self._executor.initialize()
        self._executor.set_version(self._version)
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
        if self._executor is not None:
            self._executor.destroy()
            self._executor = None
        self.params = self._layers = None
        self._k_pool = self._v_pool = self._k_scale = self._v_scale = None
        self._alloc = None

    def kv_pools(self):
        """The pool operands of `decode_step_paged`: the K and V pools, or
        `(int8 data, f32 scales)` tuples when kv_dtype="int8"."""
        return join_pool(self._k_pool, self._k_scale), join_pool(self._v_pool, self._v_scale)

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
            if item.base_key is None:  # first admission; a requeue keeps its key
                item.base_key = slot_base_key(self.config.random_seed, self._admission_seq)
                self._admission_seq += 1
            self._slots[slot] = item
            self._slot_keys[slot] = item.base_key
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
        if self._kv_quant:
            # prompt rows quantize at this scatter, as decode rows do at
            # theirs (jax_decode.py:1856-1866)
            k, k_s = quantize_kv(k)
            v, v_s = quantize_kv(v)
            self._k_scale[:, rows] = scales_blocked(k_s, nb_w, bsz)
            self._v_scale[:, rows] = scales_blocked(v_s, nb_w, bsz)
        self._k_pool[:, rows] = k.reshape(shape).to(self._k_pool.dtype)
        self._v_pool[:, rows] = v.reshape(shape).to(self._v_pool.dtype)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prefill_seconds += time.perf_counter() - t0
        self.prefill_tokens += len(ids)
        self.prefill_calls += 1

    def _chunk_bucket(self, active: np.ndarray, grow: int) -> int:
        """Smallest KV span (256 x 2^k, capped at the context) covering
        every active slot through this chunk's `grow` new rows: attention
        reads only the table columns of this span."""
        needed = int(self._slot_lengths[active].max()) + grow + 1
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

    def _spec_draft_buckets(self) -> list[int]:
        """Draft widths a verify forward can take: the powers of two below
        spec_k, and spec_k (jax_decode.py:1556-1568); the forward scores
        W = bucket + 1 positions, so a short draft does not pay the full
        width."""
        k = max(int(self.config.spec_k), 1)
        out, b = [], 1
        while b < k:
            out.append(b)
            b *= 2
        out.append(k)
        return sorted(set(out))

    def _draft_all(self, active: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Prompt-lookup drafts of up to spec_k tokens per active slot from
        its own context (jax_decode.py:1657-1696). A draft is capped so
        that the verify forward, which also emits a bonus token, writes no
        row at or past the context length and emits no token past the
        slot's max_new_tokens. Returns (drafts [R, spec_k] int64, lengths
        [R] int64)."""
        R = int(self.config.max_running_requests)
        k_max = int(self.config.spec_k)
        ngram_max = int(self.config.spec_ngram_max)
        S = int(self.config.context_length)
        drafts = np.zeros((R, k_max), dtype=np.int64)
        dlens = np.zeros(R, dtype=np.int64)
        for i in np.nonzero(active)[0]:
            s = self._slots[i]
            if s is None:
                continue
            length = int(self._slot_lengths[i])
            cap = min(
                k_max,
                S - 1 - length - 1,
                s.gconfig.max_new_tokens - (length - (len(s.prompt) - 1)) - 1,
            )
            if cap <= 0:
                continue
            d = _ngram_draft(list(s.prompt) + list(s.tokens), cap, ngram_max)
            if d:
                dlens[i] = len(d)
                drafts[i, : len(d)] = d
        return drafts, dlens

    def _run_chunk(self, active: np.ndarray) -> bool:
        """Run one pass over the active slots and consume it: a verify
        forward when speculative decode is on and some slot drafted, else
        a chunk of `new_tokens_per_chunk` decode steps. False when pool
        pressure left no slot to run.

        Frequency-penalty batches would take the normal chunk as in the
        JAX engine (:3364-3369); the port refuses the penalty itself."""
        R = int(self.config.max_running_requests)
        S = int(self.config.context_length)
        n_chunk = int(self.config.new_tokens_per_chunk)
        dev = self.device
        drafts = dlens = None
        W = 0  # verify width; 0: the normal chunk
        if self.config.spec_decode == "ngram":
            drafts, dlens = self._draft_all(active)
            max_d = int(dlens.max())
            if max_d > 0:
                b = min(x for x in self._spec_draft_buckets() if x >= max_d)
                W = b + 1
                drafts = drafts[:, :b]
        grow = W or n_chunk
        # every active slot needs blocks through this pass; shortest
        # first, so pool pressure preempts as few slots as possible
        order = sorted(np.nonzero(active)[0], key=lambda i: self._slot_lengths[i])
        for i in order:
            if self._slots[i] is None:
                continue
            need = min(int(self._slot_lengths[i]) + grow + 1, S)
            while not self._alloc.ensure(i, need):
                victims = [j for j in order if j != i and self._slots[j] is not None]
                if not victims:  # the pool always fits one full-context slot
                    raise PoolDry("KV pool cannot back a single active slot")
                self._preempt(max(victims, key=lambda j: self._slot_lengths[j]))
        active = self._active_mask()
        if not active.any():
            return False

        nb = -(-self._chunk_bucket(active, grow) // self._alloc.block_size)
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
        ctl = dict(
            lengths=torch.from_numpy(self._slot_lengths.copy()).to(dev),
            active=torch.from_numpy(active.copy()).to(dev),
            table=torch.from_numpy(self._alloc.table_slice(nb)).to(dev),
            base_keys=torch.from_numpy(self._slot_keys.copy()).to(dev),
            temps=torch.from_numpy(temps).to(dev),
            top_ps=torch.from_numpy(top_ps).to(dev),
            greedy=torch.from_numpy(greedy).to(dev),
        )
        if W:
            self._verify_chunk(active, last, drafts, dlens, W, ctl, use_topp)
        else:
            self._decode_chunk(active, last, n_chunk, ctl, use_topp)
        return True

    def _decode_chunk(self, active, last, n_chunk: int, ctl: dict, use_topp: bool) -> None:
        """`n_chunk` steps of `decode_step_paged` plus sampling on the
        device, then one copy of the chunk's tokens to the host."""
        R = len(active)
        dev = self.device
        tokens = torch.from_numpy(last).to(dev)
        lengths, active_t = ctl["lengths"], ctl["active"]
        toks = torch.empty((n_chunk, R), dtype=torch.long, device=dev)
        logps = torch.empty((n_chunk, R), dtype=torch.float32, device=dev)
        version = self._version
        k_pool, v_pool = self.kv_pools()

        t0 = time.perf_counter()
        for step in range(n_chunk):
            logits = decode_step_paged(
                self.params, tokens, lengths, k_pool, v_pool,
                ctl["table"], self.model_config, active=active_t, layers=self._layers,
            )
            # the token at position `lengths` draws with fold_in(key, lengths)
            tok, logp = sample(
                logits, ctl["base_keys"], lengths, ctl["temps"], ctl["top_ps"],
                ctl["greedy"], use_topp,
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
        self.chunk_tokens += n_chunk * int(active.sum())
        for i in np.nonzero(active)[0]:
            self._emit(i, toks_h[:, i], logps_h[:, i], version, dt / n_chunk)

    def _verify_chunk(self, active, last, drafts, dlens, W: int, ctl: dict,
                      use_topp: bool) -> None:
        """One verify forward (jax_decode.py:1596-1651): slot r's W inputs
        are its last token and its draft (zero-padded), at positions
        lengths[r] + j; every position samples with fold_in(key, lengths[r]
        + j), the sampler of the normal chunk. A slot emits its accepted
        draft prefix (position j's sample equal to draft token j, for j <
        its draft length, in a row) and then the sample after it, the bonus:
        exactly the tokens the normal chunk would have emitted. Rows written
        for rejected positions are dead: the causal mask hides them until
        the next write at that position overwrites them."""
        R = len(active)
        dev = self.device
        tokens = torch.from_numpy(np.concatenate([last[:, None], drafts], axis=1)).to(dev)
        version = self._version
        k_pool, v_pool = self.kv_pools()

        t0 = time.perf_counter()
        logits = verify_step_paged(
            self.params, tokens, ctl["lengths"], k_pool, v_pool, ctl["table"],
            self.model_config, active=ctl["active"], layers=self._layers,
        )  # [R, W, V]
        positions = ctl["lengths"][:, None] + torch.arange(W, device=dev)

        def rows(t):  # [R] -> [R * W], slot-major as the logits
            return t.repeat_interleave(W, dim=0)

        tok, logp = sample(
            logits.reshape(R * W, -1), rows(ctl["base_keys"]), positions.reshape(-1),
            rows(ctl["temps"]), rows(ctl["top_ps"]), rows(ctl["greedy"]), use_topp,
        )
        toks_h = tok.reshape(R, W).cpu().numpy()
        logps_h = logp.reshape(R, W).cpu().numpy()
        dt = time.perf_counter() - t0
        self.verify_dispatches += 1
        self.verify_seconds += dt
        self.decode_seconds += dt

        match = (toks_h[:, :-1] == drafts) & (np.arange(W - 1)[None, :] < dlens[:, None])
        accepted = np.cumprod(match, axis=1).sum(axis=1)
        for i in np.nonzero(active)[0]:
            acc = int(accepted[i])
            d = int(dlens[i])
            self.spec_chunk_slots += 1
            self.spec_hist[min(acc, len(self.spec_hist) - 1)] += 1
            self.spec_drafted += d
            self.spec_accepted += acc
            self.spec_rejected += d - acc
            e = acc + 1
            self._emit(i, toks_h[i, :e], logps_h[i, :e], version, dt / e)

    def _emit(self, slot: int, toks, logps, version: int, itl: float) -> None:
        """Deliver a pass's tokens to the slot's request: advance the slot
        by them, cut at a stop id or max_new_tokens (a stop may fall inside
        an accepted draft), and retire the request when it ends."""
        s = self._slots[slot]
        if s.ttft == float("inf"):
            s.ttft = time.monotonic() - s.start_time
        n = len(toks)
        n_before = len(s.tokens)
        s.tokens.extend(toks.tolist())
        s.logprobs.extend(logps.tolist())
        s.versions.extend([version] * n)
        s.itl.extend([itl] * n)
        self._truncate_at_stop(s)
        delivered = len(s.tokens) - n_before
        self.decode_tokens += delivered
        self.tokens_cut += n - delivered
        if s.stop_reason is not None:
            self._retire(slot)
        else:
            self._slot_lengths[slot] += n

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
        version.

        An int8-weight engine serves each dense kernel as `<path>/q` (int8)
        and `<path>/scale` (f32): those names are installed verbatim in the
        resident dtype (jax_decode.py:5009-5023), and an fp kernel name
        raises KeyError with the weight_dtype-mismatch diagnosis (:5041).
        `update_weights_from_distributed` quantizes fp tensors instead."""
        items = list(named.items() if isinstance(named, dict) else named)
        for name, val in items:
            if name.startswith("lora/"):
                raise NotImplementedError(
                    "LoRA delta push is not in the PyTorch port yet "
                    "(ROADMAP.md queue 1, item 6)"
                )
            if name not in self.params:
                raise KeyError(
                    f"weight name not in the served model: {name} — engine "
                    f"serves weight_dtype={self.config.weight_dtype!r}; an "
                    "fp<->int8 producer/consumer mismatch shifts every kernel "
                    "wire name by the '/q' + '/scale' suffix (set "
                    "WeightUpdateMeta.weight_dtype to the engine's serving dtype)"
                )
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
                self.set_version(int(version))
        finally:
            if not was_paused:
                self.continue_generation()

    def update_weights_from_distributed(
        self, meta, params=None, model_config=None, version: int | None = None
    ) -> None:
        """Colocated push (the JAX name, `jax_decode.py:4842`): install the
        trainer's parameter tensors in place, as `update_weights_from_tensor`
        does, and stamp `version` inside the same pause window. The trainer
        keeps its tensors; the served ones are copies. An int8-weight engine
        quantizes the trainer's fp kernels on install (:4860-4866;
        q/scale pairs pass through)."""
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
        if self._w_quant:
            with torch.no_grad():
                params = quantize_weights(dict(params))
        self.update_weights_from_tensor(params, version=version)

    def set_version(self, version: int) -> None:
        self._version = int(version)
        if self._executor is not None:
            self._executor.set_version(int(version))

    def get_version(self) -> int:
        return self._version

    # -- rollout queue (delegated to the WorkflowExecutor) ---------------
    def submit(self, data, workflow=None, workflow_builder=None, should_accept=None,
               rollout_id=None):
        return self._executor.submit(
            data, workflow, workflow_builder, should_accept, rollout_id=rollout_id
        )

    def wait(self, count, timeout=None):
        return self._executor.wait(count, timeout=timeout)

    def rollout_batch(self, data, workflow=None, workflow_builder=None, should_accept=None):
        return self._executor.rollout_batch(data, workflow, workflow_builder, should_accept)

    def prepare_batch(self, dataloader, workflow=None, workflow_builder=None,
                      should_accept=None):
        return self._executor.prepare_batch(dataloader, workflow, workflow_builder,
                                            should_accept)

    def pause(self) -> None:
        """Stop admitting new episodes (the executor's gate); decoding of
        requests already queued goes on."""
        self._executor.pause()

    def resume(self) -> None:
        self._executor.resume()

    # -- sample-ledger checkpointing (delegated) ------------------------
    def attach_ledger_wal(self, path: str) -> None:
        self._executor.attach_ledger_wal(path)

    def state_dict(self) -> dict:
        return self._executor.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self._executor.load_state_dict(state)
