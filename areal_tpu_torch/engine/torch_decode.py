"""TorchDecodeEngine: the in-process decode engine on one CUDA card
(counterpart of `areal_tpu/engine/jax_decode.py::JaxDecodeEngine`, its
serving core and its default scheduling).

- **Continuous batching over a paged KV pool.** R fixed decode slots over
  one pool `[L, n_blocks, page_size, nKV, hd]` per K/V with host-side block
  tables (engine/kv_pool.py). Requests hot-swap in and out of slots.
- **Admission** (`_admit`, jax_decode.py:2559-2987) takes each queued
  request down a ladder: (1) an interrupted request resumed under its rid
  with prompt + partial tokens finds its KV parked in its slot and
  prefills nothing; (2) a registered donor whose rows hold exactly
  `prompt[:-1]` (or more) is forked: its full blocks are aliased in the
  block table and only the boundary block is copied, or, when the free
  slot is the donor itself, the rows are reused in place; (3) a duplicate
  of a prompt earlier in the same admission wave forks the wave's primary
  once its prefill has run; (4) a registered prefix of at least
  `_MIN_SHARED_PREFIX` tokens (the multi-turn shape: history + a new
  turn) is forked and only the suffix is prefilled, attending to the
  prefix rows (`models/qwen2.prefill_with_prefix`); (5) the rest prefill
  `prompt[:-1]` in full, collected into the wave and batched per 64-token
  bucket (`_flush_wave`). The prompt's last token is the first decode
  input, so every generated token is sampled by the decode loop. Prefill
  work per pass is capped at `max_prefill_tokens`; a fork is no prefill
  work.
- **The prefix registry.** Every prefill and fork registers the slot's
  covered tokens (`_register_prefix`); a retired slot registers its whole
  conversation and keeps its blocks as donor material until pool
  pressure reclaims them (`_reclaim_blocks`, never a donor mid-fork). A
  weight install drops the registry and the parked KV: KV from old
  weights never seeds a request under new ones.
- **Run-ahead dispatch** (`decode_runahead_chunks`, default 1;
  jax_decode.py:28-39, 3211-3712). Chunk k+1 is dispatched against
  device-chained state (each slot's last token and length stay on the
  device between chunks) before the host consumes chunk k, so the host
  work of chunk k (stop scans, retirement, admission, prefill) overlaps
  the device's chunk k+1. A chunk's tokens and logprobs go to pinned host
  buffers behind a recorded CUDA event. A slot retired while a chunk of
  it is in flight discards that chunk's tokens at consumption (the
  identity and admission-epoch check) and its length is rewound to the
  true end. A slot whose max_new_tokens are all covered by dispatched
  chunks is masked out of the next. `decode_runahead_chunks=0` is the
  synchronous schedule: dispatch a chunk, then consume it.
  `pause_generation` drains every chunk in flight.
- **Interrupt and resume.** `abort_all` ends every running and queued
  request with stop reason "interrupt", and a running slot's KV stays
  parked for its rid; a resume covering exactly the parked tokens
  prefills nothing. With no host KV tier, an evicted parked entry is
  dropped and its resume prefills.
- **Stop criteria**: stop ids and stop strings (incremental decode of
  the tail) both cut, the earlier boundary wins; then max_new_tokens.
- **Frequency penalty** (OpenAI semantics): while any slot asks for one,
  chunks carry per-slot token counts `[R, V]` that evolve token by token,
  and the logits lose penalty x count before sampling.

- **Int8 serving.** `weight_dtype="int8"` quantizes the installed dense
  matmul kernels per output channel (`models/qwen2.quantize_weights`), and
  every prefill and decode matmul of the layers runs on the int8-weight
  kernel. `kv_dtype="int8"` keeps the paged pool as int8 with one f32
  scale per (row, kv head) in a scale pool paged like it
  (`ops/kv_quant.py`); rows are quantized where they are written (prefill
  scatter, decode step), a fork copies the boundary block's scales with
  its data, and a suffix prefill reads the prefix dequantized.

- **Position-keyed sampling.** Each request gets a base key at its first
  admission (`slot_base_key(random_seed, admission index)`, kept across
  preemption and parking), and the token at position p is drawn with
  `fold_in(base key, p)` (`engine/sampling.py`), so a stream depends on
  nothing but its key and its positions: not on batchmates, chunking,
  run-ahead, preemption or speculation.
- **Speculative decode** (`spec_decode="ngram"`, jax_decode.py:42-51).
  Before each pass the host drafts up to `spec_k` tokens per slot by
  prompt lookup (`_ngram_draft`); chunks whose results already landed are
  consumed first so the drafts see the true context. If some slot
  drafted, the pass is one verify forward (`verify_step_paged`, W = draft
  bucket + 1 positions per slot), which samples all W positions with
  their own keys and keeps the longest draft prefix sampling would have
  emitted anyway plus a bonus token, advancing each slot's device length
  and last token by what it accepted; otherwise, and while any slot has a
  frequency penalty, it is the normal chunk.

- **Rollout queue.** The engine owns a `WorkflowExecutor` built from its
  `inference_config` (staleness gate, sample ledger, async episodes) and
  delegates `submit` / `wait` / `rollout_batch` / `prepare_batch`,
  `pause` / `resume` (the executor's admission gate, not
  `pause_generation`) and the ledger's checkpoint calls to it, as
  `jax_decode.py:3814-3848` does; a new weight version reaches both.

- **Behind a server** (`launcher/decode_server.py`): `get_metrics`
  reports load and ITL windows under the JAX keys plus the op wrappers'
  `kernel_launches` and the process's `device_memory_peak`,
  `reset_timing_windows` clears the windows, and
  `update_weights_from_disk` installs an HF checkpoint as a push does,
  reading it before the pause (JAX reads it inside).

The JAX engine's host KV tier, workspace layout, session export and
import, prefill-only admissions and KV fabric are later ROADMAP items.
"""

from __future__ import annotations

import asyncio
import contextlib
import queue
import threading
import time
import traceback
from collections import deque
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
from areal_tpu_torch.models import hf_io
from areal_tpu_torch.models.convert import to_tensor
from areal_tpu_torch.models.qwen2 import (
    WEIGHT_DTYPES,
    ModelConfig,
    check_servable,
    check_supported,
    decode_step_paged,
    layer_views,
    named_shapes,
    prefill,
    prefill_with_prefix,
    quantize_weights,
    torch_dtype,
    verify_step_paged,
)
from areal_tpu_torch.ops.kv_quant import (
    KV_DTYPES,
    dequantize_kv,
    join_pool,
    quantize_kv,
    scales_rowmajor,
)
from areal_tpu_torch.ops import flash_attention as _fa
from areal_tpu_torch.ops import paged_attention as _pa
from areal_tpu_torch.ops import quant_matmul as _qm
from areal_tpu_torch.ops import threefry as _tf
from areal_tpu_torch.ops.paged_attention import check_verify_width
from areal_tpu_torch.platforms import resolve_device
from areal_tpu_torch.utils import logging

logger = logging.getLogger("torch_decode")

_PREFILL_BUCKET = 64
# partial prefix sharing kicks in only when the shared history is at least
# this long: below it a fresh prefill is cheaper than the fork + suffix pass
_MIN_SHARED_PREFIX = 64
# tokens of overlap when the stop-string scan re-decodes a chunk's tail
_STOP_OVERLAP = 16
# consumed passes kept in the rolling inter-token-latency windows
_ITL_WINDOW = 512


def kernel_launches() -> dict[str, int]:
    """The op wrappers' launch counters in this process (the port-only
    `kernel_launches` key of `get_metrics`)."""
    return dict(
        paged_attention=_pa.launches,
        paged_attention_q8=_pa.launches_q8,
        paged_verify=_pa.launches_verify,
        paged_verify_q8=_pa.launches_verify_q8,
        quant_matmul=_qm.launches,
        threefry_noise=_tf.launches,
        flash_attention_fwd=_fa.launches_fwd,
        flash_attention_bwd_dq=_fa.launches_dq,
        flash_attention_bwd_dkv=_fa.launches_dkv,
    )


def _next_bucket(n: int, bucket: int = _PREFILL_BUCKET) -> int:
    return max(((n + bucket - 1) // bucket) * bucket, bucket)


def _pow2_bucket(n: int, lo: int = _PREFILL_BUCKET) -> int:
    """Power-of-two buckets for the suffix prefill (jax_decode.py:298)."""
    b = lo
    while b < n:
        b *= 2
    return b


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
    stop_checked: int = 0  # tokens already scanned for stop strings
    tokens: list[int] = field(default_factory=list)
    logprobs: list[float] = field(default_factory=list)
    versions: list[int] = field(default_factory=list)
    itl: list[float] = field(default_factory=list)
    start_time: float = field(default_factory=time.monotonic)
    ttft: float = float("inf")
    stop_reason: str | None = None
    # [2] uint32 sampling key, set at the first admission and kept across
    # pool-pressure preemption and parking (jax_decode.py:2955-2969)
    base_key: np.ndarray | None = None


@dataclass
class _Inflight:
    """One dispatched, not yet consumed pass (jax_decode.py:345-375).
    `items` and `epochs` snapshot each slot's occupant and admission epoch
    at dispatch: a slot whose occupant changed since has its tokens
    discarded at consumption."""

    toks: torch.Tensor  # [n_chunk, R] int64, host (pinned on the card)
    logps: torch.Tensor  # [n_chunk, R] f32
    event: "torch.cuda.Event | None"  # recorded after the host copies
    items: list
    active: np.ndarray  # [R] bool, the mask the pass ran with
    epochs: np.ndarray
    version: int  # weight version the pass ran under
    t_dispatch: float
    n_chunk: int
    nb: int  # table blocks per slot the pass attended over
    # verify forwards: spec_w > 0 is the q-width; a slot emits accepted + 1
    spec_w: int = 0
    accepted: torch.Tensor | None = None  # [R] int64, host
    draft_lens: np.ndarray | None = None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def host(self) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
        if self.event is not None:
            self.event.synchronize()
        acc = None if self.accepted is None else self.accepted.numpy()
        return self.toks.numpy(), self.logps.numpy(), acc


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
        # Serializes scheduler passes (admission, dispatch, consumption)
        # against pause_generation: a pause sets the flag, then takes this
        # lock once and drains every chunk in flight, after which no chunk
        # runs until continue_generation.
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
        # KV rows each slot holds, projected ahead by dispatched chunks
        self._slot_lengths: np.ndarray | None = None
        self._overflow: list[_Slot] = []  # popped, waiting for capacity
        self._slot_keys: np.ndarray | None = None  # [R, 2] base keys (uint32 values)
        self._slot_epoch: np.ndarray | None = None  # admissions per slot
        self._admission_seq = 0  # first admissions so far: the key index
        # interrupted requests: rid -> (slot, covered rows, park time), and
        # the tokens those rows hold
        self._parked: dict[str, tuple[int, int, float]] = {}
        self._parked_tokens: dict[str, list[int]] = {}
        # the prefix registry: covered tokens -> donor slot, and its inverse
        self._prefix_lookup: dict[tuple[int, ...], int] = {}
        self._slot_prefix: list[tuple[int, ...] | None] = []
        # run-ahead: dispatched passes, oldest first, and the device-chained
        # (last token, length) per slot; `_patch_slots` lists slots whose
        # host truth diverged from the chain since the last dispatch
        self._inflight: deque[_Inflight] = deque()
        self._dev_last: torch.Tensor | None = None
        self._dev_lengths: torch.Tensor | None = None
        self._patch_slots: set[int] = set()
        self._ctl: dict | None = None  # device control arrays, rebuilt when dirty
        self._dev_table: torch.Tensor | None = None
        self._dev_table_key: tuple[int, int] | None = None
        self._last_ready_t: float | None = None
        # frequency penalty: [R, V] f32 token counts, made on first use
        self._freq_counts: torch.Tensor | None = None
        self._slot_used_freq: np.ndarray | None = None
        # prefill device intervals not yet read into prefill_seconds
        self._prefill_events: list[tuple[Any, Any]] = []
        self._prefill_secs = 0.0
        self._events_lock = threading.Lock()
        # rolling timing windows (get_metrics, reset_timing_windows):
        # per-token device and wall inter-token latency of recent passes,
        # and the device's busy and idle seconds between passes
        self._metrics_lock = threading.Lock()
        self._chunk_itl_ms: deque[float] = deque(maxlen=_ITL_WINDOW)
        self._chunk_wall_itl_ms: deque[float] = deque(maxlen=_ITL_WINDOW)
        self._dev_busy_s = 0.0
        self._dev_idle_s = 0.0
        self._chunks_dispatched = 0

        # counters (written by the scheduler thread, or under a pause)
        self.decode_steps = 0  # normal decode steps dispatched (R slots each)
        self.decode_seconds = 0.0  # device windows of consumed passes
        self.decode_tokens = 0  # tokens delivered to requests
        self.chunk_tokens = 0  # tokens normal chunks sampled for live slots, consumed
        self.tokens_cut = 0  # consumed tokens cut at a stop or max_new_tokens
        self.prefill_tokens = 0
        self.prefill_calls = 0  # model prefill forwards (all layers) each
        self.n_preemptions = 0
        self.runahead_discarded = 0  # tokens of passes a retired slot never took
        # admission counters under the JAX names (jax_decode.py:482-485)
        self._n_prefills = 0  # requests prefilled in full
        self._n_prefix_forks = 0
        self._n_prefix_inplace = 0
        self._n_suffix_prefills = 0
        self._reset_spec_counters(1)

    def _reset_spec_counters(self, spec_k: int) -> None:
        """Speculative-decode counters, named as the JAX engine's
        (jax_decode.py:852-858) without the underscore."""
        self.verify_dispatches = 0  # verify forwards
        self.verify_seconds = 0.0  # their device windows
        self.spec_chunk_slots = 0  # (slot, verify forward) pairs consumed
        self.spec_hist = np.zeros(max(int(spec_k), 1) + 1, dtype=np.int64)  # by accepted
        self.spec_drafted = 0  # draft tokens dispatched to verify
        self.spec_accepted = 0  # draft tokens accepted
        self.spec_rejected = 0  # draft tokens rejected (drafted - accepted)

    @property
    def prefill_seconds(self) -> float:
        """Seconds of prefill: on the card, the device time between events
        recorded around each prefill forward and its pool writes (waited
        for here, never by the scheduler); on the CPU, the wall."""
        self._collect_prefill_events(wait=True)
        return self._prefill_secs

    def _collect_prefill_events(self, wait: bool) -> None:
        """Add the prefill intervals whose end event has completed (all of
        them, waiting, with `wait`) to the prefill seconds."""
        with self._events_lock:
            pending, self._prefill_events = self._prefill_events, []
            for start, end in pending:
                if wait:
                    end.synchronize()
                elif not end.query():
                    self._prefill_events.append((start, end))
                    continue
                self._prefill_secs += start.elapsed_time(end) / 1e3

    # -- lifecycle ------------------------------------------------------
    def set_model(self, params: dict[str, torch.Tensor], model_config: ModelConfig) -> None:
        """Install weights (the port's flat name -> tensor dict). Always
        copies onto the engine's device: the caller keeps its tensors. A
        critic (a value head, no LM head) is refused."""
        check_supported(model_config)
        check_servable(model_config)
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
            # no model installed: the HF checkpoint at `model_path`, in
            # `dtype` (jax_decode.py:646-655)
            if not self.config.model_path:
                raise RuntimeError("no model installed or configured: call set_model "
                                   "or set model_path")
            mc = ModelConfig.from_hf_config(self.config.model_path, dtype=self.config.dtype,
                                            param_dtype=self.config.dtype)
            self.set_model(hf_io.load_hf_params(self.config.model_path, mc, device=self.device),
                           mc)
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
        self._slot_epoch = np.zeros(R, dtype=np.int64)
        self._slot_used_freq = np.zeros(R, dtype=bool)
        self._admission_seq = 0
        self._parked, self._parked_tokens = {}, {}
        self._prefix_lookup, self._slot_prefix = {}, [None] * R
        self._inflight = deque()
        self._dev_last = self._dev_lengths = None
        self._patch_slots = set()
        self._ctl = self._dev_table = self._dev_table_key = None
        self._last_ready_t = None
        self._freq_counts = None
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
        self._inflight.clear()
        self.params = self._layers = None
        self._k_pool = self._v_pool = self._k_scale = self._v_scale = None
        self._dev_last = self._dev_lengths = self._ctl = self._dev_table = None
        self._freq_counts = None
        self._alloc = None
        self._prefix_lookup.clear()
        self._parked.clear()
        self._parked_tokens.clear()

    def kv_pools(self):
        """The pool operands of `decode_step_paged`: the K and V pools, or
        `(int8 data, f32 scales)` tuples when kv_dtype="int8"."""
        return join_pool(self._k_pool, self._k_scale), join_pool(self._v_pool, self._v_scale)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On the card the copy goes
        from pinned memory without blocking, so a dispatch never waits for
        the chunk in flight; the source is a copy the host may mutate."""
        t = torch.from_numpy(np.array(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """Start `t`'s copy to the host (pinned, without blocking, on the
        card); the pass's event marks its arrival."""
        if self.device.type != "cuda":
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h

    @contextlib.contextmanager
    def _prefill_call(self, tokens: int):
        """One prefill forward with its pool writes: counted in
        `prefill_calls` and `prefill_tokens`, and timed into
        `prefill_seconds` between device events on the card (read later,
        so the scheduler never waits on them), by the wall clock on the
        CPU."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            with self._events_lock:
                self._prefill_events.append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._prefill_secs += time.perf_counter() - t0
        self.prefill_calls += 1
        self.prefill_tokens += tokens

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
                        if paused:
                            # never leave a chunk dispatched while a pause
                            # holder swaps weights or aborts
                            self._drain_inflight_locked()
                        else:
                            worked = self._pass()
                    if paused:
                        time.sleep(0.005)
                    elif not worked:
                        time.sleep(0.002)
        except BaseException as e:  # noqa: BLE001 — fail every waiter, then stop
            self._thread_exc = e
            logger.error(f"decode scheduler died: {e}\n{traceback.format_exc()}")
            self._inflight.clear()
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

    def _pass(self) -> bool:
        """One scheduler pass (jax_decode.py:3239-3266): admit, dispatch a
        pass over the active slots, then consume down to the run-ahead
        depth, so chunk k's host work runs while chunk k+1 is on the
        device. With no new dispatch, drain what is left."""
        runahead = max(int(self.config.decode_runahead_chunks), 0)
        admitted = self._admit()
        active = self._active_mask()
        dispatched = False
        if active.any():
            rec = self._dispatch_chunk(active)
            if rec is not None:
                self._inflight.append(rec)
                dispatched = True
        while len(self._inflight) > runahead:
            self._consume_chunk(self._inflight.popleft())
        drained = False
        if not dispatched:
            drained = bool(self._inflight)
            self._drain_inflight_locked()
            if not self._active_mask().any():
                # idle from here on is lack of traffic, not the scheduler's
                self._last_ready_t = None
        return dispatched or admitted or drained

    def _run_chunk(self, active: np.ndarray) -> None:
        """Dispatch one pass and consume it (the synchronous step; the
        entry point of tests that drive the scheduler by hand)."""
        rec = self._dispatch_chunk(active)
        if rec is not None:
            self._consume_chunk(rec)

    def _drain_inflight_locked(self) -> None:
        """Consume every dispatched pass (called under _sched_lock)."""
        while self._inflight:
            self._consume_chunk(self._inflight.popleft())

    def _next_request(self) -> _Slot | None:
        if self._overflow:
            return self._overflow.pop(0)
        try:
            return self._request_q.get_nowait()
        except queue.Empty:
            return None

    def _active_mask(self) -> np.ndarray:
        return np.array([s is not None for s in self._slots], dtype=bool)

    def _free_slots(self) -> list[int]:
        parked = {slot for slot, _, _ in self._parked.values()}
        return [i for i, s in enumerate(self._slots) if s is None and i not in parked]

    def _mark_slot_dirty(self, slot: int) -> None:
        """A slot's occupant or its sampling settings changed: rebuild the
        control arrays and patch its chained last token and length at the
        next dispatch."""
        self._ctl = None
        self._patch_slots.add(slot)

    # -- prefix registry (jax_decode.py:2363-2496) ----------------------
    def _unregister_prefix(self, slot: int) -> None:
        key = self._slot_prefix[slot]
        if key is not None:
            self._slot_prefix[slot] = None
            if self._prefix_lookup.get(key) == slot:
                self._prefix_lookup.pop(key, None)

    def _register_prefix(self, slot: int, covered: list[int]) -> None:
        self._unregister_prefix(slot)
        if not covered:
            return
        key = tuple(covered)
        self._slot_prefix[slot] = key
        self._prefix_lookup[key] = slot

    def _find_shared_prefix(self, covered: tuple[int, ...]):
        """Longest registered key of at least `_MIN_SHARED_PREFIX` tokens
        that is a PROPER prefix of `covered`: (donor slot, prefix length),
        or None."""
        best = None
        for key in self._prefix_lookup:
            kl = len(key)
            if (kl >= _MIN_SHARED_PREFIX and kl < len(covered) and covered[:kl] == key
                    and (best is None or kl > len(best))):
                best = key
        return None if best is None else (self._prefix_lookup[best], len(best))

    def _find_covering_donor(self, covered: tuple[int, ...]) -> int | None:
        """A registered key that EXTENDS `covered`: its first len(covered)
        rows hold exactly covered's KV (a retired slot registers its whole
        conversation, so a plain prompt may exist only as its head)."""
        n = len(covered)
        for key, slot in self._prefix_lookup.items():
            if len(key) >= n and key[:n] == covered:
                return slot
        return None

    def _invalidate_prefixes(self) -> None:
        """KV from old weights must not seed a request under new ones: free
        the blocks that only donor registrations hold (active slots keep
        theirs) and empty the registry."""
        for i, key in enumerate(self._slot_prefix):
            if key is not None and self._slots[i] is None:
                self._alloc.free_slot(i)
                self._slot_lengths[i] = 0
        self._prefix_lookup.clear()
        self._slot_prefix = [None] * len(self._slot_prefix)

    def _invalidate_parked(self) -> None:
        """Drop every parked KV cache and the registry (weight installs,
        under a pause): a resume would otherwise continue from KV the new
        weights never produced, under their version stamp."""
        for rid in list(self._parked):
            slot, _, _ = self._parked.pop(rid)
            self._parked_tokens.pop(rid, None)
            self._alloc.free_slot(slot)
            self._slot_lengths[slot] = 0
        self._invalidate_prefixes()

    def _release_slot_blocks(self, slot: int) -> None:
        self._unregister_prefix(slot)
        self._alloc.free_slot(slot)
        self._slot_lengths[slot] = 0

    def _evict_parked_lru(self, protect: frozenset[int] = frozenset()) -> int | None:
        """Free the least recently parked slot and return it. With no host
        KV tier the parked KV is dropped: its resume prefills."""
        candidates = [r for r, (s, _, _) in self._parked.items() if s not in protect]
        if not candidates:
            return None
        rid = min(candidates, key=lambda r: self._parked[r][2])
        slot, _, _ = self._parked.pop(rid)
        self._parked_tokens.pop(rid, None)
        self._release_slot_blocks(slot)
        return slot

    def _reclaim_blocks(self, protect: frozenset[int] = frozenset()) -> bool:
        """Free some blocks under pool pressure, the cheapest loss first: a
        donor registration of a free slot, then the least recently parked
        request. `protect`: slots the current admission reads or writes
        (a fork's donor, the claimed slot), never reclaimed."""
        parked_slots = {s for s, _, _ in self._parked.values()}
        for i, key in enumerate(self._slot_prefix):
            if (key is not None and self._slots[i] is None
                    and i not in parked_slots and i not in protect):
                self._release_slot_blocks(i)
                return True
        return self._evict_parked_lru(protect) is not None

    def _ensure_tokens(self, slot: int, tokens: int,
                       protect: frozenset[int] = frozenset()) -> bool:
        protect = protect | {slot}
        while not self._alloc.ensure(slot, tokens):
            if not self._reclaim_blocks(protect):
                return False
        return True

    def _take_parked(self, item: _Slot) -> int | None:
        """The slot whose parked KV covers exactly item.prompt[:-1] (a
        resume: prompt + partial tokens under the same rid), or None. A
        parked entry the prompt no longer matches is dropped."""
        entry = self._parked.get(item.rid)
        if entry is None:
            return None
        slot, covered, _ = entry
        cached = self._parked_tokens.get(item.rid, [])
        self._parked.pop(item.rid)
        self._parked_tokens.pop(item.rid, None)
        if covered == len(item.prompt) - 1 and cached == item.prompt[:-1]:
            return slot
        self._release_slot_blocks(slot)
        return None

    def _device_fork(self, src: int, dst: int, covered: int) -> None:
        """Alias the donor's full blocks and copy the boundary block (data
        and, on an int8 pool, scales). Raises PoolDry when the boundary
        block cannot be allocated."""
        cp = self._alloc.fork(src, dst, covered)
        if cp is not None:
            s, d = cp
            for pool in (self._k_pool, self._v_pool, self._k_scale, self._v_scale):
                if pool is not None:
                    pool[:, d] = pool[:, s]

    # -- admission (jax_decode.py:2559-3093) ----------------------------
    def _admit(self) -> bool:
        """Admit queued requests into free slots down the ladder of the
        module docstring. Prefill work per pass is capped at
        `max_prefill_tokens` (the first admission always goes through);
        forks and resumes cost none."""
        S = int(self.config.context_length)
        budget = max(int(self.config.max_prefill_tokens), _PREFILL_BUCKET)
        did_prefill = admitted = False
        # the wave: full prefills collected here and run after the loop,
        # batched per bucket; duplicates fork the wave's primary after it
        wave_primaries: dict[tuple[int, ...], int] = {}
        wave_pending: list[tuple[int, np.ndarray, int, int, tuple]] = []
        wave_forks: list[tuple[int, int, tuple, int]] = []
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
            needs_bucket = min(_next_bucket(P - 1), S) if P > 1 else 0
            covered_t = tuple(prompt[:-1]) if P > 1 else ()
            donor = None
            if P > 1:
                donor = self._prefix_lookup.get(covered_t)
                if donor is None:
                    donor = self._find_covering_donor(covered_t)
            partial = None
            is_wave_dup = P > 1 and covered_t in wave_primaries
            if donor is None and P > 1 and not is_wave_dup:
                found = self._find_shared_prefix(covered_t)
                if found is not None:
                    donor_slot, plen = found
                    sb = min(_pow2_bucket(P - 1 - plen), S)
                    if plen + sb <= S:
                        partial = (donor_slot, plen, sb)
                        needs_bucket = sb
                elif any(
                    _MIN_SHARED_PREFIX <= len(k) < len(covered_t) and covered_t[: len(k)] == k
                    for k in wave_primaries
                ):
                    # a wave primary's prompt heads this one but its rows
                    # are not written yet: hold this request one pass, then
                    # fork + suffix instead of prefilling the shared history
                    self._overflow.insert(0, item)
                    break
            if did_prefill and donor is None and not is_wave_dup and needs_bucket > budget:
                self._overflow.insert(0, item)
                break
            # the resume check comes first: evicting before matching could
            # destroy the very KV this request came back for
            resumed = self._take_parked(item)
            if resumed is None:
                free = self._free_slots()
                if not free:
                    evicted = self._evict_parked_lru()
                    if evicted is None:
                        self._overflow.insert(0, item)
                        break
                    free = [evicted]
                slot = free[0]
                if self._freq_counts is not None and self._slot_used_freq[slot]:
                    # a new occupant starts from zero penalty counts
                    self._freq_counts[slot].zero_()
                    self._slot_used_freq[slot] = False
                if P <= 1:
                    # the decode loop writes from row 0: no donor survives
                    self._release_slot_blocks(slot)
            else:
                slot = resumed
            if resumed is None and P > 1 and donor is not None:
                if donor != slot:
                    self._unregister_prefix(slot)
                    try:
                        self._device_fork(donor, slot, P - 1)
                    except PoolDry:
                        # never reclaim the donor mid-fork
                        if not self._reclaim_blocks(frozenset({donor, slot})):
                            self._overflow.insert(0, item)
                            break
                        try:
                            self._device_fork(donor, slot, P - 1)
                        except PoolDry:
                            self._overflow.insert(0, item)
                            break
                    self._n_prefix_forks += 1
                else:
                    # the slot may hold more rows than this prefix; decode
                    # overwrites those past P - 1, so trim the claim
                    self._n_prefix_inplace += 1
                self._register_prefix(slot, list(covered_t))
            elif resumed is None and P > 1 and partial is not None:
                donor_slot, plen, sb = partial
                budget -= sb
                did_prefill = True
                self._n_suffix_prefills += 1
                try:
                    if donor_slot != slot:
                        self._unregister_prefix(slot)
                        self._device_fork(donor_slot, slot, plen)
                    # the donor and this slot are protected (in place, the
                    # slot is still the registered donor)
                    if not self._ensure_tokens(slot, plen + sb, frozenset({donor_slot})):
                        raise PoolDry("suffix blocks")
                except PoolDry:
                    self._release_slot_blocks(slot)
                    self._overflow.insert(0, item)
                    break
                self._suffix_prefill(slot, prompt[plen : P - 1], plen, sb)
                self._register_prefix(slot, list(covered_t))
            elif resumed is None and P > 1:
                pre = P - 1
                bucket = min(_next_bucket(pre), S)
                self._unregister_prefix(slot)
                if is_wave_dup:
                    wave_forks.append((slot, wave_primaries[covered_t], covered_t, bucket))
                    self._n_prefix_forks += 1
                else:
                    self._alloc.free_slot(slot)
                    self._slot_lengths[slot] = 0
                    if not self._ensure_tokens(slot, bucket):
                        self._overflow.insert(0, item)
                        break
                    budget -= bucket
                    did_prefill = True
                    self._n_prefills += 1
                    ids = np.zeros(bucket, dtype=np.int64)
                    ids[:pre] = prompt[:-1]
                    wave_primaries[covered_t] = slot
                    wave_pending.append((slot, ids, pre, bucket, covered_t))
            self._slots[slot] = item
            self._slot_lengths[slot] = P - 1
            self._slot_epoch[slot] += 1
            # one base key per request, in first-admission order; a parked
            # resume keeps its slot's key, a requeue carries its own
            if resumed is not None:
                item.base_key = np.array(self._slot_keys[slot])
            elif item.base_key is not None:
                self._slot_keys[slot] = item.base_key
            else:
                item.base_key = slot_base_key(self.config.random_seed, self._admission_seq)
                self._admission_seq += 1
                self._slot_keys[slot] = item.base_key
            self._mark_slot_dirty(slot)
            admitted = True
        self._flush_wave(wave_pending, wave_forks)
        return admitted

    def _flush_wave(self, pending: list, forks: list) -> None:
        """Run the wave's prefills, batched per bucket in groups of 8, 4,
        2 or 1 (jax_decode.py:2998-3092), then the duplicate forks that
        read them; a fork that finds no block falls back to a prefill of
        its own, or requeues its request."""
        by_bucket: dict[int, list] = {}
        for entry in pending:
            by_bucket.setdefault(entry[3], []).append(entry)
        for bucket, entries in by_bucket.items():
            i = 0
            while i < len(entries):
                rest = len(entries) - i
                B = 8 if rest >= 8 else 4 if rest >= 4 else 2 if rest >= 2 else 1
                group = entries[i : i + B]
                i += B
                self._prefill_batch([g[0] for g in group], np.stack([g[1] for g in group]),
                                    [g[2] for g in group], bucket)
                for slot, _, _, _, covered_t in group:
                    self._register_prefix(slot, list(covered_t))
        for dst, src, covered_t, bucket in forks:
            covered = len(covered_t)
            try:
                self._device_fork(src, dst, covered)
            except PoolDry:
                try:
                    if not self._reclaim_blocks(frozenset({src, dst})):
                        raise PoolDry("wave fork")
                    self._device_fork(src, dst, covered)
                except PoolDry:
                    if not self._ensure_tokens(dst, bucket, frozenset({src})):
                        self._preempt(dst)
                        continue
                    ids = np.zeros(bucket, dtype=np.int64)
                    ids[:covered] = covered_t
                    self._prefill_batch([dst], ids[None], [covered], bucket)
            self._register_prefix(dst, list(covered_t))

    def _prefill_batch(self, slots: list[int], ids: np.ndarray, lens: list[int],
                       bucket: int) -> None:
        """One prefill forward of len(slots) prompts padded to `bucket`
        (rows [B, bucket] in `ids`) into each slot's first blocks. Rows
        past a prompt's length hold the pad tokens' KV; decode overwrites
        each of them before the validity mask lets it be read."""
        cfg = self.model_config
        B = len(slots)
        L, nKV, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim_
        bsz = self._alloc.block_size
        nb_w = -(-bucket // bsz)
        pad = nb_w * bsz - bucket
        rows = np.concatenate([self._alloc.row(s, nb_w) for s in slots]).astype(np.int64)
        with self._prefill_call(int(sum(lens))):
            rows = self._upload(rows)
            _, k, v = prefill(self.params, self._upload(ids), torch.arange(bucket, device=self.device),
                              cfg, with_logits=False, layers=self._layers)  # [B, L, bucket, nKV, hd]
            if pad:
                k = F.pad(k, (0, 0, 0, 0, 0, pad))
                v = F.pad(v, (0, 0, 0, 0, 0, pad))
            # [B, L, nb_w * bsz, ...] -> [L, B * nb_w, bsz, ...]: the slots' blocks in row order
            k = k.transpose(0, 1).reshape(L, B * nb_w, bsz, nKV, hd)
            v = v.transpose(0, 1).reshape(L, B * nb_w, bsz, nKV, hd)
            if self._kv_quant:
                # prompt rows quantize at this scatter, as decode rows do at
                # theirs (jax_decode.py:1856-1866)
                k, k_s = quantize_kv(k)
                v, v_s = quantize_kv(v)
                self._k_scale[:, rows] = k_s.transpose(-1, -2)
                self._v_scale[:, rows] = v_s.transpose(-1, -2)
            self._k_pool[:, rows] = k.to(self._k_pool.dtype)
            self._v_pool[:, rows] = v.to(self._v_pool.dtype)

    def _suffix_prefill(self, slot: int, suffix: list[int], plen: int, sb: int) -> None:
        """Prefill `suffix` (padded to `sb`) at rows plen.. of the slot, its
        context the prefix rows [0, plen) already in the slot's blocks
        (jax_decode.py:2094-2186): the slot's first blocks are gathered,
        the prefix read through a power-of-two bucket `pb`, and only the
        suffix rows are written. On an int8 pool the prefix is read
        dequantized, and only the new rows are quantized, so the prefix
        blocks keep their bytes."""
        cfg = self.model_config
        bsz = self._alloc.block_size
        pb = min(_pow2_bucket(plen), int(self.config.context_length))
        nb = -(-max(pb, plen + sb) // bsz)
        L, nKV, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim_
        row = self._alloc.row(slot, nb).astype(np.int64)
        ids = np.zeros(sb, dtype=np.int64)
        ids[: len(suffix)] = suffix
        pos = np.arange(plen, plen + sb)

        def prefix(pool, scales):  # [L, pb, nKV, hd] in the model dtype
            rows = pool[:, table].reshape(L, nb * bsz, nKV, hd)[:, :pb]
            if scales is None:
                return rows
            sc = scales_rowmajor(scales[:, table])[:, :pb]
            return dequantize_kv(rows, sc, torch_dtype(cfg.dtype))

        with self._prefill_call(len(suffix)):
            table = self._upload(row)
            ks, vs = prefill_with_prefix(
                self.params, self._upload(ids), prefix(self._k_pool, self._k_scale),
                prefix(self._v_pool, self._v_scale), plen, cfg, layers=self._layers,
            )  # [L, sb, nKV, hd]
            blocks, offs = self._upload(row[pos // bsz]), self._upload(pos % bsz)
            if self._kv_quant:
                ks, k_s = quantize_kv(ks)
                vs, v_s = quantize_kv(vs)
                self._k_scale.permute(0, 1, 3, 2)[:, blocks, offs] = k_s
                self._v_scale.permute(0, 1, 3, 2)[:, blocks, offs] = v_s
            self._k_pool[:, blocks, offs] = ks.to(self._k_pool.dtype)
            self._v_pool[:, blocks, offs] = vs.to(self._v_pool.dtype)

    # -- dispatch and consumption (jax_decode.py:3311-3712) -------------
    def _chunk_bucket(self, active: np.ndarray, grow: int) -> int:
        """Smallest KV span (256 x 2^k, capped at the context) covering
        every active slot through this pass's `grow` new rows: attention
        reads only the table columns of this span."""
        needed = int(self._slot_lengths[active].max()) + grow + 1
        b = 256
        while b < needed:
            b *= 2
        return min(b, int(self.config.context_length))

    def _preempt(self, slot: int) -> None:
        """Pool pressure: requeue the slot's request at the front (it
        re-admits with its consumed tokens) and free its blocks."""
        item = self._slots[slot]
        self._slots[slot] = None
        self._release_slot_blocks(slot)
        self._mark_slot_dirty(slot)
        if item is not None:
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
        its own host-known context (jax_decode.py:1657-1696). A draft is
        capped against the slot's projected length so that the verify
        forward, which also emits a bonus token, writes no row at or past
        the context length and emits no token past max_new_tokens.
        Returns (drafts [R, spec_k] int64, lengths [R] int64)."""
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

    def _control(self) -> dict:
        """Device control arrays (sampling settings, keys, penalties),
        rebuilt only after a slot was admitted, retired or preempted."""
        if self._ctl is not None:
            return self._ctl
        R = int(self.config.max_running_requests)
        temps = np.ones(R, dtype=np.float32)
        top_ps = np.ones(R, dtype=np.float32)
        greedy = np.zeros(R, dtype=bool)
        pens = np.zeros(R, dtype=np.float32)
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            temps[i] = max(s.gconfig.temperature, 1e-6)
            top_ps[i] = s.gconfig.top_p
            greedy[i] = s.gconfig.greedy
            pens[i] = s.gconfig.frequency_penalty
        self._ctl = dict(
            temps=self._upload(temps), top_ps=self._upload(top_ps),
            greedy=self._upload(greedy), freq_pens=self._upload(pens),
            base_keys=self._upload(self._slot_keys),
        )
        return self._ctl

    def _table_device(self, nb: int) -> torch.Tensor:
        """The [R, nb] block-table slice on the device, uploaded again only
        after the allocator's tables changed."""
        key = (self._alloc.version, nb)
        if self._dev_table is None or self._dev_table_key != key:
            self._dev_table = self._upload(self._alloc.table_slice(nb))
            self._dev_table_key = key
        return self._dev_table

    def _chain(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The device-chained (last token, length) per slot, with the
        slots whose host truth diverged (an admission, a rewind at
        retirement) patched from the host."""
        R = int(self.config.max_running_requests)
        if self._dev_last is None or self._patch_slots:
            mask = np.zeros(R, dtype=bool)
            last = np.zeros(R, dtype=np.int64)
            for i in (range(R) if self._dev_last is None else self._patch_slots):
                mask[i] = True
                s = self._slots[i]
                if s is not None:
                    # a fresh slot decodes its prompt's last token first
                    last[i] = s.tokens[-1] if s.tokens else s.prompt[-1]
            last_t, len_t = self._upload(last), self._upload(self._slot_lengths)
            if self._dev_last is None:
                self._dev_last, self._dev_lengths = last_t, len_t
            else:
                m = self._upload(mask)
                self._dev_last = torch.where(m, last_t, self._dev_last)
                self._dev_lengths = torch.where(m, len_t, self._dev_lengths)
            self._patch_slots.clear()
        return self._dev_last, self._dev_lengths

    def _dispatch_chunk(self, active: np.ndarray) -> _Inflight | None:
        """Queue one pass over the active slots on the device and start
        its results' copy to the host: a verify forward when speculative
        decode is on, no slot has a frequency penalty and some slot
        drafted, else a chunk of `new_tokens_per_chunk` decode steps.
        Projects the host lengths forward by the pass's growth. None when
        no slot is left to run."""
        R = int(self.config.max_running_requests)
        S = int(self.config.context_length)
        n_chunk = int(self.config.new_tokens_per_chunk)
        spec_on = self.config.spec_decode == "ngram"
        if spec_on and self._inflight:
            # draft freshness: passes already landed are consumed first;
            # one still in flight is left alone (a stale draft costs
            # acceptance, never correctness)
            while self._inflight and self._inflight[0].ready():
                self._consume_chunk(self._inflight.popleft())
            active = active & self._active_mask()
            if not active.any():
                return None
        # saturation: a slot whose max_new_tokens are all covered by
        # dispatched passes gets nothing from another
        active = active.copy()
        for i in np.nonzero(active)[0]:
            s = self._slots[i]
            if s is None or (int(self._slot_lengths[i]) - (len(s.prompt) - 1)
                             >= s.gconfig.max_new_tokens):
                active[i] = False
        if not active.any():
            return None
        live = [s for s in self._slots if s is not None]
        use_topp = any(not s.gconfig.greedy and s.gconfig.top_p < 1.0 for s in live)
        use_freq = any(s.gconfig.frequency_penalty != 0.0 for s in live)
        W = 0  # verify width; 0: the normal chunk
        drafts = dlens = None
        if spec_on and not use_freq:
            # a one-forward verify cannot reproduce counts that evolve
            # token by token, so penalty batches take the normal chunk
            drafts, dlens = self._draft_all(active)
            max_d = int(dlens.max())
            if max_d > 0:
                b = min(x for x in self._spec_draft_buckets() if x >= max_d)
                W = b + 1
                drafts = drafts[:, :b]
        grow = W or n_chunk
        # every active slot needs blocks through this pass; shortest first,
        # so pool pressure preempts as few slots as possible
        order = sorted(np.nonzero(active)[0], key=lambda i: self._slot_lengths[i])
        preempted: set[int] = set()
        for i in order:
            need = min(int(self._slot_lengths[i]) + grow + 1, S)
            while self._slots[i] is not None and i not in preempted \
                    and not self._ensure_tokens(i, need):
                victims = [j for j in order if j != i and j not in preempted
                           and self._slots[j] is not None]
                if victims:
                    v = max(victims, key=lambda j: self._slot_lengths[j])
                    self._preempt(v)
                    preempted.add(v)
                elif self._inflight:
                    # slots masked out as saturated hold blocks until their
                    # last pass is consumed: consume it, so they retire and
                    # their blocks become reclaimable (the JAX engine raises
                    # here instead: ROADMAP.md queue 3)
                    self._drain_inflight_locked()
                else:  # the pool always fits one full-context slot
                    raise PoolDry("KV pool cannot back a single active slot")
        active = active & self._active_mask()
        if not active.any():
            return None

        nb = -(-self._chunk_bucket(active, grow) // self._alloc.block_size)
        last, lengths = self._chain()
        ctl = self._control()
        table = self._table_device(nb)
        active_t = self._upload(active)
        k_pool, v_pool = self.kv_pools()
        version = self._version
        t0 = time.perf_counter()
        if W:
            toks, logps, acc = self._verify_pass(
                active_t, last, lengths, table, ctl, self._upload(drafts), self._upload(dlens),
                W, use_topp, k_pool, v_pool,
            )
            self.verify_dispatches += 1
            self._slot_lengths[active] += W  # reconciled to accepted + 1 at consumption
        else:
            toks, logps = self._decode_pass(
                active_t, last, lengths, table, ctl, n_chunk, use_topp, use_freq, k_pool, v_pool,
            )
            acc = None
            self.decode_steps += n_chunk
            self._slot_lengths[active] += n_chunk
        self._chunks_dispatched += 1
        host = [self._to_host(t) for t in (toks, logps) + (() if acc is None else (acc,))]
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return _Inflight(
            toks=host[0], logps=host[1], event=event, items=list(self._slots),
            active=active, epochs=self._slot_epoch.copy(), version=version,
            t_dispatch=t0, n_chunk=W or n_chunk, nb=nb, spec_w=W,
            accepted=host[2] if W else None, draft_lens=dlens if W else None,
        )

    def _decode_pass(self, active_t, tokens, lengths, table, ctl, n_chunk: int,
                     use_topp: bool, use_freq: bool, k_pool, v_pool):
        """`n_chunk` steps of `decode_step_paged` plus sampling, queued on
        the device; the slots' last tokens and lengths stay chained there.
        With `use_freq`, each step's logits lose penalty x count and the
        counts take the step's tokens (jax_decode.py:1399-1410)."""
        R = active_t.shape[0]
        dev = self.device
        toks = torch.empty((n_chunk, R), dtype=torch.long, device=dev)
        logps = torch.empty((n_chunk, R), dtype=torch.float32, device=dev)
        if use_freq:
            for i, s in enumerate(self._slots):
                if s is not None and s.gconfig.frequency_penalty != 0.0:
                    self._slot_used_freq[i] = True
            if self._freq_counts is None:
                self._freq_counts = torch.zeros(
                    (R, self.model_config.vocab_size), dtype=torch.float32, device=dev)
            active_f = active_t.float()[:, None]
        for step in range(n_chunk):
            logits = decode_step_paged(
                self.params, tokens, lengths, k_pool, v_pool, table, self.model_config,
                active=active_t, layers=self._layers,
            )
            if use_freq:
                logits = logits - ctl["freq_pens"][:, None] * self._freq_counts
            # the token at position `lengths` draws with fold_in(key, lengths)
            tok, logp = sample(
                logits, ctl["base_keys"], lengths, ctl["temps"], ctl["top_ps"],
                ctl["greedy"], use_topp,
            )
            tok = torch.where(active_t, tok, tokens)
            if use_freq:
                self._freq_counts.scatter_add_(1, tok[:, None], active_f)
            toks[step] = tok
            logps[step] = logp
            lengths = lengths + active_t
            tokens = tok
        self._dev_last, self._dev_lengths = tokens, lengths
        return toks, logps

    def _verify_pass(self, active_t, last, lengths, table, ctl, drafts, dlens, W: int,
                     use_topp: bool, k_pool, v_pool):
        """One verify forward (jax_decode.py:1596-1651): slot r's W inputs
        are its last token and its draft (zero-padded), at positions
        lengths[r] + j; every position samples with fold_in(key, lengths[r]
        + j), the sampler of the normal chunk. A slot accepts its draft
        prefix that sampling reproduces (position j's sample equal to
        draft token j, for j below its draft length, in a row), then emits
        the sample after it, the bonus: exactly the tokens the normal chunk
        would have emitted. Lengths advance by accepted + 1 and the last
        token becomes the bonus, on the device. Rows written for rejected
        positions are dead: the causal mask hides them until the next
        write at that position overwrites them."""
        R = active_t.shape[0]
        dev = self.device
        tokens = torch.cat([last[:, None], drafts], dim=1)
        logits = verify_step_paged(
            self.params, tokens, lengths, k_pool, v_pool, table, self.model_config,
            active=active_t, layers=self._layers,
        )  # [R, W, V]
        positions = lengths[:, None] + torch.arange(W, device=dev)

        def rows(t):  # [R] -> [R * W], slot-major as the logits
            return t.repeat_interleave(W, dim=0)

        tok, logp = sample(
            logits.reshape(R * W, -1), rows(ctl["base_keys"]), positions.reshape(-1),
            rows(ctl["temps"]), rows(ctl["top_ps"]), rows(ctl["greedy"]), use_topp,
        )
        tok, logp = tok.reshape(R, W), logp.reshape(R, W)
        match = (tok[:, :-1] == drafts) & (torch.arange(W - 1, device=dev)[None, :] < dlens[:, None])
        acc = torch.cumprod(match.long(), dim=1).sum(dim=1)
        emit = torch.where(active_t, acc + 1, 0)
        bonus = tok.gather(1, acc[:, None])[:, 0]
        self._dev_last = torch.where(active_t, bonus, last)
        self._dev_lengths = lengths + emit
        return tok.T.contiguous(), logp.T.contiguous(), acc * active_t

    def _consume_chunk(self, rec: _Inflight) -> None:
        """Deliver a pass's tokens (waiting for them if they have not
        landed): slots retired or preempted since its dispatch discard
        theirs, a verify forward's slots are reconciled from its
        worst-case projection to what they emitted."""
        toks, logps, acc = rec.host()
        t_ready = time.perf_counter()
        self._collect_prefill_events(wait=False)
        # the device window: from dispatch, or from the previous pass's
        # arrival when this one was queued behind it
        prev = self._last_ready_t
        start = rec.t_dispatch if prev is None else max(rec.t_dispatch, prev)
        dev_s = max(t_ready - start, 0.0)
        self._last_ready_t = t_ready
        self.decode_seconds += dev_s
        with self._metrics_lock:
            self._dev_busy_s += dev_s
            if prev is not None:
                # the host gap: the previous pass had landed and this one
                # was not queued yet
                self._dev_idle_s += max(rec.t_dispatch - prev, 0.0)
            self._chunk_itl_ms.append(1e3 * dev_s / rec.n_chunk)
            self._chunk_wall_itl_ms.append(
                1e3 * (t_ready - (prev if prev is not None else rec.t_dispatch)) / rec.n_chunk
            )
        spec = rec.spec_w > 0
        if spec:
            self.verify_seconds += dev_s
        for i, s in enumerate(rec.items):
            if s is None or not rec.active[i]:
                continue
            e = int(acc[i]) + 1 if spec else rec.n_chunk
            if s is not self._slots[i] or rec.epochs[i] != self._slot_epoch[i]:
                # the slot was retired or preempted after this dispatch:
                # its tokens never happened (its length was rewound)
                self.runahead_discarded += e
                continue
            if spec:
                self._slot_lengths[i] -= rec.n_chunk - e
                a, d = int(acc[i]), int(rec.draft_lens[i])
                self.spec_chunk_slots += 1
                self.spec_hist[min(a, len(self.spec_hist) - 1)] += 1
                self.spec_drafted += d
                self.spec_accepted += a
                self.spec_rejected += d - a
            else:
                self.chunk_tokens += e
            self._emit(i, toks[:e, i], logps[:e, i], rec.version, dev_s / e)

    def _emit(self, slot: int, toks, logps, version: int, itl: float) -> None:
        """Deliver a pass's tokens to the slot's request: cut at a stop id,
        a stop string or max_new_tokens (a stop may fall inside an accepted
        draft), and retire the request when it ends, its length rewound to
        the rows its delivered tokens cover."""
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
            self._slot_lengths[slot] = len(s.prompt) - 1 + len(s.tokens)
            self._retire(slot)

    def _stop_string_boundary(self, item: _Slot) -> int | None:
        """Earliest token count whose decoded output contains a stop string
        (jax_decode.py:3108-3129). Incremental: only the tail since
        `stop_checked`, with `_STOP_OVERLAP` tokens of overlap for strings
        that span the previous boundary, is decoded."""
        g = item.gconfig
        if not g.stop or self.tokenizer is None or not item.tokens:
            return None
        window_start = max(0, item.stop_checked - _STOP_OVERLAP)
        tail = self.tokenizer.decode(item.tokens[window_start:])
        item.stop_checked = len(item.tokens)
        if not any(s in tail for s in g.stop):
            return None
        for i in range(max(window_start, g.min_new_tokens - 1), len(item.tokens)):
            prefix = self.tokenizer.decode(item.tokens[window_start : i + 1])
            if any(s in prefix for s in g.stop):
                return i + 1
        return None

    def _truncate_at_stop(self, item: _Slot) -> None:
        """Trim tokens generated past the first stop criterion: stop ids
        (after min_new_tokens) and stop strings are both checked and the
        earlier boundary wins; else past max_new_tokens."""
        g = item.gconfig
        stop_ids = set(g.stop_token_ids or [])
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is not None:
            stop_ids.add(eos)
        tok_cut = next((i + 1 for i, t in enumerate(item.tokens)
                        if t in stop_ids and i + 1 >= g.min_new_tokens), None)
        cuts = [c for c in (tok_cut, self._stop_string_boundary(item)) if c is not None]
        if cuts:
            cut, reason = min(cuts), "stop"
        elif len(item.tokens) >= g.max_new_tokens:
            cut, reason = g.max_new_tokens, "length"
        else:
            return
        del item.tokens[cut:]
        del item.logprobs[cut:]
        del item.versions[cut:]
        del item.itl[cut:]
        item.stop_reason = reason

    def _retire(self, slot: int) -> None:
        """Free the slot (jax_decode.py:3161-3194). An interrupted request
        parks its KV for a resume under its rid; a finished one registers
        its whole conversation as donor material and keeps its blocks."""
        item = self._slots[slot]
        self._slots[slot] = None
        self._mark_slot_dirty(slot)
        covered = int(self._slot_lengths[slot])
        if item is not None and item.stop_reason == "interrupt":
            self._parked[item.rid] = (slot, covered, time.monotonic())
            self._parked_tokens[item.rid] = (item.prompt + item.tokens)[:covered]
        else:
            if item is not None and covered > 0:
                self._register_prefix(slot, (item.prompt + item.tokens)[:covered])
            else:
                self._alloc.free_slot(slot)
            self._slot_lengths[slot] = 0
        if item is not None:
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
        if req.gconfig.stop and self.tokenizer is None:
            raise ValueError(
                "gconfig.stop (stop strings) requires the engine to be "
                "constructed with a tokenizer; use stop_token_ids otherwise"
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
        """Pause on the next pass boundary; returns once the scheduler is
        parked and every dispatched pass has been consumed, so no queued
        device work reads the current weights or KV (jax_decode.py:
        3850-3861)."""
        self._gen_paused.set()
        with self._sched_lock, torch.no_grad():
            self._drain_inflight_locked()

    def continue_generation(self) -> None:
        self._gen_paused.clear()

    def abort_all(self) -> int:
        """End every running and queued request with stop reason
        "interrupt", returning their partial outputs (jax_decode.py:
        4252-4282); running slots park their KV for a resume. Call only
        while paused."""
        if not self._gen_paused.is_set():
            raise RuntimeError("abort_all requires pause_generation")
        n = 0
        with self._sched_lock:
            for i, s in enumerate(self._slots):
                if s is None:
                    continue
                s.stop_reason = "interrupt"
                self._retire(i)
                n += 1
            queued = list(self._overflow)
            self._overflow.clear()
            while True:
                try:
                    queued.append(self._request_q.get_nowait())
                except queue.Empty:
                    break
            for item in queued:
                item.stop_reason = "interrupt"
                self._complete(item, "interrupt")
                n += 1
        return n

    def update_weights_from_tensor(self, named, version: int | None = None) -> None:
        """Install tensors keyed by `/`-joined parameter names (a dict, or
        (name, array) pairs; numpy or torch, any device), copied in place
        into the served weights and cast to their dtype. Every name and
        shape is checked before anything is written. Runs inside a pause
        window (an external pause is preserved), drops the parked KV and
        the prefix registry, and stamps `version` inside the same window,
        so no token mixes new weights with the old version.

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
            with self._sched_lock:
                self._invalidate_parked()
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

    def read_disk_weights(self, meta) -> dict[str, torch.Tensor]:
        """The served tensors of an HF checkpoint directory (`meta.path`,
        as `models/hf_io.save_hf_params` writes it), read on the host with
        generation live; an int8-weight engine quantizes its kernels."""
        if meta.path is None:
            raise ValueError("update_weights_from_disk needs meta.path")
        host = hf_io.load_hf_params(meta.path, self.model_config)
        if self._w_quant:
            with torch.no_grad():
                host = quantize_weights(host)
        return host

    def update_weights_from_disk(self, meta) -> None:
        """Install the weights of an HF checkpoint directory
        (jax_decode.py:5063). The file is read before the pause
        (`read_disk_weights`; JAX reads it inside); the install is
        `update_weights_from_tensor`'s: one pause window (an external
        pause is kept), every name and shape checked first, the parked KV
        and the prefix registry dropped. The caller stamps the version
        (the server passes it to `update_weights_from_tensor` itself, to
        stamp it inside the install's pause)."""
        self.update_weights_from_tensor(self.read_disk_weights(meta))

    # -- observability --------------------------------------------------
    def reset_timing_windows(self) -> None:
        """Clear the rolling ITL windows and the busy/idle seconds
        (jax_decode.py:5103): call on an idle engine between a warm-up and
        a measured run. Counters are left alone."""
        with self._metrics_lock:
            self._chunk_itl_ms.clear()
            self._chunk_wall_itl_ms.clear()
            self._dev_busy_s = 0.0
            self._dev_idle_s = 0.0
            self._last_ready_t = None

    def get_metrics(self) -> dict:
        """Load and latency counters under the JAX engine's key names
        (jax_decode.py:5116) that this engine has, and two keys of the
        port's own: `kernel_launches`, the op wrappers' launch counters in
        this process with `decode_steps`, `verify_dispatches` and
        `prefill_calls`, so a caller in another process can hold the
        launch formulas (read it while paused: the scheduler counts a pass
        at dispatch, and the counters of a pass in progress may be torn);
        and `device_memory_peak`, this process's peak allocated and
        reserved device bytes (None on the CPU).
        ITL is per token: a pass's device window (or ready-to-ready wall
        time) over its tokens."""
        running, active_tokens = 0, 0
        for i, s in enumerate(list(self._slots)):
            if s is not None:
                running += 1
                active_tokens += int(self._slot_lengths[i]) + 1
        with self._request_q.mutex:
            queued_items = list(self._request_q.queue)
        queued_items += list(self._overflow)
        queued_tokens = sum(len(it.prompt) + it.gconfig.max_new_tokens for it in queued_items)
        self._collect_prefill_events(wait=False)
        with self._metrics_lock:
            itl = np.asarray(self._chunk_itl_ms, dtype=np.float64)
            itl_wall = np.asarray(self._chunk_wall_itl_ms, dtype=np.float64)
            busy, idle = self._dev_busy_s, self._dev_idle_s

        def pct(x, q):
            return float(np.percentile(x, q)) if x.size else 0.0

        prefix_hits = self._n_prefix_forks + self._n_prefix_inplace + self._n_suffix_prefills
        prefix_total = prefix_hits + self._n_prefills
        alloc = self._alloc
        return {
            "running_requests": running,
            "queued_requests": len(queued_items),
            "queued_tokens": queued_tokens,
            "active_tokens": active_tokens,
            "generated_tokens_total": self.decode_tokens,
            "decode_runahead_chunks": int(self.config.decode_runahead_chunks),
            "chunks_dispatched_total": self._chunks_dispatched,
            "runahead_discarded_tokens_total": self.runahead_discarded,
            "device_busy_s": round(busy, 6),
            "device_idle_s": round(idle, 6),
            "device_idle_frac": round(idle / (busy + idle), 6) if busy + idle > 0 else 0.0,
            "itl_p50_ms": pct(itl, 50),
            "itl_p99_ms": pct(itl, 99),
            "itl_wall_p50_ms": pct(itl_wall, 50),
            "itl_wall_p99_ms": pct(itl_wall, 99),
            "prefill_secs_total": round(self._prefill_secs, 6),
            "role": self.config.role,
            "prefills_total": self._n_prefills,
            "prefix_forks_total": self._n_prefix_forks,
            "prefix_inplace_total": self._n_prefix_inplace,
            "suffix_prefills_total": self._n_suffix_prefills,
            "prefix_cache_hit_rate": round(prefix_hits / prefix_total, 6) if prefix_total else 0.0,
            "preemptions_total": self.n_preemptions,
            "kv_layout": self.config.kv_layout,
            "kv_dtype": self.config.kv_dtype,
            "weight_dtype": self.config.weight_dtype,
            "kv_block_size": alloc.block_size if alloc else 0,
            "kv_blocks_total": alloc.usable_blocks if alloc else 0,
            "kv_blocks_free": alloc.free_blocks if alloc else 0,
            "kv_tokens_allocated": alloc.allocated_tokens() if alloc else 0,
            "kernel_launches": dict(
                kernel_launches(), decode_steps=self.decode_steps,
                verify_dispatches=self.verify_dispatches, prefill_calls=self.prefill_calls,
            ),
            "device_memory_peak": self._device_memory_peak(),
        }

    def _device_memory_peak(self) -> dict | None:
        """This process's peak device memory since it started (the card's
        allocator), or None on the CPU."""
        if self.device.type != "cuda":
            return None
        return dict(max_allocated_bytes=torch.cuda.max_memory_allocated(self.device),
                    max_reserved_bytes=torch.cuda.max_memory_reserved(self.device))

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
