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
- **MoE routing groups** (Qwen3-MoE, Qwen2-MoE, Mixtral;
  `models/qwen2.moe_mlp`). Every model call routes under JAX's mask: a
  batched prefill routes each row on its own over its bucket, its pad tail
  claiming no expert capacity (JAX prefills one sequence per call,
  vmapped); a decode step groups the R slots, a verify pass the R x W
  tokens, each under the slots' `active` mask, which stays fixed over a
  chunk. Capacity makes a MoE stream depend on its batchmates: the
  batch-invariance of the dense streams holds for dense models only.
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
- **The host KV tier** (`kv_host_pool_mb > 0`, jax_decode.py:1917-2091).
  Evicting a parked slot (`_evict_parked_lru`) or preempting an active one
  (`_preempt`, its consumed coverage only) offloads its covering blocks
  (and an int8 pool's scales) to pinned host memory (`HostKVStore`, its
  own byte budget and LRU); a resume whose rid and tokens match an entry
  exactly is promoted, its blocks uploaded into fresh pool blocks with its
  sampling key, ahead of every other rung of the ladder, and prefills
  nothing. A failed offload or promotion is counted and costs a prefill.
  Weight installs and `destroy` clear the tier; `abort_all` keeps it, as
  JAX does.
- **Layouts** (`kv_layout`, `paged_attn_impl`; jax_decode.py:1325-1650).
  "paged" with "auto"/"pallas" attends in place through the CUDA kernels;
  "paged" with "xla" gathers each slot's blocks once per pass, runs the
  workspace steps (`models/qwen2.decode_step`, `verify_step` through the
  plain paged attention) and writes back only the pass's rows; the
  "workspace" layout (the numerics oracle) gathers, runs the chunk on the
  workspace and scatters the blocks back. The plain paths agree bit for
  bit. An fp pool may be in float32 or bfloat16 under a model in either.
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

- **Session migration** (jax_decode.py:4284-4815). `export_session` moves
  a parked or host-tier session out as host tensors and its resume
  metadata; `import_session` lands one in the host tier (made from
  `kv_import_pool_mb` if the engine has none), where its resume is a
  promotion with no prefill. Another weight version or pool dtype is an
  honest miss. The decode server's `/drain` streams every exportable
  session to survivors over the KV frames of `core/weight_transfer.py`.

- **Prefill-only admissions** (`aprefill`, jax_decode.py:3753-3790): the
  prefill role's entry point. The request is admitted down the same
  ladder, retired with stop reason "prefill" right after the wave's
  prefills ran, and parked exactly as an interrupted one (covered =
  prompt[:-1]), ready for a local resume or an export to a decode replica.

- **The KV fabric** (`kv_fabric`, on by default as in JAX;
  `core/kv_fabric.py`). Every registration's complete blocks are keyed
  by content (chained blake2b over the tokens, salted with the weight
  version and the pool dtype) into a device index (`_fabric_dev`), and
  host-tier entries into the store's. An admission with no exact donor
  and no registered prefix looks for the longest keyed run, first on the
  device (a registration that diverges later: fork and suffix prefill),
  then in the host tier (offloaded by any rid, or fetched from a sibling:
  upload and suffix prefill). `export_fabric_blocks` copies runs out for
  a sibling's `/kv_fetch` or `/warm_start`; `export_session(rid,
  refetchable)` sends identity only (`meta_only`) when the survivors'
  digest covers every complete block, and `import_session` lands such a
  session as an identity whose resume keeps its sampling key and rebuilds
  the blocks through the fabric or a prefill.

- **Vision** (jax_decode.py:925-1144, 2884-2912). `set_vision_model`
  installs a Qwen2-VL / Qwen2.5-VL tower (`models/qwen2_vl.py`); a
  checkpoint whose config has `vision_config` loads its `visual.*` tower
  at `initialize`. A request carrying `image_data` (processed patch
  dicts) is encoded at admission, its vision vectors spliced over the
  image-pad positions, and prefilled on its own from those embeddings
  with m-rope tables; its slot then decodes with its m-rope position
  delta as a rotary offset (`_slot_rope_delta`, in every decode and
  verify pass). Image KV depends on pixels the tokens cannot see, so an
  image slot never forks, never joins a wave, never suffix-prefills,
  never registers as a donor and stays out of the fabric and of
  identity-only drains; its delta travels with it through the host tier
  and session migration. Without a tower an image request raises.
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
    ROLES,
    GenerationHyperparameters,
    InferenceEngineConfig,
    TorchDecodeConfig,
)
from areal_tpu_torch.api.engine_api import InferenceEngine
from areal_tpu_torch.api.io_struct import ModelRequest, ModelResponse
from areal_tpu_torch.core import kv_fabric
from areal_tpu_torch.core.workflow_executor import WorkflowExecutor
from areal_tpu_torch.engine.kv_pool import HostKVEntry, HostKVStore, KVBlockAllocator, PoolDry
from areal_tpu_torch.engine.sampling import sample, slot_base_key
from areal_tpu_torch.models import hf_io
from areal_tpu_torch.models.convert import to_tensor
from areal_tpu_torch.models import qwen2_vl
from areal_tpu_torch.models.qwen2 import (
    WEIGHT_DTYPES,
    ModelConfig,
    check_servable,
    check_supported,
    decode_step,
    decode_step_paged,
    layer_views,
    named_shapes,
    prefill,
    prefill_with_prefix,
    quantize_weights,
    torch_dtype,
    verify_step,
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
# fp pool dtypes the kernels read: q in f32 or bf16 over a pool in either
_FP_POOL_DTYPES = ("float32", "bfloat16")


def kernel_launches() -> dict[str, int]:
    """The op wrappers' launch counters in this process (the port-only
    `kernel_launches` key of `get_metrics`)."""
    return dict(
        paged_attention=_pa.launches,
        paged_attention_q8=_pa.launches_q8,
        paged_verify=_pa.launches_verify,
        paged_verify_q8=_pa.launches_verify_q8,
        paged_attention_f32q_bf16pool=_pa.launches_f32q_bf16pool,
        paged_attention_bf16q_f32pool=_pa.launches_bf16q_f32pool,
        paged_verify_f32q_bf16pool=_pa.launches_verify_f32q_bf16pool,
        paged_verify_bf16q_f32pool=_pa.launches_verify_bf16q_f32pool,
        quant_matmul=_qm.launches,
        threefry_noise=_tf.launches,
        flash_attention_fwd=_fa.launches_fwd,
        flash_attention_bwd_dq=_fa.launches_dq,
        flash_attention_bwd_dkv=_fa.launches_dkv,
    )


def _host_tensor(x) -> torch.Tensor:
    """A host tensor from a tensor or an array (a bfloat16 array, as the
    JAX package's wire gives it, by its bits)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    a = np.ascontiguousarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


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
    # the prefill role's admission (`aprefill`): retired with stop reason
    # "prefill" right after its prefill, its KV parked
    prefill_only: bool = False
    # processed patch dicts of a VLM request (ModelRequest.image_data)
    image_data: list | None = None


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
        self._xla = False  # paged_attn_impl == "xla": the gather path, no kernel
        self._block_nbytes = 0  # K+V bytes of one pool block, scales included
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
        # the host KV tier (kv_host_pool_mb > 0), its lock (taken by the
        # scheduler and by get_metrics), the side stream its offload copies
        # run on, and the device intervals of its copies still in flight
        # (direction, start, end), oldest first, not yet in `_swap_secs`
        self._host_store: HostKVStore | None = None
        self._host_lock = threading.Lock()
        self._copy_stream: "torch.cuda.Stream | None" = None
        self._swap_events: list[tuple[str, Any, Any]] = []
        self._swap_secs = {"out": 0.0, "in": 0.0}
        self._n_offload_failures = 0
        self._n_promote_failures = 0
        self._ws_copy_bytes = 0  # gather/scatter bytes of the gather paths
        # session migration (export_session / import_session), under
        # _metrics_lock: sessions and bytes each way, and imports refused
        # for another weight version or pool dtype
        self._migrate = dict(in_sessions=0, out_sessions=0, in_bytes=0, out_bytes=0,
                             version_rejects=0, dtype_rejects=0)
        # the prefix registry: covered tokens -> donor slot, and its inverse
        self._prefix_lookup: dict[tuple[int, ...], int] = {}
        self._slot_prefix: list[tuple[int, ...] | None] = []
        # the fabric's device index over the same registrations, by pool
        # block: content key -> (donor slot, depth in complete blocks), and
        # each slot's chain (jax_decode.py:456-480). Scheduler-owned.
        self._fabric_on = bool(config.kv_fabric)
        self._fabric_dev: dict[int, tuple[int, int]] = {}
        self._slot_fabric_keys: dict[int, list[int]] = {}
        # fabric hits, apart from the exact-resume host hits: "remote" when
        # the bytes came over the wire (a "fabric-*" entry), "local" when
        # another local rid produced them (scheduler-owned)
        self._fabric_hits = dict(local=0, remote=0, local_tokens=0, remote_tokens=0)
        # the fabric's wire, under _metrics_lock: fetched runs and their
        # bytes, and sessions exported as identity only
        self._fabric_wire = dict(fetch_bytes=0, sessions_in=0, meta_only_exports=0)
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
        # the vision tower (set_vision_model), and per slot the m-rope
        # position delta its decode adds to the rotary position and
        # whether its KV came from an image prefill
        self._vision_params: dict[str, torch.Tensor] | None = None
        self._vision_config: qwen2_vl.VisionConfig | None = None
        self._image_token_id: int | None = None
        self._mrope_sections: tuple[int, ...] | None = None
        self._slot_rope_delta: np.ndarray | None = None
        self._slot_image: np.ndarray | None = None
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
        # TTFT's prefill and transfer shares (jax_decode.py:498-499): the
        # host wall of each admitted slot's prefill dispatch, and of each
        # promotion's upload (a migrated or fetched session trades the one
        # for the other)
        self._ttft_prefill_ms: deque[float] = deque(maxlen=_ITL_WINDOW)
        self._ttft_transfer_ms: deque[float] = deque(maxlen=_ITL_WINDOW)
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
    def set_model(self, params: dict[str, torch.Tensor], model_config: ModelConfig,
                  donate: bool = False) -> None:
        """Install weights (the port's flat name -> tensor dict). Copies
        onto the engine's device, so the caller keeps its tensors, unless
        `donate`: then a tensor already on the device is taken as it is
        (Qwen3-30B-A3B's 61 GB cannot sit on an 80 GB card twice), and the
        engine's weight pushes write into it. A critic (a value head, no
        LM head) is refused."""
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
            k: v.detach().to(self.device, copy=not donate) for k, v in params.items()
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
            self._maybe_load_vision_tower(self.config.model_path)
        cfg = self.model_config
        if self.config.weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(
                f"weight_dtype={self.config.weight_dtype!r} not in {WEIGHT_DTYPES}"
            )
        if self.config.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype={self.config.kv_dtype!r} not in {KV_DTYPES}")
        if self.config.role not in ROLES:
            raise ValueError(f"role={self.config.role!r} not in {ROLES}")
        self._w_quant = self.config.weight_dtype == "int8"
        self._kv_quant = self.config.kv_dtype == "int8"
        if self.config.kv_layout not in ("paged", "workspace"):
            raise ValueError(f"kv_layout={self.config.kv_layout!r} not in ('paged', 'workspace')")
        if self._kv_quant and self.config.kv_layout != "paged":
            # the workspace layout is the fp numerics oracle (jax_decode.py:714-720)
            raise ValueError(
                "kv_dtype='int8' requires kv_layout='paged' "
                "(kv_layout='workspace' stays the fp numerics oracle)"
            )
        # "auto" and "pallas" both mean the CUDA kernels; "xla" the gather path
        self._xla = self.config.paged_attn_impl == "xla"
        if self.config.spec_decode == "ngram":
            # the verify kernels' limits on W and W x group
            check_verify_width(
                int(self.config.spec_k) + 1,
                cfg.num_attention_heads // cfg.num_key_value_heads,
            )
        if not self._kv_quant and self.config.kv_cache_dtype != cfg.dtype and not (
                self.config.kv_cache_dtype in _FP_POOL_DTYPES and cfg.dtype in _FP_POOL_DTYPES):
            # the kernels take q and an fp pool in f32 or bf16, in any pair;
            # refuse another pool here, on the CPU and the card alike
            raise NotImplementedError(
                f"kv_cache_dtype={self.config.kv_cache_dtype!r} under the model dtype "
                f"{cfg.dtype!r}: an fp KV pool outside {_FP_POOL_DTYPES} in another "
                "dtype than the model's is not in the PyTorch port yet: ROADMAP.md "
                "queue 1, item 3.6"
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
        # physical bytes of one block, K and V, int8 scales included: every
        # byte counter of the tier and the gather paths derives from it
        # (jax_decode.py:762-781)
        self._block_nbytes = 2 * cfg.num_hidden_layers * bs * cfg.num_key_value_heads * (
            cfg.head_dim_ * kv_dtype.itemsize + (4 if self._kv_quant else 0))
        with self._host_lock:
            self._host_store = (
                HostKVStore(int(float(self.config.kv_host_pool_mb) * 1024 * 1024),
                            self._block_nbytes, bs)
                if float(self.config.kv_host_pool_mb) > 0 else None)
        if self.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        self._swap_events = []
        self._swap_secs = {"out": 0.0, "in": 0.0}
        self._n_offload_failures = self._n_promote_failures = 0
        self._ws_copy_bytes = 0
        with self._metrics_lock:
            self._migrate = dict.fromkeys(self._migrate, 0)
            self._fabric_wire = dict.fromkeys(self._fabric_wire, 0)
        self._fabric_hits = dict.fromkeys(self._fabric_hits, 0)
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
        self._slot_rope_delta = np.zeros(R, dtype=np.int64)
        self._slot_image = np.zeros(R, dtype=bool)
        self._admission_seq = 0
        self._parked, self._parked_tokens = {}, {}
        self._prefix_lookup, self._slot_prefix = {}, [None] * R
        self._fabric_dev, self._slot_fabric_keys = {}, {}
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
        # a waiter of a request still queued or running gets an error, not
        # a future that never resolves (a server killed mid-request answers
        # its clients, who fail over)
        pending = [s for s in self._slots if s is not None] + list(self._overflow)
        while True:
            try:
                pending.append(self._request_q.get_nowait())
            except queue.Empty:
                break
        gone = RuntimeError("decode engine destroyed")
        for item in pending:
            if item.future is not None and not item.future.done():
                with contextlib.suppress(RuntimeError):  # its loop has closed
                    item.loop.call_soon_threadsafe(_fail, item.future, gone)
        self._slots = [None] * len(self._slots)
        self._overflow = []
        if self._executor is not None:
            self._executor.destroy()
            self._executor = None
        self._inflight.clear()
        self.params = self._layers = None
        self._k_pool = self._v_pool = self._k_scale = self._v_scale = None
        self._dev_last = self._dev_lengths = self._ctl = self._dev_table = None
        self._freq_counts = None
        self._vision_params = None
        self._alloc = None
        self._prefix_lookup.clear()
        self._parked.clear()
        self._parked_tokens.clear()
        with self._host_lock:
            if self._host_store is not None:
                self._host_store.clear()
            self._host_store = None

    def kv_pools(self):
        """The pool operands of `decode_step_paged`: the K and V pools, or
        `(int8 data, f32 scales)` tuples when kv_dtype="int8"."""
        return join_pool(self._k_pool, self._k_scale), join_pool(self._v_pool, self._v_scale)

    # -- the vision tower (jax_decode.py:925-1083) -----------------------
    def _maybe_load_vision_tower(self, model_path: str) -> None:
        """A VLM checkpoint (its config.json carries "vision_config") also
        installs its `visual.*` tower, its image token and its m-rope
        sections, so image requests serve from the checkpoint alone.
        The tower's geometry is the vision_config's own; only a Qwen2-VL
        layout takes the language model's width as its merger output (the
        JAX engine lays the language width over a Qwen2.5-VL tower's
        `hidden_size` too: ROADMAP queue 3)."""
        import json
        import os

        cfg_path = os.path.join(model_path, "config.json")
        if not os.path.exists(cfg_path):
            return
        with open(cfg_path) as f:
            raw = json.load(f)
        if "vision_config" not in raw:
            return
        vc = dict(raw["vision_config"])
        if "out_hidden_size" in vc or "intermediate_size" in vc:
            vc.setdefault("out_hidden_size", raw["hidden_size"])
        else:
            vc["hidden_size"] = raw["hidden_size"]
        vcfg = qwen2_vl.VisionConfig.from_hf_dict(vc)
        rs = raw.get("rope_scaling") or {}
        mrope = (tuple(rs["mrope_section"])
                 if rs.get("type", rs.get("rope_type")) in ("mrope", "default")
                 and "mrope_section" in rs else None)
        self.set_vision_model(hf_io.load_hf_vision_params(model_path, vcfg, device=self.device),
                              vcfg, raw.get("image_token_id", 151655), mrope_sections=mrope)
        logger.info(f"vision tower loaded: depth={vcfg.depth} embed={vcfg.embed_dim}")

    def set_vision_model(self, vision_params: dict[str, torch.Tensor],
                         vision_config: "qwen2_vl.VisionConfig", image_token_id: int,
                         mrope_sections: tuple[int, ...] | None = None) -> None:
        """Install a vision tower (`models/qwen2_vl.py`'s flat parameters,
        copied onto the engine's device) so requests carrying
        `image_data` serve instead of raising. Each entry of `image_data`
        is a processed patch dict in the HF AutoProcessor's format:
        {"pixel_values": [N, patch_dim] WINDOW-MAJOR rows,
        "image_grid_thw": [n, 3]}. `mrope_sections` turns on Qwen2-VL's
        m-rope positions (rope_scaling.mrope_section); without them an
        image prompt takes 1-D positions."""
        want = qwen2_vl.vision_param_shapes(vision_config)
        if set(vision_params) != set(want):
            missing = sorted(set(want) - set(vision_params))[:5]
            extra = sorted(set(vision_params) - set(want))[:5]
            raise KeyError(f"vision parameter names differ: missing {missing}, extra {extra}")
        for name, t in vision_params.items():
            if tuple(t.shape) != tuple(want[name]):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {want[name]}")
        self._vision_params = {k: v.detach().to(self.device, copy=True)
                               for k, v in vision_params.items()}
        self._vision_config = vision_config
        self._image_token_id = int(image_token_id)
        self._mrope_sections = (tuple(int(x) for x in mrope_sections)
                                if mrope_sections else None)

    def _encode_images(self, image_data: list) -> torch.Tensor:
        """Processed patch dicts -> [K, hidden] language-space embeddings
        in the model's dtype, on the engine's device. pixel_values rows
        are window-major already (the HF processor's order), and the 2-D
        rope coordinates follow the same permutation. The JAX engine pads
        rows to buckets so that `jit` compiles once per bucket; here every
        row is real, so no `valid` mask is needed."""
        vcfg = self._vision_config
        pv = np.concatenate([np.asarray(d["pixel_values"], dtype=np.float32) for d in image_data])
        thw = np.concatenate([np.asarray(d["image_grid_thw"]).reshape(-1, 3) for d in image_data])
        coords = qwen2_vl.patch_grid_coords(thw, vcfg.spatial_merge_size).astype(np.int64)
        dtype = torch_dtype(self.model_config.dtype)
        return qwen2_vl.forward_vision(self._vision_params, self._upload(pv).to(dtype),
                                       self._upload(coords), vcfg)

    def _image_rope_tables(self, prompt: list[int], image_data: list, bucket: int):
        """(cos, sin) [bucket, hd/2] on the device, and the rope delta, of a
        multimodal prompt (jax_decode.py:1048-1083). With m-rope sections,
        HF get_rope_index positions (`qwen2_vl.mrope_positions`), the
        rows past the prompt continuing scalar positions; without, 1-D
        positions and delta 0."""
        cfg = self.model_config
        if self._mrope_sections is None:
            pos3 = np.broadcast_to(np.arange(bucket, dtype=np.int32), (3, bucket))
            delta = 0
        else:
            thw = np.concatenate([np.asarray(d["image_grid_thw"]).reshape(-1, 3)
                                  for d in image_data])
            pos, delta = qwen2_vl.mrope_positions(
                np.asarray(prompt, dtype=np.int64), thw, self._image_token_id,
                self._vision_config.spatial_merge_size)
            pos3 = np.zeros((3, bucket), dtype=np.int32)
            n = min(pos.shape[1], bucket)
            pos3[:, :n] = pos[:, :n]
            if bucket > n:  # the pad tail: scalar positions on from the last
                cont = pos[:, n - 1].max() + 1 + np.arange(bucket - n)
                pos3[:, n:] = cont[None, :]
        sections = self._mrope_sections or (cfg.head_dim_ // 2,)
        cos, sin = qwen2_vl.mrope_table(pos3, cfg.head_dim_, cfg.rope_theta, sections)
        return cos.to(self.device), sin.to(self.device), int(delta)

    def _image_prefill(self, slot: int, item: _Slot, prompt: list[int], ids: np.ndarray,
                       pre: int, bucket: int) -> None:
        """Prefill one image request into the slot's first blocks (fp or
        int8 pool alike, jax_decode.py:1085-1144): the tower's vectors
        spliced over the image-pad positions of the request's own prompt
        (generated tokens of a requeued request never splice), m-rope
        tables for every row, and the slot's rope delta set."""
        img = self._encode_images(item.image_data)
        cos, sin, delta = self._image_rope_tables(prompt, item.image_data, bucket)
        self._slot_rope_delta[slot] = delta
        ids_t = self._upload(ids)
        splice_ids = np.array(ids)
        splice_ids[len(item.prompt):] = 0
        embeds = qwen2_vl.splice_image_embeds(
            self.params["embed/embedding"][ids_t].to(torch_dtype(self.model_config.dtype)),
            self._upload(splice_ids), img, self._image_token_id)
        self._prefill_batch([slot], ids[None], [pre], bucket,
                            embeds=embeds[None], rope=(cos[None], sin[None]))

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
    def _prefill_call(self, tokens: int, slots: int = 1):
        """One prefill forward of `slots` requests with its pool writes:
        counted in `prefill_calls` and `prefill_tokens`, and timed into
        `prefill_seconds` between device events on the card (read later,
        so the scheduler never waits on them), by the wall clock on the
        CPU. Its host wall, shared out per slot, is TTFT's prefill share."""
        t_wall = time.monotonic()
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
        per = (time.monotonic() - t_wall) * 1000.0 / max(slots, 1)
        with self._metrics_lock:
            self._ttft_prefill_ms.extend([per] * max(slots, 1))

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
        # the fabric's keys go with the registration that owns them: a fork
        # must never read blocks the slot's next occupant writes
        for fk in self._slot_fabric_keys.pop(slot, ()):
            if self._fabric_dev.get(fk, (None, 0))[0] == slot:
                del self._fabric_dev[fk]

    def _register_prefix(self, slot: int, covered: list[int]) -> None:
        self._unregister_prefix(slot)
        if not covered or self._slot_image[slot]:
            # image KV depends on pixels the token key cannot see: a text
            # request with the same tokens must never fork from it
            return
        key = tuple(covered)
        self._slot_prefix[slot] = key
        self._prefix_lookup[key] = slot
        if self._fabric_on and self._alloc is not None:
            # the registration's complete blocks, keyed by content
            fks = kv_fabric.chain_keys(covered, self._alloc.block_size, int(self._version),
                                       str(self.config.kv_dtype))
            if fks:
                self._slot_fabric_keys[slot] = fks
                for i, fk in enumerate(fks):
                    # the first writer wins: equal keys mean equal bytes
                    self._fabric_dev.setdefault(fk, (slot, i + 1))

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
        # keys are salted with the weight version: new chains never match
        # these, so clear them rather than leak them
        self._fabric_dev.clear()
        self._slot_fabric_keys.clear()

    # -- the KV fabric's rungs (jax_decode.py:2219-2361) ----------------
    def _fabric_floor_blocks(self) -> int:
        """The shortest run (in blocks) either fabric rung serves: the
        shared-prefix floor (below it a prefill beats fork + suffix) or
        `kv_fabric_min_blocks`, whichever is larger."""
        bs = self._alloc.block_size
        return max(-(-_MIN_SHARED_PREFIX // bs), max(1, int(self.config.kv_fabric_min_blocks)))

    def _fabric_dev_match(self, chain: list[int], covered: int) -> tuple[int, int] | None:
        """The device rung: the longest keyed run a resident registration
        can donate, as (donor slot, prefix length), even when that
        registration diverges from this prompt past the run."""
        bs = self._alloc.block_size
        for n in range(len(chain), self._fabric_floor_blocks() - 1, -1):
            plen = n * bs
            if plen >= covered:
                continue  # the suffix prefill needs a suffix
            hit = self._fabric_dev.get(chain[n - 1])
            if hit is None:
                continue
            slot, depth = hit
            keys = self._slot_fabric_keys.get(slot)
            # a depth off the chain's position is a 64-bit collision
            # between prefixes of different lengths
            if keys is None or depth != n or len(keys) < n or keys[n - 1] != chain[n - 1]:
                continue
            return slot, plen
        return None

    def _claim_meta_identity(self, item: _Slot) -> None:
        """An identity-only session (a cheap drain) carries no KV: take its
        sampling key, so the resumed stream samples as it would have, and
        let the ladder rebuild the blocks (the fabric or a prefill)."""
        if self._host_store is None:
            return
        try:
            with self._host_lock:
                e = self._host_store.peek(item.rid)
                if e is None or not e.meta_only:
                    return
                e = self._host_store.take(item.rid)
        except Exception as e:  # noqa: BLE001 — degrade to a fresh key, never wedge
            # an injected swap-in fault: the resume goes on as a fresh request
            logger.warning(f"meta-only claim of {item.rid} failed: {e!r}")
            return
        if e is not None and item.base_key is None:
            item.base_key = np.array(e.base_key, dtype=np.uint32)

    def _promote_fabric_blocks(self, item: _Slot, slot: int, chain: list[int],
                               covered: int) -> int:
        """The host rung: seed `slot` with the longest keyed run the host
        tier holds (offloaded by any rid, or fetched from a sibling) and
        return its length in tokens (0: none). The upload is queued on the
        decode stream ahead of the suffix prefill that reads it. The entry
        stays in the store for later matches. Raises PoolDry when the pool
        cannot back the run even after reclaim; a failed upload is a miss,
        counted in `kv_promote_failures_total`."""
        if self._host_store is None or not chain:
            return 0
        bs = self._alloc.block_size
        floor = self._fabric_floor_blocks()
        max_n = min(len(chain), (covered - 1) // bs)  # keep a suffix
        if max_n < floor:
            return 0
        with self._host_lock:
            m = self._host_store.match_blocks(chain[:max_n], min_blocks=floor)
        if m is None:
            return 0
        entry, n = m
        plen = n * bs
        t0 = time.monotonic()
        try:
            self._unregister_prefix(slot)
            self._alloc.free_slot(slot)
            self._slot_lengths[slot] = 0
            if not self._ensure_tokens(slot, plen):
                raise PoolDry("no device blocks for fabric promotion")
            blocks = self._upload(self._alloc.row(slot, n).astype(np.int64))
            hosts = (entry.k, entry.v) + (() if entry.ks is None else (entry.ks, entry.vs))
            for pool, host in zip(self._pool_parts(), hosts):
                pool[:, blocks] = host[:, :n].to(self.device, non_blocking=True)
        except PoolDry:
            raise
        except Exception as e:  # noqa: BLE001 — degrade to a prefill, never wedge
            self._n_promote_failures += 1
            logger.warning(f"fabric block promotion failed: {e!r}")
            return 0
        self._slot_rope_delta[slot] = 0
        self._register_prefix(slot, [int(t) for t in entry.tokens[:plen]])
        way = "remote" if entry.rid.startswith("fabric-") else "local"
        self._fabric_hits[way] += 1
        self._fabric_hits[f"{way}_tokens"] += plen
        with self._metrics_lock:
            self._ttft_transfer_ms.append((time.monotonic() - t0) * 1000.0)
        return plen

    def _invalidate_parked(self) -> None:
        """Drop every parked KV cache, the registry and the host tier
        (weight installs, under a pause): a resume would otherwise continue
        from KV the new weights never produced, under their version stamp.
        The tier's dropped rids are tombstoned, so their resumes count as
        misses and prefill (jax_decode.py:4815-4837)."""
        for rid in list(self._parked):
            slot, _, _ = self._parked.pop(rid)
            self._parked_tokens.pop(rid, None)
            self._alloc.free_slot(slot)
            self._slot_lengths[slot] = 0
        self._invalidate_prefixes()
        with self._host_lock:
            if self._host_store is not None:
                self._host_store.clear()

    def _release_slot_blocks(self, slot: int) -> None:
        self._unregister_prefix(slot)
        self._alloc.free_slot(slot)
        self._slot_lengths[slot] = 0

    def _evict_parked_lru(self, protect: frozenset[int] = frozenset()) -> int | None:
        """Free the least recently parked slot and return it
        (jax_decode.py:2439-2460). With the host KV tier its blocks are
        offloaded first and its resume promotes them; with none (or a
        failed offload) the parked KV is dropped and its resume prefills."""
        candidates = [r for r, (s, _, _) in self._parked.items() if s not in protect]
        if not candidates:
            return None
        rid = min(candidates, key=lambda r: self._parked[r][2])
        slot, covered, _ = self._parked.pop(rid)
        cached = self._parked_tokens.pop(rid, None)
        if cached:
            self._offload_slot_kv(rid, slot, covered, cached)
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

    # -- host KV tier (jax_decode.py:1917-2091) -------------------------
    def _pool_parts(self) -> tuple:
        """The pool tensors a block carries: K and V data, and on an int8
        pool their scales."""
        return tuple(t for t in (self._k_pool, self._v_pool, self._k_scale, self._v_scale)
                     if t is not None)

    def _note_swap(self, way: str, start, end=None) -> None:
        """Add one swap's copy time to `_swap_secs`: wall seconds on the
        CPU (`start` alone); on the card a pair of device events, folded in
        as soon as they have passed, so that only copies in flight wait."""
        with self._events_lock:
            if end is None:
                self._swap_secs[way] += start
            else:
                self._swap_events.append((way, start, end))
                self._fold_swaps(wait=False)

    def _fold_swaps(self, wait: bool) -> None:
        """Move the intervals of finished copies, oldest first, into
        `_swap_secs`; with `wait`, all of them. Under `_events_lock`."""
        while self._swap_events:
            way, start, end = self._swap_events[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self._swap_secs[way] += start.elapsed_time(end) / 1e3
            self._swap_events.pop(0)

    def swap_rates(self) -> dict:
        """Bytes and seconds of the tier's copies so far, each way (`out`:
        the offloads' device-to-host copies; `in`: the promotions'
        uploads): the store's byte counts, and the device time between
        events around the copies on the card (waited for here), the wall
        on the CPU."""
        with self._events_lock:
            self._fold_swaps(wait=True)
            secs = dict(self._swap_secs)
        with self._host_lock:
            store = self._host_store  # falsy when empty (its __len__)
            on = store is not None
            nbytes = {"out": store.swap_out_bytes_total if on else 0,
                      "in": store.swap_in_bytes_total if on else 0}
        return {w: dict(bytes=nbytes[w], seconds=secs[w]) for w in ("out", "in")}

    def _offload_slot_kv(self, rid: str, slot: int, covered: int, tokens: list[int]) -> bool:
        """Swap a victim slot's KV to the host tier before its blocks are
        freed (jax_decode.py:1957-2028). The covering blocks (and an int8
        pool's scales) are gathered into fresh device buffers on the
        decode stream, so the gather is queued before any later kernel
        that reuses the freed blocks; on the card the copies into pinned
        host memory then run on a side stream after an event, and the
        buffers are kept (and `record_stream`ed) until the copy's event
        has passed. False when the tier is off, the entry does not fit its
        budget, or the offload failed (counted): the caller drops the
        blocks, as with no tier, and the resume prefills."""
        if self._host_store is None or covered <= 0:
            return False
        nb = self._alloc.blocks_for(covered)
        if nb <= 0 or nb > int(self._alloc.nblocks[slot]):
            return False
        try:
            t0 = time.perf_counter()
            blocks = self._upload(self._alloc.row(slot, nb).astype(np.int64))
            bufs = [t.index_select(1, blocks) for t in self._pool_parts()]
            event = None
            if self.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record()
                host = [torch.empty(b.shape, dtype=b.dtype, pin_memory=True) for b in bufs]
                side = self._copy_stream
                side.wait_event(ready)
                with torch.cuda.stream(side):
                    start = torch.cuda.Event(enable_timing=True)
                    event = torch.cuda.Event(enable_timing=True)
                    start.record(side)
                    for h, b in zip(host, bufs):
                        h.copy_(b, non_blocking=True)
                    event.record(side)
                for b in bufs:
                    b.record_stream(side)
                timing = (start, event)
            else:
                host = bufs  # the gather is the synchronous copy
                timing = (time.perf_counter() - t0,)
            k, v, *scales = host
            image = bool(self._slot_image[slot])
            entry = HostKVEntry(
                rid=rid, k=k, v=v, ks=scales[0] if scales else None,
                vs=scales[1] if scales else None, nb=nb, covered=int(covered),
                tokens=list(tokens), base_key=np.array(self._slot_keys[slot]),
                weight_version=int(self._version), kv_dtype=self.config.kv_dtype,
                rope_delta=int(self._slot_rope_delta[slot]), image=image,
                # an image session's blocks are keyed by no content chain
                block_keys=(tuple(kv_fabric.chain_keys(
                    tokens, self._alloc.block_size, int(self._version),
                    str(self.config.kv_dtype)))
                    if self._fabric_on and not image else ()),
                pending=event is not None, event=event,
                dev=tuple(bufs) if event is not None else (),
            )
            with self._host_lock:
                kept = self._host_store.put(entry)
            if kept:  # the store counts the bytes of the entries it keeps
                self._note_swap("out", *timing)
            return kept
        except Exception as e:  # noqa: BLE001 — degrade to a prefill, never wedge
            # a failed offload (host memory, a copy error, an injected
            # fault) costs the resume a prefill, never the scheduler thread
            self._n_offload_failures += 1
            logger.warning(f"host-KV offload of {rid} failed: {e!r}")
            return False

    def _host_match(self, rid: str, covered: int, tokens: list[int]) -> bool:
        """Exact-resume peek into the host tier (a stale entry is dropped
        and counted a miss inside the store)."""
        if self._host_store is None:
            return False
        with self._host_lock:
            return self._host_store.match(rid, covered, tokens, weight_version=int(self._version))

    def _host_promote(self, item: _Slot, slot: int, covered: int) -> bool:
        """Promote the item's host entry into `slot` (jax_decode.py:
        2040-2091): fresh device blocks and an upload of the stored bytes
        on the decode stream, so the slot's first chunk, queued behind it,
        reads them; no prefill. Restores the slot's sampling key and
        registers the covered tokens as a prefix. Raises PoolDry, with the
        entry put back, when the pool cannot back the blocks even after
        reclaim; False only if the entry vanished."""
        t_promote = time.monotonic()
        with self._host_lock:
            entry = self._host_store.take(item.rid)
        if entry is None:
            return False
        self._unregister_prefix(slot)
        self._alloc.free_slot(slot)
        self._slot_lengths[slot] = 0
        if not self._ensure_tokens(slot, covered):
            with self._host_lock:
                self._host_store.restore(entry)
            raise PoolDry("no device blocks for host-tier promotion")
        blocks = self._upload(self._alloc.row(slot, entry.nb).astype(np.int64))
        hosts = (entry.k, entry.v) + (() if entry.ks is None else (entry.ks, entry.vs))
        cuda = self.device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        for pool, host in zip(self._pool_parts(), hosts):
            pool[:, blocks] = host.to(self.device, non_blocking=True)
        if cuda:
            end.record()
            self._note_swap("in", start, end)
        else:
            self._note_swap("in", time.perf_counter() - t0)
        self._slot_keys[slot] = entry.base_key
        self._slot_rope_delta[slot] = entry.rope_delta
        item.base_key = np.array(entry.base_key)
        # rows [0, covered) hold exactly these tokens: a donor as valid as
        # a prefill's (an image slot's never register)
        self._register_prefix(slot, list(entry.tokens))
        with self._host_lock:
            self._host_store.note_hit(entry)
        # the upload's host wall is this request's TTFT transfer share
        with self._metrics_lock:
            self._ttft_transfer_ms.append((time.monotonic() - t_promote) * 1000.0)
        return True

    # -- session migration (jax_decode.py:4284-4480, 4630-4815) ---------
    def list_exportable_sessions(self) -> list[str]:
        """rids whose whole resumable KV this engine holds: parked slots,
        then host-tier entries. A drain exports exactly these."""
        with self._sched_lock:
            rids = list(self._parked)
            with self._host_lock:
                if self._host_store is not None:
                    rids += [r for r in self._host_store.rids() if r not in self._parked]
        return rids

    def _session_meta(self, rid: str, covered: int, tokens: list[int], base_key,
                      weight_version: int, nb: int, kv_dtype: str, rope_delta: int,
                      image: bool) -> dict:
        """The wire metadata of a session: a host-tier entry's resume
        contract (`core/weight_transfer.py`'s `_KV_META_REQUIRED`), and
        whether it is an image session."""
        return dict(rid=rid, covered=int(covered), tokens=[int(t) for t in tokens],
                    rope_delta=int(rope_delta), base_key=[int(x) for x in np.asarray(base_key)],
                    weight_version=int(weight_version), nb=int(nb), kv_dtype=str(kv_dtype),
                    image=bool(image))

    def _refetchable_meta(self, refetchable: "set[int] | None", tokens: list[int],
                          weight_version: int, kv_dtype: str, image: bool) -> bool:
        """The cheap drain's test: every complete block of the session is
        keyed and resident somewhere among the survivors (`refetchable`,
        the union of their digests), so identity alone can travel. Never
        for an image session, whose KV no chain keys."""
        if image or not refetchable or not self._fabric_on:
            return False
        keys = kv_fabric.chain_keys(tokens, self._alloc.block_size, weight_version, kv_dtype)
        return bool(keys) and all(k in refetchable for k in keys)

    def _export_meta_only(self, meta: dict) -> dict:
        meta["meta_only"] = True
        with self._metrics_lock:
            self._migrate["out_sessions"] += 1
            self._fabric_wire["meta_only_exports"] += 1
        return dict(meta=meta)

    def export_session(self, rid: str, refetchable: "set[int] | None" = None) -> dict | None:
        """Move one session's resumable KV out of this engine: {"meta", "k",
        "v"} with host tensors `[L, nb, page, nKV, hd]` (and "ks"/"vs", the
        f32 scales `[L, nb, nKV, page]`, of an int8 pool, bytes as they
        are), or None when `rid` holds no exportable session or the export
        failed (logged; the session then re-prefills wherever it resumes).
        With `refetchable` (the content keys the surviving fleet serves), a
        session whose complete blocks all lie among them leaves as
        {"meta": {..., "meta_only": True}}, with no KV bytes: the importer
        keeps its sampling key and rebuilds the blocks through the fabric or
        a suffix prefill (jax_decode.py:4298-4480).

        A parked session's covering blocks are gathered under the scheduler
        lock, on the decode stream, so the gather is queued before any later
        pass can reuse them, and copied to the host before this returns; the
        parked entry is dropped and its blocks stay registered as donor
        material for same-prompt siblings. A host-tier session is taken
        from the store. The metadata carries the weight version and the
        pool dtype, which the importer checks."""
        try:
            with self._sched_lock, torch.no_grad():
                parked = self._parked.get(rid)
                if parked is not None:
                    slot, covered, _ = parked
                    tokens = list(self._parked_tokens.get(rid) or [])
                    nb = self._alloc.blocks_for(covered)
                    if (covered <= 0 or len(tokens) != covered or nb <= 0
                            or nb > int(self._alloc.nblocks[slot])):
                        return None
                    rd, image = int(self._slot_rope_delta[slot]), bool(self._slot_image[slot])
                    if self._refetchable_meta(refetchable, tokens, int(self._version),
                                              str(self.config.kv_dtype), image):
                        meta = self._session_meta(rid, covered, tokens, self._slot_keys[slot],
                                                  self._version, nb, self.config.kv_dtype, rd,
                                                  image)
                        self._parked.pop(rid, None)
                        self._parked_tokens.pop(rid, None)
                        self._register_prefix(slot, tokens)
                        return self._export_meta_only(meta)
                    blocks = self._upload(self._alloc.row(slot, nb).astype(np.int64))
                    parts = [t.index_select(1, blocks).cpu() for t in self._pool_parts()]
                    meta = self._session_meta(rid, covered, tokens, self._slot_keys[slot],
                                              self._version, nb, self.config.kv_dtype, rd, image)
                    self._parked.pop(rid, None)
                    self._parked_tokens.pop(rid, None)
                    if image:
                        # no donor material: the blocks go (the JAX engine
                        # registers them, ROADMAP queue 3)
                        self._release_slot_blocks(slot)
                    else:
                        self._register_prefix(slot, tokens)
                else:
                    with self._host_lock:
                        store = self._host_store
                        entry = store.take(rid) if store is not None else None
                    if entry is None:
                        return None
                    meta = self._session_meta(rid, entry.covered, entry.tokens, entry.base_key,
                                              entry.weight_version, entry.nb, entry.kv_dtype,
                                              entry.rope_delta, entry.image)
                    if entry.meta_only or self._refetchable_meta(
                            refetchable, [int(t) for t in entry.tokens],
                            int(entry.weight_version), str(entry.kv_dtype), entry.image):
                        return self._export_meta_only(meta)
                    parts = [entry.k, entry.v] + ([] if entry.ks is None else [entry.ks, entry.vs])
            out = dict(meta=meta, k=parts[0], v=parts[1])
            if len(parts) == 4:
                out["ks"], out["vs"] = parts[2], parts[3]
            with self._metrics_lock:
                self._migrate["out_sessions"] += 1
                self._migrate["out_bytes"] += sum(t.numel() * t.element_size() for t in parts)
            return out
        except Exception as e:  # noqa: BLE001 — degrade to a re-prefill, never wedge
            logger.warning(f"kv export of {rid} failed: {e!r}")
            return None

    def export_fabric_blocks(self, keys: "list[int] | None" = None, top: int = 0) -> list[dict]:
        """Serve the fabric (jax_decode.py:4482-4629): COPY keyed block runs
        out, dropping nothing here. `keys`, a content chain (block 0
        first): the longest run this replica holds, on the device first and
        in the host tier second, as one session whose meta carries
        `fabric=True` and a rid made from its last key ("fabric-<hex>").
        `top`: the `top` longest resident chains (a cold sibling's warm
        start). Returns sessions shaped like `export_session`'s; empty when
        nothing matches or the export failed (logged)."""
        if not self._fabric_on or self._alloc is None:
            return []
        bs = self._alloc.block_size

        def session(chain: list[int], n: int, tokens: list[int], wv: int, kv_dtype: str,
                    parts: list) -> dict:
            meta = dict(rid=f"fabric-{chain[n - 1] & 0xFFFFFFFFFFFFFFFF:016x}",
                        covered=n * bs, tokens=[int(t) for t in tokens[:n * bs]],
                        rope_delta=0,
                        # a run is never resumed by rid: the sampling key
                        # travels with sessions, not with runs
                        base_key=[0, 0], weight_version=int(wv), nb=n,
                        kv_dtype=str(kv_dtype), fabric=True)
            sess = dict(meta=meta, k=parts[0], v=parts[1])
            if len(parts) == 4:
                sess["ks"], sess["vs"] = parts[2], parts[3]
            return sess

        def resolve_locked(chain: list[int]) -> dict | None:
            for n in range(len(chain), 0, -1):  # the device rung
                hit = self._fabric_dev.get(chain[n - 1])
                if hit is None:
                    continue
                slot, depth = hit
                fks = self._slot_fabric_keys.get(slot)
                toks = self._slot_prefix[slot]
                if (fks is None or toks is None or depth != n or len(fks) < n
                        or fks[n - 1] != chain[n - 1] or len(toks) < n * bs):
                    continue
                blocks = self._upload(self._alloc.row(slot, n).astype(np.int64))
                parts = [t.index_select(1, blocks).cpu() for t in self._pool_parts()]
                return session(chain, n, list(toks), self._version, self.config.kv_dtype, parts)
            with self._host_lock:  # the host rung
                m = self._host_store.match_blocks(chain) if self._host_store is not None else None
                if m is None:
                    return None
                e, n = m
                parts = [t[:, :n].clone() for t in (e.k, e.v, e.ks, e.vs) if t is not None]
                return session(chain, n, e.tokens, e.weight_version, e.kv_dtype, parts)

        out: list[dict] = []
        try:
            with self._sched_lock, torch.no_grad():
                chains: list[list[int]] = [[int(x) for x in keys]] if keys else []
                if top > 0:
                    # the longest resident chains: the device's, then the
                    # host entries' complete blocks
                    cand = [list(fks) for fks in self._slot_fabric_keys.values()]
                    with self._host_lock:
                        if self._host_store is not None:
                            for r in self._host_store.rids():
                                e = self._host_store.peek(r)
                                if e is not None and e.block_keys:
                                    cand.append(list(e.block_keys))
                    cand.sort(key=len, reverse=True)
                    chains.extend(cand[:int(top)])
                seen: set[str] = set()
                for chain in chains:
                    if not chain:
                        continue
                    sess = resolve_locked(chain)
                    if sess is None or sess["meta"]["rid"] in seen:
                        continue
                    seen.add(sess["meta"]["rid"])
                    out.append(sess)
        except Exception as e:  # noqa: BLE001 — the requester prefills, never wedge
            logger.warning(f"fabric block export failed: {e!r}")
        return out

    def _ensure_host_store_locked(self, block_size: int) -> None:
        """Under `_host_lock`: an imported session (or its miss tombstone)
        needs a host tier to land in; without `kv_host_pool_mb` one is made,
        bounded by `kv_import_pool_mb`, and evicts least recently used like
        any tier."""
        if self._host_store is None:
            budget = max(float(self.config.kv_import_pool_mb), 1.0) * 1024 * 1024
            self._host_store = HostKVStore(int(budget), max(self._block_nbytes, 1), block_size)

    def _refuse_import(self, rid: str, block_size: int, why: str, counter: str) -> str:
        """Tombstone `rid` so its resume counts an honest miss and
        prefills, and count the refusal."""
        with self._host_lock:
            self._ensure_host_store_locked(block_size)
            self._host_store.tombstone(rid)
        with self._metrics_lock:
            self._migrate[counter] += 1
        logger.warning(f"kv import of {rid} refused: {why}")
        return "stale_version" if counter == "version_rejects" else "kv_dtype_mismatch"

    def import_session(self, meta: dict, k, v, ks=None, vs=None) -> str:
        """Land a migrated session in the host tier, where the next
        /generate of its rid promotes it through the `kv.swap_in` seam with
        no prefill. Returns "ok"; "kv_dtype_mismatch" (the session's pool
        scheme is not this engine's) or "stale_version" (its KV was
        computed under another weight version), both with the rid
        tombstoned, so its resume counts a miss and prefills; or "rejected"
        (malformed, or over the tier's budget). `k`, `v`, `ks`, `vs` are
        host tensors or arrays; an int8 session's land as they are. An
        identity-only session (`meta_only`, a cheap drain) lands as an
        identity with no version or dtype test: its resume takes the
        sampling key and rebuilds the blocks through the fabric or a
        prefill. A fabric run (`fabric` in meta, from `/kv_fetch` or
        `/warm_start`) lands as any session, its bytes counted as the
        fabric's, and its blocks are indexed for every request."""
        if self._alloc is None or self._k_pool is None:
            return "rejected"
        try:
            rid = str(meta["rid"])
            covered, nb = int(meta["covered"]), int(meta["nb"])
            tokens = [int(t) for t in meta["tokens"]]
            wv = int(meta.get("weight_version", -1))
            sess_dtype = str(meta.get("kv_dtype", "fp"))
            base_key = np.asarray(meta["base_key"], dtype=np.uint32)
            rope_delta = int(meta.get("rope_delta", 0))
            image = bool(meta.get("image", False))
            meta_only = bool(meta.get("meta_only"))
            if not meta_only:
                k, v = _host_tensor(k), _host_tensor(v)
            ks = None if ks is None else _host_tensor(ks)
            vs = None if vs is None else _host_tensor(vs)
        except (KeyError, TypeError, ValueError):
            return "rejected"
        L, _, bs, nkv, hd = self._k_pool.shape
        if meta_only:
            # identity only: the same for any weights
            if covered <= 0 or len(tokens) != covered or base_key.shape != (2,):
                return "rejected"
            entry = HostKVEntry(rid=rid, k=None, v=None, nb=nb, covered=covered, tokens=tokens,
                                base_key=base_key, weight_version=wv, kv_dtype=sess_dtype,
                                rope_delta=rope_delta, image=image)
            with self._host_lock:
                self._ensure_host_store_locked(bs)
                if not self._host_store.put(entry):
                    return "rejected"
            with self._metrics_lock:
                self._migrate["in_sessions"] += 1
            return "ok"
        if (tuple(k.shape) != (L, nb, bs, nkv, hd) or tuple(v.shape) != tuple(k.shape)
                or base_key.shape != (2,) or covered <= 0 or len(tokens) != covered
                or self._alloc.blocks_for(covered) != nb):
            return "rejected"
        if sess_dtype != self.config.kv_dtype:
            # requantizing in flight would change the stream
            return self._refuse_import(rid, bs, f"session kv_dtype {sess_dtype!r} != "
                                                f"{self.config.kv_dtype!r}", "dtype_rejects")
        if k.dtype != self._k_pool.dtype or v.dtype != k.dtype:
            return "rejected"
        if self._kv_quant and (ks is None or vs is None
                               or tuple(ks.shape) != (L, nb, nkv, bs)
                               or tuple(vs.shape) != tuple(ks.shape)
                               or ks.dtype != torch.float32 or vs.dtype != torch.float32):
            return "rejected"
        if wv >= 0 and wv != self._version:
            # the migration raced a weight commit
            return self._refuse_import(rid, bs, f"weight version {wv} != {self._version}",
                                       "version_rejects")
        # the blocks are indexed for every request (and join this replica's
        # digest), salted with the session's version: a legacy -1 never
        # matches a current chain; an image session's never
        entry = HostKVEntry(rid=rid, k=k, v=v, ks=ks, vs=vs, nb=nb, covered=covered,
                            tokens=tokens, base_key=base_key, weight_version=wv,
                            kv_dtype=sess_dtype, rope_delta=rope_delta, image=image,
                            block_keys=(tuple(kv_fabric.chain_keys(tokens, bs, wv, sess_dtype))
                                        if self._fabric_on and not image else ()))
        with self._host_lock:
            self._ensure_host_store_locked(bs)
            if not self._host_store.put(entry):
                return "rejected"
        nbytes = sum(t.numel() * t.element_size() for t in (k, v, ks, vs) if t is not None)
        with self._metrics_lock:
            if meta.get("fabric"):
                # a fetched run, not a moved session: the migration counters
                # keep meaning whole sessions
                self._fabric_wire["sessions_in"] += 1
                self._fabric_wire["fetch_bytes"] += nbytes
            else:
                self._migrate["in_sessions"] += 1
                self._migrate["in_bytes"] += nbytes
        return "ok"

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
        # prefill-only admissions, retired after the wave's prefills wrote
        # their KV and before any chunk can run for them
        prefill_done: list[int] = []
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
            if P > 1:
                # an identity-only session gives up its sampling key here,
                # then goes down the ladder as a fresh request would
                self._claim_meta_identity(item)
            # the host tier first: an exact offloaded match needs neither
            # prefill nor fork, and its bytes are the original KV's
            host_hit = P > 1 and self._host_match(item.rid, P - 1, prompt[:-1])
            # an image request's KV depends on pixels the token key cannot
            # see: it never forks, joins a wave or suffix-prefills
            image = bool(item.image_data)
            donor = None
            if P > 1 and not image and not host_hit:
                donor = self._prefix_lookup.get(covered_t)
                if donor is None:
                    donor = self._find_covering_donor(covered_t)
            partial = None
            partial_fabric = False
            is_wave_dup = P > 1 and not image and covered_t in wave_primaries
            # the content chain of the covered prefix, for the fabric's
            # device rung here and its host rung once a slot is chosen
            req_chain: list[int] = []
            if (self._fabric_on and donor is None and P > 1 and not image and not is_wave_dup
                    and not host_hit):
                req_chain = kv_fabric.chain_keys(prompt[:-1], self._alloc.block_size,
                                                 int(self._version), str(self.config.kv_dtype))
            if donor is None and P > 1 and not image and not is_wave_dup and not host_hit:
                found = self._find_shared_prefix(covered_t)
                if found is None and req_chain:
                    # the device rung: the longest block run shared with any
                    # registration, even one that diverges past it
                    found = self._fabric_dev_match(req_chain, P - 1)
                    partial_fabric = found is not None
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
            if (did_prefill and donor is None and not is_wave_dup and not host_hit
                    and needs_bucket > budget):
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
                # a new occupant: an image prefill sets its delta, a
                # promotion restores it (jax_decode.py:2722)
                self._slot_rope_delta[slot] = 0
                self._slot_image[slot] = image
                if self._freq_counts is not None and self._slot_used_freq[slot]:
                    # a new occupant starts from zero penalty counts
                    self._freq_counts[slot].zero_()
                    self._slot_used_freq[slot] = False
                if P <= 1:
                    # the decode loop writes from row 0: no donor survives
                    self._release_slot_blocks(slot)
            else:
                slot = resumed
            promoted = False
            if resumed is None and host_hit:
                try:
                    promoted = self._host_promote(item, slot, P - 1)
                except PoolDry:
                    # the entry went back to the store: retry next pass
                    self._overflow.insert(0, item)
                    break
                except Exception as e:  # noqa: BLE001 — degrade to a prefill
                    # the promotion died (an unreadable entry, an upload
                    # error, an injected fault): a miss, and the request
                    # prefills below with the same stream (jax_decode.py:
                    # 2750-2759)
                    self._n_promote_failures += 1
                    logger.warning(f"host-KV promotion of {item.rid} failed: {e!r}")
            if (resumed is None and not promoted and donor is None and partial is None
                    and not is_wave_dup and req_chain):
                # the fabric's host rung: a keyed run offloaded by any rid,
                # or fetched from a sibling, seeds this slot, and the suffix
                # goes through the partial path below with the slot as its
                # own donor
                try:
                    fplen = self._promote_fabric_blocks(item, slot, req_chain, P - 1)
                except PoolDry:
                    self._overflow.insert(0, item)
                    break
                if fplen > 0:
                    sb = min(_pow2_bucket(P - 1 - fplen), S)
                    if fplen + sb <= S:
                        partial = (slot, fplen, sb)
                        partial_fabric = False  # counted by the rung
            if resumed is None and P > 1 and not promoted and donor is not None:
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
            elif resumed is None and P > 1 and not promoted and partial is not None:
                donor_slot, plen, sb = partial
                budget -= sb
                did_prefill = True
                self._n_suffix_prefills += 1
                if partial_fabric:
                    # the device rung: another local rid's blocks served
                    self._fabric_hits["local"] += 1
                    self._fabric_hits["local_tokens"] += plen
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
            elif resumed is None and P > 1 and not promoted:
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
                    if image:
                        # one image request at a time, inside the budget
                        # (jax_decode.py:2884-2912); never a donor
                        self._image_prefill(slot, item, prompt, ids, pre, bucket)
                    else:
                        wave_primaries[covered_t] = slot
                        wave_pending.append((slot, ids, pre, bucket, covered_t))
            self._slots[slot] = item
            self._slot_lengths[slot] = P - 1
            self._slot_epoch[slot] += 1
            if item.prefill_only:
                prefill_done.append(slot)
            # one base key per request, in first-admission order; a parked
            # resume keeps its slot's key, a promotion restored the entry's,
            # a requeue carries its own
            if resumed is not None or promoted:
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
        # prefill-only requests retire now, parked as an interrupted one
        # (covered = prompt[:-1]); one a wave fork's fallback requeued
        # comes back on a later pass and retires then
        for slot in prefill_done:
            item = self._slots[slot]
            if item is None or not item.prefill_only:
                continue
            item.stop_reason = "prefill"
            self._retire(slot)
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
                       bucket: int, embeds=None, rope=None) -> None:
        """One prefill forward of len(slots) prompts padded to `bucket`
        (rows [B, bucket] in `ids`) into each slot's first blocks. Rows
        past a prompt's length hold the pad tokens' KV; decode overwrites
        each of them before the validity mask lets it be read. An image
        prefill passes its spliced `embeds` [B, bucket, H] and its m-rope
        tables `rope` ([B, bucket, hd/2] cos and sin)."""
        cfg = self.model_config
        B = len(slots)
        L, nKV, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim_
        bsz = self._alloc.block_size
        nb_w = -(-bucket // bsz)
        pad = nb_w * bsz - bucket
        rows = np.concatenate([self._alloc.row(s, nb_w) for s in slots]).astype(np.int64)
        # the real tokens of each row: a MoE layer routes each row on its
        # own, its pad tail claiming no capacity (jax_decode.py:1834-1838)
        valid = np.arange(bucket)[None, :] < np.asarray(lens)[:, None]
        with self._prefill_call(int(sum(lens)), slots=B):
            rows = self._upload(rows)
            _, k, v = prefill(self.params, self._upload(ids), torch.arange(bucket, device=self.device),
                              cfg, with_logits=False, layers=self._layers, input_embeds=embeds,
                              rope_cos=None if rope is None else rope[0],
                              rope_sin=None if rope is None else rope[1],
                              valid=self._upload(valid),
                              )  # [B, L, bucket, nKV, hd]
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

        def prefix(pool, scales):  # [L, pb, nKV, hd]: an fp pool's dtype (prefill casts)
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
                valid=self._upload(np.arange(sb) < len(suffix)),
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
        re-admits with its consumed tokens) and free its blocks
        (jax_decode.py:2497-2527). With the host KV tier the consumed
        coverage, prompt[:-1] + tokens, is offloaded first: rows that
        chunks still in flight write past it are never claimed, and the
        re-admission promotes the rest instead of prefilling."""
        item = self._slots[slot]
        if item is not None:
            covered = len(item.prompt) - 1 + len(item.tokens)
            if covered > 0:
                self._offload_slot_kv(item.rid, slot, covered,
                                      (item.prompt + item.tokens)[:covered])
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
            rope_delta=self._upload(self._slot_rope_delta),
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
        # the gather paths' copies of the active KV (jax_decode.py:3499-3510,
        # 3585-3601): the workspace gathers and scatters every slot's nb
        # blocks, the paged gather path gathers them once (an int8 pool,
        # in place, once per step), the kernels copy nothing
        if self.config.kv_layout == "workspace":
            copies = 2
        elif not self._xla:
            copies = 0
        else:
            copies = n_chunk if self._kv_quant and not W else 1
        self._ws_copy_bytes += copies * R * nb * self._block_nbytes
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
        gather = self.config.kv_layout == "workspace" or (self._xla and not self._kv_quant)
        if gather:
            # the gather paths (jax_decode.py:1447-1549): each slot's nb
            # blocks into a contiguous workspace in the pool's dtype
            kc, vc = self._gather_workspace(table)
            lengths0 = lengths
        for step in range(n_chunk):
            if gather:
                logits = decode_step(self.params, tokens, lengths, kc, vc, self.model_config,
                                     active=active_t, layers=self._layers,
                                     rope_offset=ctl["rope_delta"])
            else:
                # an int8 pool on the gather path attends in place through
                # the plain version, as JAX's xla impl does
                logits = decode_step_paged(
                    self.params, tokens, lengths, k_pool, v_pool, table, self.model_config,
                    active=active_t, layers=self._layers, rope_offset=ctl["rope_delta"],
                    **(dict(attn_fn=_pa.paged_attention_ref) if self._xla else {}),
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
        if gather and self.config.kv_layout == "workspace":
            self._scatter_workspace(table, kc, vc)
        elif gather:
            self._write_back_rows(table, kc, vc, lengths0, active_t, n_chunk)
        self._dev_last, self._dev_lengths = tokens, lengths
        return toks, logps

    def _gather_workspace(self, table) -> tuple[torch.Tensor, torch.Tensor]:
        """The [L, R, nb * bsz, nKV, hd] workspace of each slot's table
        blocks, in the pool's dtype (a copy: the pass writes into it)."""
        L, _, bsz, nKV, hd = self._k_pool.shape
        R, nb = table.shape
        idx = table.reshape(-1).long()
        return tuple(p.index_select(1, idx).reshape(L, R, nb * bsz, nKV, hd)
                     for p in (self._k_pool, self._v_pool))

    def _scatter_workspace(self, table, kc, vc) -> None:
        """Write every slot's workspace blocks back into the pool (the
        workspace layout). Aliased blocks and the null block receive the
        same bytes from each holder: no slot writes below its length, and
        an inactive slot's rows pass through unchanged."""
        L, _, bsz, nKV, hd = self._k_pool.shape
        R, nb = table.shape
        idx = table.reshape(-1).long()
        self._k_pool[:, idx] = kc.reshape(L, R * nb, bsz, nKV, hd)
        self._v_pool[:, idx] = vc.reshape(L, R * nb, bsz, nKV, hd)

    def _write_back_rows(self, table, kc, vc, lengths0, active_t, n_chunk: int) -> None:
        """The paged gather path's write-back (jax_decode.py:1479-1507):
        only the n_chunk rows per slot from its length before the chunk,
        at their pool coordinates; an inactive slot's rows go to the null
        block 0."""
        L, _, bsz, nKV, hd = self._k_pool.shape
        R, nb = table.shape
        pos = (lengths0[:, None] + torch.arange(n_chunk, device=self.device)).clamp(0, nb * bsz - 1)
        slots = torch.arange(R, device=self.device)[:, None]
        block = table.long().gather(1, (pos // bsz).clamp(0, nb - 1))
        block = torch.where(active_t[:, None], block, 0).reshape(-1)
        off = torch.where(active_t[:, None], pos % bsz, 0).reshape(-1)
        for pool, ws in ((self._k_pool, kc), (self._v_pool, vc)):
            pool[:, block, off] = ws[:, slots, pos].reshape(L, R * n_chunk, nKV, hd)

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
        if self.config.kv_layout == "workspace":
            # gather, verify over the workspace, scatter the blocks back
            kc, vc = self._gather_workspace(table)
            logits = verify_step(self.params, tokens, lengths, kc, vc, self.model_config,
                                 active=active_t, layers=self._layers,
                                 rope_offset=ctl["rope_delta"])
            self._scatter_workspace(table, kc, vc)
        else:
            # the paged gather path attends through the plain version, which
            # gathers inside each layer (jax_decode.py:1604-1609)
            logits = verify_step_paged(
                self.params, tokens, lengths, k_pool, v_pool, table, self.model_config,
                active=active_t, layers=self._layers, rope_offset=ctl["rope_delta"],
                **(dict(attn_fn=_pa.paged_attention_qlen_ref) if self._xla else {}),
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
        """Free the slot (jax_decode.py:3161-3194). An interrupted or
        prefill-only request parks its KV for a resume under its rid; a
        finished one registers
        its whole conversation as donor material and keeps its blocks."""
        item = self._slots[slot]
        self._slots[slot] = None
        self._mark_slot_dirty(slot)
        covered = int(self._slot_lengths[slot])
        # "prefill" is the prefill role's park: no token generated, the
        # covered rows are the prompt's KV, ready to export
        if item is not None and item.stop_reason in ("interrupt", "prefill"):
            self._parked[item.rid] = (slot, covered, time.monotonic())
            self._parked_tokens[item.rid] = (item.prompt + item.tokens)[:covered]
        else:
            if item is not None and covered > 0 and not item.image_data:
                self._register_prefix(slot, (item.prompt + item.tokens)[:covered])
            else:
                # an image slot is never donor material: its blocks go
                self._unregister_prefix(slot)
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
        self._check_vision(req)
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        item = _Slot(
            rid=req.rid,
            prompt=list(req.input_ids),
            gconfig=req.gconfig,
            future=future,
            loop=loop,
            image_data=req.image_data,
        )
        self._request_q.put(item)
        # the death handler sets _thread_exc before draining the queue, so
        # a put that raced past the drain is caught here
        if self._thread_exc is not None:
            raise RuntimeError("decode engine crashed") from self._thread_exc
        return await future

    async def aprefill(self, req: ModelRequest) -> ModelResponse:
        """Run only the prompt's prefill, park its KV and return (stop
        reason "prefill", no output token): the prefill role's entry point
        (jax_decode.py:3753-3790). The parked session is what an
        interrupted request leaves (covered = prompt[:-1], the sampling key
        given in admission order), so a /generate with the same rid and
        prompt resumes it with no prefill, here or on a decode replica it
        was exported to. Prefix sharing applies as for any admission."""
        if self._thread_exc is not None:
            raise RuntimeError("decode engine crashed") from self._thread_exc
        if self._thread is None:
            raise RuntimeError("engine not initialized: call initialize()")
        if not req.input_ids:
            raise ValueError("empty prompt")
        self._check_vision(req)
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        self._request_q.put(_Slot(rid=req.rid, prompt=list(req.input_ids), gconfig=req.gconfig,
                                  future=future, loop=loop, prefill_only=True,
                                  image_data=req.image_data))
        if self._thread_exc is not None:
            raise RuntimeError("decode engine crashed") from self._thread_exc
        return await future

    def _check_vision(self, req: ModelRequest) -> None:
        """An image request with no tower installed fails loudly, never as
        image-blind text (jax_decode.py:3721, 3768)."""
        if req.image_data and self._vision_params is None:
            raise NotImplementedError(
                "TorchDecodeEngine has no vision tower installed; call "
                "set_vision_model() (models/qwen2_vl.py) to serve image inputs"
            )

    def generate(self, req: ModelRequest, timeout: float | None = None) -> ModelResponse:
        """Blocking wrapper over `agenerate` (its own event loop thread)."""
        return self._blocking(self.agenerate, req, timeout)

    def prefill(self, req: ModelRequest, timeout: float | None = None) -> ModelResponse:
        """Blocking wrapper over `aprefill`."""
        return self._blocking(self.aprefill, req, timeout)

    def _blocking(self, afn, req: ModelRequest, timeout: float | None) -> ModelResponse:
        done = threading.Event()
        result: list = [None, None]

        async def _run():
            try:
                result[0] = await afn(req)
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
                    "(ROADMAP.md queue 1, item 6.7)"
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
            self._ttft_prefill_ms.clear()
            self._ttft_transfer_ms.clear()
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
            mig = dict(self._migrate)
            wire = dict(self._fabric_wire)
            ttft_prefill = np.asarray(self._ttft_prefill_ms, dtype=np.float64)
            ttft_transfer = np.asarray(self._ttft_transfer_ms, dtype=np.float64)
        hits = dict(self._fabric_hits)
        # the fabric's digest: the keys this replica can serve, from the
        # device index (read without the scheduler lock, as JAX does: a
        # resize mid-copy retries) and the host tier
        fabric_keys: list[int] = []
        if self._fabric_on:
            for _ in range(3):
                try:
                    fabric_keys = list(self._fabric_dev)
                    break
                except RuntimeError:
                    continue

        def pct(x, q):
            return float(np.percentile(x, q)) if x.size else 0.0

        prefix_hits = self._n_prefix_forks + self._n_prefix_inplace + self._n_suffix_prefills
        prefix_total = prefix_hits + self._n_prefills
        alloc = self._alloc
        with self._host_lock:
            hs = self._host_store
            # `if hs` would be False for an empty store (its __len__)
            on = hs is not None
            if self._fabric_on and on:
                fabric_keys.extend(hs.fabric_keys())
            host = dict(
                enabled=on, budget=hs.budget_bytes if on else 0,
                used=hs.bytes_used if on else 0, entries=len(hs) if on else 0,
                tokens=hs.resident_tokens() if on else 0,
                occupancy=round(hs.occupancy(), 6) if on else 0.0,
                swap_out=hs.swap_out_bytes_total if on else 0,
                swap_in=hs.swap_in_bytes_total if on else 0, hits=hs.hits if on else 0,
                misses=hs.misses if on else 0, evictions=hs.evictions if on else 0,
                rejected=hs.rejected_puts if on else 0,
                avoided=hs.reprefill_tokens_avoided if on else 0,
                version_rejects=hs.version_rejects if on else 0,
            )
        host_lookups = host["hits"] + host["misses"]
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
            # TTFT's shares: the prefill dispatch wall per admitted slot,
            # and the promotions' upload wall (jax_decode.py:5276-5300)
            "ttft_prefill_p50_ms": pct(ttft_prefill, 50),
            "ttft_prefill_p99_ms": pct(ttft_prefill, 99),
            "ttft_transfer_p50_ms": pct(ttft_transfer, 50),
            "ttft_transfer_p99_ms": pct(ttft_transfer, 99),
            "role": self.config.role,
            # session migration (a drain): sessions and bytes each way, and
            # imports refused as honest misses (jax_decode.py:5303-5310)
            "kv_migrated_in_sessions_total": mig["in_sessions"],
            "kv_migrated_out_sessions_total": mig["out_sessions"],
            "kv_migrated_in_bytes_total": mig["in_bytes"],
            "kv_migrated_out_bytes_total": mig["out_bytes"],
            "kv_migrate_version_rejects_total": mig["version_rejects"],
            "kv_migrate_dtype_rejects_total": mig["dtype_rejects"],
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
            # free blocks that cannot back another max-context admission
            # (the router's admission subtracts them from the headroom)
            "kv_pool_fragmentation": alloc.fragmentation_blocks() if alloc else 0,
            "kv_block_nbytes": self._block_nbytes,
            # the host KV tier (jax_decode.py:5363-5392): all zeros when off
            "kv_host_pool_enabled": host["enabled"],
            "kv_host_pool_bytes": host["budget"],
            "kv_host_pool_bytes_used": host["used"],
            "kv_host_pool_entries": host["entries"],
            "kv_host_pool_tokens": host["tokens"],
            "kv_host_pool_occupancy": host["occupancy"],
            "kv_swap_out_bytes_total": host["swap_out"],
            "kv_swap_in_bytes_total": host["swap_in"],
            "kv_host_hits_total": host["hits"],
            "kv_host_misses_total": host["misses"],
            "kv_host_evictions_total": host["evictions"],
            "kv_host_rejected_puts_total": host["rejected"],
            "kv_host_version_rejects_total": host["version_rejects"],
            "kv_offload_failures_total": self._n_offload_failures,
            "kv_promote_failures_total": self._n_promote_failures,
            "kv_host_hit_rate": round(host["hits"] / host_lookups, 6) if host_lookups else 0.0,
            # the KV fabric (jax_decode.py:5391-5412), apart from the
            # exact-resume counters above
            "kv_fabric_enabled": self._fabric_on,
            "kv_fabric_local_hits_total": hits["local"],
            "kv_fabric_remote_hits_total": hits["remote"],
            "kv_fabric_local_tokens_avoided_total": hits["local_tokens"],
            "kv_fabric_remote_tokens_avoided_total": hits["remote_tokens"],
            "kv_fabric_fetch_bytes_total": wire["fetch_bytes"],
            "kv_fabric_sessions_in_total": wire["sessions_in"],
            "kv_fabric_meta_only_exports_total": wire["meta_only_exports"],
            "kv_fabric_blocks_resident": len(dict.fromkeys(fabric_keys)),
            "kv_fabric_digest": (
                kv_fabric.encode_digest(dict.fromkeys(fabric_keys),
                                        cap=int(self.config.kv_fabric_digest_max))
                if self._fabric_on else ""),
            # prefills skipped by any reuse: exact host resumes and fabric runs
            "reprefill_tokens_avoided_total": (host["avoided"] + hits["local_tokens"]
                                               + hits["remote_tokens"]),
            # the gather paths' KV copies: workspace gather + scatter, the
            # paged gather path the gather, the kernels none
            "kv_workspace_copy_bytes_total": self._ws_copy_bytes,
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
