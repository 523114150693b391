"""HTTP decode server (counterpart of `areal_tpu/launcher/decode_server.py`):
a `TorchDecodeEngine` behind the JSON-over-HTTP control plane that
`RemoteInfEngine` speaks, in either package.

Routes (JAX :1187-1202), with the JAX bodies and replies:

  GET  /health                  {"status": "ok", "version": N, "role"}: the
                                router's role-aware pick reads the role
  GET  /info                    model and config metadata
  GET  /metrics                 engine load and latency counters, the
                                weight sync's counters (`weight_sync`), the
                                idempotency table's size and hits, and the
                                port's `kernel_launches` and
                                `device_memory_peak`, and the fabric's
                                server side (`kv_fabric`)
  POST /generate                one completion with token logprobs and
                                versions; an "xid" makes it idempotent: a
                                duplicate of a submission in flight waits
                                for the same result, a duplicate of a
                                finished one gets the cached reply. A
                                "kv_fabric" hint ({"peer", "keys"}) from the
                                router pulls the peer's block runs into
                                the host tier first (`_fabric_prefetch`)
  POST /prefill                 the prefill role: prefill only, park the KV
                                and, with "target", stream the session to
                                that decode replica; idempotent per xid
                                (JAX :909-975)
  POST /pause_generation        pause on a pass boundary; {"abort": true}
                                ends running requests with stop reason
                                "interrupt" (their KV stays parked)
  POST /continue_generation
  POST /update_weights_from_disk  {"path", "version"?}: the checkpoint
                                is read with generation live, then
                                installed and stamped in one pause (JAX
                                reads it inside the pause)
  POST /update_weights_from_tensor?push_id=ID  one weight frame, staged
                                with generation live
  POST /commit_weights          {"version", "push_id"}: the only pause of a
                                push; a stale push id answers 409, no
                                staged weights 400
  POST /abort_weights           {"push_id"}: drop a failed push's staging
  POST /set_version             {"version": N}

  POST /kv_recv?xid=ID           one frame of a migrated KV session, staged
                                per xid (duplicates merge; a torn frame is
                                refused before a byte stages)
  POST /kv_commit               {"xid"}: import the staged session(s) into
                                the host tier; a replay of a finished xid
                                answers the first result with "dedup"
  POST /kv_fetch                {"keys" or "top", "target"}: copy the
                                longest keyed block runs (or the `top`
                                longest resident chains) to `target` over
                                the migration wire (JAX :762-812)
  POST /warm_start              {"peers", "max_sessions"}: pull each peer's
                                longest runs here before taking traffic
                                (JAX :865-907)
  POST /drain                   {"targets": [addr, ...], "refetchable"?}:
                                park what runs and stream every parked or
                                host-tier session to the targets; a session
                                whose complete blocks the `refetchable`
                                digest covers goes as identity only
                                (JAX :1069-1162); a concurrent drain
                                replays the first one's result
  POST /set_role                {"role"}: flip the role the router reads
                                (the supervisor's re-role, after a drain)

Threading. The JAX server runs every handler on one event loop; here
`http.server.ThreadingHTTPServer` runs each connection on a thread of its
own. `_ctl_lock` is held around every pause, swap, stage and commit, so a
`/continue_generation` can never resume decoding in the middle of a
weight swap; the idempotency table has its own lock, and a duplicate of
a submission in flight waits on a `concurrent.futures.Future`.
`/generate` calls the engine's blocking `generate`; the engine's
scheduler is its own thread.

Fault seams (`core/fault_injection.py`, JAX :274, :472, :512, :690, :988):
`server.generate` before the idempotency table and the engine,
`server.prefill` likewise for `/prefill`,
`server.weights.stage` per received frame, `server.weights.commit`
before `_ctl_lock` is taken, `kv.migrate.send` before each frame a drain
sends and `kv.migrate.recv` (fire and tear) per frame received. A raised `InjectedFault` answers 500, which
the client retries; a delay sleeps only the handler's own thread.

Run one with `python -m areal_tpu_torch.launcher.decode_server
--model-path <HF checkpoint directory> [flags]`, or `--scratch-model
'<ModelConfig JSON>'` for random weights from `--seed`: the JAX server's
flags and defaults, and `--device` (the card, `cuda:0`, by default; `cpu`
runs the kernels' plain versions). A checkpoint is served in `--dtype`
with its tokenizer (`transformers.AutoTokenizer` on the same directory)
unless `--skip-tokenizer-init`; a tokenizer that fails to load is logged
and the server runs without stop-on-eos, as the JAX server does.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import signal
import socket
import socketserver
import threading
import time
import traceback
import urllib.parse
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from areal_tpu_torch.api.cli_args import (
    ROLES,
    GenerationHyperparameters,
    InferenceEngineConfig,
    TorchDecodeConfig,
)
from areal_tpu_torch.api.io_struct import ModelRequest, WeightUpdateMeta
from areal_tpu_torch.core import fault_injection, kv_fabric
from areal_tpu_torch.core.weight_transfer import WeightStaging, frame_raw_nbytes
from areal_tpu_torch.models.convert import to_layout
from areal_tpu_torch.models.qwen2 import ModelConfig
from areal_tpu_torch.utils import logging, name_resolve, names
from areal_tpu_torch.utils.network import gethostip

logger = logging.getLogger("decode_server")

_GCONFIG_FIELDS = {f.name for f in dataclasses.fields(GenerationHyperparameters)}



def _parse_gconfig(d: dict[str, Any]) -> GenerationHyperparameters:
    return GenerationHyperparameters(**{k: v for k, v in d.items() if k in _GCONFIG_FIELDS})


class _Reply(Exception):
    """A non-200 JSON answer: {"status": "error", "message"} unless `body`
    is given, with extra `headers` (the router's 429 and Retry-After)."""

    def __init__(self, status: int, message: str, body: dict | None = None,
                 headers: dict[str, str] | None = None):
        super().__init__(message)
        self.status = status
        self.body = body if body is not None else {"status": "error", "message": message}
        self.headers = headers or {}


class DecodeServer:
    def __init__(
        self,
        config: TorchDecodeConfig,
        inference_config: InferenceEngineConfig | None = None,
        tokenizer: Any = None,
        engine: Any = None,
        device: Any = None,
    ):
        from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine

        self.config = config
        self.engine = engine or TorchDecodeEngine(
            config, inference_config or InferenceEngineConfig(), tokenizer, device=device
        )
        self._owns_engine = engine is None
        self._httpd: ThreadingHTTPServer | None = None
        self._serve_thread: threading.Thread | None = None
        self.addr: str | None = None
        # set by /pause_generation, cleared by /continue_generation: a
        # weight swap must not end a pause the client asked for
        self._client_paused = False  # guarded-by: _ctl_lock
        self._ctl_lock = threading.Lock()
        self._weight_staging = WeightStaging()  # guarded-by: _ctl_lock
        self._staging_push_id: str | None = None  # guarded-by: _ctl_lock
        self._staging_t0: float | None = None  # guarded-by: _ctl_lock
        self._staging_last_frame_t: float | None = None  # guarded-by: _ctl_lock
        self._last_commit_version: int | None = None  # guarded-by: _ctl_lock
        self._last_commit_push_id: str | None = None  # guarded-by: _ctl_lock
        self._sync_stats = dict(  # guarded-by: _ctl_lock
            n_pushes=0,
            wire_bytes=0,
            wire_bytes_raw=0,
            staging_secs=0.0,
            commit_pause_secs=0.0,
            aborted_pushes=0,
            reaped_pushes=0,
        )
        # xid -> {"done": False, "fut": Future, "t"} while in flight,
        # {"done": True, "resp", "t"} after; LRU-bounded by
        # idempotency_entries, finished entries expire after
        # idempotency_ttl_s
        self._idem: OrderedDict[str, dict[str, Any]] = OrderedDict()  # guarded-by: _idem_lock
        self._idem_hits = 0  # guarded-by: _idem_lock
        self._idem_lock = threading.Lock()
        # session migration (JAX :172-198): inbound frames staged per xid
        # (a replay's duplicate frames merge), finished commits per xid (a
        # replayed commit answers from here and never imports twice), the
        # server's own counters, and the drain in progress, whose result a
        # concurrent /drain replays
        self._kv_staging: OrderedDict[str, dict[str, Any]] = OrderedDict()  # guarded-by: _kv_lock
        self._kv_done: OrderedDict[str, dict[str, Any]] = OrderedDict()  # guarded-by: _kv_lock
        self._migrate_stats = dict(  # guarded-by: _kv_lock
            out_sessions=0, out_bytes=0, out_failures=0, in_frames=0, in_commits=0,
            commit_dedups=0, transfer_secs=0.0,
        )
        self._kv_lock = threading.Lock()
        self._drain_inflight: concurrent.futures.Future | None = None  # guarded-by: _drain_lock
        self._drain_lock = threading.Lock()
        # the fabric's server side (JAX :200-214): outbound fetches in
        # flight by hint (requests with the same hint on other threads wait
        # on one fetch), and the counters /metrics reports as "kv_fabric"
        self._fabric_inflight: dict[str, concurrent.futures.Future] = {}  # guarded-by: _fabric_lock
        self._fabric_stats = dict(  # guarded-by: _fabric_lock
            fetch_attempts=0, fetch_sessions=0, fetch_bytes=0, fetch_failures=0,
            serve_sessions=0, serve_bytes=0, warm_start_sessions=0, warm_start_bytes=0,
        )
        self._fabric_lock = threading.Lock()

    # -- routes ---------------------------------------------------------
    def handle(self, method: str, path: str, query: dict, body: bytearray) -> dict:
        """Answer one request (or raise `_Reply` for a non-200 answer)."""
        routes = {
            ("GET", "/health"): self._health,
            ("GET", "/info"): self._info,
            ("GET", "/metrics"): self._metrics,
            ("POST", "/generate"): self._generate,
            ("POST", "/pause_generation"): self._pause,
            ("POST", "/continue_generation"): self._continue,
            ("POST", "/update_weights_from_disk"): self._update_weights_from_disk,
            ("POST", "/update_weights_from_tensor"): self._update_weights_from_tensor,
            ("POST", "/commit_weights"): self._commit_weights,
            ("POST", "/abort_weights"): self._abort_weights,
            ("POST", "/set_version"): self._set_version,
            ("POST", "/prefill"): self._prefill,
            ("POST", "/kv_recv"): self._kv_recv,
            ("POST", "/kv_commit"): self._kv_commit,
            ("POST", "/kv_fetch"): self._kv_fetch,
            ("POST", "/warm_start"): self._warm_start,
            ("POST", "/drain"): self._drain,
            ("POST", "/set_role"): self._set_role,
        }
        fn = routes.get((method, path))
        if fn is None:
            raise _Reply(404 if all(p != path for _, p in routes) else 405,
                         f"no route {method} {path}")
        return fn(query, body)

    @staticmethod
    def _json(body: bytearray, optional: bool = False) -> dict:
        if not body and optional:
            return {}
        try:
            out = json.loads(bytes(body))
        except ValueError as e:
            if optional:
                return {}
            raise _Reply(400, f"body is not JSON: {e}") from None
        if not isinstance(out, dict):
            raise _Reply(400, "body is not a JSON object")
        return out

    def _health(self, query, body) -> dict:
        return {"status": "ok", "version": self.engine.get_version(), "role": self.config.role}

    def _info(self, query, body) -> dict:
        c = self.config
        return {
            "model_path": c.model_path,
            "role": c.role,
            "kv_migrate_chunk_mb": c.kv_migrate_chunk_mb,
            "context_length": c.context_length,
            "max_running_requests": c.max_running_requests,
            "decode_runahead_chunks": c.decode_runahead_chunks,
            "kv_layout": c.kv_layout,
            "kv_dtype": c.kv_dtype,
            "weight_dtype": c.weight_dtype,
            "kv_host_pool_mb": c.kv_host_pool_mb,
            "paged_attn_impl": c.paged_attn_impl,
            "spec_decode": c.spec_decode,
            "spec_k": c.spec_k,
            "spec_ngram_max": c.spec_ngram_max,
            "version": self.engine.get_version(),
        }

    def _metrics(self, query, body) -> dict:
        out = dict(self.engine.get_metrics())
        # a snapshot without _ctl_lock (one dict copy under the GIL): the
        # lock is held across whole pauses and installs
        ws = dict(self._sync_stats, staged_tensors=len(self._weight_staging))
        ws["wire_bytes_sent"] = ws["wire_bytes"]
        ws["weight_sync_compression"] = (
            round(ws["wire_bytes_raw"] / ws["wire_bytes_sent"], 4) if ws["wire_bytes_sent"] else 1.0
        )
        out["weight_sync"] = ws
        with self._idem_lock:
            out["idem_entries"] = len(self._idem)
            out["idem_hits_total"] = self._idem_hits
        # the server's side of migration; the engine's kv_migrated_* keys
        # sit beside it at the top level
        with self._kv_lock:
            out["kv_migrate"] = dict(self._migrate_stats, staging_xids=len(self._kv_staging),
                                     done_xids=len(self._kv_done))
        # the fabric's server side; the engine's kv_fabric_* keys (hits,
        # tokens avoided, the digest) are at the top level
        with self._fabric_lock:
            out["kv_fabric"] = dict(self._fabric_stats, inflight=len(self._fabric_inflight))
        return out

    def _prune_idem_locked(self) -> None:
        now = time.monotonic()
        ttl = self.config.idempotency_ttl_s
        for xid in list(self._idem):
            ent = self._idem[xid]
            if ent["done"] and now - ent["t"] > ttl:
                del self._idem[xid]
        while len(self._idem) > max(1, self.config.idempotency_entries):
            victim = next((x for x, e in self._idem.items() if e["done"]), next(iter(self._idem)))
            del self._idem[victim]

    def _idempotent(self, xid: str | None, run) -> dict:
        """`run()` once per xid: a duplicate of a submission in flight waits
        for the same result, a duplicate of a finished one gets the cached
        reply (with "dedup"), and a failed run leaves no entry, so its
        retry runs again."""
        if xid is None:
            return run()
        with self._idem_lock:
            prior = self._idem.get(xid)
            if prior is not None:
                # a duplicate delivery: never run twice
                self._idem_hits += 1
                if prior["done"]:
                    self._idem.move_to_end(xid)
                    return {**prior["resp"], "dedup": "completed"}
            else:
                ent = {"done": False, "fut": concurrent.futures.Future(), "t": time.monotonic()}
                self._idem[xid] = ent
        if prior is not None:
            return {**prior["fut"].result(), "dedup": "in_progress"}
        try:
            out = run()
        except BaseException as e:
            with self._idem_lock:
                if self._idem.get(xid) is ent:
                    del self._idem[xid]
            ent["fut"].set_exception(e)
            raise
        with self._idem_lock:
            if self._idem.get(xid) is ent:
                self._idem[xid] = {"done": True, "resp": out, "t": time.monotonic()}
                self._idem.move_to_end(xid)
            self._prune_idem_locked()
        ent["fut"].set_result(out)
        return out

    @staticmethod
    def _request(req_body: dict) -> ModelRequest:
        return ModelRequest(
            rid=req_body.get("rid") or ModelRequest().rid,
            input_ids=[int(t) for t in req_body["input_ids"]],
            gconfig=_parse_gconfig(req_body.get("gconfig", {})),
            image_data=req_body.get("image_data"),
        )

    def _generate(self, query, body) -> dict:
        req_body = self._json(body)
        xid = req_body.get("xid")
        # pre-effect seam: an abort rejects the request before any engine
        # state moves; a delay sleeps this handler's thread only
        fault_injection.fire("server.generate", rid=str(req_body.get("rid") or ""),
                             xid=str(xid or ""), addr=str(self.addr or ""))

        def run() -> dict:
            req = self._request(req_body)
            hint = req_body.get("kv_fabric")
            if hint and self.config.kv_fabric:
                # the router says a sibling holds this prefix: pull its
                # runs into the host tier before admission looks
                self._fabric_prefetch(hint)
            resp = self.engine.generate(req)
            return {
                "output_tokens": resp.output_tokens,
                "output_logprobs": resp.output_logprobs,
                "output_versions": resp.output_versions,
                "stop_reason": resp.stop_reason,
                "latency": resp.latency,
                "ttft": resp.ttft,
                "itl": resp.itl,
            }

        return self._idempotent(xid, run)

    def _prefill(self, query, body) -> dict:
        """The prefill role's hot path (JAX :909-975): prefill only, park
        the KV and, with a "target", stream the session to that decode
        replica, whose /generate of the same rid then resumes it with no
        prefill. Idempotent per xid, as /generate."""
        req_body = self._json(body)
        xid = req_body.get("xid")
        fault_injection.fire("server.prefill", rid=str(req_body.get("rid") or ""),
                             xid=str(xid or ""), addr=str(self.addr or ""))

        def run() -> dict:
            req = self._request(req_body)
            resp = self.engine.prefill(req)
            out: dict[str, Any] = {"status": "ok", "stop_reason": resp.stop_reason,
                                   "latency": resp.latency, "migrated": False, "kv_bytes": 0}
            target = req_body.get("target")
            if target and target != self.addr:
                moved = self._migrate_session_out(target, req.rid, xid or f"pf-{req.rid}")
                if moved is not None:
                    out.update(migrated=True, kv_bytes=moved["bytes"],
                               transfer_secs=moved["secs"])
            return out

        return self._idempotent(xid, run)

    def _pause(self, query, body) -> dict:
        req_body = self._json(body, optional=True)
        with self._ctl_lock:
            self._client_paused = True
            self.engine.pause_generation()
            aborted = self.engine.abort_all() if req_body.get("abort") else 0
        return {"status": "ok", "aborted": aborted}

    def _continue(self, query, body) -> dict:
        with self._ctl_lock:
            self._client_paused = False
            self.engine.continue_generation()
        return {"status": "ok"}

    def _update_weights_from_disk(self, query, body) -> dict:
        req_body = self._json(body)
        meta = WeightUpdateMeta(type="disk", path=req_body["path"])
        version = req_body.get("version")
        # the checkpoint is read with generation live (the JAX server
        # reads it inside the pause); only the install pauses
        host = self.engine.read_disk_weights(meta)
        with self._ctl_lock:
            # one pause over the swap and the version stamp: no token of
            # the new weights carries the old version; a client's pause
            # is kept
            self.engine.update_weights_from_tensor(host, version=version)
        return {"status": "ok", "version": self.engine.get_version()}

    def _set_version(self, query, body) -> dict:
        self.engine.set_version(int(self._json(body)["version"]))
        return {"status": "ok"}

    # -- the staged "dcn" weight push ------------------------------------
    def _clear_staging_locked(self) -> None:
        self._weight_staging.reset()
        self._staging_push_id = None
        self._staging_t0 = None
        self._staging_last_frame_t = None

    def _reap_stale_staging_locked(self) -> None:
        """A push whose frames stopped for `weight_staging_ttl_s` is dead
        (its trainer crashed mid-stage): drop its staging and its push-id
        epoch so the next push starts clean."""
        ttl = self.config.weight_staging_ttl_s
        if ttl <= 0 or self._staging_last_frame_t is None:
            return
        if time.monotonic() - self._staging_last_frame_t <= ttl:
            return
        if self._weight_staging.n_partial or len(self._weight_staging):
            logger.warning(f"reaping stale weight staging (push {self._staging_push_id}, "
                           f"silent > {ttl:.0f}s)")
            self._sync_stats["reaped_pushes"] += 1
        self._clear_staging_locked()

    def _update_weights_from_tensor(self, query, body) -> dict:
        push_id = (query.get("push_id") or [None])[0]
        fault_injection.fire("server.weights.stage", push_id=str(push_id or ""),
                             addr=str(self.addr or ""))
        with self._ctl_lock:
            self._reap_stale_staging_locked()
            # push ids are ordered by time: a newer one supersedes what an
            # abandoned push left, an older one is a straggler frame
            if push_id is not None:
                cur = self._staging_push_id
                if cur is not None and push_id < cur:
                    raise _Reply(409, "stale push_id")
                if push_id != cur:
                    self._weight_staging.reset()
                    self._staging_push_id = push_id
                    self._staging_t0 = time.monotonic()
            elif self._staging_t0 is None:
                self._staging_t0 = time.monotonic()
            try:
                self._weight_staging.add_bucket(body)
            except ValueError as e:  # a torn frame: the client resends it
                raise _Reply(500, str(e)) from None
            self._staging_last_frame_t = time.monotonic()
            self._sync_stats["wire_bytes"] += len(body)
            self._sync_stats["wire_bytes_raw"] += frame_raw_nbytes(body)
            staged = len(self._weight_staging)
        return {"status": "ok", "staged": staged}

    def _commit_weights(self, query, body) -> dict:
        req_body = self._json(body)
        version = req_body.get("version")
        push_id = req_body.get("push_id")
        if req_body.get("lora_scale") is not None:
            raise _Reply(501, "LoRA delta push is not in the PyTorch port yet: ROADMAP.md "
                              "queue 1, item 6.7")
        # before the lock (JAX :512-516): a delay never stalls a pause or an
        # install, an abort leaves the staged weights and the old version
        fault_injection.fire("server.weights.commit", push_id=str(push_id or ""),
                             addr=str(self.addr or ""))
        with self._ctl_lock:
            self._reap_stale_staging_locked()
            if push_id is not None and push_id != self._staging_push_id:
                if (push_id == self._last_commit_push_id and version is not None
                        and self._last_commit_version == int(version)):
                    # a retry of the commit that already landed
                    return {"status": "ok", "version": self.engine.get_version()}
                raise _Reply(409, "stale push_id")
            if not len(self._weight_staging):
                if version is not None and self._last_commit_version == int(version):
                    return {"status": "ok", "version": self.engine.get_version()}
                raise _Reply(400, "no staged weights")
            t_commit = time.monotonic()
            try:
                staged = self._weight_staging.finalize()
                named = to_layout(staged, self.engine.model_config)
                self.engine.update_weights_from_tensor(named, version=version)
            except Exception as e:  # noqa: BLE001 — answered, the server goes on
                # a wedged staging area would poison every later push; a
                # malformed push (names, shapes) is 400, as in JAX
                self._clear_staging_locked()
                raise _Reply(400 if isinstance(e, (ValueError, KeyError)) else 500,
                             str(e)) from e
            self._sync_stats["commit_pause_secs"] += time.monotonic() - t_commit
            if self._staging_t0 is not None:
                # the transfer window: first frame to the commit's start
                self._sync_stats["staging_secs"] += t_commit - self._staging_t0
            self._sync_stats["n_pushes"] += 1
            self._last_commit_version = int(version) if version is not None else None
            self._last_commit_push_id = push_id
            self._clear_staging_locked()
        return {"status": "ok", "version": self.engine.get_version()}

    def _abort_weights(self, query, body) -> dict:
        push_id = self._json(body, optional=True).get("push_id")
        with self._ctl_lock:
            if push_id is not None and self._staging_push_id not in (None, push_id):
                # a newer push owns the staging area
                return {"status": "ok", "dropped": 0}
            dropped = self._weight_staging.n_partial + len(self._weight_staging)
            self._clear_staging_locked()
            if dropped:
                self._sync_stats["aborted_pushes"] += 1
        return {"status": "ok", "dropped": dropped}

    # -- session migration (JAX :617-760, :976-1162) ---------------------
    # The transfer has the weight push's shape: frames -> staging -> one
    # commit. A sender's recovery is to replay the whole session under the
    # same xid: duplicate frames merge, the commit deduplicates, and the
    # session lands once.
    _MIGRATE_TIMEOUT_S = 60.0
    _KV_STAGING_MAX = 64
    _KV_DONE_MAX = 1024

    def _prune_kv_maps_locked(self) -> None:
        now = time.monotonic()
        ttl = self.config.idempotency_ttl_s
        for xid in list(self._kv_done):
            if now - self._kv_done[xid]["t"] > ttl:
                del self._kv_done[xid]
        while len(self._kv_done) > self._KV_DONE_MAX:
            self._kv_done.popitem(last=False)
        # staging whose frames stopped is a sender that died: its replay
        # (same xid) starts again from empty staging
        for xid in list(self._kv_staging):
            if now - self._kv_staging[xid]["last_t"] > ttl:
                del self._kv_staging[xid]
        while len(self._kv_staging) > self._KV_STAGING_MAX:
            victim, _ = self._kv_staging.popitem(last=False)
            logger.warning(f"kv staging {victim} dropped (map full)")

    def _stream_kv(self, target: str, sess: dict[str, Any], rid: str, xid: str,
                   retries: int = 2) -> dict[str, Any] | None:
        """Send one exported session to `target` under delivery id `xid`
        (frames to /kv_recv, then /kv_commit), replaying the whole stream
        up to `retries` times; None when every attempt failed (the session
        then re-prefills where it resumes)."""
        from areal_tpu_torch.core.weight_transfer import pack_kv_session
        from areal_tpu_torch.utils.http import request_with_retry

        frames = list(pack_kv_session(sess["meta"], sess.get("k"), sess.get("v"),
                                      ks=sess.get("ks"), vs=sess.get("vs"),
                                      chunk_mb=self.config.kv_migrate_chunk_mb))
        nbytes = sum(len(f) for f in frames)
        t0 = time.monotonic()
        last: Exception | None = None
        for attempt in range(retries + 1):
            try:
                for frame in frames:
                    # an abort is the sender dying mid-stream: the replay
                    # (same xid) must land the session once
                    fault_injection.fire("kv.migrate.send", rid=rid, xid=xid, target=target,
                                         attempt=attempt)
                    request_with_retry(target, f"/kv_recv?xid={xid}", data=frame,
                                       max_retries=2, timeout=self._MIGRATE_TIMEOUT_S)
                out = request_with_retry(target, "/kv_commit", payload={"xid": xid, "rid": rid},
                                         max_retries=2, timeout=self._MIGRATE_TIMEOUT_S)
                dt = time.monotonic() - t0
                with self._kv_lock:
                    self._migrate_stats["out_sessions"] += 1
                    self._migrate_stats["out_bytes"] += nbytes
                    self._migrate_stats["transfer_secs"] += dt
                return {"bytes": nbytes, "secs": dt, "commit": out}
            except Exception as e:  # noqa: BLE001 — replay, then degrade
                last = e
                if attempt < retries:
                    logger.warning(f"kv migration of {rid} to {target} failed ({e!r}); "
                                   f"replaying under xid {xid}")
        with self._kv_lock:
            self._migrate_stats["out_failures"] += 1
        logger.warning(f"kv migration of {rid} to {target} abandoned ({last!r}); the "
                       "session resumes with a re-prefill")
        return None

    def _migrate_session_out(self, target: str, rid: str, xid: str, retries: int = 2,
                             refetchable: "set[int] | None" = None) -> dict[str, Any] | None:
        """Export `rid` (it leaves this engine) and stream it to `target`.
        The replay budget is two whole streams under the same xid: a sender
        death and a torn frame are independent failures, and two of them
        on one session must not downgrade it to a re-prefill. With
        `refetchable` (the keys the survivors serve), a session they cover
        goes as identity only (`meta_only` in the result)."""
        # the plain call when no digest came (an engine without the fabric
        # takes the rid alone), as JAX keeps it (:1145-1148)
        sess = (self.engine.export_session(rid) if refetchable is None
                else self.engine.export_session(rid, refetchable))
        if sess is None:
            return None
        out = self._stream_kv(target, sess, rid, xid, retries=retries)
        if out is not None:
            out["meta_only"] = bool(sess["meta"].get("meta_only"))
        return out

    def _kv_recv(self, query, body) -> dict:
        """Stage one inbound KV frame under its migration xid."""
        xid = (query.get("xid") or [""])[0]
        if not xid:
            raise _Reply(400, "xid required")
        # an abort is the receiver dying with the frame in hand; a torn
        # frame fails the manifest check before a byte stages (500), and
        # the sender's frame retry sends it again
        fault_injection.fire("kv.migrate.recv", xid=xid, addr=str(self.addr or ""))
        payload = fault_injection.tear("kv.migrate.recv", body, xid=xid)
        from areal_tpu_torch.core.weight_transfer import WeightStaging

        with self._kv_lock:
            if xid in self._kv_done:
                # a straggler of a committed migration: the commit's
                # replay answers from the dedup table
                return {"status": "ok", "staged": 0}
            ent = self._kv_staging.get(xid)
            if ent is None:
                ent = self._kv_staging[xid] = {"staging": WeightStaging(),
                                               "t0": time.monotonic()}
            ent["last_t"] = time.monotonic()
            try:
                ent["staging"].add_bucket(payload)
            except ValueError as e:  # a torn frame
                raise _Reply(500, str(e)) from None
            self._migrate_stats["in_frames"] += 1
            staged = len(ent["staging"])
            self._prune_kv_maps_locked()
        return {"status": "ok", "staged": staged}

    def _kv_commit(self, query, body) -> dict:
        """Finalize and import a staged migration; idempotent per xid."""
        from areal_tpu_torch.core.weight_transfer import unpack_kv_sessions

        xid = str(self._json(body).get("xid") or "")
        with self._kv_lock:
            done = self._kv_done.get(xid)
            if done is not None:
                # the sender lost the answer and replayed: never import twice
                self._kv_done.move_to_end(xid)
                self._migrate_stats["commit_dedups"] += 1
                return {**done["resp"], "dedup": True}
            ent = self._kv_staging.get(xid)
            if ent is None:
                raise _Reply(400, f"no staged kv for {xid!r}")
            try:
                sessions = unpack_kv_sessions(ent["staging"].finalize())
                if not sessions:
                    raise ValueError("no complete kv session staged")
            except (RuntimeError, ValueError) as e:
                # incomplete or malformed: the staging stays for the
                # sender's replay to top up and commit again
                raise _Reply(400, str(e)) from None
            del self._kv_staging[xid]
            t0 = time.monotonic()
            counts = dict(ok=0, stale_version=0, kv_dtype_mismatch=0, rejected=0)
            rids = []
            for meta, k, v, scales in sessions:
                ks, vs = scales if scales is not None else (None, None)
                verdict = self.engine.import_session(meta, k, v, ks, vs)
                counts[verdict] = counts.get(verdict, 0) + 1
                if verdict == "ok":
                    rids.append(meta["rid"])
            resp = {"status": "ok", "imported": counts["ok"],
                    "stale_version": counts["stale_version"],
                    "kv_dtype_mismatch": counts["kv_dtype_mismatch"],
                    "rejected": counts["rejected"], "rids": rids}
            self._kv_done[xid] = {"resp": resp, "t": time.monotonic()}
            self._migrate_stats["in_commits"] += 1
            self._migrate_stats["transfer_secs"] += time.monotonic() - t0
            self._prune_kv_maps_locked()
        return resp

    # -- the KV fabric (JAX :762-907) -------------------------------------
    def _kv_fetch(self, query, body) -> dict:
        """Serve keyed block runs to a sibling: resolve the chain in "keys"
        (a list or a digest), or the `top` longest resident chains for a
        warm start, and push the runs to "target" over the migration wire.
        Nothing here is dropped; a failed push costs the requester a
        prefill."""
        import uuid

        req = self._json(body)
        target = str(req.get("target") or "")
        if not target or target == self.addr:
            raise _Reply(400, "target required")
        keys = req.get("keys")
        if isinstance(keys, str):
            keys = kv_fabric.decode_digest(keys)
        keys = [int(x) for x in (keys or [])]
        top = int(req.get("top") or 0)
        if not keys and top <= 0:
            raise _Reply(400, "keys or top required")
        sessions = self.engine.export_fabric_blocks(keys=keys or None, top=top)
        served = nbytes = 0
        xid_base = str(req.get("xid") or f"fab-{uuid.uuid4().hex[:12]}")
        for i, sess in enumerate(sessions):
            moved = self._stream_kv(target, sess, sess["meta"]["rid"], f"{xid_base}-{i}")
            if moved is not None:
                served += 1
                nbytes += moved["bytes"]
        with self._fabric_lock:
            self._fabric_stats["serve_sessions"] += served
            self._fabric_stats["serve_bytes"] += nbytes
        return {"status": "ok", "resolved": len(sessions), "sessions": served, "bytes": nbytes}

    def _fabric_prefetch(self, hint: dict[str, Any]) -> None:
        """Act on a router hint ({"peer", "keys"}) before the engine sees
        the request: pull the matching runs from the peer, so admission
        finds them in the host tier. Requests with the same hint on other
        threads wait on the one fetch (no lock is held while waiting). Any
        failure degrades to a local prefill, with the same stream."""
        from areal_tpu_torch.utils.http import request_with_retry

        peer = str(hint.get("peer") or "")
        keys = hint.get("keys")
        if not peer or not keys or peer == self.addr:
            return
        dedup = keys if isinstance(keys, str) else ",".join(map(str, keys))
        with self._fabric_lock:
            fut = self._fabric_inflight.get(dedup)
            owner = fut is None
            if owner:
                fut = self._fabric_inflight[dedup] = concurrent.futures.Future()
                self._fabric_stats["fetch_attempts"] += 1
        if not owner:
            fut.result()  # the owner always sets a result
            return
        out = None
        try:
            out = request_with_retry(peer, "/kv_fetch", payload={"keys": keys, "target": self.addr},
                                     max_retries=1,
                                     timeout=float(self.config.kv_fabric_fetch_timeout_s))
            with self._fabric_lock:
                self._fabric_stats["fetch_sessions"] += int(out.get("sessions") or 0)
                self._fabric_stats["fetch_bytes"] += int(out.get("bytes") or 0)
        except Exception as e:  # noqa: BLE001 — degrade to a local prefill, never wedge
            with self._fabric_lock:
                self._fabric_stats["fetch_failures"] += 1
            logger.warning(f"fabric prefetch from {peer} failed ({e!r}); prefilling locally")
        finally:
            with self._fabric_lock:
                self._fabric_inflight.pop(dedup, None)
            fut.set_result(out)

    def _warm_start(self, query, body) -> dict:
        """Before this replica takes traffic, ask each peer to push its
        longest resident runs here; a peer that cannot serve adds nothing."""
        from areal_tpu_torch.utils.http import request_with_retry

        req = self._json(body)
        peers = [p for p in req.get("peers") or [] if p and p != self.addr]
        k = int(req.get("max_sessions") or 4)
        if not peers or k <= 0:
            raise _Reply(400, "peers required")
        sessions = nbytes = failures = 0
        for peer in peers:
            try:
                out = request_with_retry(peer, "/kv_fetch", payload={"top": k, "target": self.addr},
                                         max_retries=1,
                                         timeout=float(self.config.kv_fabric_fetch_timeout_s))
                sessions += int(out.get("sessions") or 0)
                nbytes += int(out.get("bytes") or 0)
            except Exception as e:  # noqa: BLE001 — best effort
                failures += 1
                logger.warning(f"warm start from {peer} failed: {e!r}")
        with self._fabric_lock:
            self._fabric_stats["warm_start_sessions"] += sessions
            self._fabric_stats["warm_start_bytes"] += nbytes
        return {"status": "ok", "peers": len(peers), "sessions": sessions, "bytes": nbytes,
                "failures": failures}

    def _set_role(self, query, body) -> dict:
        """Flip this replica's role (the supervisor's re-role, after a
        drain). Every replica serves every route; the role only steers the
        router, which reads it at its next poll."""
        role = str(self._json(body).get("role", "")).lower()
        if role not in ROLES:
            raise _Reply(400, f"bad role {role!r}")
        old = self.config.role
        self.config.role = role
        logger.info(f"role flipped {old} -> {role}")
        return {"status": "ok", "old_role": old, "role": role}

    def _drain(self, query, body) -> dict:
        """Stream every resumable session to `targets` (a scale-down or a
        replace): running requests end "interrupt" with their KV parked,
        and each parked or host-tier session is exported and committed on
        a target, where its resume is a promotion with no prefill.

        Drains are serialized: a /drain that arrives while one runs waits
        for it and replays its result, so no session is exported twice."""
        req = self._json(body)
        targets = [t for t in req.get("targets") or [] if t and t != self.addr]
        if not targets:
            raise _Reply(400, "targets required")
        with self._drain_lock:
            fut = self._drain_inflight
            owner = fut is None or fut.done()
            if owner:
                fut = self._drain_inflight = concurrent.futures.Future()
        if not owner:
            resp, status = fut.result()
            if status != 200:
                raise _Reply(status, resp["message"])
            return dict(resp, dedup="in_progress")
        try:
            resp, status = self._drain_once(req, targets), 200
        except Exception as e:  # noqa: BLE001 — the waiters need a result
            logger.error(f"/drain failed:\n{traceback.format_exc()}")
            resp, status = {"status": "error", "message": repr(e)}, 500
        fut.set_result((resp, status))
        if status != 200:
            raise _Reply(status, resp["message"])
        return resp

    def _drain_once(self, req: dict[str, Any], targets: list[str]) -> dict[str, Any]:
        import uuid

        # the cheap drain: sessions whose blocks the survivors can fetch
        # by content key travel as identity only (the supervisor sends the
        # union of the survivors' digests)
        refetchable: set[int] | None = None
        rf = req.get("refetchable")
        if rf is not None and self.config.kv_fabric:
            if isinstance(rf, str):
                rf = kv_fabric.decode_digest(rf)
            refetchable = {int(x) for x in rf}
        # the whole drain holds _ctl_lock with generation paused, so a
        # client's resume that reaches this server meanwhile waits in the
        # queue and cannot take back a session before it is exported (the
        # JAX server resumes generation before it exports, and such a
        # resume wins the session there; ROADMAP.md queue 3)
        with self._ctl_lock:
            self.engine.pause_generation()
            try:
                aborted = self.engine.abort_all() if req.get("abort_active", True) else 0
                rids = self.engine.list_exportable_sessions()
                drained = failed = total = meta_only = 0
                for i, rid in enumerate(rids):
                    moved = self._migrate_session_out(targets[i % len(targets)], rid,
                                                      f"drain-{uuid.uuid4().hex[:12]}",
                                                      refetchable=refetchable)
                    if moved is None:
                        failed += 1
                    else:
                        drained += 1
                        total += moved["bytes"]
                        meta_only += moved["meta_only"]
            finally:
                if not self._client_paused:
                    self.engine.continue_generation()
        return {"status": "ok", "aborted": aborted, "sessions": len(rids),
                "drained": drained, "failed": failed, "meta_only": meta_only, "bytes": total}

    # -- lifecycle ------------------------------------------------------
    def start(self, host: str = "0.0.0.0", port: int = 0) -> str:
        """Initialize an engine this server built, then listen; returns
        the address ("ip:port") clients reach it at."""
        if self._owns_engine:
            self.engine.initialize()
        self._httpd, self._serve_thread, self.addr = serve_app(self, host, port,
                                                               "decode-server-http")
        logger.info(f"decode server listening on {self.addr}")
        return self.addr

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.close_connections()
            self._httpd.server_close()
            self._httpd = None
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10)
            self._serve_thread = None
        if self._owns_engine:
            self.engine.destroy()

    def register(self, experiment_name: str, trial_name: str, server_id: str) -> None:
        if self.addr is None:
            raise RuntimeError("start the server before registering it")
        name_resolve.add(names.gen_server(experiment_name, trial_name, server_id), self.addr,
                         keepalive_ttl=None, replace=True)


def serve_app(app: Any, host: str, port: int, name: str
              ) -> tuple[ThreadingHTTPServer, threading.Thread, str]:
    """Listen for `app` (an object with `handle(method, path, query,
    body)`) on a daemon thread: (the server, its thread, "ip:port")."""

    class Handler(_Handler):
        server_app = app

    httpd = _Server((host, port), Handler)
    ip = gethostip() if host in ("0.0.0.0", "::", "") else host
    thread = threading.Thread(target=httpd.serve_forever, kwargs=dict(poll_interval=0.2),
                              daemon=True, name=name)
    thread.start()
    return httpd, thread, f"{ip}:{httpd.server_address[1]}"


class _Server(ThreadingHTTPServer):
    """Keeps its open connections, so that a stopped server closes its
    kept-alive ones too instead of serving them on."""

    daemon_threads = True

    def __init__(self, *args, **kwargs):
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address) -> None:
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request) -> None:
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def close_connections(self) -> None:
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def server_bind(self) -> None:
        # HTTPServer.server_bind looks the bound address up in the
        # resolver (socket.getfqdn); the name is not needed
        socketserver.TCPServer.server_bind(self)
        self.server_name, self.server_port = self.server_address[:2]

    def handle_error(self, request, client_address) -> None:
        logger.error(f"request from {client_address} failed:\n{traceback.format_exc()}")


class _Handler(BaseHTTPRequestHandler):
    """JSON over HTTP/1.1 for an app with `handle(method, path, query,
    body)`: the decode server, the router and the supervisor."""

    protocol_version = "HTTP/1.1"
    # the reply's headers and body go out in two writes
    disable_nagle_algorithm = True
    server_app: Any

    def log_message(self, format: str, *args) -> None:
        logger.debug(format % args)

    def do_GET(self) -> None:
        self._dispatch("GET")

    def do_POST(self) -> None:
        self._dispatch("POST")

    def _read_body(self) -> bytearray:
        n = int(self.headers.get("Content-Length") or 0)
        buf = bytearray(n)
        view, got = memoryview(buf), 0
        while got < n:
            k = self.rfile.readinto(view[got:])
            if not k:
                break  # the client went away: a torn body
            got += k
        return buf if got == n else buf[:got]

    def _dispatch(self, method: str) -> None:
        url = urllib.parse.urlsplit(self.path)
        headers: dict[str, str] = {}
        if self.headers.get("Transfer-Encoding", "").lower() == "chunked":
            status, out = 411, {"status": "error", "message": "send a Content-Length"}
            self.close_connection = True
        else:
            body = self._read_body()
            try:
                out, status = self.server_app.handle(
                    method, url.path, urllib.parse.parse_qs(url.query), body), 200
            except _Reply as e:
                status, out, headers = e.status, e.body, e.headers
            except Exception as e:  # noqa: BLE001 — the server keeps serving
                logger.error(f"{method} {url.path} failed:\n{traceback.format_exc()}")
                status, out = 500, {"status": "error", "message": f"{type(e).__name__}: {e}"}
        data = json.dumps(out).encode()
        try:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)
        except ConnectionError as e:
            # the client left before the reply (a trainer that finished
            # while its last rollouts were still generating)
            logger.warning(f"{method} {url.path}: reply not delivered ({e!r})")
            self.close_connection = True


def _scratch_model(args: argparse.Namespace, device):
    """The `--scratch-model` geometry in `--dtype`, random weights from
    `--seed` on `device`."""
    import torch

    from areal_tpu_torch.models.qwen2 import init_params

    mc = ModelConfig(**{**json.loads(args.scratch_model), "dtype": args.dtype,
                        "param_dtype": args.dtype})
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return init_params(mc, gen, device), mc


def _serve(args: argparse.Namespace) -> None:
    from areal_tpu_torch.platforms import resolve_device

    config = TorchDecodeConfig(
        # a scratch model replaces the checkpoint (offline runs)
        model_path="" if args.scratch_model else args.model_path,
        dtype=args.dtype,
        kv_cache_dtype=args.dtype,
        role=args.role,
        kv_migrate_chunk_mb=args.kv_migrate_chunk_mb,
        kv_import_pool_mb=args.kv_import_pool_mb,
        context_length=args.context_length,
        max_running_requests=args.max_running_requests,
        new_tokens_per_chunk=args.new_tokens_per_chunk,
        decode_runahead_chunks=args.decode_runahead_chunks,
        kv_layout=args.kv_layout,
        kv_dtype=args.kv_dtype,
        weight_dtype=args.weight_dtype,
        kv_host_pool_mb=args.kv_host_pool_mb,
        paged_attn_impl=args.paged_attn_impl,
        spec_decode=args.spec_decode,
        spec_k=args.spec_k,
        spec_ngram_max=args.spec_ngram_max,
        random_seed=args.seed,
        tensor_parallel_size=args.tensor_parallel_size,
    )
    # flags of unported features are refused before anything is built
    config.check_supported()
    if args.prewarm_prompt_len > 0:
        # the JAX engine compiles its jit variants there; the port has
        # nothing to compile ahead (its kernels build on first use)
        logger.info("--prewarm-prompt-len: nothing to warm in the PyTorch port")
    device = resolve_device(args.device or None)
    tokenizer = None
    if not args.scratch_model:
        # the checkpoint's config.json first: a path with no local
        # directory (a hub id) fails here, before a tokenizer load could
        # reach for the hub
        ModelConfig.from_hf_config(args.model_path)
        if not args.skip_tokenizer_init:
            try:
                from transformers import AutoTokenizer

                tokenizer = AutoTokenizer.from_pretrained(args.model_path)
                logger.info(f"tokenizer {type(tokenizer).__name__} loaded, eos "
                            f"{getattr(tokenizer, 'eos_token_id', None)}")
            except Exception as e:  # noqa: BLE001 — as the JAX server (:1296-1297)
                logger.warning(f"tokenizer load failed ({e}); stop-on-eos disabled")
    server = DecodeServer(config, tokenizer=tokenizer, device=device)
    if args.scratch_model:
        params, mc = _scratch_model(args, device)
        server.engine.set_model(params, mc)
        del params
    # a checkpoint is read by the engine's initialize, in --dtype
    server.start(args.host, args.port)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    if args.experiment_name and args.trial_name:
        server.register(args.experiment_name, args.trial_name, args.server_id or server.addr)
        from areal_tpu_torch.utils.experiment import watch_until_terminal

        watch_until_terminal(args.experiment_name, args.trial_name, lambda status: stop.set())
    try:
        while not stop.wait(0.5):
            pass
    finally:
        logger.info("decode server stopping")
        server.stop()


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="areal_tpu_torch decode server")
    p.add_argument("--model-path", default="")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--role", default="unified", choices=list(ROLES),
                   help="disaggregated fleet role: the router picks prefill replicas for "
                        "/prefill and decode replicas for /generate")
    p.add_argument("--kv-migrate-chunk-mb", type=float, default=64.0)
    p.add_argument("--kv-import-pool-mb", type=float, default=256.0)
    p.add_argument("--context-length", type=int, default=32768)
    p.add_argument("--max-running-requests", type=int, default=64)
    p.add_argument("--new-tokens-per-chunk", type=int, default=128)
    p.add_argument("--decode-runahead-chunks", type=int, default=1,
                   help="passes kept in flight while the host consumes the one before "
                        "(0: dispatch, then consume)")
    p.add_argument("--kv-layout", default="paged", choices=["paged", "workspace"])
    p.add_argument("--kv-dtype", default="fp", choices=["fp", "int8"],
                   help="'int8' keeps the paged pool as int8 with f32 row scales")
    p.add_argument("--weight-dtype", default="fp", choices=["fp", "int8"],
                   help="'int8' serves the dense matmul kernels as int8 with per-channel "
                        "scales; the trainer's WeightUpdateMeta.weight_dtype must match")
    p.add_argument("--kv-host-pool-mb", type=float, default=0.0)
    p.add_argument("--paged-attn-impl", default="auto", choices=["auto", "pallas", "xla"])
    p.add_argument("--spec-decode", default="off", choices=["off", "ngram"])
    p.add_argument("--spec-k", type=int, default=4)
    p.add_argument("--spec-ngram-max", type=int, default=3)
    p.add_argument("--tp-size", dest="tensor_parallel_size", type=int, default=1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=int(os.environ.get("PORT", 0)))
    p.add_argument("--experiment-name", default=os.environ.get("AREAL_EXPERIMENT_NAME", ""))
    p.add_argument("--trial-name", default=os.environ.get("AREAL_TRIAL_NAME", ""))
    p.add_argument("--server-id", default="")
    p.add_argument("--skip-tokenizer-init", action="store_true")
    p.add_argument("--scratch-model", default="",
                   help="JSON ModelConfig dict: serve a from-scratch model with random "
                        "weights from --seed instead of loading --model-path")
    p.add_argument("--prewarm-prompt-len", type=int, default=0)
    p.add_argument("--prewarm-new-tokens", type=int, default=1)
    p.add_argument("--device", default="",
                   help="torch device of the engine: the card (cuda:0) by default, "
                        "'cpu' for the kernels' plain versions")
    args = p.parse_args(argv)
    name_resolve.reconfigure_from_env()
    _serve(args)


if __name__ == "__main__":
    main()
