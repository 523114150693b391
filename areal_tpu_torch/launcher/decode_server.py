"""HTTP decode server (counterpart of `areal_tpu/launcher/decode_server.py`):
a `TorchDecodeEngine` behind the JSON-over-HTTP control plane that
`RemoteInfEngine` speaks, in either package.

Routes (JAX :1187-1202), with the JAX bodies and replies:

  GET  /health                  {"status": "ok", "version": N, "role"}
  GET  /info                    model and config metadata
  GET  /metrics                 engine load and latency counters, the
                                weight sync's counters (`weight_sync`), the
                                idempotency table's size and hits, and the
                                port's `kernel_launches` and
                                `device_memory_peak`
  POST /generate                one completion with token logprobs and
                                versions; an "xid" makes it idempotent: a
                                duplicate of a submission in flight waits
                                for the same result, a duplicate of a
                                finished one gets the cached reply
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

`/prefill`, `/kv_recv`, `/kv_commit` (session migration, ROADMAP.md
queue 1, item 3.4), `/kv_fetch`, `/warm_start`, `/drain` and `/set_role`
(the fleet, item 4) answer 501. The `kv_fabric` hint of a `/generate`
body is ignored, as a lone engine does.

Threading. The JAX server runs every handler on one event loop; here
`http.server.ThreadingHTTPServer` runs each connection on a thread of its
own. `_ctl_lock` is held around every pause, swap, stage and commit, so a
`/continue_generation` can never resume decoding in the middle of a
weight swap; the idempotency table has its own lock, and a duplicate of
a submission in flight waits on a `concurrent.futures.Future`.
`/generate` calls the engine's blocking `generate`; the engine's
scheduler is its own thread.

Run one with `python -m areal_tpu_torch.launcher.decode_server
--scratch-model '<ModelConfig JSON>' [flags]`: the JAX server's flags and
defaults, and `--device` (the card, `cuda:0`, by default; `cpu` runs the
kernels' plain versions).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import signal
import socketserver
import threading
import time
import traceback
import urllib.parse
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from areal_tpu_torch.api.cli_args import (
    GenerationHyperparameters,
    InferenceEngineConfig,
    TorchDecodeConfig,
)
from areal_tpu_torch.api.io_struct import ModelRequest, WeightUpdateMeta
from areal_tpu_torch.core.weight_transfer import WeightStaging, frame_raw_nbytes
from areal_tpu_torch.models.convert import to_layout
from areal_tpu_torch.utils import logging, name_resolve, names
from areal_tpu_torch.utils.network import gethostip

logger = logging.getLogger("decode_server")

_GCONFIG_FIELDS = {f.name for f in dataclasses.fields(GenerationHyperparameters)}

# routes of features still to port, and their ROADMAP.md queue 1 items
_UNPORTED = {
    "/prefill": "item 3.4, the prefill role and session migration",
    "/kv_recv": "item 3.4, session migration",
    "/kv_commit": "item 3.4, session migration",
    "/kv_fetch": "item 4, the fleet KV fabric",
    "/warm_start": "item 4, the fleet KV fabric",
    "/drain": "item 4, the fleet supervisor",
    "/set_role": "item 4, the prefill/decode roles",
}


def _parse_gconfig(d: dict[str, Any]) -> GenerationHyperparameters:
    return GenerationHyperparameters(**{k: v for k, v in d.items() if k in _GCONFIG_FIELDS})


class _Reply(Exception):
    """A non-200 JSON answer."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


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
        }
        if path in _UNPORTED:
            raise _Reply(501, f"{path} is not in the PyTorch port yet: ROADMAP.md queue 1, "
                              f"{_UNPORTED[path]}")
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

    def _generate(self, query, body) -> dict:
        req_body = self._json(body)
        xid = req_body.get("xid")
        ent = None
        if xid is not None:
            with self._idem_lock:
                prior = self._idem.get(xid)
                if prior is not None:
                    # a duplicate delivery: never generate twice
                    self._idem_hits += 1
                    if prior["done"]:
                        self._idem.move_to_end(xid)
                        return {**prior["resp"], "dedup": "completed"}
                else:
                    ent = {"done": False, "fut": concurrent.futures.Future(),
                           "t": time.monotonic()}
                    self._idem[xid] = ent
            if prior is not None:
                return {**prior["fut"].result(), "dedup": "in_progress"}
        req = ModelRequest(
            rid=req_body.get("rid") or ModelRequest().rid,
            input_ids=[int(t) for t in req_body["input_ids"]],
            gconfig=_parse_gconfig(req_body.get("gconfig", {})),
        )
        try:
            resp = self.engine.generate(req)
        except BaseException as e:
            if ent is not None:
                with self._idem_lock:
                    if self._idem.get(xid) is ent:
                        del self._idem[xid]
                ent["fut"].set_exception(e)
            raise
        out = {
            "output_tokens": resp.output_tokens,
            "output_logprobs": resp.output_logprobs,
            "output_versions": resp.output_versions,
            "stop_reason": resp.stop_reason,
            "latency": resp.latency,
            "ttft": resp.ttft,
            "itl": resp.itl,
        }
        if ent is not None:
            with self._idem_lock:
                if self._idem.get(xid) is ent:
                    self._idem[xid] = {"done": True, "resp": out, "t": time.monotonic()}
                    self._idem.move_to_end(xid)
                self._prune_idem_locked()
            ent["fut"].set_result(out)
        return out

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
                              "queue 1, item 6")
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

    # -- lifecycle ------------------------------------------------------
    def start(self, host: str = "0.0.0.0", port: int = 0) -> str:
        """Initialize an engine this server built, then listen; returns
        the address ("ip:port") clients reach it at."""
        if self._owns_engine:
            self.engine.initialize()
        app = self

        class Handler(_Handler):
            server_app = app

        self._httpd = _Server((host, port), Handler)
        actual_port = self._httpd.server_address[1]
        ip = gethostip() if host in ("0.0.0.0", "::", "") else host
        self.addr = f"{ip}:{actual_port}"
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs=dict(poll_interval=0.2), daemon=True,
            name="decode-server-http",
        )
        self._serve_thread.start()
        logger.info(f"decode server listening on {self.addr}")
        return self.addr

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
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


class _Server(ThreadingHTTPServer):
    daemon_threads = True

    def server_bind(self) -> None:
        # HTTPServer.server_bind looks the bound address up in the
        # resolver (socket.getfqdn); the name is not needed
        socketserver.TCPServer.server_bind(self)
        self.server_name, self.server_port = self.server_address[:2]

    def handle_error(self, request, client_address) -> None:
        logger.error(f"request from {client_address} failed:\n{traceback.format_exc()}")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # the reply's headers and body go out in two writes
    disable_nagle_algorithm = True
    server_app: DecodeServer

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
        if self.headers.get("Transfer-Encoding", "").lower() == "chunked":
            status, out = 411, {"status": "error", "message": "send a Content-Length"}
            self.close_connection = True
        else:
            body = self._read_body()
            try:
                out, status = self.server_app.handle(
                    method, url.path, urllib.parse.parse_qs(url.query), body), 200
            except _Reply as e:
                status, out = e.status, {"status": "error", "message": str(e)}
            except Exception as e:  # noqa: BLE001 — the server keeps serving
                logger.error(f"{method} {url.path} failed:\n{traceback.format_exc()}")
                status, out = 500, {"status": "error", "message": f"{type(e).__name__}: {e}"}
        data = json.dumps(out).encode()
        try:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
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

    from areal_tpu_torch.models.qwen2 import ModelConfig, init_params

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
    if not args.scratch_model:
        raise NotImplementedError(
            "serving a checkpoint (--model-path) is not in the PyTorch port yet: "
            "ROADMAP.md queue 1, item 6; pass --scratch-model"
        )
    if args.prewarm_prompt_len > 0:
        # the JAX engine compiles its jit variants there; the port has
        # nothing to compile ahead (its kernels build on first use)
        logger.info("--prewarm-prompt-len: nothing to warm in the PyTorch port")
    device = resolve_device(args.device or None)
    server = DecodeServer(config, device=device)
    params, mc = _scratch_model(args, device)
    server.engine.set_model(params, mc)
    del params
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
    p.add_argument("--role", default="unified", choices=["unified", "prefill", "decode"],
                   help="disaggregated fleet role; the port serves 'unified' "
                        "(ROADMAP.md queue 1, item 4)")
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
