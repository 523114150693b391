"""RemoteInfEngine: the HTTP client over decode servers (counterpart of
`areal_tpu/core/remote_inf_engine.py`), speaking the protocol of either
package's `launcher/decode_server.py`.

Kept from the JAX client:

- Discovery: the `addr` argument, else the name_resolve subtree
  `names.gen_servers(experiment, trial)`, else `AREAL_LLM_SERVER_ADDRS`
  (:184-203); then a health wait on every server.
- `choose_server`: rid affinity (a resumed request lands on the server
  that parked its KV), then the least estimated token load (prompt +
  0.4 x budget), round robin on ties.
- `agenerate`'s interrupt-resume loop (:532-621): a response cut by a
  weight swap (stop reason "interrupt") is resubmitted with its partial
  tokens appended to the prompt until it ends for a real reason; each
  submission carries a fresh delivery id ("xid") that its transport
  retries and failover reuse, so the server's idempotency table makes it
  exactly-once. `_generate_failover` moves a submission whose retries to
  one server are exhausted to another.
- Fan-out of pause/continue, `set_version` and the disk push to every
  server, and the staged "dcn" push: `stage_weights` streams frames with
  generation live (a feeder thread packs frame N+1 while frame N is in
  the air, at most `weight_sync_inflight_buckets` frames outstanding, each
  sent as its buffers, never joined), `commit_staged` is the only pause,
  `abort_push` drops a failed push's staging, and `_new_push_id` orders
  pushes by time.
- The rollout queue is the port's `WorkflowExecutor`, as in
  `TorchDecodeEngine`.
- Fault injection: an enabled `config.fault_injection` arms the
  process-global injector at construction (a disabled one leaves an armed
  injector as it is), and `client.weights.stage` fires per staged frame.

- Scheduling through a fleet router (JAX :236-347, :420-490, :599-636):
  when one is registered under `names.rollout_router` (looked up again 30
  s after a miss), `agenerate` asks its `/schedule_request` for each
  request, shipping the remaining deadline and honouring a 429's
  Retry-After within it, and falls back to the local policy when the
  router fails. A failed-over submission is rescheduled with
  `requeue=True`, and `/finish_request` releases the router's accounting
  when the request ends.

- A placement's extras (JAX :491-580): a `prefill_url` (a disaggregated
  fleet) makes the first submission a handoff (`_prefill_handoff`): the
  prompt runs on the prefill replica, which streams its KV to the decode
  replica, and the /generate that follows resumes it with no prefill; a
  failed handoff leaves the decode replica to prefill. A `kv_fabric` hint
  rides on the first submission's body. Plain `threading.Lock`s stand in
  for `OrderedLock`.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import os
import queue
import random
import threading
import time
import uuid
from typing import Any

from areal_tpu_torch.api.cli_args import InferenceEngineConfig
from areal_tpu_torch.api.engine_api import InferenceEngine
from areal_tpu_torch.api.io_struct import ModelRequest, ModelResponse, WeightUpdateMeta
from areal_tpu_torch.core import fault_injection
from areal_tpu_torch.core.weight_transfer import (
    frame_nbytes,
    pack_frames,
    raw_wire_nbytes,
    wire_dtype_name,
)
from areal_tpu_torch.core.workflow_executor import WorkflowExecutor
from areal_tpu_torch.utils import logging, name_resolve, names
from areal_tpu_torch.utils.http import (
    HttpRequestError,
    arequest_with_retry,
    request_with_retry,
    wait_server_healthy,
)

logger = logging.getLogger("remote_inf_engine")

ROLLOUT_POLL_WAIT_TIME = 0.05


class RemoteBackend:
    """Builds and parses one server family's payloads (JAX :67)."""

    PAUSE_ENDPOINT = "/pause_generation"
    CONTINUE_ENDPOINT = "/continue_generation"
    UPDATE_WEIGHTS_FROM_DISK_ENDPOINT = "/update_weights_from_disk"
    SET_VERSION_ENDPOINT = "/set_version"
    HEALTH_ENDPOINT = "/health"

    def build_generate_payload(self, req: ModelRequest) -> dict[str, Any]:
        payload = {
            "rid": req.rid,
            "input_ids": [int(t) for t in req.input_ids],
            "gconfig": dataclasses.asdict(req.gconfig),
        }
        if req.image_data:
            payload["image_data"] = [self._encode_image_impl(img) for img in req.image_data]
        return payload

    @staticmethod
    def _encode_image_impl(img: Any) -> str:
        """bytes, a base64 string or a PIL-style image -> a base64 string
        (JAX :89-106). The decode engine's tower takes processed patch
        dicts, which this refuses, so a decoupled vision run fails here as
        in JAX (ROADMAP queue 3)."""
        import base64

        if isinstance(img, (bytes, bytearray)):
            return base64.b64encode(img).decode()
        if isinstance(img, str):
            return img
        if hasattr(img, "save"):  # a PIL.Image
            import io

            buf = io.BytesIO()
            img.save(buf, format="PNG")
            return base64.b64encode(buf.getvalue()).decode()
        raise TypeError(
            f"image_data entries must be bytes, base64 str, or PIL images; "
            f"got {type(img).__name__}"
        )

    def parse_generate_response(self, data: dict[str, Any]) -> dict[str, Any]:
        return {
            "output_tokens": [int(t) for t in data["output_tokens"]],
            "output_logprobs": [float(x) for x in data["output_logprobs"]],
            "output_versions": [int(v) for v in data.get("output_versions", [])],
            "stop_reason": data["stop_reason"],
        }


class JaxDecodeBackend(RemoteBackend):
    """The decode servers' protocol (both packages speak it); the JAX
    name is kept."""


class RemoteInfEngine(InferenceEngine):
    def __init__(self, config: InferenceEngineConfig, backend: RemoteBackend | None = None,
                 tokenizer: Any = None):
        config.check_supported()
        self.config = config
        self.backend = backend or JaxDecodeBackend()
        self.tokenizer = tokenizer
        fault_injection.configure_from_config(config.fault_injection)
        self.addresses: list[str] = []
        # the router's address ("" after a miss, looked up again once the
        # cooldown clock passes)
        self._router: str | None = None
        self._router_next_lookup = 0.0
        # round-robin cursor, rid affinity and per-server estimated load,
        # touched by the rollout loop and by callers on other threads
        self._server_idx = 0  # guarded-by: _rid_lock
        self._rid_to_addr: dict[str, str] = {}  # guarded-by: _rid_lock
        self._addr_est_load: dict[str, float] = {}  # guarded-by: _rid_lock
        self._rid_cost: dict[str, float] = {}  # guarded-by: _rid_lock
        self._rid_lock = threading.Lock()
        self._version = 0
        self._executor: WorkflowExecutor | None = None
        # staging runs on the trainer's push thread, commit on its main
        # thread
        self._stats_lock = threading.Lock()
        self._sync_stats = dict(  # guarded-by: _stats_lock
            n_pushes=0,
            wire_bytes=0,
            wire_bytes_raw=0,
            last_push_bytes=0,
            staging_secs=0.0,
            commit_pause_secs=0.0,
            aborts=0,
        )
        # a push that staged and never committed: the next push aborts it
        # on the servers before it streams
        self._incomplete_push_id: str | None = None  # guarded-by: _stats_lock

    # -- discovery ------------------------------------------------------
    def _discover_servers(self, addr: str | list[str] | None) -> list[str]:
        if addr:
            return [addr] if isinstance(addr, str) else list(addr)
        if self.config.experiment_name and self.config.trial_name:
            root = names.gen_servers(self.config.experiment_name, self.config.trial_name)
            deadline = time.monotonic() + self.config.setup_timeout
            while time.monotonic() < deadline:
                found = name_resolve.get_subtree(root)
                if found:
                    return sorted(found)
                time.sleep(1)
        env = os.environ.get("AREAL_LLM_SERVER_ADDRS", "")
        if env:
            return [a.strip() for a in env.split(",") if a.strip()]
        raise RuntimeError(
            "no decode servers found (addr arg, name_resolve, AREAL_LLM_SERVER_ADDRS all empty)"
        )

    def initialize(self, addr: str | list[str] | None = None, ft_spec: Any = None,
                   train_data_parallel_size: int | None = None) -> "RemoteInfEngine":
        self.addresses = self._discover_servers(addr)

        async def _wait_all():
            await asyncio.gather(*[
                wait_server_healthy(a, timeout=self.config.setup_timeout) for a in self.addresses
            ])

        asyncio.run(_wait_all())
        logger.info(f"connected to {len(self.addresses)} decode servers")
        self._executor = WorkflowExecutor(self.config, self)
        self._executor.initialize(train_data_parallel_size)
        self._executor.set_version(self._version)
        return self

    def destroy(self) -> None:
        if self._executor is not None:
            self._executor.destroy()
            self._executor = None

    # -- scheduling -----------------------------------------------------
    def _router_addr(self) -> str | None:
        """The fleet router's address, if one registered: placement then
        goes through its least-load and qid-affinity scheduling. A found
        address is kept; a miss is looked up again after 30 s (the router
        starts independently of the trainers)."""
        if self._router:
            return self._router
        now = time.monotonic()
        if now < self._router_next_lookup:
            return None
        self._router_next_lookup = now + 30.0
        addr = ""
        if self.config.experiment_name and self.config.trial_name:
            try:
                addr = name_resolve.get(
                    names.rollout_router(self.config.experiment_name, self.config.trial_name))
            except Exception as e:  # noqa: BLE001 — the router is optional
                logger.debug(f"no rollout router registered ({e!r})")
                addr = ""
        self._router = addr
        return addr or None

    async def _schedule_via_router(self, req: ModelRequest, requeue: bool = False,
                                   deadline: float | None = None) -> dict[str, Any] | None:
        """The router's placement of `req` ({"url", "version"}), or None
        with no router or when it fails (the local policy decides). A 429
        waits its Retry-After, jittered, and asks again while the request's
        deadline allows."""
        router = self._router_addr()
        if router is None:
            return None
        if deadline is None:
            deadline = time.monotonic() + self.config.request_timeout
        # the prefix the router's affinity hashes (64-token blocks, up to 4)
        payload: dict[str, Any] = dict(
            qid=req.rid, prompt_len=len(req.input_ids), group_size=req.gconfig.n_samples,
            new_token_budget=req.gconfig.max_new_tokens,
            input_prefix=[int(t) for t in req.input_ids[:256]],
        )
        if requeue:
            payload["requeue"] = True
        backoff = 1.0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                logger.warning(f"router schedule for {req.rid} abandoned: deadline exhausted")
                return None
            # the router holds a queued request no longer than this
            payload["deadline_s"] = remaining
            try:
                out = await arequest_with_retry(
                    router, "/schedule_request", payload=payload, max_retries=2,
                    timeout=min(self.config.router_request_timeout, remaining))
                return out if out.get("url") else None
            except HttpRequestError as e:
                if e.status == 429 and time.monotonic() < deadline:
                    # shed by the router's bounded queue: wait, do not
                    # dogpile a server directly
                    ra = e.body.get("retry_after")
                    wait = float(ra) if ra is not None else backoff
                    backoff = min(backoff * 2, 10.0)
                    j = max(self.config.retry_jitter, 0.0)
                    wait *= 1.0 + random.uniform(-j, j)
                    await asyncio.sleep(max(0.0, min(wait, deadline - time.monotonic())))
                    continue
                return self._router_schedule_failed(e)
            except Exception as e:  # noqa: BLE001 — the local policy decides
                return self._router_schedule_failed(e)

    def _router_schedule_failed(self, e: Exception) -> None:
        logger.warning(f"router schedule failed ({e!r}); using local policy")
        # forget the address: a restarted router registers a new one
        self._router = ""
        self._router_next_lookup = time.monotonic() + 30.0
        return None

    async def _finish_request_best_effort(self, rid: str) -> None:
        """Release one unit of the router's accounting of `rid`; a failure
        is logged (the router's TTL expiry releases a leaked unit)."""
        try:
            await arequest_with_retry(self._router, "/finish_request", payload=dict(qid=rid),
                                      max_retries=1, timeout=10)
        except Exception as e:  # noqa: BLE001 — accounting is best effort
            logger.debug(f"finish_request({rid}) failed: {e!r}")

    def choose_server(self, rid: str | None = None, cost: float = 0.0,
                      exclude: str | None = None) -> str:
        """The server for `rid`: its affinity if it has one (and it is not
        `exclude`), else the least estimated token load, round robin on
        ties. `cost` is charged to the choice until `_release_local(rid)`."""
        with self._rid_lock:
            if rid is not None:
                cached = self._rid_to_addr.get(rid)
                if cached is not None and cached != exclude:
                    return cached
            pool = [a for a in self.addresses if a != exclude] or list(self.addresses)
            n = len(pool)
            k = self._server_idx % n
            order = {a: i for i, a in enumerate(pool[k:] + pool[:k])}
            addr = min(pool, key=lambda a: (self._addr_est_load.get(a, 0.0), order[a]))
            self._server_idx += 1
            if cost:
                self._addr_est_load[addr] = self._addr_est_load.get(addr, 0.0) + cost
            if rid is not None:
                self._rid_to_addr[rid] = addr
                if cost:
                    self._rid_cost[rid] = self._rid_cost.get(rid, 0.0) + cost
                if len(self._rid_to_addr) > 65536:
                    for old in list(self._rid_to_addr)[:32768]:
                        self._release_local_locked(old)
        return addr

    def _release_local_locked(self, rid: str) -> None:
        addr = self._rid_to_addr.pop(rid, None)
        c = self._rid_cost.pop(rid, None)
        if addr is not None and c:
            self._addr_est_load[addr] = max(0.0, self._addr_est_load.get(addr, 0.0) - c)

    def _release_local(self, rid: str) -> None:
        with self._rid_lock:
            self._release_local_locked(rid)

    @staticmethod
    def _local_cost(req: ModelRequest) -> float:
        return float(len(req.input_ids)) + 0.4 * float(req.gconfig.max_new_tokens)

    # -- generation -----------------------------------------------------
    async def _generate_failover(self, req: ModelRequest, payload: dict[str, Any], addr: str,
                                 deadline: float) -> tuple[dict[str, Any], str]:
        """POST /generate; when the retries to `addr` are exhausted (the
        replica died), reschedule — through the router with requeue=True,
        whose failover has moved the qid to a survivor, or locally without
        `addr` — and send the same payload (same xid) there. Every
        attempt's timeout is clipped to the request's remaining budget.
        Returns (reply, the address that served it)."""
        for attempt in range(self.config.fleet_failover_retries + 1):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                if attempt:
                    raise HttpRequestError(
                        f"/generate for {req.rid} abandoned: request deadline exhausted "
                        f"after {attempt} failover attempt(s)"
                    )
                remaining = self.config.request_timeout
            try:
                data = await arequest_with_retry(
                    addr, "/generate", payload=payload, max_retries=self.config.request_retries,
                    timeout=min(self.config.request_timeout, remaining),
                )
                return data, addr
            except HttpRequestError as e:
                if e.status is not None and e.status < 500:
                    raise  # a real 4xx: no other server does better
                if attempt >= self.config.fleet_failover_retries:
                    raise
                logger.warning(f"/generate to {addr} failed ({e!r}); failing over")
                sched = await self._schedule_via_router(req, requeue=True, deadline=deadline)
                routed = sched["url"] if sched else None
                if routed is None or routed == addr:
                    self._release_local(req.rid)
                    routed = self.choose_server(req.rid, cost=self._local_cost(req),
                                                exclude=addr)
                if routed == addr:
                    raise  # one server: nowhere to go
                addr = routed
        raise AssertionError("unreachable")

    async def _prefill_handoff(self, rid: str, payload: dict[str, Any], prefill_addr: str,
                               decode_addr: str, deadline: float) -> bool:
        """Run the prompt on the prefill replica, which streams its KV to
        the decode replica server to server (the client carries no KV);
        True when it landed. Best effort: one retry with the same xid (the
        prefill route and the receiver's commit deduplicate, so a death
        mid-transfer lands the session once), and any failure leaves the
        decode replica to prefill itself."""
        p = dict(payload, target=decode_addr, xid=f"pf-{uuid.uuid4().hex}")
        last: Exception | None = None
        for _ in range(2):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            try:
                out = await arequest_with_retry(prefill_addr, "/prefill", payload=p,
                                                max_retries=1, timeout=min(60.0, remaining))
                return bool(out.get("migrated"))
            except Exception as e:  # noqa: BLE001 — degrade to the decode replica's prefill
                last = e
        logger.warning(f"prefill handoff for {rid} via {prefill_addr} failed ({last!r}); "
                       f"{decode_addr} will prefill itself")
        return False

    async def agenerate(self, req: ModelRequest) -> ModelResponse:
        """Generate with the interrupt-resume loop (JAX :532-621)."""
        start = time.monotonic()
        deadline = start + self.config.request_timeout
        sched = await self._schedule_via_router(req, deadline=deadline)
        routed = sched["url"] if sched else None
        addr = routed or self.choose_server(req.rid, cost=self._local_cost(req))
        # a disaggregated fleet: the router named a prefill replica too
        prefill_url = sched.get("prefill_url") if sched else None
        prompt = list(req.input_ids)
        acc_tokens: list[int] = []
        acc_logprobs: list[float] = []
        acc_versions: list[int] = []
        stop_reason = "interrupt"
        ttft = float("inf")
        try:
            while stop_reason == "interrupt":
                work = req.copy()
                work.input_ids = prompt + acc_tokens
                work.gconfig = req.gconfig.new(
                    max_new_tokens=req.gconfig.max_new_tokens - len(acc_tokens),
                    min_new_tokens=max(0, req.gconfig.min_new_tokens - len(acc_tokens)),
                )
                payload = self.backend.build_generate_payload(work)
                if sched and sched.get("kv_fabric") and not acc_tokens:
                    # a sibling holds this prompt's prefix: the decode
                    # server fetches it (the first submission only; a
                    # resume has its KV already)
                    payload["kv_fabric"] = sched["kv_fabric"]
                if prefill_url and prefill_url != addr:
                    # the first submission only: a resume continues from
                    # KV the decode replica holds
                    await self._prefill_handoff(req.rid, payload, prefill_url, addr, deadline)
                    prefill_url = None
                # one delivery id per submission: its retries and failover
                # reuse it, a resume is a new submission
                payload["xid"] = uuid.uuid4().hex
                data, addr = await self._generate_failover(req, payload, addr, deadline)
                out = self.backend.parse_generate_response(data)
                acc_tokens.extend(out["output_tokens"])
                acc_logprobs.extend(out["output_logprobs"])
                acc_versions.extend(
                    out["output_versions"] or [self._version] * len(out["output_tokens"]))
                if ttft == float("inf") and out["output_tokens"]:
                    ttft = time.monotonic() - start
                stop_reason = out["stop_reason"]
                if stop_reason == "interrupt" and not out["output_tokens"]:
                    # flushed before its first token: let the swap finish
                    await asyncio.sleep(ROLLOUT_POLL_WAIT_TIME)
        finally:
            self._release_local(req.rid)
            if routed is not None:
                try:
                    # shielded: a cancelled rollout still releases its unit
                    await asyncio.shield(self._finish_request_best_effort(req.rid))
                except BaseException as e:  # noqa: BLE001 — the router's TTL backstops it
                    logger.debug(f"finish_request({req.rid}) skipped: {e!r}")
        return ModelResponse(
            input_tokens=prompt,
            output_tokens=acc_tokens,
            output_logprobs=acc_logprobs,
            output_versions=acc_versions,
            stop_reason=stop_reason,  # type: ignore[arg-type]
            latency=time.monotonic() - start,
            ttft=ttft,
            tokenizer=self.tokenizer,
        )

    def generate(self, req: ModelRequest, timeout: float | None = None) -> ModelResponse:
        """Blocking `agenerate` (call it outside a running event loop)."""
        return asyncio.run(asyncio.wait_for(self.agenerate(req), timeout))

    # -- fan-out --------------------------------------------------------
    def _fanout(self, endpoint: str, payload: dict[str, Any] | None = None,
                timeout: float | None = None) -> list[dict[str, Any]]:
        """`endpoint` on every server at once; every reply, in order."""
        with concurrent.futures.ThreadPoolExecutor(max(len(self.addresses), 1)) as ex:
            futs = [
                ex.submit(request_with_retry, a, endpoint, payload=payload,
                          max_retries=self.config.request_retries,
                          timeout=timeout or self.config.setup_timeout)
                for a in self.addresses
            ]
            return [f.result() for f in futs]

    def pause_generation(self, abort: bool = True) -> None:
        self._fanout(self.backend.PAUSE_ENDPOINT, {"abort": abort})

    def continue_generation(self) -> None:
        self._fanout(self.backend.CONTINUE_ENDPOINT, {})

    # -- weight updates -------------------------------------------------
    def init_weights_update_group(self, meta: WeightUpdateMeta) -> None:
        pass

    def update_weights_from_disk(self, meta: WeightUpdateMeta) -> None:
        if meta.path is None:
            raise ValueError("a disk weight update needs meta.path")
        self._fanout(self.backend.UPDATE_WEIGHTS_FROM_DISK_ENDPOINT,
                     {"path": meta.path, "version": self._version},
                     timeout=self.config.request_timeout)

    @staticmethod
    def _new_push_id() -> str:
        """Unique and ordered by time (a fixed-width ns timestamp first):
        servers reset staging for a newer id and refuse frames of an older
        one, so a late frame of an aborted push never wipes a newer push."""
        return f"{time.time_ns():020d}-{uuid.uuid4().hex[:8]}"

    def stage_weights(self, named, push_id: str | None = None, chunk_mb: float = 512,
                      inflight: int | None = None) -> str:
        """Stream the frames of `named` (a dict or a lazy (name, host
        tensor) producer) into every server's staging, generation live.
        A feeder thread packs frames into a queue of `inflight`; at most
        `inflight` frames are in the air. On any failure the servers'
        staging of this push is dropped (`abort_push`) before the error
        propagates. Returns the push id for `commit_staged`."""
        inflight = max(int(inflight or self.config.weight_sync_inflight_buckets), 1)
        push_id = push_id or self._new_push_id()
        with self._stats_lock:
            stale_push, self._incomplete_push_id = self._incomplete_push_id, push_id
        if stale_push is not None and stale_push != push_id:
            logger.warning(f"aborting incomplete previous push {stale_push} before {push_id}")
            self.abort_push(stale_push, forget=False)
        t0 = time.monotonic()
        raw_bytes = 0

        def counted(items):
            nonlocal raw_bytes
            for name, arr in items:
                raw_bytes += raw_wire_nbytes(name, int(arr.nbytes), wire_dtype_name(arr))
                yield name, arr

        frames: queue.Queue = queue.Queue(maxsize=inflight)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    frames.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                items = named.items() if hasattr(named, "items") else named
                for parts in pack_frames(counted(items), chunk_mb=chunk_mb):
                    if not put(parts):
                        return
                put(None)
            except BaseException as e:  # noqa: BLE001 — handed to the consumer
                put(e)

        feeder = threading.Thread(target=produce, daemon=True, name="weight-frames")
        feeder.start()
        n_bytes = 0
        endpoint = f"/update_weights_from_tensor?push_id={push_id}"
        pool = concurrent.futures.ThreadPoolExecutor(max(inflight * len(self.addresses), 1))
        try:
            sending: collections.deque = collections.deque()
            while True:
                item = frames.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                while len(sending) >= inflight:
                    for f in sending.popleft():
                        f.result()
                fault_injection.fire("client.weights.stage", push_id=push_id,
                                     nbytes=frame_nbytes(item))
                n_bytes += frame_nbytes(item) * len(self.addresses)
                sending.append([
                    pool.submit(request_with_retry, a, endpoint, data=item,
                                max_retries=self.config.request_retries,
                                timeout=self.config.request_timeout)
                    for a in self.addresses
                ])
            while sending:
                for f in sending.popleft():
                    f.result()
        except BaseException:
            stop.set()
            pool.shutdown(wait=True, cancel_futures=True)
            with self._stats_lock:
                self._sync_stats["aborts"] += 1
            self.abort_push(push_id)
            raise
        finally:
            pool.shutdown(wait=True)
            feeder.join(timeout=10)
        with self._stats_lock:
            self._sync_stats["staging_secs"] += time.monotonic() - t0
            self._sync_stats["wire_bytes"] += n_bytes
            self._sync_stats["wire_bytes_raw"] += raw_bytes * len(self.addresses)
            self._sync_stats["last_push_bytes"] = n_bytes
        return push_id

    def _commit_fanout(self, push_id: str | None, version: int | None) -> None:
        payload: dict[str, Any] = {"version": version}
        if push_id is not None:
            payload["push_id"] = push_id
        self._fanout("/commit_weights", payload, timeout=self.config.request_timeout)
        if version is not None:
            self._version = int(version)
            if self._executor is not None:
                self._executor.set_version(int(version))

    def commit_staged(self, push_id: str, version: int | None = None) -> None:
        """The only pause of a staged push: pause on a pass boundary,
        install the staged weights on every server (the version stamped
        inside the servers' pause; a stale push id is refused there), go
        on."""
        t0 = time.monotonic()
        self.pause_generation(abort=False)
        try:
            self._commit_fanout(push_id, version)
        finally:
            self.continue_generation()
        with self._stats_lock:
            self._sync_stats["commit_pause_secs"] += time.monotonic() - t0
            self._sync_stats["n_pushes"] += 1
            if self._incomplete_push_id == push_id:
                self._incomplete_push_id = None

    def abort_push(self, push_id: str, forget: bool = True) -> None:
        """Drop the servers' staging of a failed or abandoned push
        (best effort). `forget=False` keeps the incomplete-push marker for
        its caller."""
        try:
            self._fanout("/abort_weights", {"push_id": push_id})
        except (HttpRequestError, OSError) as e:
            logger.warning(f"abort_weights({push_id}) failed: {e!r}")
        if forget:
            with self._stats_lock:
                if self._incomplete_push_id == push_id:
                    self._incomplete_push_id = None

    def update_weights_from_tensor(self, named, version: int | None = None,
                                   chunk_mb: float = 512, overlap: bool | None = None,
                                   inflight: int | None = None) -> None:
        """Push `named` to every server and commit it. Overlapped (the
        default, `weight_sync_overlap`): frames stage with generation live
        and only the commit pauses; otherwise the whole push sits in one
        pause."""
        if overlap is None:
            overlap = self.config.weight_sync_overlap
        push_id = self._new_push_id()
        if overlap:
            self.stage_weights(named, push_id=push_id, chunk_mb=chunk_mb, inflight=inflight)
            self.commit_staged(push_id, version=version)
            return
        t0 = time.monotonic()
        self.pause_generation(abort=False)
        try:
            self.stage_weights(named, push_id=push_id, chunk_mb=chunk_mb, inflight=inflight)
            self._commit_fanout(push_id, version)
        finally:
            self.continue_generation()
        with self._stats_lock:
            self._sync_stats["commit_pause_secs"] += time.monotonic() - t0
            self._sync_stats["n_pushes"] += 1
            if self._incomplete_push_id == push_id:
                self._incomplete_push_id = None

    def get_metrics(self) -> dict:
        """The client's weight-sync counters: pushes, wire bytes, staging
        seconds (generation live) and commit-pause seconds."""
        with self._stats_lock:
            out = dict(self._sync_stats)
        out["wire_bytes_sent"] = out["wire_bytes"]
        out["weight_sync_compression"] = (
            round(out["wire_bytes_raw"] / out["wire_bytes_sent"], 4)
            if out["wire_bytes_sent"] else 1.0
        )
        return out

    def update_weights_from_distributed(self, meta: WeightUpdateMeta, params=None,
                                        model_config=None) -> None:
        raise NotImplementedError(
            "remote engines take weights from disk or the staged dcn push "
            "(update_weights_from_tensor); the in-memory handoff is the colocated "
            "TorchDecodeEngine's"
        )

    def update_weights(self, meta: WeightUpdateMeta) -> None:
        if meta.type != "disk":
            raise NotImplementedError(f"weight update type {meta.type}")
        self.update_weights_from_disk(meta)

    # -- versioning -----------------------------------------------------
    def set_version(self, version: int) -> None:
        self._version = version
        if self._executor is not None:
            self._executor.set_version(version)
        self._fanout(self.backend.SET_VERSION_ENDPOINT, {"version": version})

    def get_version(self) -> int:
        return self._version

    # -- rollout queue (delegated) ---------------------------------------
    def submit(self, data, workflow=None, workflow_builder=None, should_accept=None,
               rollout_id=None):
        return self._executor.submit(data, workflow, workflow_builder, should_accept,
                                     rollout_id=rollout_id)

    def wait(self, count, timeout=None):
        return self._executor.wait(count, timeout=timeout)

    def rollout_batch(self, data, workflow=None, workflow_builder=None, should_accept=None):
        return self._executor.rollout_batch(data, workflow, workflow_builder, should_accept)

    def prepare_batch(self, dataloader, workflow=None, workflow_builder=None,
                      should_accept=None):
        return self._executor.prepare_batch(dataloader, workflow, workflow_builder,
                                            should_accept)

    def pause(self) -> None:
        self._executor.pause()

    def resume(self) -> None:
        self._executor.resume()

    # -- sample-ledger checkpointing (delegated) --------------------------
    def attach_ledger_wal(self, path: str) -> None:
        self._executor.attach_ledger_wal(path)

    def state_dict(self) -> dict:
        return self._executor.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self._executor.load_state_dict(state)
