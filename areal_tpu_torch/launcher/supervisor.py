"""Self-healing fleet supervisor (counterpart of
`areal_tpu/launcher/supervisor.py`): an autoscaler over the decode fleet
that absorbs churn itself.

Each tick it

  1. polls the router's `/metrics` and every managed replica's `/health`,
  2. freezes the readings into a `FleetSnapshot`,
  3. runs the pure planner `plan_actions(snapshot, policy)` — hysteresis
     marks, per-action cooldowns, a `min_replicas` floor no plan breaks,
     at most one disruptive action in flight — and
  4. carries the plan out through `spawn_fn(role) -> handle` (in-process
     replicas in `chip_smoke.py`'s fleet phase, decode-server subprocesses
     through `LocalLauncher.spawn_decode_server` in `main`), HTTP against
     the replicas (`/drain`) and `handle.kill()`.

The safe transitions:

  scale up    a new slot is spawned with jittered exponential backoff;
              after `spawn_max_attempts` failures in a row it is
              crash-looped: no more retries, `crash_loops_total` counts it,
              and the fleet goes on degraded.
  scale down  `/drain` to the survivors first; the victim is killed only
              after the drain commits. A drain past `drain_deadline_s` is
              rolled back (`drain_rollbacks_total`): the victim keeps
              serving.
  replace     a dead or breaker-open replica is drained if it still
              answers, killed, and its slot respawned through the same
              spawn machinery. Its requests in flight are the router's:
              its failover requeues their qids and the clients' xid
              retries land once on the servers' idempotency tables.
  re-role     a replica of a disaggregated fleet is drained and flipped
              through `/set_role` when the prefill share of the fleet's
              work leaves `rerole_band` around the prefill replicas' share.

Drain first is safe: a drained replica has exported every resumable
session to the survivors (their resumes are promotions with no prefill)
and parks nothing, so the kill destroys no state a client needs.

Threading. JAX runs the tick and the handlers on one event loop under an
`asyncio.Lock`; here the tick runs on a daemon thread, each spawn and the
one disruptive action on worker threads the tick checks (in place of
`_disruptive_task`'s asyncio task), the endpoints on `ThreadingHTTPServer`
threads, and one `threading.Lock` guards the `_GUARDED_BY` fields.

Fault seams (`core/fault_injection.py`, JAX :500, :745, :903, :924):
`supervisor.health` before each replica probe (an abort is a failed
probe), `supervisor.spawn` before each spawn attempt (an abort is a spawn
failure: backoff, then the crash loop), `supervisor.drain` inside the
drain's deadline (a delay is a hung drain: rollback, and the drain is
never sent) and `supervisor.kill` after a committed drain, before the kill.

The KV fabric (`kv_fabric`, JAX :810-900): a spawned replica pulls its
peers' longest resident block runs (`/warm_start`, `warm_start_sessions`)
before it is registered, so its first requests promote instead of
prefilling; and a drain sends the union of the survivors' digests
(`_refetchable_digest`), so a session they can serve again leaves as
identity only.

Run: ``python -m areal_tpu_torch.launcher.supervisor --experiment-name e
--trial-name t --router host:port --model-path <checkpoint>``: spawned
replicas are decode-server subprocesses that register themselves for the
router to discover.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import random
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Protocol

from areal_tpu_torch.api.cli_args import SupervisorConfig
from areal_tpu_torch.core import fault_injection, kv_fabric
from areal_tpu_torch.launcher.decode_server import _Reply, serve_app
from areal_tpu_torch.utils import logging, name_resolve, names
from areal_tpu_torch.utils.http import request_with_retry

logger = logging.getLogger("supervisor")

# the control plane's state; every access holds `_lock`
_GUARDED_BY = {
    "FleetSupervisor._slots": "_lock",
    "FleetSupervisor._next_slot_id": "_lock",
    "FleetSupervisor._last_action_t": "_lock",
    "FleetSupervisor._disruptive_task": "_lock",
    "FleetSupervisor._last_tick_t": "_lock",
    "FleetSupervisor._prev_sheds": "_lock",
    "FleetSupervisor._prev_secs": "_lock",
    "FleetSupervisor._prefill_share": "_lock",
    "FleetSupervisor._replica_seconds": "_lock",
    "FleetSupervisor._counters": "_lock",
    "FleetSupervisor._gauges": "_lock",
}

# actions that remove or disturb live capacity: at most one per tick, and
# none while one is in flight
DISRUPTIVE_KINDS = frozenset({"scale_down", "replace", "rerole"})


# -- the planner's inputs and outputs (frozen: the planner is pure) ---------
@dataclass(frozen=True)
class ReplicaView:
    """One replica as the planner sees it."""

    addr: str
    alive: bool = True
    role: str = "unified"
    breaker_state: str = "closed"  # "closed" | "open" | "half_open"
    load: float = 0.0  # the router's token load (the scale-down victim)


@dataclass(frozen=True)
class FleetSnapshot:
    """The readings one tick plans over, with the supervisor's own
    bookkeeping folded in (`last_action_t`, `disruptive_inflight`,
    `spawn_failures`, `pending_spawns`), so cooldowns, one disruptive
    action at a time and the crash-loop gate are the planner's."""

    now: float
    replicas: tuple[ReplicaView, ...]
    queue_depth: int = 0
    shed_rate: float = 0.0  # router sheds per second since the last tick
    util: float = 0.0  # fleet demand / capacity
    # measured share of fleet compute spent on prefill (None until read)
    prefill_share: float | None = None
    last_action_t: Mapping[str, float] = field(default_factory=dict)
    disruptive_inflight: bool = False
    # spawn failures in a row of the pending slot (0 with none pending)
    spawn_failures: int = 0
    # slots spawning or backing off: capacity already on its way
    pending_spawns: int = 0


@dataclass(frozen=True)
class Action:
    kind: str  # "scale_up" | "scale_down" | "replace" | "rerole"
    target: str | None = None  # the replica (disruptive kinds)
    role: str = "unified"  # the role to spawn with or flip to
    reason: str = ""


def _cooldown_of(policy: SupervisorConfig, kind: str) -> float:
    return {
        "scale_up": policy.scale_up_cooldown_s,
        "scale_down": policy.scale_down_cooldown_s,
        "replace": policy.replace_cooldown_s,
        "rerole": policy.rerole_cooldown_s,
    }[kind]


def _cooled(snap: FleetSnapshot, policy: SupervisorConfig, kind: str) -> bool:
    last = snap.last_action_t.get(kind)
    return last is None or (snap.now - last) >= _cooldown_of(policy, kind)


def _settled(snap: FleetSnapshot, window: float) -> bool:
    """No action of any kind within `window` seconds: a fresh replica's
    zero load is not evidence of idleness."""
    if not snap.last_action_t:
        return True
    return (snap.now - max(snap.last_action_t.values())) >= window


def plan_actions(snap: FleetSnapshot, policy: SupervisorConfig) -> list[Action]:
    """Pure policy: a snapshot to at most one action, the first that
    matches of (1) replace a dead or breaker-open replica, (2) re-role on
    a shift of the prefill share (a disaggregated fleet only), (3) scale
    up under pressure (queue depth, sheds, or util at the high mark), (4)
    scale down when idle (util at or below the low mark, no queue, no
    sheds). No plan takes the alive count below `min_replicas`; disruptive
    kinds wait while one is in flight; each kind keeps its cooldown, and a
    scale-down waits out a settle window after an action of any kind;
    spawns stop once the pending slot has crash-looped."""
    alive = [r for r in snap.replicas if r.alive]
    n_alive = len(alive)
    floor = max(1, policy.min_replicas)
    can_spawn = snap.spawn_failures < max(1, policy.spawn_max_attempts)

    # 1. replace: dead first, then breaker-open
    if not snap.disruptive_inflight and _cooled(snap, policy, "replace"):
        broken = [r for r in snap.replicas if not r.alive] + [
            r for r in alive if r.breaker_state == "open"]
        if broken:
            victim = broken[0]
            return [Action("replace", target=victim.addr, role=victim.role,
                           reason="dead" if not victim.alive else "breaker_open")]

    # 2. re-role, only in a fleet that already has roles
    disagg = any(r.role != "unified" for r in alive)
    if (policy.rerole_enabled and disagg and snap.prefill_share is not None
            and n_alive >= 2 and not snap.disruptive_inflight
            and _cooled(snap, policy, "rerole")):
        n_prefill = sum(1 for r in alive if r.role == "prefill")
        provisioned = n_prefill / n_alive
        mismatch = snap.prefill_share - provisioned
        if mismatch > policy.rerole_band:
            # flip the least loaded non-prefill replica, never the last one
            cands = sorted((r for r in alive if r.role != "prefill"),
                           key=lambda r: (r.load, r.addr))
            if len(cands) >= 2:
                return [Action("rerole", target=cands[0].addr, role="prefill",
                               reason=f"prefill_share={snap.prefill_share:.2f} "
                                      f"> provisioned={provisioned:.2f}")]
        elif mismatch < -policy.rerole_band and n_prefill >= 1:
            cands = sorted((r for r in alive if r.role == "prefill"),
                           key=lambda r: (r.load, r.addr))
            return [Action("rerole", target=cands[0].addr, role="decode",
                           reason=f"prefill_share={snap.prefill_share:.2f} "
                                  f"< provisioned={provisioned:.2f}")]

    # 3. scale up under pressure
    pressured = (snap.queue_depth >= max(1, policy.scale_up_queue_depth)
                 or snap.shed_rate > 0.0 or snap.util >= policy.scale_up_util)
    if (pressured and can_spawn and snap.pending_spawns == 0
            and n_alive + snap.pending_spawns < policy.max_replicas
            and _cooled(snap, policy, "scale_up")):
        return [Action("scale_up", role="decode" if disagg else "unified",
                       reason=f"queue={snap.queue_depth} shed_rate={snap.shed_rate:.2f}/s "
                              f"util={snap.util:.2f}")]

    # 4. scale down when idle; between the marks nothing is planned
    idle = snap.queue_depth == 0 and snap.shed_rate <= 0.0 and snap.util <= policy.scale_down_util
    if (idle and n_alive > floor and not snap.disruptive_inflight
            and _settled(snap, policy.scale_down_cooldown_s)):
        non_prefill = [r for r in alive if r.role != "prefill"]
        for victim in sorted(alive, key=lambda r: (r.load, r.addr)):
            if victim.role != "prefill" and len(non_prefill) <= 1:
                continue  # keep one decode-capable replica
            return [Action("scale_down", target=victim.addr,
                           reason=f"util={snap.util:.2f} <= {policy.scale_down_util:.2f}")]
    return []


# -- the executor -----------------------------------------------------------
class ReplicaHandle(Protocol):
    """What `spawn_fn` returns: a live replica's address and a way to end
    it."""

    addr: str

    def kill(self) -> None: ...


class _Slot:
    """One managed replica position: a live handle, or a pending (re)spawn
    with its backoff, or crash-looped."""

    __slots__ = ("slot_id", "role", "handle", "addr", "spawning", "fail_count",
                 "next_spawn_t", "crash_looped", "health_fails")

    def __init__(self, slot_id: int, role: str):
        self.slot_id = slot_id
        self.role = role
        self.handle: ReplicaHandle | None = None
        self.addr: str | None = None
        self.spawning = False
        self.fail_count = 0
        self.next_spawn_t = 0.0
        self.crash_looped = False
        self.health_fails = 0


class FleetSupervisor:
    """The control loop: construct, `adopt()` replicas that exist already,
    then `start()`."""

    def __init__(self, router_addr: str, spawn_fn: Callable[[str], ReplicaHandle], *,
                 config: SupervisorConfig | None = None, experiment_name: str = "",
                 trial_name: str = "", time_fn: Callable[[], float] = time.monotonic):
        self.config = config or SupervisorConfig()
        self.router_addr = router_addr
        self._spawn_fn = spawn_fn
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self._time = time_fn
        # jitter for spawn backoff: it breaks lockstep, the planner decides
        self._rng = random.Random(0xA5CA1E)
        self._slots: dict[int, _Slot] = {}
        self._next_slot_id = 0
        self._last_action_t: dict[str, float] = {}
        self._disruptive_task: threading.Thread | None = None
        self._last_tick_t: float | None = None
        self._prev_sheds: int | None = None
        # addr -> (prefill_secs_total, device_busy_s) at the last tick
        self._prev_secs: dict[str, tuple[float, float]] = {}
        self._prefill_share: float | None = None
        self._replica_seconds = 0.0
        self._counters: dict[str, int] = dict(
            ticks_total=0,
            scale_ups_total=0,
            scale_downs_total=0,
            replacements_total=0,
            reroles_total=0,
            crash_loops_total=0,
            drain_rollbacks_total=0,
            spawn_attempts_total=0,
            spawn_failures_total=0,
            kills_total=0,
            health_flaps_total=0,
        )
        self._gauges: dict[str, Any] = dict(
            fleet_size=0,
            fleet_alive=0,
            pending_spawns=0,
            crash_looped_slots=0,
            queue_depth=0,
            shed_rate=0.0,
            util=0.0,
            prefill_share=0.0,
            disruptive_inflight=0,
        )
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._tick_thread: threading.Thread | None = None
        self._workers: list[threading.Thread] = []
        self._httpd = None
        self._serve_thread: threading.Thread | None = None
        self.addr: str | None = None

    # -- fleet membership ------------------------------------------------
    def adopt(self, handle: ReplicaHandle, role: str = "unified") -> int:
        """Manage a replica that exists already (before `start`)."""
        with self._lock:
            slot = _Slot(self._next_slot_id, role)
            self._next_slot_id += 1
            slot.handle = handle
            slot.addr = handle.addr
            self._slots[slot.slot_id] = slot
            return slot.slot_id

    def _slot_by_addr_locked(self, addr: str | None) -> _Slot | None:
        for s in self._slots.values():
            if s.addr == addr and s.handle is not None:
                return s
        return None

    def _survivors_locked(self, exclude: _Slot) -> list[str]:
        thresh = max(1, self.config.health_fail_threshold)
        return [s.addr for s in sorted(self._slots.values(), key=lambda s: s.slot_id)
                if s is not exclude and s.handle is not None and s.addr
                and s.health_fails < thresh]

    # -- discovery ---------------------------------------------------------
    def _register(self, addr: str) -> None:
        if not (self.experiment_name and self.trial_name):
            return
        try:
            name_resolve.add(names.gen_server(self.experiment_name, self.trial_name, addr), addr,
                             keepalive_ttl=None, replace=True)
        except Exception as e:  # noqa: BLE001 — discovery is best effort
            logger.warning(f"register {addr} failed: {e!r}")

    def _deregister(self, addr: str | None) -> None:
        if not addr or not (self.experiment_name and self.trial_name):
            return
        try:
            name_resolve.delete(names.gen_server(self.experiment_name, self.trial_name, addr))
        except Exception as e:  # noqa: BLE001 — already gone is fine
            logger.debug(f"deregister {addr}: {e!r}")

    # -- polling -----------------------------------------------------------
    def _poll_router(self) -> dict[str, Any] | None:
        try:
            return request_with_retry(self.router_addr, "/metrics", method="GET",
                                      timeout=self.config.health_timeout_s, max_retries=1)
        except Exception as e:  # noqa: BLE001 — the tick goes on blind
            logger.warning(f"router metrics poll failed: {e!r}")
            return None

    def _probe_health(self, slot: _Slot) -> tuple[int, bool]:
        try:
            fault_injection.fire("supervisor.health", target=slot.addr or "")
            request_with_retry(slot.addr, "/health", method="GET",
                               timeout=self.config.health_timeout_s, max_retries=1)
            return slot.slot_id, True
        except Exception as e:  # noqa: BLE001 — a failed probe is the signal
            logger.debug(f"health probe {slot.addr}: {e!r}")
            return slot.slot_id, False

    def _poll_healths(self) -> list[tuple[int, bool]]:
        with self._lock:
            live = [s for s in self._slots.values() if s.handle is not None and s.addr]
        if not live:
            return []
        with concurrent.futures.ThreadPoolExecutor(len(live)) as pool:
            return list(pool.map(self._probe_health, live))

    def _fold_healths_locked(self, healths: list[tuple[int, bool]]) -> None:
        for sid, ok in healths:
            slot = self._slots.get(sid)
            if slot is None:
                continue
            if ok:
                # a blip that recovered before the dead mark is a flap
                if 0 < slot.health_fails < max(1, self.config.health_fail_threshold):
                    self._counters["health_flaps_total"] += 1
                slot.health_fails = 0
            else:
                slot.health_fails += 1

    # -- snapshot ----------------------------------------------------------
    def _snapshot_locked(self, now: float, dt: float,
                         router: dict[str, Any] | None) -> FleetSnapshot:
        cfg = self.config
        router = router or {}
        breaker = router.get("breaker") or {}
        token_loads = router.get("token_loads") or {}
        request_counts = router.get("request_counts") or {}
        roles = router.get("roles") or {}
        pressure = router.get("pressure") or {}
        thresh = max(1, cfg.health_fail_threshold)

        views = []
        for slot in sorted(self._slots.values(), key=lambda s: s.slot_id):
            if slot.handle is None or not slot.addr:
                continue
            b = breaker.get(slot.addr) or {}
            views.append(ReplicaView(
                addr=slot.addr, alive=slot.health_fails < thresh,
                role=str(roles.get(slot.addr, slot.role)),
                breaker_state=str(b.get("state", "closed")),
                load=float(token_loads.get(slot.addr, 0.0))))
        alive_addrs = [v.addr for v in views if v.alive]

        queue_depth = int(router.get("queue_depth", 0) or 0)
        sheds = int(router.get("queue_sheds_total", 0) or 0) + int(
            router.get("deadline_sheds_total", 0) or 0)
        shed_rate = 0.0
        if self._prev_sheds is not None and dt > 0:
            shed_rate = max(0, sheds - self._prev_sheds) / dt
        self._prev_sheds = sheds

        # util = demand / capacity: in-flight requests (the router's
        # accounting) plus the queue, against the per-replica target
        demand = sum(int(request_counts.get(a, 0) or 0) for a in alive_addrs) + queue_depth
        capacity = len(alive_addrs) * max(1, cfg.util_inflight_target)
        util = (demand / capacity) if capacity else (1.0 if demand else 0.0)

        # prefill share: prefill seconds over busy seconds, fleet-summed
        # deltas, smoothed
        d_pre = d_busy = 0.0
        for addr, p in pressure.items():
            try:
                pre = float(p.get("prefill_secs_total", 0.0) or 0.0)
                busy = float(p.get("device_busy_s", 0.0) or 0.0)
            except (TypeError, ValueError):
                continue
            prev = self._prev_secs.get(addr)
            if prev is not None:
                d_pre += max(0.0, pre - prev[0])
                d_busy += max(0.0, busy - prev[1])
            self._prev_secs[addr] = (pre, busy)
        for addr in list(self._prev_secs):
            if addr not in pressure:
                del self._prev_secs[addr]
        total = d_pre + d_busy
        if total > 0:
            inst = d_pre / total
            self._prefill_share = (inst if self._prefill_share is None
                                   else 0.5 * self._prefill_share + 0.5 * inst)

        pending = [s for s in self._slots.values() if s.handle is None and not s.crash_looped]
        spawn_failures = max((s.fail_count for s in self._slots.values() if s.handle is None),
                             default=0)
        return FleetSnapshot(
            now=now, replicas=tuple(views), queue_depth=queue_depth, shed_rate=shed_rate,
            util=util, prefill_share=self._prefill_share,
            last_action_t=dict(self._last_action_t),
            disruptive_inflight=(self._disruptive_task is not None
                                 and self._disruptive_task.is_alive()),
            spawn_failures=spawn_failures, pending_spawns=len(pending))

    # -- tick --------------------------------------------------------------
    def _tick(self) -> None:
        now = self._time()
        router = self._poll_router()
        healths = self._poll_healths()
        with self._lock:
            self._counters["ticks_total"] += 1
            dt = now - self._last_tick_t if self._last_tick_t is not None else 0.0
            self._last_tick_t = now
            self._fold_healths_locked(healths)
            snap = self._snapshot_locked(now, dt, router)
            n_alive = sum(1 for r in snap.replicas if r.alive)
            # replica-seconds: the capacity bill
            self._replica_seconds += n_alive * dt
            self._gauges.update(
                fleet_size=len(snap.replicas), fleet_alive=n_alive,
                pending_spawns=snap.pending_spawns,
                crash_looped_slots=sum(1 for s in self._slots.values() if s.crash_looped),
                queue_depth=snap.queue_depth, shed_rate=round(snap.shed_rate, 6),
                util=round(snap.util, 6), prefill_share=round(snap.prefill_share or 0.0, 6),
                disruptive_inflight=int(snap.disruptive_inflight))
            for act in plan_actions(snap, self.config):
                self._dispatch_locked(act, now)
            self._spawn_pending_locked(now)

    def _tick_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 — keep the loop alive
                logger.warning(f"supervisor tick error: {e!r}")
            self._stop.wait(self.config.tick_interval_s)

    def _worker(self, target, *args, name: str) -> threading.Thread:
        t = threading.Thread(target=target, args=args, daemon=True, name=name)
        self._workers = [w for w in self._workers if w.is_alive()] + [t]
        t.start()
        return t

    def _dispatch_locked(self, act: Action, now: float) -> None:
        if act.kind == "scale_up":
            slot = _Slot(self._next_slot_id, act.role)
            self._next_slot_id += 1
            slot.next_spawn_t = now
            self._slots[slot.slot_id] = slot
            self._last_action_t["scale_up"] = now
            self._counters["scale_ups_total"] += 1
            logger.info(f"scale_up -> slot {slot.slot_id} role={act.role} ({act.reason})")
            return
        if act.kind not in DISRUPTIVE_KINDS:
            logger.warning(f"unknown action kind {act.kind!r}")
            return
        if self._disruptive_task is not None and self._disruptive_task.is_alive():
            return  # one disruptive transition at a time
        slot = self._slot_by_addr_locked(act.target)
        if slot is None:
            return
        self._last_action_t[act.kind] = now
        logger.info(f"{act.kind} -> {act.target} ({act.reason})")
        self._disruptive_task = self._worker(self._run_disruptive, act, slot,
                                             name=f"supervisor-{act.kind}")

    # -- spawning ----------------------------------------------------------
    def _spawn_pending_locked(self, now: float) -> None:
        for slot in self._slots.values():
            if (slot.handle is None and not slot.crash_looped and not slot.spawning
                    and slot.next_spawn_t <= now):
                slot.spawning = True
                self._worker(self._spawn_slot, slot, name=f"supervisor-spawn-{slot.slot_id}")

    def _spawn_slot(self, slot: _Slot) -> None:
        cfg = self.config
        with self._lock:
            self._counters["spawn_attempts_total"] += 1
        try:
            fault_injection.fire("supervisor.spawn", slot=str(slot.slot_id), role=slot.role)
            handle = self._spawn_fn(slot.role)
        except Exception as e:  # noqa: BLE001 — a failed spawn is routine
            with self._lock:
                slot.spawning = False
                slot.fail_count += 1
                self._counters["spawn_failures_total"] += 1
                if slot.fail_count >= max(1, cfg.spawn_max_attempts):
                    # the crash loop: stop retrying, count it, degrade
                    slot.crash_looped = True
                    self._counters["crash_loops_total"] += 1
                    logger.warning(f"slot {slot.slot_id} CRASH-LOOPED after "
                                   f"{slot.fail_count} spawn failures: {e!r}")
                else:
                    backoff = min(cfg.spawn_backoff_max_s,
                                  cfg.spawn_backoff_s * (2 ** (slot.fail_count - 1)))
                    j = max(0.0, cfg.spawn_backoff_jitter)
                    if j:
                        backoff *= self._rng.uniform(1 - j, 1 + j)
                    slot.next_spawn_t = self._time() + backoff
                    logger.warning(f"spawn attempt {slot.fail_count} for slot {slot.slot_id} "
                                   f"failed: {e!r}; retry in {backoff:.2f}s")
            return
        with self._lock:
            slot.spawning = False
            slot.handle = handle
            slot.addr = handle.addr
            slot.fail_count = 0
            slot.health_fails = 0
            peers = [s.addr for s in self._slots.values()
                     if s.addr and s.addr != handle.addr and s.handle is not None]
        # the new replica's boot configuration, logged: a mixed fleet
        # (kv_dtype, weight_dtype) refuses its peers' sessions
        try:
            info = request_with_retry(handle.addr, "/info", method="GET", max_retries=1,
                                      timeout=5)
            logger.info(f"replica {handle.addr} booted: role={info.get('role')} "
                        f"kv_layout={info.get('kv_layout')} kv_dtype={info.get('kv_dtype')} "
                        f"weight_dtype={info.get('weight_dtype')} "
                        f"version={info.get('version')}")
        except Exception as e:  # noqa: BLE001 — observability only
            logger.debug(f"/info probe of {handle.addr} failed: {e!r}")
        if peers and cfg.kv_fabric:
            # the warm start: the siblings' longest runs land in the new
            # replica's host tier before the router sends it traffic; a
            # failure is a cold cache
            try:
                out = request_with_retry(
                    handle.addr, "/warm_start",
                    payload={"peers": peers, "max_sessions": int(cfg.warm_start_sessions)},
                    timeout=cfg.drain_deadline_s, max_retries=1)
                logger.info(f"slot {slot.slot_id} warm start: {out.get('sessions', 0)} "
                            f"sessions, {out.get('bytes', 0)} bytes from {len(peers)} peers")
            except Exception as e:  # noqa: BLE001 — a cold start is fine
                logger.warning(f"warm start of {handle.addr} failed: {e!r}")
        self._register(handle.addr)
        logger.info(f"slot {slot.slot_id} spawned {handle.addr} role={slot.role}")

    # -- disruptive transitions --------------------------------------------
    def _run_disruptive(self, act: Action, slot: _Slot) -> None:
        try:
            if act.kind == "scale_down":
                self._do_scale_down(slot)
            elif act.kind == "replace":
                self._do_replace(slot)
            elif act.kind == "rerole":
                self._do_rerole(slot, act.role)
        except Exception as e:  # noqa: BLE001 — a later tick replans
            logger.warning(f"{act.kind} of {slot.addr} failed: {e!r}")

    def _refetchable_digest(self, survivors: list[str], victim: str | None) -> str | None:
        """The union of the survivors' advertised content keys (their
        `kv_fabric_digest` in the router's pressure snapshots): a session
        whose blocks all lie in it drains as identity only, since a
        survivor serves the bytes again over /kv_fetch."""
        router = self._poll_router()
        if not router:
            return None
        alive = set(survivors)
        keys: set[int] = set()
        for s, p in (router.get("pressure") or {}).items():
            if s == victim or s not in alive:
                continue
            dig = (p or {}).get("kv_fabric_digest")
            if dig:
                keys |= set(kv_fabric.decode_digest(dig))
        if not keys:
            return None
        return kv_fabric.encode_digest(sorted(keys), cap=kv_fabric.DIGEST_HARD_CAP)

    def _drain(self, slot: _Slot, survivors: list[str]) -> bool:
        """POST /drain within drain_deadline_s: True once it committed
        (every exportable session landed on a survivor), False when it
        failed or ran past the deadline (the caller rolls back). The
        `supervisor.drain` seam sits inside the deadline, and a drain whose
        deadline passed before it was sent is never sent."""
        payload: dict[str, Any] = {"targets": survivors}
        if self.config.kv_fabric:
            try:
                refetchable = self._refetchable_digest(survivors, slot.addr)
            except Exception as e:  # noqa: BLE001 — a full drain is always right
                logger.debug(f"refetchable digest unavailable: {e!r}")
                refetchable = None
            if refetchable:
                payload["refetchable"] = refetchable
        expired = threading.Event()
        out: dict[str, Any] = {}

        def call():
            try:
                fault_injection.fire("supervisor.drain", target=slot.addr or "")
                if expired.is_set():
                    return
                out["resp"] = request_with_retry(slot.addr, "/drain", payload=payload,
                                                 timeout=self.config.drain_deadline_s,
                                                 max_retries=1)
            except Exception as e:  # noqa: BLE001 — a failed drain aborts
                out["err"] = e

        t = threading.Thread(target=call, daemon=True, name="supervisor-drain-call")
        t.start()
        t.join(self.config.drain_deadline_s)
        if t.is_alive():
            expired.set()
            logger.warning(f"drain of {slot.addr} did not commit within "
                           f"{self.config.drain_deadline_s}s")
            return False
        if "err" in out:
            logger.warning(f"drain of {slot.addr} did not commit: {out['err']!r}")
            return False
        resp = out.get("resp")
        return bool(resp) and resp.get("status") == "ok"

    def _kill(self, slot: _Slot) -> None:
        fault_injection.fire("supervisor.kill", target=slot.addr or "")
        self._deregister(slot.addr)
        h = slot.handle
        if h is not None:
            try:
                h.kill()
            except Exception as e:  # noqa: BLE001 — killing the dead is fine
                logger.debug(f"kill of {slot.addr}: {e!r}")
        with self._lock:
            self._counters["kills_total"] += 1

    def _do_scale_down(self, slot: _Slot) -> None:
        with self._lock:
            survivors = self._survivors_locked(slot)
            if len(survivors) < max(1, self.config.min_replicas):
                return  # the floor, again at run time
        if not self._drain(slot, survivors):
            with self._lock:
                self._counters["drain_rollbacks_total"] += 1
            logger.warning(f"scale_down of {slot.addr} rolled back (drain aborted)")
            return
        self._kill(slot)
        with self._lock:
            self._slots.pop(slot.slot_id, None)
            self._counters["scale_downs_total"] += 1
        logger.info(f"scale_down committed: {slot.addr} retired")

    def _do_replace(self, slot: _Slot) -> None:
        with self._lock:
            survivors = self._survivors_locked(slot)
            reachable = slot.health_fails < max(1, self.config.health_fail_threshold)
        if survivors and reachable:
            # breaker-open but answering: salvage its sessions first; a
            # failed drain does not stop the replace
            self._drain(slot, survivors)
        self._kill(slot)
        with self._lock:
            old = slot.addr
            slot.handle = None
            slot.addr = None
            slot.fail_count = 0
            slot.health_fails = 0
            slot.next_spawn_t = self._time()
            self._counters["replacements_total"] += 1
        logger.info(f"replace: {old} killed; slot {slot.slot_id} respawning")

    def _do_rerole(self, slot: _Slot, new_role: str) -> None:
        with self._lock:
            survivors = self._survivors_locked(slot)
        if not survivors:
            return
        if not self._drain(slot, survivors):
            with self._lock:
                self._counters["drain_rollbacks_total"] += 1
            logger.warning(f"rerole of {slot.addr} rolled back (drain aborted)")
            return
        resp = request_with_retry(slot.addr, "/set_role", payload={"role": new_role},
                                  timeout=self.config.health_timeout_s, max_retries=2)
        if resp.get("status") == "ok":
            with self._lock:
                slot.role = new_role
                self._counters["reroles_total"] += 1
            logger.info(f"rerole committed: {slot.addr} -> {new_role}")

    # -- observability -----------------------------------------------------
    def get_metrics(self) -> dict[str, Any]:
        """Action counters and the last tick's fleet gauges (dict copies of
        scalars, read without the lock)."""
        return {
            **self._counters,
            **self._gauges,
            "replica_seconds": round(self._replica_seconds, 3),
            "min_replicas": self.config.min_replicas,
            "max_replicas": self.config.max_replicas,
        }

    def handle(self, method: str, path: str, query: dict, body: bytearray) -> dict:
        if method == "GET" and path == "/health":
            return {"status": "ok"}
        if method == "GET" and path == "/supervisor":
            thresh = max(1, self.config.health_fail_threshold)
            with self._lock:
                out = dict(self.get_metrics())
                out["slots"] = [
                    {"slot_id": s.slot_id, "role": s.role, "addr": s.addr,
                     "alive": s.handle is not None and s.health_fails < thresh,
                     "spawning": s.spawning, "fail_count": s.fail_count,
                     "crash_looped": s.crash_looped, "health_fails": s.health_fails}
                    for s in sorted(self._slots.values(), key=lambda s: s.slot_id)
                ]
            return out
        raise _Reply(404, f"no route {method} {path}")

    # -- lifecycle ---------------------------------------------------------
    def start(self, host: str = "0.0.0.0", port: int = 0) -> str:
        with self._lock:
            addrs = [s.addr for s in self._slots.values() if s.addr]
        for addr in addrs:
            self._register(addr)
        self._httpd, self._serve_thread, self.addr = serve_app(self, host, port,
                                                               "supervisor-http")
        self._stop.clear()
        self._tick_thread = threading.Thread(target=self._tick_loop, daemon=True,
                                             name="supervisor-tick")
        self._tick_thread.start()
        logger.info(f"fleet supervisor on {self.addr} (router {self.router_addr})")
        return self.addr

    def stop(self, timeout: float = 60.0) -> None:
        """Stop ticking and wait for the transition and spawns in flight."""
        self._stop.set()
        if self._tick_thread is not None:
            self._tick_thread.join(timeout=timeout)
            self._tick_thread = None
        for w in list(self._workers):
            w.join(timeout=timeout)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.close_connections()
            self._httpd.server_close()
            self._httpd = None
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10)
            self._serve_thread = None


def main(argv: list[str] | None = None) -> None:
    """A supervisor over a `LocalLauncher` fleet: spawned replicas are
    decode-server subprocesses that register themselves."""
    from areal_tpu_torch.launcher.local import LocalLauncher

    p = argparse.ArgumentParser(description="areal_tpu_torch fleet supervisor")
    p.add_argument("--experiment-name", required=True)
    p.add_argument("--trial-name", required=True)
    p.add_argument("--router", required=True, help="router host:port")
    p.add_argument("--model-path", required=True)
    p.add_argument("--fileroot", default="/tmp/areal_tpu")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--max-replicas", type=int, default=8)
    p.add_argument("--tick-interval", dest="tick_interval_s", type=float, default=1.0)
    p.add_argument("--server-arg", action="append", default=[],
                   help="extra decode_server flag, passed on as it is (repeatable)")
    args = p.parse_args(argv)
    name_resolve.reconfigure_from_env()
    launcher = LocalLauncher(args.experiment_name, args.trial_name, args.fileroot)

    def spawn(role: str) -> ReplicaHandle:
        return launcher.spawn_decode_server(role, model_path=args.model_path,
                                            extra_args=list(args.server_arg))

    sup = FleetSupervisor(
        args.router, spawn,
        config=SupervisorConfig(enabled=True, min_replicas=args.min_replicas,
                                max_replicas=args.max_replicas,
                                tick_interval_s=args.tick_interval_s),
        experiment_name=args.experiment_name, trial_name=args.trial_name)
    sup.start(host=args.host, port=args.port)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        sup.stop()
        launcher.stop_all()


if __name__ == "__main__":
    main()
