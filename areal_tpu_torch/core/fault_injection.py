"""Deterministic fault injection (counterpart of
`areal_tpu/core/fault_injection.py`): named seams at the boundaries of the
rollout stack, and a seed-driven plan that perturbs them reproducibly, so
a run can be killed, slowed or torn at a chosen point and the
exactly-once and bit-identical-stream invariants checked after it.

The plan format, the seam names, the modes and the decisions are the JAX
module's: the same plan over the same sequence of seam visits raises,
sleeps and tears at the same visits, with the same delays and tear
lengths, and counts the same in `snapshot()`.

Seams in the port (grep for `fault_injection.fire(` / `.afire(` / `.tear(`):

  client.http.send      utils/http.py        before the request leaves —
                                             an abort means the server
                                             never saw it (no effect)
  client.http.recv      utils/http.py        after a 2xx response arrived —
                                             the ERROR-AFTER-EFFECT shape:
                                             the side effect landed, the
                                             reply is lost, and only the
                                             server's idempotency table
                                             saves the retry
  client.http.body      utils/http.py        torn/truncated response body
  client.weights.stage  core/remote_inf_engine.py  per staged frame
  server.generate       launcher/decode_server.py  before the engine runs
  server.prefill        launcher/decode_server.py  /prefill, before the
                                             engine runs
  server.weights.stage  launcher/decode_server.py  per received frame
  server.weights.commit launcher/decode_server.py  before the install
                                             (outside `_ctl_lock`)
  weight.stage.add      core/weight_transfer.py    WeightStaging.add_bucket
                                             (fire and tear: a torn frame
                                             fails the manifest length
                                             check before a byte stages)
  task.run              core/async_task_runner.py  rollout task execution
  recover.dump.save     utils/recover.py     the tmp dir exists, nothing
                                             written into it yet
  recover.dump.info     utils/recover.py     between the engine checkpoint
                                             and recover_info.pkl
  recover.dump.marker   utils/recover.py     between the fsynced manifest
                                             and the atomic rename
  recover.load          utils/recover.py     per load candidate (an abort
                                             is a torn candidate: the walk
                                             falls back to the next-older
                                             committed step)
  train.step            engine/torch_engine.py  top of train_batch, before
                                             any optimizer work
  train.weights.push    engine/torch_engine.py  update_weights entry
  dataloader.next       dataset/__init__.py  before each batch is yielded
                                             (the restored position
                                             re-yields it)
  kv.swap_out           engine/kv_pool.py    HostKVStore.put (the D2H
                                             offload of a parked or
                                             preempted slot's blocks)
  kv.swap_in            engine/kv_pool.py    HostKVStore.take (promotion)
  kv.migrate.send       launcher/decode_server.py  before each frame a
                                             migration sends (an abort is
                                             the sender dying: the replay
                                             under the same xid lands once)
  kv.migrate.recv       launcher/decode_server.py  per received frame (fire
                                             and tear: a torn frame is
                                             refused before a byte stages)
  router.poll           launcher/router.py   before each server's health
                                             probe (an abort is a failed
                                             poll)
  router.schedule       launcher/router.py   top of /schedule_request (an
                                             abort: the client falls back
                                             to its local policy)
  supervisor.health     launcher/supervisor.py  before each replica probe
  supervisor.spawn      launcher/supervisor.py  before each spawn attempt
                                             (an abort is a spawn failure)
  supervisor.drain      launcher/supervisor.py  inside the drain deadline (a
                                             delay is a hung drain)
  supervisor.kill       launcher/supervisor.py  after a committed drain,
                                             before the kill

Fault modes:

  abort               raise InjectedFault (at a pre-effect seam: clean loss)
  error_after_effect  raise InjectedFault at a post-effect seam; the name
                      documents intent, the mechanics equal `abort`
  delay               fixed + seed-jittered sleep (a slow component)
  torn                truncate a payload at a seeded fraction; only
                      `tear()` honours torn points (fire/afire skip them
                      without consuming a hit, so a seam that calls both
                      keeps its abort and torn points independent)

Determinism: every draw (probability gates, jitter, tear fraction) comes
from a per-point `random.Random(seed * 1_000_003 + index)` stream, and
the hit counters are serialized under one lock.

The injector is process-global (`configure` / `deactivate`); when none is
armed each seam costs one `is None` check. `configure_from_config` arms
it from a `FaultInjectionConfig` (`rollout.fault_injection`): the remote
client and the in-process decode engine call it at construction, and a
disabled config leaves an armed injector as it is.
"""

from __future__ import annotations

import asyncio
import fnmatch
import json
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any

from areal_tpu_torch.utils import logging

logger = logging.getLogger("fault_injection")


class InjectedFault(RuntimeError):
    """A fault raised by the injector at a registered seam."""

    def __init__(self, site: str, mode: str, point: "FaultPoint"):
        super().__init__(f"injected {mode} at {site} (point {point.site!r})")
        self.site = site
        self.mode = mode
        self.point = point


_MODES = ("abort", "error_after_effect", "delay", "torn")


@dataclass
class FaultPoint:
    """One entry of a fault plan.

    site:     fnmatch pattern over seam names ("client.http.*").
    mode:     one of abort / error_after_effect / delay / torn.
    at:       explicit 0-based hit indices of the matching seam at which to
              fire (empty = every hit, or probability `p` when set).
    p:        per-hit firing probability from the point's seeded stream
              (used only when `at` is empty).
    times:    max total firings (0 = unlimited — "repeated failure", the
              shape that must trip breaker/failover escalation).
    delay_s:  base sleep for mode="delay".
    jitter_s: extra uniform-[0, jitter_s) sleep from the seeded stream.
    match:    {ctx_key: substring} filters — the seam's context values
              (endpoint, addr, rid, ...) must contain every substring.
    """

    site: str
    mode: str = "abort"
    at: tuple[int, ...] = ()
    p: float = 0.0
    times: int = 1
    delay_s: float = 0.0
    jitter_s: float = 0.0
    match: dict[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.mode not in _MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; one of {_MODES}")
        self.at = tuple(int(i) for i in self.at)


@dataclass
class FaultPlan:
    """A seed plus an ordered list of fault points."""

    seed: int = 0
    points: list[FaultPoint] = field(default_factory=list)

    @classmethod
    def from_json(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Parse `[{"site": ..., "mode": ..., ...}, ...]` (the
        `FaultInjectionConfig.plan` wire format)."""
        data = json.loads(text)
        if isinstance(data, dict):
            seed = int(data.get("seed", seed))
            data = data.get("points", [])
        pts = []
        for d in data:
            d = dict(d)
            if "at" in d:
                d["at"] = tuple(d["at"])
            pts.append(FaultPoint(**d))
        return cls(seed=seed, points=pts)

    @classmethod
    def from_config(cls, cfg: Any) -> "FaultPlan | None":
        """Build from an `api.cli_args.FaultInjectionConfig`; None when
        disabled or the plan is empty."""
        if not getattr(cfg, "enabled", False):
            return None
        plan_text = getattr(cfg, "plan", "") or "[]"
        return cls.from_json(plan_text, seed=int(getattr(cfg, "seed", 0)))


class _Armed:
    """One fault point armed with its own deterministic RNG + counters."""

    __slots__ = ("point", "rng", "hits", "fired")

    def __init__(self, point: FaultPoint, seed: int, index: int):
        self.point = point
        # mix the plan seed with the point index so each point owns an
        # independent deterministic stream (tuple seeding is py<3.11 only)
        self.rng = random.Random(seed * 1_000_003 + index)
        self.hits = 0
        self.fired = 0


@dataclass
class _Action:
    mode: str
    point: FaultPoint
    sleep_s: float = 0.0
    tear_frac: float = 1.0


class FaultInjector:
    """Evaluates a FaultPlan at seam visits. Thread-safe: seams are hit
    from asyncio loops, the decode scheduler thread, and trainer threads;
    one lock serializes the hit counters and RNG draws."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._armed = [
            _Armed(p, plan.seed, i) for i, p in enumerate(plan.points)
        ]
        self._lock = threading.Lock()
        # (site, mode) -> fired count: the degradation evidence chaos
        # benches report next to recovery latency
        self.counters: dict[str, int] = {}

    # -- decision -------------------------------------------------------
    def _decide(
        self, site: str, ctx: dict[str, Any], modes: tuple[str, ...]
    ) -> _Action | None:
        """First matching armed point wins. A point's hit counter counts
        the visits that REACH it under an applicable entry point — points
        whose mode the entry point cannot express (`torn` at fire/afire,
        everything else at tear) are skipped without consuming a hit, and
        an earlier point that fires short-circuits the scan."""
        with self._lock:
            for a in self._armed:
                pt = a.point
                if pt.mode not in modes:
                    continue
                if not fnmatch.fnmatch(site, pt.site):
                    continue
                if any(
                    sub not in str(ctx.get(k, "")) for k, sub in pt.match.items()
                ):
                    continue
                hit = a.hits
                a.hits += 1
                if pt.times and a.fired >= pt.times:
                    continue
                if pt.at:
                    if hit not in pt.at:
                        continue
                elif pt.p > 0.0 and a.rng.random() >= pt.p:
                    continue
                a.fired += 1
                key = f"{site}|{pt.mode}"
                self.counters[key] = self.counters.get(key, 0) + 1
                sleep_s = pt.delay_s
                if pt.jitter_s > 0.0:
                    sleep_s += a.rng.uniform(0.0, pt.jitter_s)
                return _Action(
                    mode=pt.mode,
                    point=pt,
                    sleep_s=sleep_s,
                    tear_frac=a.rng.uniform(0.1, 0.9),
                )
        return None

    _FIRE_MODES = ("abort", "error_after_effect", "delay")

    # -- seam entry points ---------------------------------------------
    def fire(self, site: str, **ctx: Any) -> None:
        """Synchronous seam: sleep for delay faults, raise for aborts;
        torn points wait for the seam's `tear()` stage."""
        act = self._decide(site, ctx, self._FIRE_MODES)
        if act is None:
            return
        if act.mode == "delay":
            logger.warning(f"fault: delay {act.sleep_s:.3f}s at {site}")
            time.sleep(act.sleep_s)
            return
        logger.warning(f"fault: {act.mode} at {site} ({ctx})")
        raise InjectedFault(site, act.mode, act.point)

    async def afire(self, site: str, **ctx: Any) -> None:
        """Async seam twin of `fire` (delays await instead of blocking
        the event loop)."""
        act = self._decide(site, ctx, self._FIRE_MODES)
        if act is None:
            return
        if act.mode == "delay":
            logger.warning(f"fault: delay {act.sleep_s:.3f}s at {site}")
            await asyncio.sleep(act.sleep_s)
            return
        logger.warning(f"fault: {act.mode} at {site} ({ctx})")
        raise InjectedFault(site, act.mode, act.point)

    def tear(self, site: str, data, **ctx: Any):
        """Payload seam: a torn-mode point truncates `data` (str/bytes)
        at a seeded fraction; other modes are not considered here (they
        belong to fire/afire seams and keep their hit counters)."""
        act = self._decide(site, ctx, ("torn",))
        if act is None:
            return data
        cut = max(1, int(len(data) * act.tear_frac)) if len(data) else 0
        logger.warning(
            f"fault: torn payload at {site} ({len(data)} -> {cut} bytes)"
        )
        return data[:cut]

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self.counters)


# -- process-global injector -------------------------------------------------

_INJECTOR: FaultInjector | None = None


def configure(plan: FaultPlan | FaultInjector | None) -> FaultInjector | None:
    """Install (or clear, with None) the process-global injector."""
    global _INJECTOR
    if plan is None:
        _INJECTOR = None
    elif isinstance(plan, FaultInjector):
        _INJECTOR = plan
    else:
        _INJECTOR = FaultInjector(plan)
    return _INJECTOR


def deactivate() -> None:
    configure(None)


def get() -> FaultInjector | None:
    """The active injector, or None. Seams use this as their fast path:
    `inj = fault_injection.get();  if inj is not None: inj.fire(...)`."""
    return _INJECTOR


def fire(site: str, **ctx: Any) -> None:
    if _INJECTOR is not None:
        _INJECTOR.fire(site, **ctx)


async def afire(site: str, **ctx: Any) -> None:
    if _INJECTOR is not None:
        await _INJECTOR.afire(site, **ctx)


def tear(site: str, data, **ctx: Any):
    if _INJECTOR is not None:
        return _INJECTOR.tear(site, data, **ctx)
    return data


def snapshot() -> dict[str, int]:
    return _INJECTOR.snapshot() if _INJECTOR is not None else {}


def configure_from_config(cfg: Any) -> FaultInjector | None:
    """Arm the process-global injector from a `FaultInjectionConfig`
    (JAX `RemoteInfEngine.__init__`, :135-139). A disabled config leaves
    the current injector as it is."""
    plan = FaultPlan.from_config(cfg)
    if plan is None:
        return None
    inj = configure(plan)
    logger.warning(
        f"fault injection ARMED: seed={plan.seed} {len(plan.points)} point(s) — "
        f"chaos testing only"
    )
    return inj
