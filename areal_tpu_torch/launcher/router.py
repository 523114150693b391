"""Decode-fleet router (counterpart of `areal_tpu/launcher/router.py`):
prefix-affinity scheduling, pressure-aware admission with a bounded
queue, and exactly-once failover, over decode servers of either package.

- **/schedule_request**: pick a server for a new generation request by
  policy — `prefix_affinity` (default), `round_robin`, `least_requests`
  or `least_token_usage` — with qid affinity (the samples of one prompt
  group land on one server, so its prefix cache works). A request that
  resumes on the same weight version keeps its previous server.
  `prefix_affinity` also hashes the prompt's prefix at block granularity
  (`prefix_block_tokens` x 1..`prefix_max_blocks`, longest match first)
  into a per-server affinity map, overridden when the affine server is hot
  (`affinity_load_factor`).

  Admission is pressure-aware: each health poll snapshots every replica's
  pool occupancy and fragmentation, host-tier state and in-flight depth
  from its `/metrics`; a request that would overflow every replica's pool
  waits in a bounded FIFO, shed with 429 and Retry-After past `queue_max`
  or its deadline (the client's `deadline_s` bounds the hold).

- **/allocate_rollout** and **/finish_rollout**: the server-side
  staleness gate: (trainer-consumed samples, published under
  `names.training_samples`, + running rollouts) // train_batch_size must
  not pass the fleet's weight version + max_head_offpolicyness.
- **/finish_request**: release one unit of a qid's load accounting.
- **/metrics**: queue depth, sheds, affinity hit rate, requeues, the
  breaker, and the per-server pressure snapshots admission acts on.

**Failover**: `dead_after_failures` consecutive failed health polls declare
a replica dead; its in-flight qids are requeued onto the least-loaded
survivors and its affinity entries drained. With the servers' xid tables,
a client's retry never generates or counts a rollout twice. A per-replica
circuit breaker trips after `breaker_trip_after` bad polls (failed, slow or
metrics-erroring), probes half-open and closes when a probe request
finishes.

**The KV fabric** (`kv_fabric`, JAX :395-412, :699-744, :895-983): each
poll's `kv_fabric_digest` becomes the replica's entry in the fabric
index (dropped on failover). With no affinity entry, `prefix_affinity`
routes to a candidate that holds a resident run of the prompt's chain
(`fabric_local_routes_total`); and when another replica holds a longer
run than the chosen one, the placement carries a `kv_fabric` hint
({"peer", "keys"}), priced at `kv_fabric_fetch_cost_factor` of a prefill,
which the decode server acts on before admission
(`fabric_remote_hints_total`).

**Roles** (JAX :745-860). With prefill-role and decode-role replicas
alive, `_pick_disagg_locked` picks a decode home by pool headroom,
charged only the decode share, and a prefill replica by prefix affinity,
charged the prompt; the placement's `prefill_url` tells the client to
hand off (`disagg_schedules_total`). With every prefill replica
saturated, no `prefill_url` is given and the decode replica prefills.

The same decisions as the JAX router, fleet for fleet.

Threading. JAX runs every handler and the poll loop on one event loop
under an `asyncio.Lock`; here `ThreadingHTTPServer` runs each connection on
a thread, the poll loop runs on a daemon thread, and one `threading.Lock`
guards the same fields (`_GUARDED_BY`). No handler blocks on a replica
while holding it. A queued `/schedule_request` waits on its own
`threading.Event`, bounded by its hold time.

Fault seams (`core/fault_injection.py`, JAX :303, :1016): `router.poll`
before each server's health probe (an abort is a failed poll) and
`router.schedule` at the top of `/schedule_request` (an abort answers
500; the client falls back to its local policy).

Run: ``python -m areal_tpu_torch.launcher.router --experiment-name e
--trial-name t`` (servers discovered through name_resolve, the router
registered under `names.rollout_router`) or ``--servers host:p1,host:p2``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import signal
import threading
import time
from collections import OrderedDict, defaultdict, deque
from typing import Any

from areal_tpu_torch.api.cli_args import RouterConfig
from areal_tpu_torch.core import fault_injection, kv_fabric
from areal_tpu_torch.launcher.decode_server import _Reply, serve_app
from areal_tpu_torch.utils import logging, name_resolve, names
from areal_tpu_torch.utils.http import request_with_retry

logger = logging.getLogger("rollout_router")

# consecutive /metrics failures before a server's measured token load is
# dropped (least_token_usage then uses the router's own estimate)
_METRICS_FAIL_LIMIT = 3

# fields of the routing state; every access holds `_lock`
_GUARDED_BY = {
    "DecodeRouter._rr": "_lock",
    "DecodeRouter._request_counts": "_lock",
    "DecodeRouter._token_usage": "_lock",
    "DecodeRouter._measured_tokens": "_lock",
    "DecodeRouter._est_since_poll": "_lock",
    "DecodeRouter._metrics_fail": "_lock",
    "DecodeRouter._health_fail": "_lock",
    "DecodeRouter._pressure": "_lock",
    "DecodeRouter._qid_to_server": "_lock",
    "DecodeRouter._qid_cost": "_lock",
    "DecodeRouter._qid_pending": "_lock",
    "DecodeRouter._qid_touched": "_lock",
    "DecodeRouter._prefix_map": "_lock",
    "DecodeRouter._waitq": "_lock",
    "DecodeRouter._counters": "_lock",
    "DecodeRouter._versions": "_lock",
    "DecodeRouter._running": "_lock",
    "DecodeRouter._submitted": "_lock",
    "DecodeRouter._accepted": "_lock",
    "DecodeRouter._breaker": "_lock",
    "DecodeRouter._roles": "_lock",
    "DecodeRouter._fabric_index": "_lock",
}

# /metrics keys the admission controller snapshots per replica (JAX
# :110-147)
_PRESSURE_KEYS = (
    "running_requests",
    "queued_requests",
    "queued_tokens",
    "active_tokens",
    "kv_block_size",
    "kv_blocks_total",
    "kv_blocks_free",
    "kv_pool_fragmentation",
    "kv_tokens_allocated",
    "kv_host_pool_enabled",
    "kv_host_pool_occupancy",
    "prefix_cache_hit_rate",
    # the fabric: the digest feeds the fetch hints, the counters the fleet
    # sums on /metrics
    "kv_dtype",
    "kv_fabric_digest",
    "kv_fabric_local_hits_total",
    "kv_fabric_remote_hits_total",
    "kv_fabric_fetch_bytes_total",
    "reprefill_tokens_avoided_total",
    "role",
    "kv_migrated_in_sessions_total",
    "kv_migrated_out_sessions_total",
    "kv_migrated_in_bytes_total",
    "kv_migrated_out_bytes_total",
    "kv_migrate_version_rejects_total",
    "ttft_prefill_p99_ms",
    "ttft_transfer_p99_ms",
    "prefill_secs_total",
    "device_busy_s",
)

class _Waiter:
    """One queued /schedule_request: placed by the queue's drain, or shed."""

    __slots__ = ("event", "result", "req")

    def __init__(self, req: dict):
        self.event = threading.Event()
        self.result: dict | None = None
        self.req = req

    def done(self) -> bool:
        return self.event.is_set()


class DecodeRouter:
    def __init__(self, experiment_name: str = "", trial_name: str = "",
                 servers: list[str] | None = None, *, config: RouterConfig | None = None,
                 **overrides: Any):
        cfg = config or RouterConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.config = cfg
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.schedule_policy = cfg.schedule_policy
        self.max_concurrent_rollouts = cfg.max_concurrent_rollouts
        self.max_head_offpolicyness = cfg.max_head_offpolicyness
        self.train_batch_size = max(1, cfg.train_batch_size)
        self.health_poll_interval = cfg.health_poll_interval

        self._seed_servers: list[str] = list(servers or [])
        self.servers: list[str] = list(self._seed_servers)
        self._rr = 0
        self._request_counts: dict[str, int] = defaultdict(int)
        self._token_usage: dict[str, float] = defaultdict(float)
        # least_token_usage inputs: each server's measured active tokens
        # (refreshed per poll) plus the estimated cost routed since
        self._measured_tokens: dict[str, float] = {}
        self._est_since_poll: dict[str, float] = defaultdict(float)
        self._metrics_fail: dict[str, int] = defaultdict(int)
        # consecutive failed health polls: reaching dead_after_failures
        # fails the replica over, once
        self._health_fail: dict[str, int] = defaultdict(int)
        self._pressure: dict[str, dict[str, Any]] = {}
        self._qid_to_server: dict[str, str] = {}
        self._qid_cost: dict[str, float] = {}
        # one qid may carry several in-flight requests (a group shares its
        # prompt's rid); each finish releases one unit
        self._qid_pending: dict[str, int] = {}
        self._qid_touched: dict[str, float] = {}
        # prefix key -> (server, last used), recency-ordered (LRU + TTL)
        self._prefix_map: OrderedDict[int, tuple[str, float]] = OrderedDict()
        self._waitq: deque[_Waiter] = deque()
        self._counters: dict[str, int] = dict(
            schedules_total=0,
            affinity_hits_total=0,
            affinity_overrides_total=0,
            queue_enqueues_total=0,
            queue_admits_total=0,
            queue_sheds_total=0,
            queue_timeouts_total=0,
            client_requeues_total=0,
            requeues_total=0,
            failovers_total=0,
            expired_qids_total=0,
            expired_prefixes_total=0,
            breaker_trips_total=0,
            breaker_probes_total=0,
            breaker_probe_expiries_total=0,
            breaker_closes_total=0,
            deadline_sheds_total=0,
            disagg_schedules_total=0,
            fabric_local_routes_total=0,
            fabric_remote_hints_total=0,
        )
        # replica role from /health: a fleet with prefill and decode
        # replicas alive schedules prefill by prefix affinity and decode by
        # pool headroom
        self._roles: dict[str, str] = {}
        # the fabric index: each replica's advertised content keys (its
        # last digest; a key it evicted drops out at the next poll)
        self._fabric_index: dict[str, set[int]] = {}
        # per-replica circuit breaker: state closed / open / half_open,
        # `bad` consecutive bad polls, `probes` in-flight half-open probe
        # requests, `probe_t` the last probe's charge (expired after
        # breaker_probe_ttl_s so a probe whose client died cannot wedge
        # the breaker half-open)
        self._breaker: dict[str, dict[str, Any]] = defaultdict(
            lambda: {"state": "closed", "bad": 0, "probes": 0, "probe_t": 0.0}
        )
        self._versions: dict[str, int] = {}
        self._running = 0
        self._submitted = 0
        self._accepted = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._poll_thread: threading.Thread | None = None
        self._httpd = None
        self._serve_thread: threading.Thread | None = None
        self.addr: str | None = None

    # -- fleet state ----------------------------------------------------
    def _discover(self) -> list[str]:
        # the seed list stays: a server dropped after a failed poll comes
        # back once healthy
        found: list[str] = []
        if self.experiment_name and self.trial_name:
            try:
                found = name_resolve.get_subtree(
                    names.gen_servers(self.experiment_name, self.trial_name))
            except Exception as e:  # noqa: BLE001 — discovery is best effort
                logger.debug(f"server discovery failed: {e!r}")
        return sorted(set(self._seed_servers) | set(found))

    def _probe(self, s: str) -> tuple:
        """Health and metrics of one server, with the since-poll estimate
        read at fetch time (requests routed after it must survive the
        subtraction) and the health round trip (the breaker's slow
        signal): (server, version, load, est, pressure, rtt, role)."""
        t0 = time.monotonic()
        try:
            fault_injection.fire("router.poll", server=s)
            data = request_with_retry(s, "/health", method="GET", timeout=5, max_retries=1)
            version = int(data.get("version", 0))
            role = str(data.get("role", "unified"))
        except Exception:  # noqa: BLE001 — a dead server drops out
            logger.warning(f"server {s} failed health poll")
            return s, None, None, 0.0, None, time.monotonic() - t0, "unified"
        rtt = time.monotonic() - t0
        with self._lock:
            est_snapshot = self._est_since_poll[s]
        try:
            m = request_with_retry(s, "/metrics", method="GET", timeout=5, max_retries=1)
            # a server with no real metrics answers {}: no measurement
            load = (float(m["active_tokens"]) + float(m.get("queued_tokens", 0.0))
                    if "active_tokens" in m else None)
            pressure = ({k: m[k] for k in _PRESSURE_KEYS if k in m}
                        if "active_tokens" in m else None)
        except Exception as e:  # noqa: BLE001 — _metrics_fail escalates
            logger.debug(f"metrics probe of {s} failed: {e!r}")
            load = pressure = None
        return s, version, load, est_snapshot, pressure, rtt, role

    def _poll_once(self, pool: concurrent.futures.Executor) -> None:
        servers = self._discover()
        # fan out: one hung server must not stale the fleet's readings
        probes = list(pool.map(self._probe, servers))
        with self._lock:
            self._apply_probes_locked(servers, probes)
            self._expire_locked(time.monotonic(), servers)
            self._drain_queue_locked()

    def _poll_loop(self) -> None:
        with concurrent.futures.ThreadPoolExecutor(8, thread_name_prefix="router-probe") as pool:
            while not self._stop.is_set():
                try:
                    self._poll_once(pool)
                except Exception as e:  # noqa: BLE001 — keep the loop alive
                    logger.warning(f"router poll loop error: {e!r}")
                self._stop.wait(self.health_poll_interval)

    def _apply_probes_locked(self, servers: list[str], probes) -> None:
        """Fold one poll round into the fleet view: the live set, versions,
        measured loads, pressure snapshots and the failed-health and
        failed-metrics counters."""
        versions = {p[0]: p[1] for p in probes if p[1] is not None}
        self.servers = [s for s in servers if s in versions]
        self._versions = versions
        for p in probes:
            s, v, load, est_snapshot, pressure = p[:5]
            rtt = p[5] if len(p) > 5 else None
            if v is not None:
                self._roles[s] = p[6] if len(p) > 6 else "unified"
                if pressure is not None:
                    pressure = dict(pressure, role=self._roles[s])
            slow = (self.config.breaker_slow_s > 0 and rtt is not None
                    and rtt > self.config.breaker_slow_s)
            # erroring metrics degrade only a server that has reported some
            metrics_err = v is not None and load is None and s in self._measured_tokens
            self._breaker_update_locked(s, bad=(v is None) or slow or metrics_err)
            if v is None:
                self._health_fail[s] += 1
                if self._health_fail[s] == self.config.dead_after_failures:
                    self._failover_locked(s)
            else:
                self._health_fail[s] = 0
            if v is None or load is None:
                self._metrics_fail[s] += 1
                if (self._metrics_fail[s] >= _METRICS_FAIL_LIMIT
                        and s in self._measured_tokens):
                    del self._measured_tokens[s]
                    self._pressure.pop(s, None)
                    self._fabric_index.pop(s, None)
                continue
            self._metrics_fail[s] = 0
            self._measured_tokens[s] = load
            if pressure is not None:
                self._pressure[s] = pressure
                dig = pressure.get("kv_fabric_digest")
                if dig:
                    self._fabric_index[s] = set(kv_fabric.decode_digest(dig))
                else:
                    self._fabric_index.pop(s, None)
            # subtract only what the measurement could have seen
            self._est_since_poll[s] = max(0.0, self._est_since_poll[s] - est_snapshot)

    # -- circuit breaker ------------------------------------------------
    def _breaker_update_locked(self, s: str, bad: bool) -> None:
        """Trip after `breaker_trip_after` consecutive bad polls, go
        half-open on the first good poll after a trip, fall back to open on
        a bad poll while half-open. Closing happens when a probe request
        finishes (`_release_qid`)."""
        if not self.config.breaker_enabled:
            return
        b = self._breaker[s]
        if bad:
            b["bad"] += 1
            if b["state"] == "closed" and b["bad"] >= self.config.breaker_trip_after:
                b["state"] = "open"
                b["probes"] = 0
                self._counters["breaker_trips_total"] += 1
                logger.warning(f"circuit breaker OPEN for {s} after {b['bad']} bad polls")
            elif b["state"] == "half_open":
                b["state"] = "open"
                b["probes"] = 0
        else:
            b["bad"] = 0
            if b["state"] == "open":
                b["state"] = "half_open"
                b["probes"] = 0
                logger.info(f"circuit breaker HALF-OPEN for {s}: probing")

    def _breaker_admits(self, s: str) -> bool:
        """May a new request go to `s`? Not while open; while half-open,
        only within the probe budget. Affinity entries survive a trip."""
        if not self.config.breaker_enabled:
            return True
        b = self._breaker[s]
        if b["state"] == "open":
            return False
        if b["state"] == "half_open":
            return b["probes"] < max(1, self.config.breaker_probe_requests)
        return True

    def _breaker_charge_locked(self, addr: str) -> None:
        if not self.config.breaker_enabled:
            return
        b = self._breaker[addr]
        if b["state"] == "half_open":
            b["probes"] += 1
            b["probe_t"] = time.monotonic()
            self._counters["breaker_probes_total"] += 1

    def _failover_locked(self, dead: str) -> None:
        """A replica reached dead_after_failures: move its in-flight qids
        to the least-loaded survivors (the clients' retries then land
        there) and drop every affinity entry that points at it."""
        self._counters["failovers_total"] += 1
        survivors = [s for s in self.servers if s != dead]
        stale = [h for h, (s, _) in self._prefix_map.items() if s == dead]
        for h in stale:
            del self._prefix_map[h]
        moved = 0
        now = time.monotonic()
        for qid, srv in list(self._qid_to_server.items()):
            if srv != dead:
                continue
            pending = self._qid_pending.get(qid, 1)
            cost = self._qid_cost.get(qid, 0.0)
            self._request_counts[dead] = max(0, self._request_counts[dead] - pending)
            self._token_usage[dead] = max(0.0, self._token_usage[dead] - cost)
            self._est_since_poll[dead] = max(0.0, self._est_since_poll[dead] - cost)
            if survivors:
                new = min(survivors, key=self._token_load)
                self._qid_to_server[qid] = new
                self._qid_touched[qid] = now
                self._request_counts[new] += pending
                self._token_usage[new] += cost
                self._est_since_poll[new] += cost
                moved += 1
            else:
                # nowhere to carry it: the client's reschedule queues
                self._qid_to_server.pop(qid, None)
                self._qid_cost.pop(qid, None)
                self._qid_pending.pop(qid, None)
                self._qid_touched.pop(qid, None)
        self._counters["requeues_total"] += moved
        self._measured_tokens.pop(dead, None)
        self._pressure.pop(dead, None)
        # nor can a dead replica serve fabric fetches
        self._fabric_index.pop(dead, None)
        # a replica back from the dead starts with a clean breaker
        self._breaker.pop(dead, None)
        if moved or stale:
            logger.warning(f"failover: {dead} declared dead; requeued {moved} qids, "
                           f"drained {len(stale)} prefix affinities")

    def _expire_probes_locked(self, now: float) -> None:
        """Free half-open probe charges whose requests died with their
        clients, past breaker_probe_ttl_s."""
        ttl = self.config.breaker_probe_ttl_s
        if not self.config.breaker_enabled or ttl <= 0:
            return
        for s, b in self._breaker.items():
            if b["state"] == "half_open" and b["probes"] > 0 and now - b.get("probe_t", 0.0) > ttl:
                b["probes"] = 0
                self._counters["breaker_probe_expiries_total"] += 1
                logger.warning(f"expired stale half-open probe charge for {s}")

    def _expire_locked(self, now: float, discovered: list[str]) -> None:
        """TTL and size expiry of the routing state: a crashed client or a
        replaced fleet must not leak load accounting."""
        self._expire_probes_locked(now)
        ttl = self.config.route_ttl_s
        if ttl > 0:
            for qid, t in list(self._qid_touched.items()):
                if now - t <= ttl:
                    continue
                # its owner is gone: release every pending unit
                while qid in self._qid_to_server:
                    self._release_qid(qid)
                self._qid_touched.pop(qid, None)
                self._counters["expired_qids_total"] += 1
            # recency order: the stale entries are at the front
            while self._prefix_map:
                h, (_, t) = next(iter(self._prefix_map.items()))
                if now - t <= ttl:
                    break
                del self._prefix_map[h]
                self._counters["expired_prefixes_total"] += 1
        while len(self._prefix_map) > self.config.route_max_entries:
            self._prefix_map.popitem(last=False)
            self._counters["expired_prefixes_total"] += 1
        over = len(self._qid_to_server) - self.config.route_max_entries
        if over > 0:
            oldest = sorted(self._qid_touched.items(), key=lambda kv: kv[1])
            for qid, _ in oldest[:over]:
                while qid in self._qid_to_server:
                    self._release_qid(qid)
                self._qid_touched.pop(qid, None)
                self._counters["expired_qids_total"] += 1
        # per-server state of servers gone from discovery and the seed list
        keep = set(discovered) | set(self._seed_servers)
        per_server = (self._request_counts, self._token_usage, self._est_since_poll,
                      self._metrics_fail, self._health_fail, self._measured_tokens,
                      self._pressure, self._versions, self._breaker, self._roles,
                      self._fabric_index)
        tracked = set().union(*(d for d in per_server if d is not self._versions))
        for s in tracked - keep:
            for d in per_server:
                d.pop(s, None)

    @property
    def fleet_version(self) -> int:
        """The fleet's weight version: the least over its servers (a
        conservative gate while a push is halfway through the fleet)."""
        return min(self._versions.values()) if self._versions else 0

    def _training_sample_cnt(self) -> int:
        try:
            return int(name_resolve.get(names.training_samples(self.experiment_name,
                                                               self.trial_name)))
        except Exception as e:  # noqa: BLE001 — not published yet
            logger.debug(f"training-sample counter unavailable: {e!r}")
            return 0

    def _is_staled(self) -> bool:
        expected = (self._training_sample_cnt() + self._running) // self.train_batch_size
        return expected > self.max_head_offpolicyness + self.fleet_version

    # -- scheduling -----------------------------------------------------
    def _token_load(self, s: str) -> float:
        """A server's token load: its last measured active tokens plus the
        estimate routed there since; the router's own estimate for a
        server that never reported metrics."""
        if s in self._measured_tokens:
            return self._measured_tokens[s] + self._est_since_poll[s]
        return self._token_usage[s]

    @staticmethod
    def _request_cost(req: dict[str, Any]) -> float:
        return float(req.get("prompt_len", 0)) + 0.4 * float(
            req.get("new_token_budget", 0)) * float(req.get("group_size", 1))

    def _kv_headroom(self, s: str, need: float) -> float | None:
        """Pool tokens left on `s` after admitting `need`, or None for a
        server that never reported pressure (admissible). Fragmented free
        blocks are subtracted; a replica with a host tier admits to its
        whole pool (its evictions offload)."""
        p = self._pressure.get(s)
        if not p or not p.get("kv_blocks_total"):
            return None
        block = float(p.get("kv_block_size", 1) or 1)
        cap = float(p["kv_blocks_total"]) * block
        if not p.get("kv_host_pool_enabled"):
            cap *= self.config.kv_pressure_high
        frag = float(p.get("kv_pool_fragmentation", 0)) * block
        used = float(p.get("kv_tokens_allocated", 0.0)) + self._est_since_poll[s]
        return cap - frag - used - need

    def _admissible(self, s: str, need: float) -> bool:
        if not self._breaker_admits(s):
            return False
        limit = self.config.max_inflight_per_server
        if limit:
            p = self._pressure.get(s)
            if p is not None:
                depth = int(p.get("running_requests", 0)) + int(p.get("queued_requests", 0))
                if depth >= limit:
                    return False
        h = self._kv_headroom(s, need)
        return h is None or h >= 0.0

    def _fleet_kv_dtype(self) -> str:
        for p in self._pressure.values():
            d = p.get("kv_dtype")
            if d:
                return str(d)
        return "bfloat16"

    def _fabric_chain(self, req: dict[str, Any]) -> list[int]:
        """The content chain of the prompt's prefix at
        `prefix_block_tokens`, block 0 first: the keys the engines index
        their blocks under (`kv_fabric.chain_keys`, salted by the fleet's
        weight version and kv dtype), so a match here means resident bytes."""
        prefix = req.get("input_prefix")
        if not prefix:
            return []
        block = max(1, self.config.prefix_block_tokens)
        nb = min(len(prefix) // block, self.config.prefix_max_blocks)
        if nb <= 0:
            return []
        return kv_fabric.chain_keys(prefix, block, self.fleet_version, self._fleet_kv_dtype(),
                                    max_blocks=nb)

    def _prefix_hashes(self, req: dict[str, Any]) -> list[int]:
        """The prefix chain, longest first (the affinity map's keys)."""
        return list(reversed(self._fabric_chain(req)))

    def _fabric_best_locked(self, chain: list[int], skip: str | None = None
                            ) -> tuple[str | None, int]:
        """(server, blocks) of the longest resident run of `chain` among
        the advertised digests, `skip` aside."""
        best_s, best_n = None, 0
        for s, keys in self._fabric_index.items():
            if s == skip or s not in self.servers:
                continue
            n = kv_fabric.longest_run(chain, keys)
            if n > best_n:
                best_s, best_n = s, n
        return best_s, best_n

    def _role_of(self, s: str) -> str:
        return self._roles.get(s, "unified")

    def _pick_locked(self, req: dict[str, Any]) -> tuple[str | None, float, str | None]:
        """(server, prefix discount tokens, prefill server) for `req`, or
        (None, 0, None) when no server is admissible now (the caller
        queues). The discount is the prompt work the server skips because
        it holds the prefix already, or because the prompt's KV arrives
        from a prefill replica: the accounting charges the marginal cost.
        A prefill server of None means no handoff."""
        qid = req.get("qid")
        prev_url = req.get("previous_server_url")
        if (prev_url and prev_url in self.servers
                and req.get("previous_version") == self.fleet_version
                and self._breaker_admits(prev_url)):
            # a resume on the same weights: its KV is parked there, and a
            # handoff would recompute it
            return prev_url, 0.0, None
        if qid and qid in self._qid_to_server:
            cached = self._qid_to_server[qid]
            # a tripped breaker diverts affine traffic; the mapping stays
            if cached in self.servers and self._breaker_admits(cached):
                return cached, 0.0, None
        need = self._request_cost(req)
        prefill_pool = [s for s in self.servers if self._role_of(s) == "prefill"]
        decode_pool = [s for s in self.servers if self._role_of(s) != "prefill"]
        if prefill_pool and decode_pool:
            return self._pick_disagg_locked(req, prefill_pool, decode_pool)
        candidates = [s for s in self.servers if self._admissible(s, need)]
        if not candidates:
            return None, 0.0, None
        policy = self.schedule_policy
        if policy == "prefix_affinity":
            return (*self._pick_prefix_affine_locked(req, candidates, need), None)
        if policy == "round_robin":
            addr = candidates[self._rr % len(candidates)]
            self._rr += 1
        elif policy == "least_requests":
            addr = min(candidates, key=lambda s: self._request_counts[s])
        elif policy == "least_token_usage":
            addr = min(candidates, key=self._token_load)
        else:
            raise _Reply(400, f"unknown schedule policy {policy}")
        return addr, 0.0, None

    def _pick_disagg_locked(self, req: dict[str, Any], prefill_pool: list[str],
                            decode_pool: list[str]) -> tuple[str | None, float, str | None]:
        """The role-aware pick: a decode home by pool headroom (the memory
        a decode replica runs out of), charged only the decode share since
        the prompt's KV comes over the wire, and a prefill replica by
        prefix affinity (where donor forks save compute)."""
        prompt_cost = float(req.get("prompt_len", 0))
        decode_need = max(self._request_cost(req) - prompt_cost, 0.0)
        decode_cands = [s for s in decode_pool if self._admissible(s, decode_need)]
        if not decode_cands:
            return None, 0.0, None
        headrooms = {s: self._kv_headroom(s, decode_need) for s in decode_cands}
        if all(h is not None for h in headrooms.values()):
            addr = max(decode_cands, key=lambda s: headrooms[s])
        else:
            addr = min(decode_cands, key=self._token_load)
        prefill_cands = [s for s in prefill_pool if self._admissible(s, prompt_cost)]
        prefill_addr = None
        if prefill_cands:
            prefill_addr, _ = self._pick_prefix_affine_locked(req, prefill_cands, prompt_cost)
            # a charge the prefill replica's next poll replaces
            self._est_since_poll[prefill_addr] += prompt_cost
        discount = prompt_cost if prefill_addr is not None else 0.0
        self._counters["disagg_schedules_total"] += 1
        return addr, discount, prefill_addr

    def _pick_prefix_affine_locked(self, req: dict[str, Any], candidates: list[str],
                                   need: float) -> tuple[str, float]:
        hashes = self._prefix_hashes(req)
        block = max(1, self.config.prefix_block_tokens)
        now = time.monotonic()
        best = min(candidates, key=self._token_load)
        chosen, discount = None, 0.0
        for i, h in enumerate(hashes):  # longest prefix first
            ent = self._prefix_map.get(h)
            if ent is None or ent[0] not in self.servers:
                continue
            affine = ent[0]
            saved = min((len(hashes) - i) * block, float(req.get("prompt_len", 0)))
            # affinity against load, by marginal cost: a hot (or
            # inadmissible) affine server must not melt while siblings idle
            hot = affine not in candidates or (
                self._token_load(affine) + need - saved
                > self.config.affinity_load_factor * (self._token_load(best) + need))
            if hot:
                self._counters["affinity_overrides_total"] += 1
                break
            self._counters["affinity_hits_total"] += 1
            chosen, discount = affine, saved
            break
        if chosen is None and hashes and self.config.kv_fabric:
            # no affinity entry, but a candidate may hold the blocks anyway
            # (deduplicated from another request, or fetched earlier): route
            # by its advertised run, priced as affinity is
            chain = hashes[::-1]
            run_of = {s: kv_fabric.longest_run(chain, self._fabric_index[s])
                      for s in candidates if s in self._fabric_index}
            cand = max(run_of, key=lambda s: run_of[s]) if run_of else None
            if cand is not None and run_of[cand] > 0:
                saved = min(run_of[cand] * block, float(req.get("prompt_len", 0)))
                if (self._token_load(cand) + need - saved
                        <= self.config.affinity_load_factor * (self._token_load(best) + need)):
                    chosen, discount = cand, saved
                    self._counters["fabric_local_routes_total"] += 1
        if chosen is None:
            chosen = best
        for h in hashes:
            self._prefix_map[h] = (chosen, now)
            self._prefix_map.move_to_end(h)
        return chosen, discount

    def _try_schedule_locked(self, req: dict[str, Any]) -> dict[str, Any] | None:
        """Pick and account, or None when every replica is saturated."""
        addr, discount, prefill_addr = self._pick_locked(req)
        if addr is None:
            return None
        qid = req.get("qid")
        fabric_hint = None
        chain = self._fabric_chain(req) if self.config.kv_fabric else []
        if chain:
            block = max(1, self.config.prefix_block_tokens)
            local = kv_fabric.longest_run(chain, self._fabric_index.get(addr, frozenset()))
            peer, run = self._fabric_best_locked(chain, skip=addr)
            if peer is not None and run > local:
                # the peer holds `run - local` more blocks than the chosen
                # replica; fetching them costs the factor of prefilling
                # them, and the rest is discounted
                factor = min(max(float(self.config.kv_fabric_fetch_cost_factor), 0.0), 1.0)
                saved = (run - local) * block * (1.0 - factor)
                discount = min(discount + saved, float(req.get("prompt_len", 0)))
                fabric_hint = {"peer": peer, "keys": kv_fabric.encode_digest(chain[:run])}
                self._counters["fabric_remote_hints_total"] += 1
        cost = max(self._request_cost(req) - discount, 0.0)
        self._counters["schedules_total"] += 1
        self._breaker_charge_locked(addr)
        self._request_counts[addr] += 1
        self._token_usage[addr] += cost
        self._est_since_poll[addr] += cost
        if qid:
            self._qid_to_server[qid] = addr
            self._qid_cost[qid] = self._qid_cost.get(qid, 0.0) + cost
            self._qid_pending[qid] = self._qid_pending.get(qid, 0) + 1
            self._qid_touched[qid] = time.monotonic()
        out = {"url": addr, "version": self.fleet_version}
        if fabric_hint is not None:
            # the decode server pulls these runs from the peer first
            out["kv_fabric"] = fabric_hint
        if prefill_addr is not None:
            # the client prefills here first (/prefill streams the KV to
            # `url`), then its /generate on `url` resumes with no prefill
            out["prefill_url"] = prefill_addr
        return out

    def _drain_queue_locked(self) -> None:
        """Place queued requests in FIFO order while pressure allows; an
        unplaceable head blocks the tail."""
        while self._waitq:
            w = self._waitq[0]
            if w.done():
                self._waitq.popleft()
                continue
            out = self._try_schedule_locked(w.req)
            if out is None:
                break
            self._waitq.popleft()
            self._counters["queue_admits_total"] += 1
            w.result = out
            w.event.set()

    def _shed(self, why: str) -> _Reply:
        ra = self.config.retry_after_s
        return _Reply(429, why, body={"url": None, "reason": why, "retry_after": ra},
                      headers={"Retry-After": str(max(1, math.ceil(ra)))})

    def _release_qid(self, qid: str | None) -> None:
        """Release one in-flight unit of a qid's load accounting."""
        if not qid or qid not in self._qid_to_server:
            return
        addr = self._qid_to_server[qid]
        # a finished request on a half-open replica is its probe passing
        if self.config.breaker_enabled:
            b = self._breaker[addr]
            if b["state"] == "half_open" and b["probes"] > 0:
                b["probes"] -= 1
                b["state"] = "closed"
                b["bad"] = 0
                self._counters["breaker_closes_total"] += 1
                logger.info(f"circuit breaker CLOSED for {addr} (probe ok)")
        pending = self._qid_pending.get(qid, 1)
        unit_cost = self._qid_cost.get(qid, 0.0) / max(1, pending)
        self._request_counts[addr] = max(0, self._request_counts[addr] - 1)
        self._token_usage[addr] = max(0.0, self._token_usage[addr] - unit_cost)
        self._est_since_poll[addr] = max(0.0, self._est_since_poll[addr] - unit_cost)
        if pending <= 1:
            self._qid_to_server.pop(qid, None)
            self._qid_cost.pop(qid, None)
            self._qid_pending.pop(qid, None)
            self._qid_touched.pop(qid, None)
        else:
            self._qid_pending[qid] = pending - 1
            self._qid_cost[qid] = self._qid_cost[qid] - unit_cost

    # -- routes ---------------------------------------------------------
    def handle(self, method: str, path: str, query: dict, body: bytearray) -> dict:
        routes = {
            ("GET", "/health"): self._health,
            ("GET", "/metrics"): self._metrics,
            ("POST", "/schedule_request"): self._schedule_request,
            ("POST", "/allocate_rollout"): self._allocate_rollout,
            ("POST", "/finish_rollout"): self._finish_rollout,
            ("POST", "/finish_request"): self._finish_request,
        }
        fn = routes.get((method, path))
        if fn is None:
            raise _Reply(404, f"no route {method} {path}")
        if method == "GET":
            return fn()
        try:
            req = json.loads(bytes(body) or b"{}")
        except ValueError as e:
            raise _Reply(400, f"body is not JSON: {e}") from None
        if not isinstance(req, dict):
            raise _Reply(400, "body is not a JSON object")
        return fn(req)

    def _schedule_request(self, req: dict) -> dict:
        fault_injection.fire("router.schedule", qid=str(req.get("qid") or ""))
        # the client ships its remaining budget: a request waits no longer
        # than its owner waits for the answer
        try:
            deadline_s = float(req.get("deadline_s") or 0.0)
        except (TypeError, ValueError):
            deadline_s = 0.0
        hold = self.config.queue_timeout_s
        if deadline_s > 0.0:
            hold = min(hold, deadline_s)
        with self._lock:
            if req.get("requeue") and req.get("qid"):
                # a client's retry reschedules the same logical request:
                # release its earlier unit (its finish comes once)
                self._release_qid(req.get("qid"))
                self._counters["client_requeues_total"] += 1
            out = self._try_schedule_locked(req)
            if out is not None:
                return out
            if hold <= 0.0:
                self._counters["deadline_sheds_total"] += 1
                raise self._shed("request deadline exhausted")
            if len(self._waitq) >= self.config.queue_max:
                self._counters["queue_sheds_total"] += 1
                raise self._shed("admission queue full")
            w = _Waiter(req)
            self._waitq.append(w)
            self._counters["queue_enqueues_total"] += 1
        if w.event.wait(hold):
            return w.result
        with self._lock:
            if w.result is not None:  # placed as the hold ran out
                return w.result
            w.event.set()  # shed: the drain skips it
            try:
                self._waitq.remove(w)
            except ValueError:
                pass
            self._counters["queue_timeouts_total"] += 1
            if hold < self.config.queue_timeout_s:
                self._counters["deadline_sheds_total"] += 1
        raise self._shed("admission deadline exceeded")

    def _allocate_rollout(self, req: dict) -> dict:
        with self._lock:
            has_capacity = self._running < self.max_concurrent_rollouts
            staled = self._is_staled()
            if has_capacity and not staled:
                self._running += 1
                self._submitted += 1
                return {"success": True, "reason": ""}
            reason = []
            if not has_capacity:
                reason.append(f"capacity: {self._running} >= {self.max_concurrent_rollouts}")
            if staled:
                reason.append(f"staled: version {self.fleet_version} + offpolicyness "
                              f"{self.max_head_offpolicyness} exceeded")
            return {"success": False, "reason": "; ".join(reason)}

    def _finish_rollout(self, req: dict) -> dict:
        with self._lock:
            self._running = max(0, self._running - 1)
            if req.get("accepted"):
                self._accepted += 1
            self._release_qid(req.get("qid"))
            self._drain_queue_locked()
            return {"success": True}

    def _finish_request(self, req: dict) -> dict:
        """Release a /schedule_request's accounting without touching the
        rollout counters (clients that only route)."""
        with self._lock:
            self._release_qid(req.get("qid"))
            self._drain_queue_locked()
            return {"success": True}

    def _health(self) -> dict:
        with self._lock:
            return {
                "status": "ok",
                "servers": list(self.servers),
                "versions": dict(self._versions),
                "running": self._running,
                "submitted": self._submitted,
                "accepted": self._accepted,
                "request_counts": dict(self._request_counts),
                "token_loads": {s: self._token_load(s) for s in self.servers},
            }

    def _metrics(self) -> dict:
        """Queue and shedding, affinity, failover, the breaker and the
        pressure snapshots admission acts on; the supervisor reads it."""
        with self._lock:
            sched = self._counters["schedules_total"]
            hits = self._counters["affinity_hits_total"]

            def fleet_sum(key: str) -> int:
                return sum(int(p.get(key, 0) or 0) for p in self._pressure.values())

            return {
                "kv_fabric_local_hits_total": fleet_sum("kv_fabric_local_hits_total"),
                "kv_fabric_remote_hits_total": fleet_sum("kv_fabric_remote_hits_total"),
                "kv_fabric_fetch_bytes_total": fleet_sum("kv_fabric_fetch_bytes_total"),
                "reprefill_tokens_avoided_total": fleet_sum("reprefill_tokens_avoided_total"),
                "fabric_indexed_servers": len(self._fabric_index),
                "schedule_policy": self.schedule_policy,
                "servers": list(self.servers),
                "roles": {s: self._role_of(s) for s in self.servers},
                "kv_migrated_sessions_total": fleet_sum("kv_migrated_in_sessions_total"),
                "kv_migrated_bytes_total": fleet_sum("kv_migrated_in_bytes_total"),
                "queue_depth": sum(1 for w in self._waitq if not w.done()),
                "queue_max": self.config.queue_max,
                **self._counters,
                "affinity_hit_rate": round(hits / sched, 6) if sched else 0.0,
                "tracked_qids": len(self._qid_to_server),
                "tracked_prefixes": len(self._prefix_map),
                "running": self._running,
                "request_counts": dict(self._request_counts),
                "token_loads": {s: self._token_load(s) for s in self.servers},
                "pressure": {s: dict(p) for s, p in self._pressure.items()},
                "breaker": {s: dict(b) for s, b in self._breaker.items()},
            }

    # -- lifecycle ------------------------------------------------------
    def start(self, host: str = "0.0.0.0", port: int = 0) -> str:
        """Listen, start the poll loop and register under
        `names.rollout_router`; returns "ip:port"."""
        self._httpd, self._serve_thread, self.addr = serve_app(self, host, port, "router-http")
        self._stop.clear()
        self._poll_thread = threading.Thread(target=self._poll_loop, daemon=True,
                                             name="router-poll")
        self._poll_thread.start()
        if self.experiment_name and self.trial_name:
            name_resolve.add(names.rollout_router(self.experiment_name, self.trial_name),
                             self.addr, replace=True)
        logger.info(f"rollout router on {self.addr}")
        return self.addr

    def stop(self) -> None:
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=30)
            self._poll_thread = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.close_connections()
            self._httpd.server_close()
            self._httpd = None
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10)
            self._serve_thread = None


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="areal_tpu_torch decode-fleet router")
    p.add_argument("--experiment-name", default="")
    p.add_argument("--trial-name", default="")
    p.add_argument("--servers", default="", help="comma-separated host:port")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=0)
    d = RouterConfig()
    p.add_argument("--schedule-policy", default=d.schedule_policy)
    p.add_argument("--max-concurrent-rollouts", type=int, default=d.max_concurrent_rollouts)
    p.add_argument("--max-head-offpolicyness", type=int, default=d.max_head_offpolicyness)
    p.add_argument("--train-batch-size", type=int, default=d.train_batch_size)
    p.add_argument("--health-poll-interval", type=float, default=d.health_poll_interval)
    p.add_argument("--queue-max", type=int, default=d.queue_max)
    p.add_argument("--queue-timeout-s", type=float, default=d.queue_timeout_s)
    p.add_argument("--kv-pressure-high", type=float, default=d.kv_pressure_high)
    p.add_argument("--route-ttl-s", type=float, default=d.route_ttl_s)
    args = p.parse_args(argv)
    # the experiment's discovery store, from the launcher's environment
    name_resolve.reconfigure_from_env()
    router = DecodeRouter(
        args.experiment_name, args.trial_name, [s for s in args.servers.split(",") if s],
        config=RouterConfig(
            schedule_policy=args.schedule_policy,
            max_concurrent_rollouts=args.max_concurrent_rollouts,
            max_head_offpolicyness=args.max_head_offpolicyness,
            train_batch_size=args.train_batch_size,
            health_poll_interval=args.health_poll_interval,
            queue_max=args.queue_max,
            queue_timeout_s=args.queue_timeout_s,
            kv_pressure_high=args.kv_pressure_high,
            route_ttl_s=args.route_ttl_s,
        ),
    )
    router.start(args.host, args.port)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        router.stop()


if __name__ == "__main__":
    main()
