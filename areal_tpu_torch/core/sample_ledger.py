"""Exactly-once sample accounting for the async rollout→train pipeline
(a copy of `areal_tpu/core/sample_ledger.py`).

The trainer is the only durable component: when it dies, every accepted
trajectory sitting in `WorkflowExecutor._result_cache` and every rollout
still running on the fleet dies with it (or worse, arrives again after a
restart). The ledger makes trainer death a replayed, verifiable event:

- every submitted episode gets a monotonically increasing **rollout id**;
  accepted trajectories are stamped with (rollout id, weight version);
- `wait()` journals the identities of each consumed training batch into a
  small write-ahead log (`SampleWAL`, JSONL, fsynced per entry) BEFORE the
  batch is trained on — the WAL sequence number is committed inside the
  recover checkpoint, so after a crash the surviving WAL prefix is exactly
  the set of batches whose weight updates are durable;
- on resume, WAL entries past the committed sequence are rolled back
  (their samples are regenerated and re-trained — correct, because the
  weight updates they fed were rolled back with the checkpoint), and a
  trajectory arriving from a still-running fleet replica whose rollout id
  was already consumed is **deduped** at accept time.

Consumed ids travel in the checkpoint (`state_dict`); accepted-but-
unconsumed ids deliberately do not — those trajectories die with the
process, so restoring them would permanently overstate the staleness
cap's `accepted` term. The restored `accepted` count is the consumed
count (see WorkflowExecutor.load_state_dict).

Mutated from the rollout thread (accept/dedup) and the trainer thread
(consume/state_dict), hence the lock.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any

from areal_tpu_torch.utils import logging

logger = logging.getLogger("sample_ledger")


class SampleWAL:
    """Append-only JSONL journal of consumed training batches.

    Each entry: {"seq": int, "version": int, "rids": [int, ...]}. Appends
    are flushed+fsynced so an entry either fully exists or doesn't; a torn
    trailing line (crash mid-append) is dropped at replay/rollback time.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def append(self, seq: int, version: int, rids: list[int]) -> None:
        entry = dict(seq=seq, version=version, rids=sorted(int(r) for r in rids))
        with open(self.path, "a") as f:
            f.write(json.dumps(entry) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def replay(self) -> list[dict[str, Any]]:
        """All well-formed entries, in file order; a torn trailing line is
        silently dropped (it was never committed)."""
        if not os.path.exists(self.path):
            return []
        entries = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                    entries.append(
                        dict(seq=int(e["seq"]), version=int(e["version"]),
                             rids=[int(r) for r in e["rids"]])
                    )
                except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                    logger.warning(
                        f"dropping torn WAL line in {self.path}: {line[:80]!r}"
                    )
        return entries

    def rollback_to(self, committed_seq: int) -> int:
        """Truncate entries with seq > committed_seq (consumed after the
        restored checkpoint committed — their weight updates were rolled
        back, so their samples will be regenerated and re-journaled).
        Returns how many entries were dropped. Atomic: rewrite + rename."""
        entries = self.replay()
        keep = [e for e in entries if e["seq"] <= committed_seq]
        dropped = len(entries) - len(keep)
        if dropped:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                for e in keep:
                    f.write(json.dumps(e) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, self.path)
            logger.info(
                f"WAL rollback to seq {committed_seq}: dropped {dropped} "
                f"uncommitted consume entries"
            )
        return dropped


class SampleLedger:
    """Rollout-id issuance + accepted/consumed tracking + dedup."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next_rid = 0
        # rid -> weight version at accept time; pending consumption
        self._accepted: dict[int, int] = {}
        self._consumed: set[int] = set()
        self._wal_seq = 0
        self._wal: SampleWAL | None = None
        self._deduped_total = 0

    # -- wiring ---------------------------------------------------------
    def attach_wal(self, wal: SampleWAL | None) -> None:
        with self._lock:
            self._wal = wal

    # -- rollout lifecycle ----------------------------------------------
    def new_rid(self) -> int:
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            return rid

    def on_accepted(self, rid: int, version: int) -> bool:
        """Record an accepted trajectory. False when `rid` was already
        consumed (a duplicate from a still-running replica after resume)
        or is already pending — the caller must treat the trajectory as
        rejected."""
        with self._lock:
            if rid in self._consumed or rid in self._accepted:
                self._deduped_total += 1
                return False
            self._accepted[rid] = version
            # externally-supplied rids must not collide with future issues
            if rid >= self._next_rid:
                self._next_rid = rid + 1
            return True

    def on_consumed(self, rids: list[int], version: int) -> int:
        """Journal one consumed training batch; returns its WAL seq. The
        entry is durable before the caller trains on the batch."""
        with self._lock:
            self._wal_seq += 1
            seq = self._wal_seq
            for rid in rids:
                self._accepted.pop(rid, None)
                self._consumed.add(int(rid))
            wal = self._wal
        if wal is not None:
            wal.append(seq, version, rids)
        return seq

    # -- introspection ---------------------------------------------------
    def consumed_count(self) -> int:
        with self._lock:
            return len(self._consumed)

    def pending_count(self) -> int:
        with self._lock:
            return len(self._accepted)

    def deduped_total(self) -> int:
        with self._lock:
            return self._deduped_total

    def is_consumed(self, rid: int) -> bool:
        with self._lock:
            return rid in self._consumed

    # -- checkpointing ----------------------------------------------------
    def state_dict(self) -> dict[str, Any]:
        """Committed with the recover checkpoint. Pending (accepted but
        unconsumed) entries are intentionally excluded — see module doc."""
        with self._lock:
            return dict(
                next_rid=self._next_rid,
                consumed=sorted(self._consumed),
                wal_seq=self._wal_seq,
            )

    def load_state_dict(self, state: dict[str, Any]) -> None:
        """Restore, then roll the attached WAL back to the committed seq
        so uncommitted consume entries don't survive the restart."""
        with self._lock:
            self._next_rid = int(state.get("next_rid", 0))
            self._consumed = {int(r) for r in state.get("consumed", [])}
            self._accepted = {}
            self._wal_seq = int(state.get("wal_seq", 0))
            wal, seq = self._wal, self._wal_seq
        if wal is not None:
            wal.rollback_to(seq)
