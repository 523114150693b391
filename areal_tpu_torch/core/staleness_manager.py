"""Staleness-aware rollout capacity control (a copy of
`areal_tpu/core/staleness_manager.py`). The capacity rule is the
heart of the async-RL data policy (AReaL "boba²"): never admit a rollout
that could be consumed more than `max_staleness` weight-versions after it
was generated:

    staleness_cap = (max_staleness + version + 1) * consumer_batch_size
                    - (accepted + running)
    capacity      = min(max_concurrent - running, staleness_cap)

Counters are mutated from the rollout thread and read from the trainer
thread, hence the lock.
"""

from __future__ import annotations

from threading import Lock

from areal_tpu_torch.api.io_struct import RolloutStat


class StalenessManager:
    def __init__(
        self,
        max_concurrent_rollouts: int,
        consumer_batch_size: int,
        max_staleness: int,
    ):
        self.max_concurrent_rollouts = max_concurrent_rollouts
        self.consumer_batch_size = consumer_batch_size
        self.max_staleness = max_staleness
        self.lock = Lock()
        self.rollout_stat = RolloutStat()

    def get_capacity(self, current_version: int) -> int:
        """Available rollout slots (may be negative when over capacity)."""
        with self.lock:
            concurrency_capacity = (
                max(1, self.max_concurrent_rollouts) - self.rollout_stat.running
            )
            sample_cnt = self.rollout_stat.accepted + self.rollout_stat.running
            staleness_capacity = (
                (self.max_staleness + current_version + 1)
                * max(1, self.consumer_batch_size)
                - sample_cnt
            )
            return min(concurrency_capacity, staleness_capacity)

    def on_rollout_submitted(self) -> None:
        with self.lock:
            self.rollout_stat.submitted += 1
            self.rollout_stat.running += 1

    def on_rollout_accepted(self) -> None:
        with self.lock:
            self.rollout_stat.accepted += 1
            self.rollout_stat.running -= 1

    def on_rollout_rejected(self) -> None:
        with self.lock:
            self.rollout_stat.running -= 1

    def get_stats(self) -> RolloutStat:
        with self.lock:
            return RolloutStat(
                submitted=self.rollout_stat.submitted,
                accepted=self.rollout_stat.accepted,
                running=self.rollout_stat.running,
            )

    # -- checkpointing ---------------------------------------------------
    def state_dict(self) -> dict:
        """Counters as committed with the recover checkpoint. The caller
        (WorkflowExecutor.load_state_dict) overrides `accepted` with the
        ledger's consumed count and forces `running` to 0 on restore —
        in-flight rollouts and cached-but-unconsumed trajectories die with
        the process, so restoring them raw would permanently shrink the
        staleness cap."""
        with self.lock:
            return dict(
                submitted=self.rollout_stat.submitted,
                accepted=self.rollout_stat.accepted,
                running=self.rollout_stat.running,
            )

    def load_state_dict(self, state: dict) -> None:
        with self.lock:
            self.rollout_stat.submitted = int(state.get("submitted", 0))
            self.rollout_stat.accepted = int(state.get("accepted", 0))
            self.rollout_stat.running = int(state.get("running", 0))
