"""WorkflowExecutor: the asynchronous rollout pipeline driver (a copy of
`areal_tpu/core/workflow_executor.py`).

Submits workflow episodes to the AsyncTaskRunner under StalenessManager
capacity control, validates trajectory format, applies `should_accept`
filtering, stamps each accepted trajectory with its `rollout_id` and
`rollout_version`, and assembles accepted trajectories into padded
training batches. `prepare_batch` keeps >= 2 training batches in flight
so the trainer never starves while staleness permits. While paused,
nothing is admitted: a `wait` then times out (the JAX executor's
behaviour, kept).
"""

from __future__ import annotations

import asyncio
import queue
import random
import time
from typing import TYPE_CHECKING, Any, Callable

import numpy as np

from areal_tpu_torch.api.cli_args import InferenceEngineConfig
from areal_tpu_torch.core.async_task_runner import AsyncTaskRunner, TaskResult
from areal_tpu_torch.core.sample_ledger import SampleLedger, SampleWAL
from areal_tpu_torch.core.staleness_manager import StalenessManager
from areal_tpu_torch.utils import logging, stats_tracker
from areal_tpu_torch.utils.data import concat_padded_tensors, cycle_dataloader

if TYPE_CHECKING:
    from areal_tpu_torch.api.engine_api import InferenceEngine
    from areal_tpu_torch.api.workflow_api import RolloutWorkflow

logger = logging.getLogger("workflow_executor")


ROLLOUT_POLL_WAIT_TIME = 0.4


def check_trajectory_format(traj: dict[str, Any]) -> None:
    """Validate a workflow result batch.

    Requirements: dict of numpy arrays with a leading batch dim shared by
    all array values; must contain `attention_mask` and `input_ids` with
    matching [B, T] shapes.
    """
    if not isinstance(traj, dict) or not traj:
        raise ValueError(f"trajectory must be a non-empty dict, got {type(traj)}")
    if "input_ids" not in traj or "attention_mask" not in traj:
        raise ValueError(
            f"trajectory must contain input_ids and attention_mask, got "
            f"{sorted(traj.keys())}"
        )
    ii, am = np.asarray(traj["input_ids"]), np.asarray(traj["attention_mask"])
    if ii.ndim != 2 or am.shape != ii.shape:
        raise ValueError(
            f"input_ids/attention_mask must be matching [B, T], got "
            f"{ii.shape} vs {am.shape}"
        )
    bs = ii.shape[0]
    for k, v in traj.items():
        arr = np.asarray(v)
        if arr.ndim >= 1 and arr.shape[0] != bs:
            raise ValueError(
                f"trajectory key {k!r} batch dim {arr.shape[0]} != {bs}"
            )


class WorkflowExecutor:
    def __init__(
        self,
        config: InferenceEngineConfig,
        inference_engine: "InferenceEngine",
    ):
        self.config = config
        self.engine = inference_engine
        qsize = config.queue_size or 4096
        self.runner = AsyncTaskRunner(queue_size=qsize, name="rollout")
        max_concurrent = config.max_concurrent_rollouts or 64
        self.staleness_manager = StalenessManager(
            max_concurrent_rollouts=max_concurrent,
            consumer_batch_size=config.consumer_batch_size,
            max_staleness=config.max_head_offpolicyness,
        )
        # submissions deferred until staleness capacity admits them
        self._pending_inputs: queue.Queue = queue.Queue(maxsize=qsize)
        self._result_cache: list[dict[str, Any]] = []
        self._data_generator = None
        self._version = 0
        self._paused = False
        self._consecutive_failures = 0
        # exactly-once sample accounting: rollout-id issuance, consumed-id
        # dedup, and the consumed-batch WAL (core/sample_ledger.py)
        self.ledger = SampleLedger()

    # -- lifecycle ------------------------------------------------------
    def initialize(self, train_data_parallel_size: int | None = None) -> None:
        self.runner.start()

    def destroy(self) -> None:
        self.runner.destroy()

    # -- versioning -----------------------------------------------------
    def set_version(self, version: int) -> None:
        self._version = version

    def get_version(self) -> int:
        return self._version

    # -- flow control ---------------------------------------------------
    def pause(self) -> None:
        """Stop admitting new rollouts (weight-update window)."""
        self._paused = True
        self.runner.pause()

    def resume(self) -> None:
        self._paused = False
        self.runner.resume()

    @property
    def paused(self) -> bool:
        return self._paused

    # -- submission -----------------------------------------------------
    def submit(
        self,
        data: dict[str, Any],
        workflow: "RolloutWorkflow | None" = None,
        workflow_builder: Callable | None = None,
        should_accept: Callable | None = None,
        rollout_id: int | None = None,
    ) -> None:
        """Queue one episode; actual launch happens when capacity allows.

        `rollout_id` gives the episode a caller-chosen stable identity
        (deterministic resubmission after a trainer restart regenerates
        the same ids, so the ledger can dedup); default is the ledger's
        next monotone id."""
        assert workflow is not None or workflow_builder is not None
        rid = self.ledger.new_rid() if rollout_id is None else int(rollout_id)
        try:
            self._pending_inputs.put_nowait(
                (rid, data, workflow, workflow_builder, should_accept)
            )
        except queue.Full:
            raise RuntimeError("workflow executor input queue full") from None

    def _launch_one(self, item) -> None:
        rid, data, workflow, workflow_builder, should_accept = item
        if workflow is None:
            workflow = workflow_builder()
        sm = self.staleness_manager
        engine = self.engine
        tracing = self.config.enable_rollout_tracing
        check_format = self.config.check_trajectory_format

        async def episode():
            traj = await workflow.arun_episode(engine, data)
            if traj is not None and check_format:
                check_trajectory_format(traj)
            if traj is not None and should_accept is not None and not should_accept(traj):
                traj = None
            return rid, traj

        task_id = self.runner.submit(episode)
        sm.on_rollout_submitted()
        if tracing:
            logger.info(f"submitted rollout task {task_id} (rid {rid})")

    def _admit_pending(self) -> None:
        """Move pending submissions into the runner within capacity."""
        if self._paused:
            return
        capacity = self.staleness_manager.get_capacity(self._version)
        while capacity > 0:
            try:
                item = self._pending_inputs.get_nowait()
            except queue.Empty:
                return
            self._launch_one(item)
            capacity -= 1

    def _collect(self) -> None:
        results = self.runner.poll_results()
        for i, tr in enumerate(results):
            try:
                self._on_result(tr)
            except BaseException:
                # the failure-streak escalation raises out of here; the
                # drained-but-unprocessed tail still owns running slots —
                # requeue it so the accounting stays collectable instead
                # of leaking with the dropped list
                self.runner.requeue_results(results[i + 1:])
                raise

    def _on_result(self, tr: TaskResult) -> None:
        sm = self.staleness_manager
        if tr.exception is not None:
            # whatever killed the episode, its capacity slot is released
            # exactly once here — the runner guarantees one TaskResult per
            # task (including cancelled ones), so `running` can neither
            # leak nor double-release on a cancel-then-fail race
            sm.on_rollout_rejected()
            if isinstance(tr.exception, asyncio.CancelledError):
                # a drained (pause/shutdown) episode is not evidence of a
                # sick engine — release the slot but don't feed the
                # consecutive-failure escalation
                return
            # A systematic failure (e.g. crashed decode engine) must surface
            # instead of spinning forever resubmitting doomed episodes.
            self._consecutive_failures += 1
            if self._consecutive_failures >= 16:
                # embed the root cause in the message itself — operators see
                # the raised line long before they dig for the __cause__
                raise RuntimeError(
                    f"16 consecutive rollout episodes failed; last error: "
                    f"{tr.exception!r}"
                ) from tr.exception
            return
        # any completed episode (accepted or rejected) breaks the streak
        self._consecutive_failures = 0
        rid, traj = tr.result
        if traj is None:
            sm.on_rollout_rejected()
            if self.config.enable_rollout_tracing:
                logger.info(f"rollout {tr.task_id} (rid {rid}) rejected")
            return
        if not self.ledger.on_accepted(rid, self._version):
            # already consumed (or already pending) — a duplicate from a
            # still-running replica after a trainer restart; training on it
            # again would double-count the sample
            sm.on_rollout_rejected()
            logger.info(f"rollout rid {rid} deduped (already in ledger)")
            return
        sm.on_rollout_accepted()
        # stamp identity so the batch carries provenance through
        # concat/microbatching and wait() can journal what it consumed
        key0 = "input_ids" if "input_ids" in traj else next(iter(traj))
        bs = int(np.asarray(traj[key0]).shape[0])
        traj["rollout_id"] = np.full((bs,), rid, dtype=np.int64)
        traj["rollout_version"] = np.full((bs,), self._version, dtype=np.int64)
        self._result_cache.append(traj)

    # -- collection -----------------------------------------------------
    def wait(self, count: int, timeout: float | None = None) -> dict[str, Any]:
        """Block until `count` accepted trajectories exist; returns their
        concatenation as one padded batch."""
        deadline = (
            time.monotonic() + (timeout if timeout is not None else 3600.0)
        )
        while len(self._result_cache) < count:
            self.runner.health_check()
            self._admit_pending()
            self._collect()
            if len(self._result_cache) >= count:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"wait({count}): only {len(self._result_cache)} accepted"
                )
            time.sleep(ROLLOUT_POLL_WAIT_TIME / 100)
        results, self._result_cache = (
            self._result_cache[:count],
            self._result_cache[count:],
        )
        # journal the consumed batch BEFORE handing it to the trainer: the
        # WAL entry is durable by the time any weight update can depend on
        # these samples, so crash recovery can tell trained from lost
        rids = [int(np.asarray(r["rollout_id"]).flat[0]) for r in results
                if "rollout_id" in r]
        if rids:
            self.ledger.on_consumed(rids, self._version)
        # Shuffle so GRPO groups from the same prompt don't correlate with
        # batch position.
        random.shuffle(results)
        return concat_padded_tensors(results)

    def rollout_batch(
        self,
        data: list[dict[str, Any]],
        workflow: "RolloutWorkflow | None" = None,
        workflow_builder: Callable | None = None,
        should_accept: Callable | None = None,
    ) -> dict[str, Any]:
        """Synchronous batch rollout: submit all, wait for all."""
        for item in data:
            self.submit(item, workflow, workflow_builder, should_accept)
        return self.wait(count=len(data))

    def prepare_batch(
        self,
        dataloader,
        workflow: "RolloutWorkflow | None" = None,
        workflow_builder: Callable | None = None,
        should_accept: Callable | None = None,
    ) -> dict[str, Any]:
        """Async pipeline heart: keep >=2 batches of episodes in flight and
        return one training batch when ready."""
        if self._data_generator is None:
            self._data_generator = cycle_dataloader(dataloader)
        batch_size = dataloader.batch_size
        assert batch_size is not None
        while True:
            self.runner.health_check()
            capacity = self.staleness_manager.get_capacity(self._version)
            pending_total = (
                self._pending_inputs.qsize()
                + self.runner.inflight
                + len(self._result_cache)
            )
            # keep two batches in the pipeline
            if capacity + batch_size > 0 and pending_total < 2 * batch_size:
                items = next(self._data_generator)
                if isinstance(items, dict):
                    items = [items]
                for item in items:
                    self.submit(item, workflow, workflow_builder, should_accept)
            self._admit_pending()
            self._collect()
            if len(self._result_cache) >= batch_size:
                with stats_tracker.record_timing("prepare_batch/concat"):
                    return self.wait(batch_size, timeout=1)
            time.sleep(ROLLOUT_POLL_WAIT_TIME / 10)

    def get_stats(self):
        return self.staleness_manager.get_stats()

    # -- checkpointing ---------------------------------------------------
    def attach_ledger_wal(self, path: str) -> None:
        """Journal consumed batches to a WAL at `path` (colocated with the
        recover checkpoints; see utils/recover.ledger_wal_path)."""
        self.ledger.attach_wal(SampleWAL(path))

    def state_dict(self) -> dict[str, Any]:
        """Sample-ledger + staleness accounting, committed inside the
        recover checkpoint (RecoverInfo.ledger_info)."""
        return dict(
            ledger=self.ledger.state_dict(),
            staleness=self.staleness_manager.state_dict(),
        )

    def load_state_dict(self, state: dict[str, Any]) -> None:
        """Restore after a trainer crash. The staleness cap is recomputed
        from the ledger: `accepted` := consumed count (cached-but-
        unconsumed trajectories died with the process and will be
        regenerated — restoring the raw accepted counter would permanently
        shrink capacity by the lost cache), `running` := 0 (nothing is in
        flight in a fresh process). The attached WAL is rolled back to the
        committed sequence inside ledger.load_state_dict."""
        self.ledger.load_state_dict(state.get("ledger", {}))
        consumed = self.ledger.consumed_count()
        sm_state = dict(state.get("staleness", {}))
        sm_state["accepted"] = consumed
        sm_state["running"] = 0
        sm_state["submitted"] = max(int(sm_state.get("submitted", 0)), consumed)
        self.staleness_manager.load_state_dict(sm_state)
        self._result_cache = []
        self._consecutive_failures = 0
