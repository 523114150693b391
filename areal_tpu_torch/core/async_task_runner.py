"""Generic asyncio-in-a-background-thread task executor (counterpart of
`areal_tpu/core/async_task_runner.py`): submit coroutines from synchronous
code, collect completed results, pause/resume gate, health check,
wait(count, timeout).

The trainer thread is synchronous (it drives the device steps); rollout
episodes are coroutines awaiting the decode engine. This runner owns a
private event loop on a daemon thread and bridges the two worlds with
thread-safe queues. Every task yields exactly one `TaskResult`, a
cancelled one included. The JAX runner's fault-injection seam and its
HTTP session close (the remote engine's) are not in the port.
"""

from __future__ import annotations

import asyncio
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from areal_tpu_torch.utils import logging

logger = logging.getLogger("async_task_runner")


class TaskRunnerError(RuntimeError):
    pass


@dataclass
class TaskResult:
    task_id: int
    result: Any = None
    exception: BaseException | None = None
    latency: float = 0.0
    metadata: dict = field(default_factory=dict)


class AsyncTaskRunner:
    """Runs async task factories on a background event loop."""

    def __init__(self, queue_size: int = 1024, name: str = "runner"):
        self.name = name
        self._input: queue.Queue = queue.Queue(maxsize=queue_size)
        self._output: queue.Queue = queue.Queue(maxsize=queue_size)
        self._paused = threading.Event()  # set = paused
        self._shutdown = threading.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._task_counter = 0
        self._inflight = 0
        self._lock = threading.Lock()
        self._thread_exc: BaseException | None = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        started = threading.Event()

        def _run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            started.set()
            try:
                self._loop.run_until_complete(self._main())
            except BaseException as e:  # noqa: BLE001
                self._thread_exc = e
                logger.error(f"runner thread died: {e}\n{traceback.format_exc()}")
            finally:
                self._loop.close()

        self._thread = threading.Thread(
            target=_run, daemon=True, name=f"AsyncTaskRunner-{self.name}"
        )
        self._thread.start()
        started.wait()

    async def _main(self):
        pending: set[asyncio.Task] = set()
        while not self._shutdown.is_set():
            # Drain the input queue into asyncio tasks (unless paused).
            while not self._paused.is_set():
                try:
                    task_id, factory, meta = self._input.get_nowait()
                except queue.Empty:
                    break
                task = asyncio.ensure_future(
                    self._execute(task_id, factory, meta)
                )
                pending.add(task)
                task.add_done_callback(pending.discard)
            await asyncio.sleep(0.002)
        if pending:
            for t in pending:
                t.cancel()
            await asyncio.gather(*pending, return_exceptions=True)

    async def _execute(self, task_id: int, factory, meta: dict):
        start = time.monotonic()
        finished = False

        def finish(tr: TaskResult) -> None:
            # exactly-once completion accounting: whatever path ends this
            # task (result, failure, cancel, cancel racing a failure), the
            # inflight counter drops ONCE and ONE result is emitted — a
            # leaked decrement here used to wedge StalenessManager capacity
            # (the submitted slot stayed "running" forever)
            nonlocal finished
            if finished:
                return
            finished = True
            with self._lock:
                self._inflight -= 1
            self._output.put(tr)

        try:
            result = await factory()
            finish(
                TaskResult(
                    task_id=task_id,
                    result=result,
                    latency=time.monotonic() - start,
                    metadata=meta,
                )
            )
        except asyncio.CancelledError as e:
            # a cancelled task (pause-window drain, shutdown) still owns a
            # capacity slot — surface a result so the executor releases it
            finish(
                TaskResult(
                    task_id=task_id,
                    exception=e,
                    latency=time.monotonic() - start,
                    metadata=meta,
                )
            )
            raise
        except BaseException as e:  # noqa: BLE001
            logger.error(
                f"task {task_id} failed: {e}\n{traceback.format_exc()}"
            )
            finish(
                TaskResult(
                    task_id=task_id,
                    exception=e,
                    latency=time.monotonic() - start,
                    metadata=meta,
                )
            )

    def destroy(self) -> None:
        self._shutdown.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- health ---------------------------------------------------------
    def health_check(self) -> None:
        if self._thread_exc is not None:
            raise TaskRunnerError(
                f"runner thread crashed: {self._thread_exc}"
            ) from self._thread_exc
        if self._thread is not None and not self._thread.is_alive():
            raise TaskRunnerError("runner thread is not alive")

    # -- flow control ---------------------------------------------------
    def pause(self) -> None:
        """Stop launching queued tasks (in-flight tasks continue)."""
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    @property
    def paused(self) -> bool:
        return self._paused.is_set()

    # -- submission / collection ---------------------------------------
    def submit(
        self, factory: Callable[[], Awaitable[Any]], metadata: dict | None = None
    ) -> int:
        """Enqueue an async task factory; returns its task id."""
        self.health_check()
        with self._lock:
            task_id = self._task_counter
            self._task_counter += 1
            self._inflight += 1
        try:
            self._input.put_nowait((task_id, factory, metadata or {}))
        except queue.Full:
            with self._lock:
                self._inflight -= 1
            raise TaskRunnerError("input queue is full") from None
        return task_id

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def poll_results(self) -> list[TaskResult]:
        """Non-blocking drain of completed results."""
        out = []
        while True:
            try:
                out.append(self._output.get_nowait())
            except queue.Empty:
                return out

    def requeue_results(self, results: list[TaskResult]) -> None:
        """Put drained results back for a later poll. A consumer that
        dies mid-batch (the executor's failure-streak escalation) must
        not drop the unprocessed tail — each result accounts for a
        capacity slot that stays leaked unless someone collects it."""
        for tr in results:
            self._output.put(tr)

    def wait(
        self,
        count: int,
        timeout: float | None = None,
        raise_errors: bool = False,
    ) -> list[TaskResult]:
        """Block until `count` results complete or timeout (TimeoutError)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        results: list[TaskResult] = []
        while len(results) < count:
            self.health_check()
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # put collected results back? The reference discards
                    # partial waits; we re-queue to avoid losing rollouts.
                    for r in results:
                        self._output.put(r)
                    raise TimeoutError(
                        f"wait({count}) timed out with {len(results)} done"
                    )
            try:
                tr = self._output.get(timeout=min(remaining or 0.1, 0.1))
            except queue.Empty:
                continue
            if tr.exception is not None and raise_errors:
                raise TaskRunnerError(
                    f"task {tr.task_id} failed"
                ) from tr.exception
            results.append(tr)
        return results
