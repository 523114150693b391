"""Launcher job bookkeeping (a copy of `areal_tpu/launcher/base.py`): the
job state machine and the exit classification."""

from __future__ import annotations

import dataclasses
import enum
import os
import signal
import subprocess
import time


class JobFailure(RuntimeError):
    """A launcher job exited non-zero. `recoverable` marks preemption-like
    exits (SIGKILL, SIGTERM) worth restarting the experiment for, against
    deterministic failures that would only loop."""

    def __init__(self, msg: str, *, recoverable: bool = False):
        super().__init__(msg)
        self.recoverable = recoverable


class JobState(enum.Enum):
    NOT_FOUND = 0
    PENDING = 1
    RUNNING = 2
    COMPLETED = 3
    FAILED = 4
    CANCELLED = 5

    def active(self) -> bool:
        return self in (JobState.PENDING, JobState.RUNNING)


# exits treated as preemptions: killed (137) or terminated (143)
RECOVERABLE_RETURNCODES = {-signal.SIGKILL, -signal.SIGTERM, 137, 143}


@dataclasses.dataclass
class JobInfo:
    name: str
    cmd: list[str]
    proc: subprocess.Popen | None = None
    log_path: str | None = None
    start_time: float = dataclasses.field(default_factory=time.monotonic)

    @property
    def state(self) -> JobState:
        if self.proc is None:
            return JobState.PENDING
        rc = self.proc.poll()
        if rc is None:
            return JobState.RUNNING
        return JobState.COMPLETED if rc == 0 else JobState.FAILED

    @property
    def returncode(self) -> int | None:
        return None if self.proc is None else self.proc.poll()

    def recoverable(self) -> bool:
        rc = self.returncode
        return rc is not None and rc in RECOVERABLE_RETURNCODES


def kill_process_tree(proc: subprocess.Popen, grace_seconds: float = 5.0) -> None:
    """SIGTERM the job's process group, then SIGKILL what is left after
    `grace_seconds`; returns once the process has been reaped."""
    if proc.poll() is not None:
        return
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        proc.terminate()
    try:
        proc.wait(timeout=grace_seconds)
        return
    except subprocess.TimeoutExpired:
        pass
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        proc.kill()
    proc.wait()
