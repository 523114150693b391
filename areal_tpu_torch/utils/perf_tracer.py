"""Chrome-trace (catapult) JSON performance tracer and the device-trace
window (counterpart of `areal_tpu/utils/perf_tracer.py`).

Host half, as in JAX: `PerfTracer` records sync scopes, async begin/end
pairs and instants under the categories compute/comm/io/sync/scheduler/misc,
saves per-rank catapult JSON, merges rank files, and is initialised from
`AREAL_TPU_PERF_TRACE` and `AREAL_TPU_PERF_TRACE_DIR`.

Device half, on `torch.profiler` (the JAX module's is `jax.profiler`):

- `xprof_trace(log_dir)` is a profile window (CPU activity, and CUDA
  activity unless the device is the CPU) whose Chrome trace goes to
  `log_dir` or `AREAL_TPU_XPROF_DIR`;
- `annotate(name)` is a `torch.profiler.record_function` range, plus an
  NVTX range when the device is a CUDA card;
- `maybe_xprof_step(step, owner)` is the train engine's env-gated window:
  with `AREAL_TPU_XPROF_DIR` set it starts a profile at the first step of
  `AREAL_TPU_XPROF_STEPS` (default "2-4", inclusive) and ends it after the
  last. The first owner to reach the start step claims the window and only
  that owner ends it (a PPO actor and its critic share a process); an
  atexit hook flushes a window the run never closed. One window per
  process: the state resets only through `reset_xprof_window`.

Each exported window is `xprof-{pid}-{n}.pt.trace.json` under the
directory.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path

_CATEGORIES = ("compute", "comm", "io", "sync", "scheduler", "misc")


class PerfTracer:
    def __init__(self, rank: int = 0, save_path: str | None = None, enabled: bool = True):
        self.rank = rank
        self.save_path = save_path
        self.enabled = enabled
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        if enabled and save_path:
            atexit.register(self.save)

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextmanager
    def trace_scope(self, name: str, category: str = "compute", **args):
        if not self.enabled:
            yield
            return
        start = self._now_us()
        try:
            yield
        finally:
            end = self._now_us()
            with self._lock:
                self._events.append(
                    dict(
                        name=name,
                        cat=category if category in _CATEGORIES else "misc",
                        ph="X",
                        ts=start,
                        dur=end - start,
                        pid=self.rank,
                        tid=threading.get_ident() % 100000,
                        args=args,
                    )
                )

    # async (flow) events for spans across threads, e.g. a rollout's life
    def atrace_begin(self, name: str, aid: str, category: str = "scheduler"):
        if not self.enabled:
            return
        with self._lock:
            self._events.append(
                dict(name=name, cat=category, ph="b", id=aid, ts=self._now_us(),
                     pid=self.rank, tid=0)
            )

    def atrace_end(self, name: str, aid: str, category: str = "scheduler"):
        if not self.enabled:
            return
        with self._lock:
            self._events.append(
                dict(name=name, cat=category, ph="e", id=aid, ts=self._now_us(),
                     pid=self.rank, tid=0)
            )

    def instant(self, name: str, category: str = "misc", **args):
        if not self.enabled:
            return
        with self._lock:
            self._events.append(
                dict(name=name, cat=category, ph="i", ts=self._now_us(),
                     pid=self.rank, tid=0, s="p", args=args)
            )

    def save(self, path: str | None = None) -> str | None:
        path = path or self.save_path
        if not path or not self.enabled:
            return None
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            events = list(self._events)
        with open(p, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return str(p)

    @staticmethod
    def merge(rank_files: list[str], out_path: str) -> str:
        """Merge per-rank trace files into one; unreadable files are
        skipped."""
        merged: list[dict] = []
        for rf in rank_files:
            try:
                with open(rf) as f:
                    merged.extend(json.load(f).get("traceEvents", []))
            except (OSError, json.JSONDecodeError):
                continue
        with open(out_path, "w") as f:
            json.dump({"traceEvents": merged, "displayTimeUnit": "ms"}, f)
        return out_path


_tracer: PerfTracer | None = None


def init_from_env(rank: int = 0) -> PerfTracer:
    """Initialise the global tracer from the AREAL_TPU_PERF_TRACE* env vars."""
    global _tracer
    enabled = os.environ.get("AREAL_TPU_PERF_TRACE", "0") in ("1", "true")
    trace_dir = os.environ.get("AREAL_TPU_PERF_TRACE_DIR", "/tmp/areal_tpu/traces")
    path = os.path.join(trace_dir, f"trace-rank{rank}.json") if enabled else None
    _tracer = PerfTracer(rank=rank, save_path=path, enabled=enabled)
    return _tracer


def get() -> PerfTracer:
    global _tracer
    if _tracer is None:
        _tracer = init_from_env()
    return _tracer


def trace_scope(name: str, category: str = "compute", **args):
    return get().trace_scope(name, category, **args)


# ---------------------------------------------------------------------------
# The device trace: torch.profiler windows exported as Chrome traces.
# ---------------------------------------------------------------------------


def _activities(device=None) -> list:
    import torch
    from torch.profiler import ProfilerActivity

    if device is None:
        cuda = torch.cuda.is_available()
    else:
        cuda = torch.device(device).type == "cuda"
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


_trace_seq = itertools.count()


def _export(prof, target: str) -> str:
    os.makedirs(target, exist_ok=True)
    path = os.path.join(target, f"xprof-{os.getpid()}-{next(_trace_seq)}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextmanager
def xprof_trace(log_dir: str | None = None, device=None):
    """Profile the enclosed block and export its Chrome trace under
    `log_dir` (or AREAL_TPU_XPROF_DIR); yields the directory, or None (and
    profiles nothing) when neither is set."""
    target = log_dir or os.environ.get("AREAL_TPU_XPROF_DIR")
    if not target:
        yield None
        return
    from torch.profiler import profile

    prof = profile(activities=_activities(device))
    prof.start()
    try:
        yield target
    finally:
        prof.stop()
        _export(prof, target)


class annotate:
    """A named range in the device trace (`record_function`), and an NVTX
    range on a CUDA device; cheap when no profile is running."""

    def __init__(self, name: str, device=None):
        self.name = name
        self._nvtx = device is not None and getattr(device, "type", str(device)).startswith(
            "cuda")
        self._rf = None

    def __enter__(self):
        import torch

        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        self._rf.__exit__(*exc)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        return False


# one profiler per process: "owner" records which engine claimed the
# window, so co-resident engines (a PPO actor and its critic both call
# maybe_xprof_step from train_batch) neither end nor skew each other's
_xprof_state = {"active": False, "done": False, "owner": None, "prof": None,
                "target": None}
_atexit_registered = False


def _xprof_flush() -> str | None:
    """End the window in progress and export its trace; its path, or None
    when no window is open."""
    if not _xprof_state["active"]:
        return None
    prof, target = _xprof_state["prof"], _xprof_state["target"]
    prof.stop()
    _xprof_state.update(active=False, owner=None, prof=None, done=True)
    return _export(prof, target)


def reset_xprof_window() -> str | None:
    """Flush any open window and allow a new one (a script that runs
    several trainers in one process traces each)."""
    path = _xprof_flush()
    _xprof_state.update(active=False, done=False, owner=None, prof=None, target=None)
    return path


def maybe_xprof_step(step: int, owner: object = None, device=None) -> None:
    """The env-gated window for training loops: with AREAL_TPU_XPROF_DIR set
    it starts a profile at the first step of AREAL_TPU_XPROF_STEPS (default
    "2-4", inclusive) and ends it at the first later step of the owner that
    started it. Called by the train engine at the top of every train_batch;
    free when the variable is unset."""
    global _atexit_registered
    target = os.environ.get("AREAL_TPU_XPROF_DIR")
    if not target or _xprof_state["done"]:
        return
    lo, _, hi = os.environ.get("AREAL_TPU_XPROF_STEPS", "2-4").partition("-")
    lo, hi = int(lo), int(hi or lo)
    if not _xprof_state["active"] and lo <= step <= hi:
        from torch.profiler import profile

        prof = profile(activities=_activities(device))
        prof.start()
        _xprof_state.update(active=True, owner=owner, prof=prof, target=target)
        if not _atexit_registered:
            # a short run (or a crash in the window) never reaches a step
            # past the window: flush at exit so the capture is kept
            atexit.register(_xprof_flush)
            _atexit_registered = True
    elif _xprof_state["active"] and step > hi and _xprof_state["owner"] == owner:
        _xprof_flush()
