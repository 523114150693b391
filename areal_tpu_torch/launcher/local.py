"""Local launcher: decode servers and trainer processes on one host
(counterpart of `areal_tpu/launcher/local.py`).

`run_experiment` reads the allocation mode: for DECOUPLED_TRAIN
(`jax:d1+d1`) it starts one decode server
(`python -m areal_tpu_torch.launcher.decode_server`) with the
experiment's decode settings, waits until it registers under
name_resolve, then starts the trainer, waits for it, and tears the
server down; a COLOCATE allocation starts the trainer alone. Every
process gets the experiment's name_resolve store through the
environment (`name_resolve.to_env`), and the launcher's device through
`--device` for the server (the card by default). With one server of one
device both processes see the whole card, as the JAX launcher leaves
chip visibility alone for a single replica. A recoverable failure
(SIGKILL, SIGTERM) restarts the whole experiment up to `recover.retries`
times when `recover.mode` is "auto" or "fault". Offline sentinel models
(`synthetic-arith`) are served from scratch at the smoke geometry
(`models/smoke.SMOKE_MODEL_DICT`).

    python -m areal_tpu_torch.launcher.local entry.py --config cfg.yaml [k=v ...]

More than one server or device in one allocation is ROADMAP.md queue 1,
item 5 (refused by `api/alloc_mode.py`). A fleet of servers on one host is
the supervisor's (`launcher/supervisor.py`): `spawn_decode_server` is its
`spawn_fn` seam, one decode-server subprocess that registers itself and a
`DecodeServerHandle` to kill it; the router (`launcher/router.py`) finds
the servers through name_resolve.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

from areal_tpu_torch.api.alloc_mode import AllocationMode, AllocationType
from areal_tpu_torch.launcher.base import JobFailure, JobInfo, JobState, kill_process_tree
from areal_tpu_torch.utils import logging, name_resolve, names
from areal_tpu_torch.utils.network import find_free_ports, gethostip

logger = logging.getLogger("local_launcher")

RECOVER_TIME_INTERVAL = 10.0
# the directory that holds the `areal_tpu_torch` package: on every job's
# PYTHONPATH, so an entry point given as a file path imports the package
_PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


class DecodeServerHandle:
    """A launched decode server as the supervisor sees it (JAX :41-57): the
    address it registered under, and a kill that ends its process tree and
    drops it from the launcher's jobs (a kill the supervisor asked for is
    not a failure)."""

    def __init__(self, launcher: "LocalLauncher", job: JobInfo, addr: str):
        self._launcher = launcher
        self.job = job
        self.addr = addr

    def kill(self) -> None:
        if self.job.proc is not None:
            kill_process_tree(self.job.proc)
        if self.job in self._launcher.jobs:
            self._launcher.jobs.remove(self.job)


class LocalLauncher:
    def __init__(self, experiment_name: str, trial_name: str, fileroot: str):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.fileroot = fileroot
        self.jobs: list[JobInfo] = []

    def log_dir(self) -> str:
        d = os.path.join(self.fileroot, "logs", self.experiment_name, self.trial_name)
        os.makedirs(d, exist_ok=True)
        return d

    # -- submission -----------------------------------------------------
    def submit(self, name: str, cmd: list[str], env: dict[str, str] | None = None) -> JobInfo:
        """Start `cmd` in its own process group, its output appended to
        `<log_dir>/<name>.log`."""
        log_path = os.path.join(self.log_dir(), f"{name}.log")
        full_env = dict(os.environ)
        full_env.update(env or {})
        path = full_env.get("PYTHONPATH", "")
        full_env["PYTHONPATH"] = _PACKAGE_ROOT + (os.pathsep + path if path else "")
        with open(log_path, "ab") as logf:
            proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT, env=full_env,
                                    start_new_session=True)
        job = JobInfo(name=name, cmd=cmd, proc=proc, log_path=log_path)
        self.jobs.append(job)
        logger.info(f"launched {name}: pid={proc.pid} log={log_path}")
        return job

    def submit_decode_server(self, server_idx: int, model_path: str, *,
                             port: int | None = None, extra_args: list[str] | None = None,
                             env: dict[str, str] | None = None) -> JobInfo:
        port = port or find_free_ports(1)[0]
        # a lower CPU priority: the decode loop takes whatever cores it gets,
        # and on a shared host the trainer's host work must win
        nice = ["nice", "-n", "10"] if shutil.which("nice") else []
        cmd = nice + [
            sys.executable, "-m", "areal_tpu_torch.launcher.decode_server",
            "--model-path", model_path,
            "--host", "0.0.0.0",
            "--port", str(port),
            "--experiment-name", self.experiment_name,
            "--trial-name", self.trial_name,
            "--server-id", f"{gethostip()}:{port}",
        ] + (extra_args or [])
        return self.submit(f"decode_server_{server_idx}", cmd, env=env)

    def spawn_decode_server(self, role: str = "unified", *, model_path: str,
                            extra_args: list[str] | None = None,
                            env: dict[str, str] | None = None,
                            timeout: float = 300.0) -> DecodeServerHandle:
        """Start one decode server in `role` and block until it has
        registered (JAX :139-196; the supervisor's `spawn_fn`). A server
        that fails or does not register in `timeout` is reaped and raises
        a recoverable JobFailure, which the supervisor's backoff and crash
        loop own."""
        port = find_free_ports(1)[0]
        addr = f"{gethostip()}:{port}"
        args = list(extra_args or [])
        if role != "unified":
            args += ["--role", role]
        job = self.submit_decode_server(len(self.jobs), model_path, port=port,
                                        extra_args=args, env=env)
        key = names.gen_server(self.experiment_name, self.trial_name, addr)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and job.state is not JobState.FAILED:
            try:
                if name_resolve.get(key) == addr:
                    return DecodeServerHandle(self, job, addr)
            except name_resolve.NameEntryNotFoundError:
                pass
            time.sleep(0.5)
        kill_process_tree(job.proc)
        self.jobs.remove(job)
        raise JobFailure(f"decode server {addr} did not register within {timeout}s "
                         f"(rc={job.returncode}, log {job.log_path})", recoverable=True)

    def wait_decode_servers(self, count: int, timeout: float = 300.0) -> list[str]:
        """Block until `count` servers have registered; their addresses."""
        key = names.gen_servers(self.experiment_name, self.trial_name)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self._raise_on_failure()
            addrs = name_resolve.get_subtree(key)
            if len(addrs) >= count:
                return list(addrs)
            time.sleep(1.0)
        raise TimeoutError(f"{count} decode servers did not register within {timeout}s")

    def submit_trainers(self, entrypoint: list[str], n_procs: int,
                        env: dict[str, str] | None = None) -> list[JobInfo]:
        """Start the trainer process(es); one drives the card."""
        if n_procs != 1:
            raise NotImplementedError(
                f"{n_procs} trainer processes are not in the PyTorch port yet: ROADMAP.md "
                "queue 1, item 5"
            )
        proc_env = {
            "AREAL_EXPERIMENT_NAME": self.experiment_name,
            "AREAL_TRIAL_NAME": self.trial_name,
            **(env or {}),
        }
        return [self.submit("trainer_0", list(entrypoint), env=proc_env)]

    # -- supervision ----------------------------------------------------
    def _raise_on_failure(self) -> None:
        for job in self.jobs:
            if job.state is JobState.FAILED:
                tail = ""
                if job.log_path and os.path.exists(job.log_path):
                    with open(job.log_path, "rb") as f:
                        f.seek(max(0, os.path.getsize(job.log_path) - 4096))
                        tail = f.read().decode(errors="replace")
                raise JobFailure(
                    f"job {job.name} failed rc={job.returncode}\n--- last log lines ---\n{tail}",
                    recoverable=job.recoverable(),
                )

    def poll(self) -> dict[str, JobState]:
        return {j.name: j.state for j in self.jobs}

    def wait(self, check_interval: float = 2.0, until: str = "trainers",
             timeout: float | None = None) -> None:
        """Block until the trainer jobs (`until="all"`: every job) have
        completed, raising JobFailure on the first failed job and
        TimeoutError after `timeout` seconds."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self._raise_on_failure()
            watched = [j for j in self.jobs if until == "all" or j.name.startswith("trainer")]
            if not watched or all(j.state is JobState.COMPLETED for j in watched):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"jobs {self.poll()} still running after {timeout}s")
            time.sleep(check_interval)

    def stop_all(self) -> None:
        for job in reversed(self.jobs):
            if job.proc is not None:
                kill_process_tree(job.proc)
        self.jobs.clear()


def _server_args(config, device) -> list[str]:
    """The decode server's flags from the experiment's decode config."""
    from areal_tpu_torch.models.smoke import OFFLINE_SENTINELS, SMOKE_MODEL_DICT

    dec = config.decode
    extra = [
        "--context-length", str(dec.context_length),
        "--max-running-requests", str(dec.max_running_requests),
        "--new-tokens-per-chunk", str(dec.new_tokens_per_chunk),
        "--dtype", dec.dtype,
        "--seed", str(dec.random_seed),
    ]
    if dec.role != "unified":
        extra += ["--role", dec.role]
    model_path = dec.model_path or config.tokenizer_path
    if model_path in OFFLINE_SENTINELS:
        # offline: the canonical from-scratch model, no download
        extra += ["--scratch-model", json.dumps(SMOKE_MODEL_DICT)]
    if device is not None:
        extra += ["--device", str(device)]
    return extra


def run_experiment(config, entrypoint: list[str], *, max_restarts: int = 0, device=None,
                   timeout: float | None = None) -> None:
    """Start the servers and the trainer of `config`'s allocation, wait
    for the trainer, tear everything down; restart the whole experiment
    on a recoverable failure up to `max_restarts` times. `device` goes to
    the servers as `--device`, and `timeout` bounds each wait."""
    alloc = AllocationMode.from_str(config.allocation_mode)
    decoupled = alloc.type_ == AllocationType.DECOUPLED_TRAIN
    if decoupled and config.cluster.name_resolve.type == "memory":
        raise ValueError(
            "a decoupled allocation needs a name_resolve store shared across processes "
            "(nfs); type='memory' is per process and the trainer could never find the "
            "decode servers"
        )
    config.launcher.check_supported()
    name_resolve.reconfigure(config.cluster.name_resolve)
    nr_env = name_resolve.to_env(config.cluster.name_resolve)
    launcher = LocalLauncher(config.experiment_name, config.trial_name, config.cluster.fileroot)
    model_path = config.decode.model_path or config.tokenizer_path
    attempt = 0
    while True:
        try:
            # registrations of an earlier attempt point at dead servers
            name_resolve.clear_subtree(names.gen_servers(config.experiment_name,
                                                         config.trial_name))
            if decoupled:
                launcher.spawn_decode_server(
                    model_path=model_path,
                    extra_args=_server_args(config, device),
                    env=nr_env, timeout=timeout or 300.0,
                )
            launcher.submit_trainers(entrypoint, n_procs=1, env=nr_env)
            launcher.wait(timeout=timeout)
            launcher.stop_all()  # the trainer is done: the servers go
            return
        except JobFailure as e:
            launcher.stop_all()
            attempt += 1
            if attempt > max_restarts or not e.recoverable:
                raise
            logger.warning(f"experiment failed ({e}); restart {attempt}/{max_restarts} "
                           f"in {RECOVER_TIME_INTERVAL}s")
            time.sleep(RECOVER_TIME_INTERVAL)
        except BaseException:
            launcher.stop_all()
            raise


def main(argv: list[str] | None = None) -> None:
    """python -m areal_tpu_torch.launcher.local entry.py --config cfg.yaml [k=v ...]"""
    from areal_tpu_torch.api.cli_args import BaseExperimentConfig, load_expr_config

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or not argv[0].endswith(".py"):
        raise SystemExit(
            "usage: python -m areal_tpu_torch.launcher.local entry.py --config cfg.yaml [k=v ...]"
        )
    entry = argv[0]
    # the launcher reads the cluster, allocation and launcher fields; the
    # trainer reads the whole config of its entry point
    config, _ = load_expr_config(argv[1:], BaseExperimentConfig, ignore_unknown=True)
    max_restarts = config.recover.retries if config.recover.mode in ("auto", "fault") else 0
    run_experiment(config, [sys.executable, entry] + argv[1:], max_restarts=max_restarts)


if __name__ == "__main__":
    main()
