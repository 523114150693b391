"""Automatic per-checkpoint evaluation watcher (counterpart of
`areal_tpu/evaluation/auto.py`; parity: realhf/scheduler/evaluator.py
`AutomaticEvaluator`).

A trainer-side loop that watches the Saver's checkpoint tree
(`epoch{E}epochstep{S}globalstep{G}`), starts one offline-evaluation job
per new checkpoint (at most `max_concurrent_jobs` at a time, in global-step
order) and publishes each step's results in step order once its job
ends. A job is a subprocess running the offline evaluation CLI
(`python -m areal_tpu_torch.evaluation.eval_and_aggregate`, which runs on
the card) on the saved HF checkpoint; `eval_cmd` replaces that command,
with `{ckpt}` and `{out}` substituted. Results land in
`{output_root}/globalstep{G}/result.json` and go to `publish(g, result)`
lowest step first, exactly once a step. On a restart, a step with an
output directory counts as published. The default publish is a log line.
"""

from __future__ import annotations

import enum
import json
import os
import re
import subprocess
import sys
from dataclasses import dataclass, field

from areal_tpu_torch.utils import logging

logger = logging.getLogger("auto_eval")

_CKPT_RE = re.compile(r"epoch(\d+)epochstep(\d+)globalstep(\d+)$")


class EvalStatus(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    LOGGED = "logged"
    FAILED = "failed"


@dataclass
class EvalStep:
    global_step: int
    ckpt_dir: str
    output_dir: str
    status: EvalStatus = EvalStatus.PENDING
    process: subprocess.Popen | None = field(default=None, repr=False)

    @property
    def result_path(self) -> str:
        return os.path.join(self.output_dir, "result.json")


class AutomaticEvaluator:
    """Watch `ckpt_root` for Saver checkpoints and evaluate each once.

    Call `step()` from the training loop (the reference calls it once per
    training step); it is cheap when nothing changed. `drain()` blocks
    until all submitted jobs finish — for tests and end-of-run flushes.
    """

    def __init__(
        self,
        ckpt_root: str,
        output_root: str,
        data_names: str = "gsm8k",
        tokenizer_path: str = "",
        max_gen_tokens: int = 1024,
        n_sampling: int = 1,
        max_problems: int | None = None,
        max_concurrent_jobs: int = 1,
        eval_cmd: list[str] | None = None,
        publish=None,
    ):
        self.ckpt_root = ckpt_root
        self.output_root = output_root
        self.data_names = data_names
        self.tokenizer_path = tokenizer_path
        self.max_gen_tokens = max_gen_tokens
        self.n_sampling = n_sampling
        self.max_problems = max_problems
        self.max_concurrent_jobs = max_concurrent_jobs
        self._eval_cmd = eval_cmd  # test seam: overrides the CLI invocation
        self._publish = publish or self._default_publish
        self._steps: dict[int, EvalStep] = {}
        # Recover semantics match the reference: any step with existing
        # output is treated as already logged — jobs from before a restart
        # have unknown status, and resubmitting them double-evaluates.
        if os.path.isdir(output_root):
            for d in os.listdir(output_root):
                m = re.match(r"globalstep(\d+)$", d)
                if m:
                    g = int(m.group(1))
                    self._steps[g] = EvalStep(
                        g, "", os.path.join(output_root, d),
                        status=EvalStatus.LOGGED,
                    )

    # -- internals ------------------------------------------------------
    def _default_publish(self, global_step: int, result: dict) -> None:
        logger.info(f"eval globalstep{global_step}: {json.dumps(result)}")

    def _discover(self) -> None:
        if not os.path.isdir(self.ckpt_root):
            return
        for d in sorted(os.listdir(self.ckpt_root)):
            m = _CKPT_RE.search(d)
            if not m:
                continue
            g = int(m.group(3))
            if g in self._steps:
                continue
            ckpt = os.path.join(self.ckpt_root, d)
            self._steps[g] = EvalStep(
                g, ckpt, os.path.join(self.output_root, f"globalstep{g}")
            )
            logger.info(f"found new checkpoint globalstep{g} at {ckpt}")

    def _cmd(self, step: EvalStep) -> list[str]:
        if self._eval_cmd is not None:
            # plain substring substitution: argv strings may legitimately
            # contain braces (inline python via -c), so str.format is unsafe
            return [
                a.replace("{ckpt}", step.ckpt_dir).replace(
                    "{out}", step.output_dir
                )
                for a in self._eval_cmd
            ]
        cmd = [
            sys.executable,
            "-m",
            "areal_tpu_torch.evaluation.eval_and_aggregate",
            "--data-names", self.data_names,
            "--model-path", step.ckpt_dir,
            "--output-path", step.output_dir,
            "--n-sampling", str(self.n_sampling),
            "--max-gen-tokens", str(self.max_gen_tokens),
        ]
        if self.tokenizer_path:
            cmd += ["--tokenizer-path", self.tokenizer_path]
        if self.max_problems is not None:
            cmd += ["--max-problems", str(self.max_problems)]
        return cmd

    def _submit_next(self) -> None:
        running = sum(
            1 for s in self._steps.values() if s.status == EvalStatus.RUNNING
        )
        while running < self.max_concurrent_jobs:
            pending = [
                g
                for g, s in self._steps.items()
                if s.status == EvalStatus.PENDING
            ]
            if not pending:
                return
            step = self._steps[min(pending)]
            os.makedirs(step.output_dir, exist_ok=True)
            log_path = os.path.join(step.output_dir, "eval_job.log")
            with open(log_path, "w") as log:
                step.process = subprocess.Popen(
                    self._cmd(step), stdout=log, stderr=subprocess.STDOUT
                )
            step.status = EvalStatus.RUNNING
            running += 1
            logger.info(
                f"submitted eval job for globalstep{step.global_step} "
                f"(pid {step.process.pid})"
            )

    def _check_running(self) -> None:
        for s in self._steps.values():
            if s.status != EvalStatus.RUNNING:
                continue
            rc = s.process.poll()
            if rc is None:
                continue
            if rc == 0 and os.path.exists(s.result_path):
                s.status = EvalStatus.DONE
            else:
                s.status = EvalStatus.FAILED
                logger.warning(
                    f"eval job for globalstep{s.global_step} failed "
                    f"(rc={rc}); see {s.output_dir}/eval_job.log"
                )

    def _log_in_order(self) -> None:
        # publish the MINIMAL unlogged step once it is done — keeps the
        # published series monotonic in global_step (reference :312-330)
        candidates = [
            g
            for g, s in self._steps.items()
            if s.status not in (EvalStatus.LOGGED, EvalStatus.FAILED)
        ]
        if not candidates:
            return
        g = min(candidates)
        s = self._steps[g]
        if s.status != EvalStatus.DONE:
            return
        try:
            with open(s.result_path) as f:
                result = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            logger.warning(f"unreadable eval result for globalstep{g}: {e}")
            s.status = EvalStatus.FAILED
            return
        self._publish(g, result)
        s.status = EvalStatus.LOGGED

    # -- public surface -------------------------------------------------
    def step(self) -> None:
        self._discover()
        self._submit_next()
        self._check_running()
        self._log_in_order()

    def drain(self, timeout: float | None = None) -> None:
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self.step()
            busy = any(
                s.status in (EvalStatus.PENDING, EvalStatus.RUNNING)
                or s.status == EvalStatus.DONE
                for s in self._steps.values()
            )
            if not busy:
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"eval jobs still busy: "
                    f"{ {g: s.status.value for g, s in self._steps.items()} }"
                )
            time.sleep(0.05)

    @property
    def statuses(self) -> dict[int, str]:
        return {g: s.status.value for g, s in sorted(self._steps.items())}
