"""Tool-integrated reasoning (TIR) workflow: generation and tool execution
in turn (counterpart of `areal_tpu/workflow/tir.py`; parity: the
reference's examples/tir/{tir_workflow,tool_manager}.py).

The model reasons in text and opens a tool's marker (```python by
default) when it wants to compute; the runtime runs the tool, splices its
output back into the context, and generation resumes; the final answer is
scored by the task's verifiable reward.

Rounds are cut by the decode engine's stop strings (so the engine needs a
tokenizer): outside a tool block generation halts on any tool's opening
marker, inside one on that tool's closing marker. Executed code runs in a
killed-on-timeout subprocess with rlimits (the isolation model of
`reward/_code_runner.py`), and tool outputs enter the sequence as context
tokens (loss mask 0, logprob 0, version -1): the policy is never trained
to imitate tool output. Each round after the first re-sends the sequence
so far, which the decode engine serves from its prefix registry.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
import uuid
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from areal_tpu_torch.api.cli_args import GenerationHyperparameters
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.api.reward_api import AsyncRewardWrapper
from areal_tpu_torch.api.reward_api import reward_kwargs as _reward_kwargs
from areal_tpu_torch.api.workflow_api import RolloutWorkflow
from areal_tpu_torch.utils import logging
from areal_tpu_torch.utils.data import pad_sequences_to_tensors

logger = logging.getLogger("tir")

CODE_START = "```python\n"
CODE_END = "```\n"
OUTPUT_TEMPLATE = "```output\n{out}```\n"


def _tool_rlimits(cpu_seconds: float, memory_mb: int = 1024):
    """preexec_fn applying the same class of rlimits the reward sandbox
    uses (reward/_code_runner.py): CPU, address space, process count."""
    import resource

    def apply():
        os.setsid()  # own process group: the killer reaps grandchildren too
        cpu = max(1, int(cpu_seconds) + 1)
        resource.setrlimit(resource.RLIMIT_CPU, (cpu, cpu))
        mem = memory_mb * 1024 * 1024
        resource.setrlimit(resource.RLIMIT_AS, (mem, mem))
        try:
            resource.setrlimit(resource.RLIMIT_NPROC, (64, 64))
        except (ValueError, OSError):
            pass

    return apply


def run_python_tool(
    code: str, timeout_seconds: float = 8.0, max_output_chars: int = 2000
) -> str:
    """Execute `code` in a fresh python subprocess under rlimits (CPU,
    memory, nproc) in its own session; the whole process GROUP is killed on
    timeout, so spawned grandchildren holding the output pipe cannot stall
    the rollout loop past the deadline. Returns stdout+stderr, truncated.

    Threat model: RESOURCE isolation only, same as the reference's
    PythonExecutor (examples/tir/tools/python_code.py) — the policy model
    is assumed trusted-but-buggy, not adversarial. `-I` (isolated mode)
    keeps the repo and cwd off sys.path and env vars out, and the child
    runs in a throwaway tempdir, but it retains the training user's
    filesystem and network access. Untrusted-model deployments need an
    external sandbox (container/jail) around the whole rollout worker.
    """
    proc = None
    workdir = tempfile.mkdtemp(prefix="tir_tool_")
    try:
        proc = subprocess.Popen(
            [sys.executable, "-I", "-c", code],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=workdir,
            preexec_fn=_tool_rlimits(timeout_seconds),
        )
        out, _ = proc.communicate(timeout=timeout_seconds)
    except subprocess.TimeoutExpired:
        out = f"TimeoutError: code did not finish in {timeout_seconds}s\n"
    except Exception as e:  # noqa: BLE001 — tool failure is model feedback
        out = f"{type(e).__name__}: {e}\n"
    finally:
        if proc is not None and proc.poll() is None:
            import signal

            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                proc.kill()
            proc.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    if len(out) > max_output_chars:
        out = out[:max_output_chars] + "...(truncated)\n"
    if not out.endswith("\n"):
        out += "\n"
    return out


@dataclass
class Tool:
    """One invocable tool: the model opens `start_marker`, writes the
    tool's input, closes with `end_marker`; `fn(input) -> output` runs in
    the workflow and `output_template.format(out=...)` re-enters the
    context (parity: examples/tir/tools/base.py ToolDescription)."""

    name: str
    start_marker: str
    end_marker: str
    fn: Callable[[str], str]
    output_template: str = "<result>\n{out}</result>\n"


def python_tool(timeout_seconds: float = 8.0) -> Tool:
    return Tool(
        name="python",
        start_marker=CODE_START,
        end_marker=CODE_END,
        fn=lambda code: run_python_tool(code, timeout_seconds),
        output_template=OUTPUT_TEMPLATE,
    )


def calculator_tool() -> Tool:
    """<calculator>expr</calculator> — arithmetic via the restricted AST
    evaluator (utils/arith_eval.py; no code execution at all; parity:
    examples/tir/tools/calculator_tool.py)."""
    from areal_tpu_torch.utils.arith_eval import safe_eval_arithmetic

    def calc(expr: str) -> str:
        v = safe_eval_arithmetic(expr.strip())
        if v is None:
            return "error: invalid expression\n"
        # the evaluator keeps ints exact (arbitrary precision); floats
        # render via repr so nothing is silently rounded
        if isinstance(v, int) or (
            isinstance(v, float) and v.is_integer() and abs(v) < 1e15
        ):
            return f"{int(v)}\n"
        return f"{v!r}\n"

    return Tool(
        name="calculator",
        start_marker="<calculator>",
        end_marker="</calculator>",
        fn=calc,
    )


def search_tool(corpus: list[str], top_k: int = 3) -> Tool:
    """<search>query</search> over an in-memory corpus, scored by term
    overlap weighted by inverse document frequency — the air-gapped
    stand-in for the reference search-agent's retrieval service
    (examples/search-agent/tongyi_deepresearch/tool_search.py)."""
    import math
    import re as _re

    def terms(text: str) -> list[str]:
        return _re.findall(r"[a-z0-9]+", text.lower())

    doc_terms = [set(terms(d)) for d in corpus]
    n = max(len(corpus), 1)
    df: dict[str, int] = {}
    for ts in doc_terms:
        for t in ts:
            df[t] = df.get(t, 0) + 1

    def search(query: str) -> str:
        q = set(terms(query))
        scored = []
        for i, ts in enumerate(doc_terms):
            score = sum(
                math.log(1 + n / df[t]) for t in q & ts
            )
            if score > 0:
                scored.append((score, i))
        scored.sort(reverse=True)
        if not scored:
            return "no results\n"
        return "".join(
            f"[{rank + 1}] {corpus[i][:400]}\n"
            for rank, (_, i) in enumerate(scored[:top_k])
        )

    return Tool(name="search", start_marker="<search>",
                end_marker="</search>", fn=search)


class TIRWorkflow(RolloutWorkflow):
    def __init__(
        self,
        reward_fn: Callable[..., float],
        gconfig: GenerationHyperparameters,
        tokenizer: Any,
        max_tool_calls: int = 4,
        tool_timeout_seconds: float = 8.0,
        reward_timeout_seconds: float = 15.0,
        tool_fn: Callable[[str], str] | None = None,
        dump_dir: str | None = None,
        enable_thinking: bool = False,
        tools: list[Tool] | None = None,
    ):
        self.reward_fn = AsyncRewardWrapper(
            reward_fn, timeout_seconds=reward_timeout_seconds
        )
        self.gconfig = gconfig
        self.tokenizer = tokenizer
        self.max_tool_calls = max_tool_calls
        self.tool_timeout_seconds = tool_timeout_seconds
        self.dump_dir = dump_dir
        self.enable_thinking = enable_thinking
        if tools is None:
            tools = [python_tool(tool_timeout_seconds)]
        if tool_fn is not None:
            # back-compat/test seam: override the python tool's executor
            tools = [
                dataclasses.replace(t, fn=tool_fn)
                if t.name == "python"
                else t
                for t in tools
            ]
        self.tools = tools

    async def _one_sample(self, engine, data, prompt_ids):
        import asyncio

        seq = list(prompt_ids)
        loss_mask = [0] * len(seq)
        logprobs = [0.0] * len(seq)
        versions = [-1] * len(seq)
        # `remaining` budgets NEW tokens of all kinds — generated AND
        # spliced tool output — so a request can never outgrow the decode
        # engine's context_length through tool-output growth alone
        remaining = self.gconfig.max_new_tokens
        task_stops = list(self.gconfig.stop or [])

        # Two-phase marker state machine (reference tir_workflow.py:
        # 269-277): outside a tool block, generation halts only on a
        # tool's OPENING marker (a bare markdown fence in the answer is
        # not a tool call and must not end the episode); inside one, it
        # halts on THAT tool's closing marker, which triggers execution.
        active: Tool | None = None
        code_buf = ""  # tool-input chars accumulated across phase-B rounds
        tool_calls = 0
        while remaining > 0:
            stops = task_stops + (
                [active.end_marker]
                if active is not None
                else [t.start_marker for t in self.tools]
            )
            req = ModelRequest(
                rid=str(uuid.uuid4()),
                input_ids=list(seq),
                gconfig=self.gconfig.new(
                    n_samples=1, max_new_tokens=remaining, stop=stops
                ),
                tokenizer=self.tokenizer,
            )
            resp = await engine.agenerate(req)
            seq += resp.output_tokens
            loss_mask += [1] * resp.output_len
            logprobs += resp.output_logprobs
            versions += resp.output_versions
            remaining -= resp.output_len
            if remaining <= 0 or resp.stop_reason != "stop":
                break
            # NOTE the engine's stop-string cut lands on a TOKEN boundary:
            # with BPE tokenizers the retained text can extend a few chars
            # past the fence (e.g. "```python\nimport"), so match by
            # position, never by exact endswith.
            text = self.tokenizer.decode(resp.output_tokens)
            if active is None:
                best = max(
                    ((text.rfind(t.start_marker), t) for t in self.tools),
                    key=lambda x: x[0],
                )
                if best[0] < 0:
                    break  # genuine stop (eos / task stop string)
                active = best[1]
                # boundary overshoot chars already belong to the input
                code_buf = text[best[0] + len(active.start_marker):]
                continue
            tool = active
            active = None
            needle = tool.end_marker.strip()
            end = text.rfind(needle)
            # The close must sit at the END of the round's text (modulo one
            # token of stop-cut overshoot) — a marker-lookalike earlier in
            # the tool input (e.g. a bare \`\`\` inside a string literal)
            # followed by a TASK stop must end the episode, not execute
            # truncated input.
            if end < 0 or len(text) - (end + len(needle)) > 24:
                break  # a task stop matched inside the block: episode over
            code = code_buf + text[:end]
            code_buf = ""
            if tool_calls >= self.max_tool_calls:
                break  # budget spent: no further sandbox runs
            tool_calls += 1
            # off the event loop: a slow tool must not stall the other
            # samples/rollouts sharing the loop
            tool_out = await asyncio.to_thread(tool.fn, code)
            tool_ids = self.tokenizer.encode(
                tool.output_template.format(out=tool_out),
                add_special_tokens=False,  # no stray BOS mid-sequence
            )
            tool_ids = tool_ids[: max(remaining - 1, 0)]
            remaining -= len(tool_ids)
            # tool output is CONTEXT, not behavior: never trained on
            seq += tool_ids
            loss_mask += [0] * len(tool_ids)
            logprobs += [0.0] * len(tool_ids)
            versions += [-1] * len(tool_ids)

        completion_str = self.tokenizer.decode(seq[len(prompt_ids):])
        reward = await self.reward_fn(
            None,
            completion_str,
            prompt_ids,
            seq[len(prompt_ids):],
            **_reward_kwargs(data),
        )
        return dict(
            input_ids=np.array(seq, dtype=np.int32),
            loss_mask=np.array(loss_mask, dtype=np.int32),
            logprobs=np.array(logprobs, dtype=np.float32),
            versions=np.array(versions, dtype=np.int32),
            rewards=np.float32(float(reward)),
            begin_of_answer=np.int32(len(prompt_ids)),
        )

    async def arun_episode(self, engine, data: dict[str, Any]):
        import asyncio

        from areal_tpu_torch.api.workflow_api import encode_prompt

        prompt_ids = encode_prompt(
            self.tokenizer, data, enable_thinking=self.enable_thinking
        )
        rows = await asyncio.gather(
            *[
                self._one_sample(engine, data, prompt_ids)
                for _ in range(self.gconfig.n_samples)
            ]
        )
        if self.dump_dir is not None:
            import json

            version = int(
                max((int(np.asarray(r["versions"]).max()) for r in rows), default=0)
            )
            d = os.path.join(self.dump_dir, str(max(version, 0)))
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"{uuid.uuid4().hex}.jsonl"), "w") as f:
                for r in rows:
                    f.write(
                        json.dumps(
                            dict(
                                text=self.tokenizer.decode(r["input_ids"]),
                                reward=float(r["rewards"]),
                            )
                        )
                        + "\n"
                    )
        return pad_sequences_to_tensors(list(rows))
