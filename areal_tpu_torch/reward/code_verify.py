"""Code-verifier reward: batched sandboxed testcase execution (a copy of
`areal_tpu/reward/code_verify.py`; parity: the reference's
functioncall/code/verify.py `code_verify`).

Problems carry an `input_output` JSON blob ({"inputs": [...], "outputs":
[...], "fn_name": optional}, or {"asserts": [...]} for HumanEval/MBPP
harnesses); a candidate passes iff every testcase passes. Each problem
runs in its own subprocess (`python -m areal_tpu_torch.reward._code_runner`,
in a session of its own, the whole group killed on timeout, with the
repository root as its working directory); `code_verify` grades problems
concurrently in a thread pool and keeps their order.

`code_reward_fn` follows the RLVR reward signature, so `RLVRWorkflow`
runs coding RL unchanged; `code_eval_reward_fn` is the completion-style
HumanEval/MBPP reward. Both clamp the per-case timeout (1.5x the item's
`timeout`) to [0.1, 100] s.
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Any

from areal_tpu_torch.utils import logging

logger = logging.getLogger("code_verify")

SINGLE_CASE_EXEC_TIMEOUT = 6.0  # parity: verify.py SINGLE_CASE_EXEC_TIMEOUT
FUNCTIONCALL_TIMEOUT = 100.0  # parity: verify.py FUNCTIONCALL_TIMEOUT
_CODE_BLOCK = re.compile(r"```(?:python|py)?\s*\n(.*?)```", re.DOTALL)


def extract_code(completion: str) -> str | None:
    """Last fenced code block (models emit reasoning first, code last)."""
    blocks = _CODE_BLOCK.findall(completion or "")
    if blocks:
        return blocks[-1].strip()
    return None


def run_problem(
    code: str,
    input_output: dict[str, Any],
    *,
    timeout_per_case: float = SINGLE_CASE_EXEC_TIMEOUT,
    total_timeout: float = FUNCTIONCALL_TIMEOUT,
    memory_mb: int = 0,
) -> bool:
    """Run one candidate against one problem's testcases in a sandbox
    subprocess; True iff every case passed."""
    asserts = input_output.get("asserts") or []
    inputs = input_output.get("inputs", [])
    outputs = input_output.get("outputs", [])
    if asserts:
        # HumanEval/MBPP-style unit-test harnesses: each case is a code
        # snippet (assert statement or check(candidate) call) exec'd in
        # the candidate's namespace
        testcases: list[dict] = [
            {"input": "", "expectedOutput": "", "assertCode": a}
            for a in asserts
        ]
    else:
        if len(inputs) != len(outputs):
            raise ValueError(
                f"inputs({len(inputs)})/outputs({len(outputs)}) mismatch"
            )
        if not inputs:
            return False  # no testcases of either style: nothing to verify
        testcases = [
            {"input": i, "expectedOutput": o} for i, o in zip(inputs, outputs)
        ]
    spec = dict(
        code=code,
        entryFunction=input_output.get("fn_name", ""),
        testcases=testcases,
        timeout=min(100.0, max(0.1, timeout_per_case)),
        memory=memory_mb,
        isFastFail=True,
    )
    proc = subprocess.Popen(
        [sys.executable, "-m", "areal_tpu_torch.reward._code_runner"],
        stdin=subprocess.PIPE,
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
        start_new_session=True,  # own group → clean kill of forks
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
    )
    try:
        out, _ = proc.communicate(
            json.dumps(spec).encode(), timeout=total_timeout
        )
    except subprocess.TimeoutExpired:
        _kill_group(proc)
        return False
    except Exception:  # noqa: BLE001 — verifier must never crash the loop
        _kill_group(proc)
        return False
    try:
        verdict = json.loads(out.decode() or "{}")
    except json.JSONDecodeError:
        return False
    results = verdict.get("results", [])
    return len(results) == len(testcases) and all(results)


def _kill_group(proc: subprocess.Popen) -> None:
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def code_verify(
    id2info: dict[str, dict],
    generateds: list[str],
    query_ids: list[str],
    *,
    timeout: float = FUNCTIONCALL_TIMEOUT,
    timeout_for_testcase: float = SINGLE_CASE_EXEC_TIMEOUT,
    max_workers: int = 8,
) -> list[int]:
    """Batched verification (parity: verify.py:111 code_verify).

    Returns one 0/1 per query, order-aligned with `query_ids`.
    """
    assert len(generateds) == len(query_ids), (len(generateds), len(query_ids))

    def one(idx: int) -> int:
        problem = id2info[query_ids[idx]]
        io_blob = problem["input_output"]
        input_output = (
            json.loads(io_blob) if isinstance(io_blob, str) else io_blob
        )
        per_case = min(
            100.0,
            max(0.1, float(problem.get("timeout", timeout_for_testcase)) * 1.5),
        )
        try:
            ok = run_problem(
                generateds[idx] or "",
                input_output,
                timeout_per_case=per_case,
                total_timeout=timeout,
                memory_mb=int(problem.get("memory", 0)),
            )
        except Exception as e:  # noqa: BLE001 — one bad problem ≠ dead batch
            logger.warning(f"code_verify failed for {query_ids[idx]}: {e!r}")
            ok = False
        return int(ok)

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(one, range(len(query_ids))))


def code_reward_fn(prompt, completion, prompt_ids, completion_ids, **data):
    """RLVR reward: 1.0 iff the completion's code passes every testcase.

    Dataset items supply `input_output` (dict or JSON string) and optional
    `timeout`/`memory` — the reference's coding-problem schema.
    """
    code = extract_code(completion or "")
    if code is None:
        return 0.0
    io_blob = data.get("input_output")
    if io_blob is None:
        return 0.0
    input_output = json.loads(io_blob) if isinstance(io_blob, str) else io_blob
    per_case = min(
        100.0,
        max(0.1, float(data.get("timeout", SINGLE_CASE_EXEC_TIMEOUT)) * 1.5),
    )
    return float(
        run_problem(
            code,
            input_output,
            timeout_per_case=per_case,
            memory_mb=int(data.get("memory", 0)),
        )
    )


def code_eval_reward_fn(prompt, completion, prompt_ids, completion_ids, **data):
    """Completion-style code-benchmark reward (HumanEval/MBPP pass@k).

    Candidate assembly follows the Codex eval convention: a fenced code
    block wins if present (chat models); otherwise the completion is a raw
    CONTINUATION of the item's `code_prompt` (the classic HumanEval
    function-signature prefix). The item's `input_output.asserts` harness
    runs in the sandbox subprocess (reward/_code_runner assert mode).
    """
    io_blob = data.get("input_output")
    if io_blob is None:
        return 0.0
    input_output = json.loads(io_blob) if isinstance(io_blob, str) else io_blob
    code = extract_code(completion or "")
    if code is None:
        code = str(data.get("code_prompt", "")) + (completion or "")
    per_case = min(
        100.0,
        max(0.1, float(data.get("timeout", SINGLE_CASE_EXEC_TIMEOUT)) * 1.5),
    )
    return float(
        run_problem(
            code,
            input_output,
            timeout_per_case=per_case,
            memory_mb=int(data.get("memory", 0)),
        )
    )
