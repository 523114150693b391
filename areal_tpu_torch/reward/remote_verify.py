"""Remote batch verification: the scale-out reward seam (counterpart of
`areal_tpu/reward/remote_verify.py`; parity: the reference's
functioncall/base/call.py `batch_function_call`).

`batch_math_verify` and `batch_code_verify` POST their grading work to
the service named by `AREAL_VERIFIER_SERVICE` (`FUNCTIONCALL_SERVICE_DOMAIN`
is honoured for the reference's deployments) and grade locally, in a
thread pool, when neither is set. The client keeps the JAX client's rules:

- payloads of 10 items, at most 64 of them in flight;
- 3 tries per payload with 0.2·(attempt + 1) s between them and no wait
  after the last; any non-200 answer is retried, a 4xx too;
- one payload that fails all its tries makes the whole call grade
  locally: a broken service degrades to the trainer host's graders, it
  never zeroes the rewards.

The client runs on the standard library's HTTP connections
(`utils/http.py`), not `aiohttp`. The server half is
`reward/verify_server.py`.

Protocol: POST /verify {"uid", "language": "MATH" | "CODE", "payload": ...}
-> {"results": [0/1, ...]} in the payload's order.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

from areal_tpu_torch.utils import http, logging

logger = logging.getLogger("remote_verify")

_BATCH_SIZE = 10
_CONCURRENCY = 64
_RETRIES = 3


def service_addr() -> str | None:
    return (
        os.environ.get("AREAL_VERIFIER_SERVICE")
        or os.environ.get("FUNCTIONCALL_SERVICE_DOMAIN")
        or None
    )


# ---------------------------------------------------------------------------
# local grading (the fallback and the server's engine)
# ---------------------------------------------------------------------------


def _grade_math_pair(answer: str, solution: str) -> int:
    from areal_tpu_torch.reward.math_parser import (
        _extract_ground_truth,
        extract_answer,
        math_equal_subprocess,
    )

    pred = extract_answer(answer)  # extraction is regex-only: no sympy
    if pred is None:
        return 0
    # the subprocess grader: an adversarial sympy input hits its hard
    # timeout instead of wedging a grader thread (and, through it, the
    # verify service's worker pool)
    return int(
        math_equal_subprocess(pred, _extract_ground_truth(str(solution)), timeout_s=5.0)
    )


def grade_math_batch(answers: list[str], solutions: list[str]) -> list[int]:
    """Pairwise grading, in order."""
    return [_grade_math_pair(a, s) for a, s in zip(answers, solutions)]


def grade_code_batch(items: list[dict[str, Any]]) -> list[int]:
    """Each item: {"completion": str, "input_output": {...}}."""
    from areal_tpu_torch.reward.code_verify import extract_code, run_problem

    out = []
    for item in items:
        code = extract_code(item.get("completion", ""))
        io_spec = item.get("input_output") or {}
        out.append(int(bool(code) and run_problem(code, io_spec)))
    return out


# ---------------------------------------------------------------------------
# batch client
# ---------------------------------------------------------------------------


def _post_one(addr: str, payload: dict, timeout_s: float) -> list[int] | None:
    """POST one payload with the client's retry rules; None once every
    try failed."""
    last = "unknown"
    for attempt in range(_RETRIES):
        try:
            status, text = http.send_json(addr, "/verify", payload, timeout_s)
            if status == 200:
                return [int(r) for r in json.loads(text)["results"]]
            last = f"status {status}"
        except Exception as e:  # noqa: BLE001 — retry, then fail the call
            last = repr(e)
        if attempt < _RETRIES - 1:  # no dead wait after the final try
            time.sleep(0.2 * (attempt + 1))
    logger.warning(f"verify service call failed: {last}")
    return None


def _post_batches(addr: str, payloads: list[dict], timeout_s: float) -> list[list[int]] | None:
    """POST every payload, at most `_CONCURRENCY` in flight; None if any
    payload failed (the caller then grades locally)."""
    if "://" in addr:
        addr = addr.split("://", 1)[1]
    addr = addr.rstrip("/")
    with ThreadPoolExecutor(max_workers=min(_CONCURRENCY, max(len(payloads), 1))) as pool:
        results = list(pool.map(lambda p: _post_one(addr, p, timeout_s), payloads))
    if any(r is None for r in results):
        return None
    return results  # type: ignore[return-value]


def batch_math_verify(
    id2info: dict[str, dict],
    generateds: list[str],
    query_ids: list[str],
    *,
    timeout_s: float = 1000.0,
    max_workers: int = 8,
) -> list[int]:
    """One 0/1 per generated, in order (parity: functioncall/math/verify.py
    `math_verify`): a sample passes if it matches any of its question's
    solutions; a query id's part after `@` names the sample, not the
    question."""
    assert len(generateds) == len(query_ids)
    pairs: list[tuple[str, str, int]] = []  # (answer, solution, sample idx)
    for idx, (qid, gen) in enumerate(zip(query_ids, generateds)):
        info = id2info[str(qid).split("@")[0]]
        for sol in info.get("solutions") or [info.get("answer", "")]:
            pairs.append((gen, str(sol), idx))

    addr = service_addr()
    flat: list[int] | None = None
    if addr:
        payloads = []
        for i in range(0, len(pairs), _BATCH_SIZE):
            chunk = pairs[i : i + _BATCH_SIZE]
            payloads.append(
                {
                    "uid": f"math-{i}-{i + len(chunk)}",
                    "language": "MATH",
                    "payload": {
                        "answers": [a for a, _, _ in chunk],
                        "solutions": [s for _, s, _ in chunk],
                    },
                }
            )
        per_batch = _post_batches(addr, payloads, timeout_s)
        if per_batch is not None:
            flat = [r for batch in per_batch for r in batch]
    if flat is None:  # no service, or the service is down: grade here
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            flat = list(pool.map(lambda p: _grade_math_pair(p[0], p[1]), pairs))

    results = [0] * len(generateds)
    for (_, _, idx), ok in zip(pairs, flat):
        results[idx] = max(results[idx], int(ok))
    return results


def batch_code_verify(
    id2info: dict[str, dict],
    generateds: list[str],
    query_ids: list[str],
    *,
    timeout_s: float = 1000.0,
    max_workers: int = 8,
) -> list[int]:
    """One 0/1 per generated, in order (parity:
    functioncall/code/verify.py `code_verify`)."""
    assert len(generateds) == len(query_ids)
    items = []
    for qid, gen in zip(query_ids, generateds):
        info = id2info[str(qid).split("@")[0]]
        items.append({"completion": gen, "input_output": info.get("input_output") or {}})

    addr = service_addr()
    if addr:
        payloads = []
        for i in range(0, len(items), _BATCH_SIZE):
            chunk = items[i : i + _BATCH_SIZE]
            payloads.append(
                {
                    "uid": f"code-{i}-{i + len(chunk)}",
                    "language": "CODE",
                    "payload": {"items": chunk},
                }
            )
        per_batch = _post_batches(addr, payloads, timeout_s)
        if per_batch is not None:
            return [r for batch in per_batch for r in batch]
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(lambda it: grade_code_batch([it])[0], items))
