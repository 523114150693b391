"""Sandboxed testcase runner of the code graders (a copy of
`areal_tpu/reward/_code_runner.py`).

Run as a subprocess (`python -m areal_tpu_torch.reward._code_runner`): it
reads a JSON spec on stdin, runs the candidate code against each testcase
under a per-case `ITIMER_REAL` alarm and rlimits (CPU; `RLIMIT_AS` when
`memory` > 0; `RLIMIT_NPROC` 16), and writes a JSON verdict on stdout.
With `isFastFail` it stops at the first failing case. Three testcase
styles:

- **stdio**: the program reads stdin and prints; stdout is compared with
  `expectedOutput` (whitespace-normalized, per-line rstrip).
- **function**: `entryFunction(*args)` with JSON-decoded args; the return
  value is compared with the JSON-decoded expected output.
- **assert**: `assertCode` (an assert statement or a `check(candidate)`
  call) runs in the candidate's namespace; it passes if nothing raises.

It imports the standard library only, never `torch`: a grader starts one
of these per problem. The isolation is a killed-on-timeout process with
resource limits, not a security boundary: run genuinely hostile code
under an outer sandbox.
"""

from __future__ import annotations

import io
import json
import math
import signal
import sys
import traceback
from contextlib import redirect_stdout


def _apply_rlimits(cpu_seconds: float, memory_mb: int) -> None:
    try:
        import resource

        cpu = max(1, int(math.ceil(cpu_seconds)) + 1)
        resource.setrlimit(resource.RLIMIT_CPU, (cpu, cpu + 1))
        if memory_mb > 0:
            b = memory_mb * 1024 * 1024
            resource.setrlimit(resource.RLIMIT_AS, (b, b))
        # no subprocess bombs from candidate code
        resource.setrlimit(resource.RLIMIT_NPROC, (16, 16))
    except Exception:  # pragma: no cover - platform-dependent
        pass


class _CaseTimeout(Exception):
    pass


def _alarm(_sig, _frm):
    raise _CaseTimeout()


def _norm_stdout(text: str) -> list[str]:
    lines = [ln.rstrip() for ln in text.strip().splitlines()]
    while lines and not lines[-1]:
        lines.pop()
    return lines


def _run_stdio_case(code: str, inp: str) -> str:
    stdin = sys.stdin
    sys.stdin = io.StringIO(inp if inp.endswith("\n") else inp + "\n")
    out = io.StringIO()
    try:
        with redirect_stdout(out):
            g = {"__name__": "__main__", "__builtins__": __builtins__}
            exec(code, g)  # noqa: S102 — sandboxed candidate execution
    finally:
        sys.stdin = stdin
    return out.getvalue()


def _decode_arg(raw):
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, TypeError):
        return raw


def _run_assert_case(code: str, harness: str) -> bool:
    """HumanEval/MBPP-style unit-test harness: exec the candidate, then the
    harness (assert statements / a check(candidate) call) in the same
    namespace; pass iff nothing raises."""
    g = {"__name__": "__main__", "__builtins__": __builtins__}
    with redirect_stdout(io.StringIO()):
        exec(code, g)  # noqa: S102 — sandboxed candidate execution
        exec(harness, g)  # noqa: S102 — sandboxed test harness
    return True


def _run_function_case(code: str, fn_name: str, inp, expected):
    g = {"__name__": "__main__", "__builtins__": __builtins__}
    with redirect_stdout(io.StringIO()):
        exec(code, g)  # noqa: S102 — sandboxed candidate execution
        fn = g.get(fn_name)
        if fn is None and "Solution" in g:  # LeetCode-style class wrapper
            fn = getattr(g["Solution"](), fn_name, None)
        if fn is None:
            raise NameError(f"entry function {fn_name!r} not defined")
        args = inp if isinstance(inp, list) else [inp]
        got = fn(*args)
    exp = _decode_arg(expected) if isinstance(expected, str) else expected
    if isinstance(got, tuple):
        got = list(got)
    return got == exp


def main() -> None:
    spec = json.load(sys.stdin)
    code = spec["code"]
    fn_name = spec.get("entryFunction") or ""
    timeout = float(spec.get("timeout", 6.0))
    fast_fail = bool(spec.get("isFastFail", True))
    _apply_rlimits(
        cpu_seconds=timeout * max(1, len(spec.get("testcases", []))),
        memory_mb=int(spec.get("memory", 0)),
    )
    signal.signal(signal.SIGALRM, _alarm)

    results = []
    error = None
    for case in spec.get("testcases", []):
        ok = False
        try:
            signal.setitimer(signal.ITIMER_REAL, timeout)
            if case.get("assertCode"):
                ok = _run_assert_case(code, str(case["assertCode"]))
            elif fn_name:
                ok = _run_function_case(
                    code, fn_name, _decode_arg(case["input"]),
                    case["expectedOutput"],
                )
            else:
                out = _run_stdio_case(code, str(case["input"]))
                ok = _norm_stdout(out) == _norm_stdout(
                    str(case["expectedOutput"])
                )
        except _CaseTimeout:
            error = "timeout"
        except BaseException:  # noqa: BLE001 — candidate code can raise anything
            error = traceback.format_exc(limit=3)
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
        results.append(bool(ok))
        if fast_fail and not ok:
            break
    json.dump({"results": results, "error": error}, sys.stdout)
    sys.stdout.flush()


if __name__ == "__main__":
    main()
