"""Safe arithmetic expression evaluation via a whitelisted AST walk (a
copy of `areal_tpu/utils/arith_eval.py`).

Shared by the countdown reward (integer-only: python's richer literal
syntax — 3_4 digit grouping, floats — would open scoring exploits) and the
TIR calculator tool (floats allowed). No eval(), no names, no calls: the
only accepted nodes are +, -, *, / over numeric literals and parentheses.
"""

from __future__ import annotations

import ast
import re

_ALLOWED_CHARS = re.compile(r"[\d+\-*/().\s]+")


def safe_eval_arithmetic(
    expr: str, allow_float: bool = True
) -> int | float | None:
    """Evaluate `expr`; None on any syntax/operator/value violation.

    The character whitelist runs FIRST: python literal syntax is richer
    than plain arithmetic (e.g. `3_4` parses as the int 34), and for
    reward scoring those forms must be rejected, not normalized."""
    if not _ALLOWED_CHARS.fullmatch(expr):
        return None
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError:
        return None

    # ints stay ints through +,-,* (beyond-2^53 arithmetic must be exact
    # for the calculator tool); only division coerces to float
    def walk(node):
        if isinstance(node, ast.Expression):
            return walk(node.body)
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div)
        ):
            a, b = walk(node.left), walk(node.right)
            if isinstance(node.op, ast.Add):
                return a + b
            if isinstance(node.op, ast.Sub):
                return a - b
            if isinstance(node.op, ast.Mult):
                return a * b
            if b == 0:
                raise ZeroDivisionError
            return a / b
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -walk(node.operand)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, int) and not isinstance(
                node.value, bool
            ):
                return node.value
            if allow_float and isinstance(node.value, float):
                return node.value
        raise ValueError(f"disallowed node {type(node).__name__}")

    try:
        return walk(tree)
    except (ValueError, ZeroDivisionError, RecursionError, OverflowError):
        return None
