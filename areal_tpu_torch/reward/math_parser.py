"""Rule-based math answer extraction + equivalence grading (a copy of
`areal_tpu/reward/math_parser.py`).

Parity target: areal/reward/math_parser.py (867 lines + the vendored
latex2sympy under the reference's evaluation/) — the reference grades
MATH/AIME-style answers by (1) extracting the final answer from a model
completion (\\boxed{...}, "the answer is ...", minerva's "final answer is
$...$. I hope", choice letters, last number), (2) normalizing LaTeX
(units, \\text, degrees, percents, frac/sqrt repair, word numbers,
matrix/interval syntax), and (3) testing equivalence numerically,
structurally (intervals, tuples, matrices, equations) and symbolically.

With no antlr4/latex2sympy installed, sympy's parse_latex is
unusable; `_latex_to_expr` is a self-contained LaTeX -> SymPy translator
covering the answer grammar that actually occurs in math benchmarks
(fractions, roots, powers, constants, trig/log, implicit multiplication).
Everything here is pure host-side Python — nothing touches the device.
"""

from __future__ import annotations

import re

from areal_tpu_torch.utils import logging

logger = logging.getLogger("math_parser")

# answers longer than this get no sympy attempt (hang/blow-up guard)
_MAX_SYMPY_LEN = 384

# ---------------------------------------------------------------------------
# word numbers
# ---------------------------------------------------------------------------

_UNITS_WORDS = {
    "zero": 0, "one": 1, "two": 2, "three": 3, "four": 4, "five": 5,
    "six": 6, "seven": 7, "eight": 8, "nine": 9, "ten": 10, "eleven": 11,
    "twelve": 12, "thirteen": 13, "fourteen": 14, "fifteen": 15,
    "sixteen": 16, "seventeen": 17, "eighteen": 18, "nineteen": 19,
}
_TENS_WORDS = {
    "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
    "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90,
}
_SCALE_WORDS = {"hundred": 100, "thousand": 1_000, "million": 1_000_000,
                "billion": 1_000_000_000}


def word_to_number(text: str) -> int | None:
    """"twenty-five" -> 25, "one hundred seven" -> 107; None if not a
    pure spelled-out number."""
    words = re.split(r"[\s-]+", text.strip().lower())
    if not words or any(
        w not in _UNITS_WORDS and w not in _TENS_WORDS
        and w not in _SCALE_WORDS and w != "and"
        for w in words
    ):
        return None
    total = group = 0
    seen = False
    for w in words:
        if w == "and":
            continue
        seen = True
        if w in _UNITS_WORDS:
            group += _UNITS_WORDS[w]
        elif w in _TENS_WORDS:
            group += _TENS_WORDS[w]
        else:
            scale = _SCALE_WORDS[w]
            if scale == 100:
                group = max(group, 1) * 100
            else:
                total += max(group, 1) * scale
                group = 0
    return total + group if seen else None


# ---------------------------------------------------------------------------
# units (MathQA-style suffixes that must not break numeric grading)
# ---------------------------------------------------------------------------

_UNIT_TEXTS = [
    "degrees", "degree", "deg", "radians", "radian",
    "dollars", "dollar", "cents", "cent", "rupees", "rupee", "rs",
    "percent", "points", "point",
    "meters", "meter", "metres", "metre", "km", "cm", "mm", "mi",
    "miles", "mile", "feet", "foot", "ft", "inches", "inch", "yards",
    "yard", "units", "unit",
    "mph", "kmph", "kmh", "m/s",
    "sq", "square", "cubic", "cu",
    "liters", "liter", "litres", "litre", "ml", "gallons", "gallon",
    "kg", "grams", "gram", "gm", "g", "lbs", "lb", "ounces", "ounce", "oz",
    "hours", "hour", "hrs", "hr", "minutes", "minute", "min", "seconds",
    "second", "sec", "days", "day", "weeks", "week", "months", "month",
    "years", "year", "yr",
    "apples", "apple", "people", "men", "man", "women", "woman",
    "students", "student", "ways", "way",
]
# longest first so "meters" wins over "m"
_UNIT_TEXTS.sort(key=len, reverse=True)


def _strip_units(s: str) -> str:
    # "times" is special: as a trailing unit ("8 times") it must strip,
    # but mid-string it is multiplication phrasing ("4 times 5") whose
    # removal would CONCATENATE the operands into a wrong number after
    # the later space removal. (\times stays: protected by the backslash
    # guard below.)
    s = re.sub(r"(?<=\d)\s*times\s*$", "", s)
    # (?<![\\A-Za-z]) guards LaTeX commands: "min"/"sec"/"deg" must not
    # eat \min, \sec^2, \deg — a backslash or letter before the word means
    # it is (part of) a command, not a unit suffix.
    for u in _UNIT_TEXTS:
        s = re.sub(rf"(?<![\\A-Za-z]){re.escape(u)}(?![A-Za-z])", "", s)
    return s


# ---------------------------------------------------------------------------
# LaTeX repair / canonicalization
# ---------------------------------------------------------------------------


def _fix_fracs(s: str) -> str:
    """\\frac12 -> \\frac{1}{2}; \\frac1{72} -> \\frac{1}{72};
    \\fracab -> \\frac{a}{b}. Already-braced args pass through."""

    def brace_two(rest: str) -> str:
        out = []
        for _ in range(2):
            rest = rest.lstrip()
            if not rest:
                return None  # type: ignore[return-value]
            if rest[0] == "{":
                depth, i = 1, 1
                while i < len(rest) and depth:
                    depth += rest[i] == "{"
                    depth -= rest[i] == "}"
                    i += 1
                if depth:
                    return None  # type: ignore[return-value]
                out.append(rest[:i])
                rest = rest[i:]
            else:
                out.append("{" + rest[0] + "}")
                rest = rest[1:]
        return "".join(out) + rest

    parts = s.split("\\frac")
    fixed = parts[0]
    for rest in parts[1:]:
        braced = brace_two(rest)
        if braced is None:
            fixed += "\\frac" + rest
        else:
            fixed += "\\frac" + braced
    return fixed


def _fix_sqrt(s: str) -> str:
    """\\sqrt5 -> \\sqrt{5}; \\sqrt ab -> \\sqrt{a}b."""
    return re.sub(r"\\sqrt\s*([^\s{[])", r"\\sqrt{\1}", s)


def _fix_a_slash_b(s: str) -> str:
    """A bare integer ratio answer a/b -> \\frac{a}{b}."""
    m = re.fullmatch(r"(-?\d+)/(\d+)", s.strip())
    return rf"\frac{{{m.group(1)}}}{{{m.group(2)}}}" if m else s


def normalize_answer(ans: str, strip_units: bool = True) -> str:
    """Canonicalize an extracted answer string (parity:
    areal/reward/math_parser.py strip_string, :219-357)."""
    s = str(ans).strip().replace("\n", "")
    s = s.rstrip(".").rstrip("/").lstrip(":").strip()
    s = s.replace("\\!", "").replace("\\,", "").replace("\\;", "")
    s = s.replace("\\:", "").replace("~", " ")

    # matrix environments: array/bmatrix/vmatrix all compare as pmatrix
    s = re.sub(r"\\begin\{array\}\{[^}]*\}", r"\\begin{pmatrix}", s)
    s = s.replace(r"\end{array}", r"\end{pmatrix}")
    s = s.replace("bmatrix", "pmatrix").replace("vmatrix", "pmatrix")

    s = s.replace("tfrac", "frac").replace("dfrac", "frac").replace("cfrac", "frac")
    s = s.replace("\\neq", "\\ne").replace("\\leq", "\\le").replace("\\geq", "\\ge")
    s = s.replace("\\left", "").replace("\\right", "")
    s = s.replace("\\{", "{").replace("\\}", "}")

    # trailing \text{...} is a unit ("5 \text{ miles}" -> "5")
    trimmed = re.sub(r"\\text\s*\{.*?\}\s*$", "", s).strip()
    if trimmed:
        s = trimmed
    # interior \text{x} -> x
    s = re.sub(r"\\text\s*\{(.*?)\}", r"\1", s)
    s = re.sub(r"\\mbox\s*\{.*?\}", "", s)
    s = s.replace("\\mathbf", "").replace("\\bf", "").replace("\\mathrm", "")
    s = re.sub(r"\\operatorname\s*\{(.*?)\}", r"\1", s)

    # degrees / dollars / percent decorations
    s = s.replace("^{\\circ}", "").replace("^\\circ", "")
    s = s.replace("\\$", "").replace("$", "")
    s = s.replace("\\(", "").replace("\\)", "")
    s = s.replace("\\%", "").replace("%", "")

    if strip_units:
        s = _strip_units(s)

    w = word_to_number(s)
    if w is not None:
        return str(w)

    # variable-binding prefixes: "x = 5", "x \in [2, 3)"
    for key in ("x=", "y=", "z=", "x\\in", "y\\in", "z\\in",
                "x\\to", "y\\to", "z\\to"):
        s = s.replace(key, "")
    s = s.replace("\\emptyset", "{}")
    s = s.replace("(-\\infty,\\infty)", "\\mathbb{R}")

    s = s.replace("infinity", "\\infty")
    if "\\infty" not in s:
        s = s.replace("inf", "\\infty")

    # bare leading decimal points
    s = s.replace(" .", " 0.").replace("{.", "{0.")
    if s.startswith("."):
        s = "0" + s

    # trailing zero decimals: 5.000 -> 5 (also inside expressions)
    s = re.sub(r"(\d+)\.0+($|[^\d])", r"\1\2", s)

    # "k = <rhs>" with a short LHS -> rhs
    parts = s.split("=")
    if len(parts) == 2 and len(parts[0].strip()) <= 2:
        s = parts[1]

    s = _fix_sqrt(s)
    s = s.replace(" ", "")
    s = _fix_fracs(s)
    s = _fix_a_slash_b(s)

    # plain thousands separators: 1,234,567(.89)
    if re.fullmatch(r"-?\d{1,3}(,\d{3})+(\.\d+)?", s):
        s = s.replace(",", "")
    return s


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

_BOXED_RE = re.compile(r"\\boxed\s*\{|\\fbox\s*\{")
_CHOICE_RE = re.compile(r"\b([A-E])\b")
_LAST_NUMBER_RE = re.compile(r"-?\d*\.?\d+")

_CHOICE_DATASETS = ("mmlu", "sat_math", "aqua", "gaokao2023")
_KEEP_UNIT_DATASETS = ("carp_en", "minerva_math")


def extract_boxed(text: str) -> str | None:
    """The LAST \\boxed{...}/\\fbox{...} with balanced braces."""
    last = None
    for m in _BOXED_RE.finditer(text):
        start = m.end()
        depth, i = 1, start
        while i < len(text) and depth > 0:
            depth += text[i] == "{"
            depth -= text[i] == "}"
            i += 1
        if depth == 0:
            last = text[start : i - 1]
    return last


def choice_answer_clean(pred: str) -> str:
    """Reduce a prediction to its last standalone choice letter A-E."""
    pred = pred.strip("\n").rstrip(".").rstrip("/").strip().lstrip(":")
    found = _CHOICE_RE.findall(pred.upper())
    out = found[-1] if found else pred.strip().strip(".")
    return out.rstrip(".").rstrip("/")


def extract_answer(
    text: str,
    data_name: str = "math",
    use_last_number: bool = True,
) -> str | None:
    """Final-answer extraction (parity: reference extract_answer :360-427).

    Order: multiple-choice datasets -> minerva "final answer is $...$.
    I hope" -> \\boxed -> "the answer is" -> last number."""
    if text is None:
        return None
    text = str(text)
    if any(k in data_name for k in _CHOICE_DATASETS):
        return choice_answer_clean(text)

    pred: str | None = None
    if "final answer is $" in text and "$. I hope" in text:
        pred = text.split("final answer is $", 1)[1].split("$. I hope", 1)[0]
    elif "boxed" in text or "fbox" in text:
        pred = extract_boxed(text)
        if pred is None:
            # "\boxed 5" (no brace): take up to the next dollar sign
            tail = re.split(r"\\boxed|\\fbox", text)[-1].strip()
            pred = tail.split("$")[0].strip() or None
    elif "he answer is" in text:  # matches The/the
        pred = text.split("he answer is")[-1].strip()
    elif "final answer is" in text:
        pred = text.split("final answer is")[-1].strip()
    if pred is None and use_last_number:
        nums = _LAST_NUMBER_RE.findall(text.replace(",", ""))
        pred = nums[-1] if nums else None
    if pred is None:
        return None
    pred = re.sub(r"\n\s*", "", pred).strip()
    return normalize_answer(
        pred, strip_units=not any(k in data_name for k in _KEEP_UNIT_DATASETS)
    )


# ---------------------------------------------------------------------------
# numbers
# ---------------------------------------------------------------------------


def parse_number(s: str) -> float | None:
    """Float value of a numeric-looking answer: plain floats, thousands
    separators, percents, \\frac{a}{b}, a/b, mixed numbers 1\\frac{1}{2}."""
    s = str(s).strip().replace(",", "")
    if not s:
        return None
    try:
        return float(s)
    except ValueError:
        pass
    if s.endswith("\\%"):
        s = s[:-2]
    if s.endswith("%"):
        s = s[:-1]
        try:
            return float(s) / 100.0
        except ValueError:
            return None
    m = re.fullmatch(r"(-?)(\d+)?\\?frac\{(-?\d+)\}\{(-?\d+)\}", s)
    if m:
        sign = -1.0 if m.group(1) == "-" else 1.0
        whole = float(m.group(2)) if m.group(2) else 0.0
        num, den = float(m.group(3)), float(m.group(4))
        if den == 0:
            return None
        frac = num / den
        return sign * (whole + frac) if whole else sign * frac
    m = re.fullmatch(r"(-?\d+(?:\.\d+)?)\s*/\s*(-?\d+(?:\.\d+)?)", s)
    if m:
        den = float(m.group(2))
        return float(m.group(1)) / den if den else None
    return None


def numeric_equal(a: float, b: float, rel_tol: float = 1e-4) -> bool:
    from math import isclose

    return isclose(a, b, rel_tol=rel_tol, abs_tol=1e-10)


# ---------------------------------------------------------------------------
# LaTeX -> sympy (antlr-free)
# ---------------------------------------------------------------------------

_FUNC_NAMES = ("arcsin", "arccos", "arctan", "sinh", "cosh", "tanh",
               "sin", "cos", "tan", "sec", "csc", "cot", "log", "ln", "exp")


def _latex_to_pystr(s: str) -> str:
    """Translate the benchmark-answer LaTeX subset to a sympify-able
    string. Raises ValueError on syntax this grammar does not cover."""
    s = s.strip()
    if len(s) > _MAX_SYMPY_LEN:
        raise ValueError("expression too long")
    # \frac{a}{b} (recursive, innermost first)
    pat_frac = re.compile(r"\\frac\{([^{}]*)\}\{([^{}]*)\}")
    pat_root = re.compile(r"\\sqrt\[([^\[\]{}]*)\]\{([^{}]*)\}")
    pat_sqrt = re.compile(r"\\sqrt\{([^{}]*)\}")
    for _ in range(24):
        new = pat_frac.sub(r"((\1)/(\2))", s)
        new = pat_root.sub(r"((\2)**(1/(\1)))", new)
        new = pat_sqrt.sub(r"(sqrt(\1))", new)
        if new == s:
            break
        s = new
    if "\\frac" in s or "\\sqrt" in s:
        raise ValueError("unresolved frac/sqrt")
    s = s.replace("\\cdot", "*").replace("\\times", "*").replace("\\div", "/")
    s = s.replace("\\pi", "pi").replace("\\infty", "oo").replace("\\ne", "!=")
    s = s.replace("\\pm", "+")  # caller splits \pm variants beforehand
    for f in _FUNC_NAMES:
        s = s.replace("\\" + f, f)
    s = s.replace("\\theta", "theta").replace("\\alpha", "alpha")
    s = s.replace("\\beta", "beta").replace("\\gamma", "gamma")
    s = s.replace("\\lambda", "lam").replace("\\mu", "mu")
    s = s.replace("^", "**")
    # {..} grouping -> (..), subscripts x_{1} -> x_1
    s = re.sub(r"_\{([A-Za-z0-9]+)\}", r"_\1", s)
    s = s.replace("{", "(").replace("}", ")")
    s = s.replace("ln(", "log(")
    if "\\" in s:
        raise ValueError(f"unhandled latex command in {s!r}")
    return s


def _to_sympy(s: str):
    import sympy
    from sympy.parsing.sympy_parser import (
        implicit_multiplication_application,
        parse_expr,
        standard_transformations,
    )

    py = _latex_to_pystr(s)
    return parse_expr(
        py,
        transformations=standard_transformations
        + (implicit_multiplication_application,),
        evaluate=True,
        local_dict={"oo": sympy.oo, "pi": sympy.pi},
    )


def symbolic_equal(a: str, b: str) -> bool:
    """sympy equivalence: simplify(a - b) == 0, with numeric fallback."""
    import sympy

    try:
        ea, eb = _to_sympy(a), _to_sympy(b)
    except Exception:
        return False
    try:
        if ea == eb:
            return True
    except Exception:
        pass
    try:
        if sympy.simplify(ea - eb) == 0:
            return True
    except Exception:
        pass
    try:
        na, nb = complex(sympy.N(ea, 15)), complex(sympy.N(eb, 15))
        return abs(na - nb) <= 1e-6 * max(1.0, abs(nb))
    except Exception:
        return False


# ---------------------------------------------------------------------------
# structured comparisons
# ---------------------------------------------------------------------------


def _split_top_level(s: str, sep: str = ",") -> list[str]:
    """Split on sep at brace/bracket/paren depth zero (commas inside
    \\frac{}{} or nested tuples do not split)."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "{[(":
            depth += 1
        elif ch in "}])":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


_MAT_OPEN = "\\begin{pmatrix}"
_MAT_CLOSE = "\\end{pmatrix}"


def _matrix_cells(s: str) -> list[list[str]] | None:
    s = s.strip()
    if not (s.startswith(_MAT_OPEN) and s.endswith(_MAT_CLOSE)):
        return None
    body = s[len(_MAT_OPEN) : -len(_MAT_CLOSE)]
    rows = [r.strip() for r in body.split("\\\\") if r.strip()]
    return [[c.strip() for c in row.split("&")] for row in rows]


def set_to_pmatrix(s: str) -> str:
    """{a, b} column-set notation -> pmatrix (the reference's
    str_to_pmatrix bridge for set-style matrix ground truths)."""
    mats = []
    for m in re.findall(r"\{[^{}]*,[^{}]*\}", s):
        body = m.strip("{}").replace(",", "\\\\")
        mats.append(_MAT_OPEN + body + _MAT_CLOSE)
    return ", ".join(mats) if mats else s


# ---------------------------------------------------------------------------
# top-level equivalence
# ---------------------------------------------------------------------------


def math_equal(
    pred: str,
    target: str,
    include_percentage: bool = True,
    rel_tol: float = 1e-4,
    _depth: int = 0,
) -> bool:
    """Mathematical equivalence of two (extracted) answers (parity:
    reference math_equal :495-678): string, choice, numeric (with the
    x/100, x, 100x percentage ambiguity), interval/tuple elementwise,
    matrix elementwise, single-equation, then symbolic."""
    if pred is None or target is None or _depth > 4:
        return False
    pred, target = str(pred).strip(), str(target).strip()
    if pred.lower() == target.lower():
        return True
    if target in ("A", "B", "C", "D", "E") and choice_answer_clean(pred) == target:
        return True

    # numeric, including the percent ambiguity (0.5 vs 50 vs 50%)
    pn, tn = parse_number(pred), parse_number(target)
    if pn is not None and tn is not None:
        candidates = [tn / 100, tn, tn * 100] if include_percentage else [tn]
        return any(numeric_equal(pn, c, rel_tol) for c in candidates)

    if not pred:
        return False

    # Equations compare BEFORE normalization (normalize_answer drops short
    # LHSes like "y =", destroying the equation structure): a=b equals c=d
    # iff (a-b) is ±(c-d) symbolically.
    if (
        pred.count("=") == 1
        and target.count("=") == 1
        and _equation_equal(pred, target)
    ):
        return True

    npred, ntarget = normalize_answer(pred), normalize_answer(target)
    if npred.lower() == ntarget.lower():
        return True
    pn, tn = parse_number(npred), parse_number(ntarget)
    if pn is not None and tn is not None:
        candidates = [tn / 100, tn, tn * 100] if include_percentage else [tn]
        return any(numeric_equal(pn, c, rel_tol) for c in candidates)

    # matrix vs set-style ground truth
    if "pmatrix" in npred and "pmatrix" not in ntarget:
        ntarget = set_to_pmatrix(ntarget)
    pm, tm = _matrix_cells(npred), _matrix_cells(ntarget)
    if pm is not None and tm is not None:
        if len(pm) != len(tm):
            return False
        for prow, trow in zip(pm, tm):
            if len(prow) != len(trow):
                return False
            for pc, tc in zip(prow, trow):
                if not math_equal(pc, tc, include_percentage, rel_tol,
                                  _depth + 1):
                    return False
        return True

    # bare-vs-bracketed sets: {3} == 3, (1,2) == [1,2] contents
    bare_p = npred.strip("{}()[]")
    bare_t = ntarget.strip("{}()[]")
    if bare_p.lower() == bare_t.lower() and "," not in bare_p:
        return True

    # intervals / tuples: [a, b) vs [c, d) -> elementwise. Bracket
    # openness is deliberately NOT compared — reference parity (its
    # interval branch, math_parser.py:573-590, strips the brackets and
    # compares contents only).
    def enclosed(s: str) -> bool:
        return len(s) >= 2 and s[0] in "([{" and s[-1] in ")]}"

    if enclosed(npred) and enclosed(ntarget):
        pp = _split_top_level(npred[1:-1])
        tp = _split_top_level(ntarget[1:-1])
        if len(pp) == len(tp) and len(pp) > 1:
            if all(
                math_equal(a, b, include_percentage, rel_tol, _depth + 1)
                for a, b in zip(pp, tp)
            ):
                return True

    # equations surviving normalization (long LHSes): same ± diff rule
    if npred.count("=") == 1 and ntarget.count("=") == 1:
        if _equation_equal(npred, ntarget):
            return True
    elif npred.count("=") == 1 and "=" not in ntarget:
        lhs, rhs = npred.split("=")
        if len(lhs.strip()) <= 2 and math_equal(
            rhs, ntarget, include_percentage, rel_tol, _depth + 1
        ):
            return True
    elif ntarget.count("=") == 1 and "=" not in npred:
        lhs, rhs = ntarget.split("=")
        if len(lhs.strip()) <= 2 and math_equal(
            npred, rhs, include_percentage, rel_tol, _depth + 1
        ):
            return True

    # \pm expansion: "1 \pm \sqrt{2}" equals the pair {1+\sqrt2, 1-\sqrt2}
    if "\\pm" in npred or "\\pm" in ntarget:
        def expand(s):
            if "\\pm" in s:
                return [s.replace("\\pm", "+", 1), s.replace("\\pm", "-", 1)]
            return [s]
        pv, tv = expand(npred), expand(ntarget)
        if len(pv) == len(tv) and len(pv) == 2:
            if all(
                math_equal(a, b, include_percentage, rel_tol, _depth + 1)
                for a, b in zip(pv, tv)
            ):
                return True

    return symbolic_equal(npred, ntarget)


def _equation_equal(pred: str, target: str) -> bool:
    """a=b equals c=d iff (a-b) is ±(c-d) symbolically. Sides are
    normalized independently so '=' survives."""
    pl, pr = (normalize_answer(x) for x in pred.split("="))
    tl, tr = (normalize_answer(x) for x in target.split("="))
    pdiff = f"({pl})-({pr})"
    tdiff = f"({tl})-({tr})"
    return symbolic_equal(pdiff, tdiff) or symbolic_equal(f"-({pdiff})", tdiff)


def _math_equal_worker(q, pred: str, target: str) -> None:
    """Module-level so the forkserver context can pickle it."""
    try:
        q.put(bool(math_equal(pred, target)))
    except Exception:  # noqa: BLE001 — any grading crash is a False
        q.put(False)


_GRADING_CTX = None


def _grading_ctx():
    """Forkserver multiprocessing context for grading workers.

    The graders run inside thread pools (remote_verify / verify_server);
    fork-from-threads is deprecated in 3.12 and can inherit a wedged lock
    state that silently grades 0. A forkserver's children fork from a
    clean single-threaded server process instead. sympy is preloaded into
    the server so each grading child gets it by fork, not by import.
    """
    global _GRADING_CTX
    if _GRADING_CTX is None:
        import multiprocessing as mp

        ctx = mp.get_context("forkserver")
        try:
            # "__main__" keeps the default behaviour of importing the
            # caller's main module ONCE in the server (children then fork
            # with it loaded); dropping it would make every grading child
            # re-import a possibly heavy entrypoint inside its timeout.
            ctx.set_forkserver_preload(
                ["__main__", "sympy", "areal_tpu_torch.reward.math_parser"]
            )
        except Exception:  # noqa: BLE001 — preload is an optimization only
            pass
        _GRADING_CTX = ctx
    return _GRADING_CTX


def math_equal_subprocess(pred: str, target: str, timeout_s: float = 5.0) -> bool:
    """math_equal in a worker process with a hard timeout — sympy can hang
    on adversarial inputs; batch eval graders use this (parity: reference
    call_with_timeout + pebble ProcessPool, math_parser.py:684-744).

    A child that wedges anyway is terminated at timeout_s and graded False.
    """
    ctx = _grading_ctx()
    q = ctx.Queue()
    p = ctx.Process(target=_math_equal_worker, args=(q, pred, target), daemon=True)
    p.start()
    p.join(timeout_s)
    if p.is_alive():
        p.terminate()
        p.join()
        return False
    try:
        return q.get(timeout=1.0)
    except Exception:  # noqa: BLE001 — lost result is a False grade
        if p.exitcode != 0:
            # Forkserver children import the caller's __main__; a script
            # without an `if __name__ == "__main__"` guard dies here and
            # every grade silently becomes False. Make that loud.
            import logging

            logging.getLogger("math_parser").warning(
                "grading worker died rc=%s before producing a result; "
                "if this is a script, it needs a __main__ guard "
                "(forkserver re-imports the main module)",
                p.exitcode,
            )
        return False


# ---------------------------------------------------------------------------
# reward fn
# ---------------------------------------------------------------------------


def math_verify_reward(
    prompt: str | None,
    completion: str | None,
    prompt_ids=None,
    completion_ids=None,
    **data,
) -> float:
    """Binary verifiable reward for math answers (the RLVR reward_fn
    signature). Ground truth comes from data['answer'] (or 'solution')."""
    target = data.get("answer", data.get("solution"))
    if completion is None or target is None:
        return 0.0
    target_ans = _extract_ground_truth(str(target))
    pred = extract_answer(completion)
    if pred is None:
        return 0.0
    return 1.0 if math_equal(pred, target_ans) else 0.0


def _extract_ground_truth(target: str) -> str:
    """Ground truths are usually the bare answer already; only unwrap a
    \\boxed/answer-phrase if present. The last-number fallback is for model
    COMPLETIONS — on a raw LaTeX gt like "\\frac{1}{2}" it would mangle the
    answer to "2" and invert the reward. Prose solutions (multi-word text
    with no box) still get the last-number treatment."""
    ans = extract_answer(target, use_last_number=False)
    if ans is not None:
        return ans
    looks_like_prose = len(target) > 64 or re.search(
        r"[A-Za-z]{3,}\s+[A-Za-z]{2,}", target
    )
    if looks_like_prose:
        return extract_answer(target) or normalize_answer(target)
    return normalize_answer(target)


def process_results(answer: str, solution: str) -> tuple[int, tuple[str, str]]:
    """Grade a full completion against a ground-truth solution string,
    returning (0/1, (extracted_pred, extracted_gt)) — the reference's
    batch-eval entry point (math_parser.py:759)."""
    gt = _extract_ground_truth(solution)
    pred = extract_answer(answer)
    if pred is None:
        return 0, ("", gt)
    return int(math_equal(pred, gt)), (pred, gt)
