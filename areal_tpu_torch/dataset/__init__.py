"""Datasets, tokenizers and the dataloader of the entry points
(counterpart of `areal_tpu/dataset/__init__.py`).

A registry maps a dataset's name (the last part of its path, lowercased)
to a loader that returns items in the framework's schema: {"messages" |
"prompt" | "input_ids", "answer", ...}. The hub-backed loaders (`gsm8k`,
`math500`, `aime`, `hh-rlhf`, `torl_data`) go through
`datasets.load_dataset` as the JAX package does, with the same canonical
hub ids, or a local directory or file given as the path; the code
benchmarks (`humaneval`, `openai_humaneval`, `mbpp`) read a local `.jsonl`
directly and send any other path to their hub id; `countdown` and
`synthetic-arith` are made offline from a seed. `transformers` and
`datasets` are imported inside the functions that need them, so the port
imports without them. The vision datasets are refused with the ROADMAP
item that ports them, and so is sharding a dataset over hosts.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from areal_tpu_torch.core import fault_injection
from areal_tpu_torch.models.smoke import OFFLINE_SENTINELS
_REGISTRY: dict[str, Callable] = {}

# the vision datasets of the JAX registry
_UNPORTED = ("clevr_count_70k", "geometry3k", "synthetic-vision")


def register_dataset(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def load_tokenizer(path: str):
    """Tokenizer dispatch shared by the entry points and the eval CLI: the
    offline sentinels get the built-in arithmetic tokenizer, any other
    path goes to `transformers.AutoTokenizer`."""
    if path in OFFLINE_SENTINELS:
        from areal_tpu_torch.dataset.arith import ArithTokenizer

        return ArithTokenizer()
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path)


def get_custom_dataset(
    path: str,
    split: str = "train",
    type: str = "rl",
    tokenizer: Any = None,
    max_length: int | None = None,
    rank: int = 0,
    world_size: int = 1,
    **kwargs,
):
    """Load a dataset by registry name or HF path (JAX :42)."""
    if world_size > 1:
        raise NotImplementedError(
            "sharding a dataset over hosts is not in the PyTorch port yet: "
            "ROADMAP.md queue 1, item 5"
        )
    name = path.split("/")[-1].lower()
    if name in _UNPORTED:
        raise NotImplementedError(
            f"dataset {path!r} is not in the PyTorch port yet: ROADMAP.md queue 1, item 6"
        )
    if name in _REGISTRY:
        return _REGISTRY[name](
            path=path, split=split, type=type, tokenizer=tokenizer,
            max_length=max_length, **kwargs
        )
    import datasets as hf_datasets

    return hf_datasets.load_dataset(path, split=split)


@register_dataset("gsm8k")
def _gsm8k(path: str, split: str, type: str, tokenizer=None, max_length=None, **kw):
    """GSM8K mapped to the RLVR schema (question -> messages, '#### x' ->
    answer)."""
    import datasets as hf_datasets

    # The canonical hub ids need the "main" dataset config (openai/gsm8k has
    # no default); local mirrors load as-is; anything else passes through to
    # load_dataset so typos fail loudly.
    if path in ("", "gsm8k", "openai/gsm8k", None):
        ds = hf_datasets.load_dataset("openai/gsm8k", "main", split=split)
    else:
        ds = hf_datasets.load_dataset(path, split=split)

    def to_item(x):
        answer = x["answer"].split("####")[-1].strip()
        return dict(
            messages=[{"role": "user", "content": x["question"]}],
            prompt=x["question"],
            answer=answer,
        )

    ds = ds.map(to_item, remove_columns=ds.column_names)
    if type == "sft" and tokenizer is not None:
        def tokenize(x):
            ids = tokenizer.encode(x["prompt"] + "\n" + x["answer"])
            return dict(input_ids=ids[:max_length] if max_length else ids)

        ds = ds.map(tokenize)
    return ds


def _math_items(ds):
    """Map MATH-style rows (problem/solution/answer) to the RLVR schema.
    `answer` prefers the explicit answer field, falling back to the
    solution's \\boxed{...} via the math parser."""
    from areal_tpu_torch.reward.math_parser import extract_answer

    def to_item(x):
        ans = x.get("answer") or extract_answer(x.get("solution", "")) or ""
        return dict(
            messages=[{"role": "user", "content": x["problem"]}],
            prompt=x["problem"],
            answer=str(ans),
        )

    return ds.map(to_item, remove_columns=ds.column_names)


@register_dataset("math500")
@register_dataset("math-500")
def _math500(path: str, split: str, type: str, tokenizer=None, max_length=None, **kw):
    """MATH-500 (the OpenAI PRM800K test split; canonical hub id
    HuggingFaceH4/MATH-500) — the reference's headline offline math
    benchmark (its evaluation/data)."""
    import datasets as hf_datasets

    if path in ("", "math500", "math-500", None) or path.endswith("MATH-500"):
        hub = path if path and path.endswith("MATH-500") else "HuggingFaceH4/MATH-500"
        ds = hf_datasets.load_dataset(hub, split=split)
    else:
        ds = hf_datasets.load_dataset(path, split=split)
    return _math_items(ds)


@register_dataset("aime")
@register_dataset("aime24")
@register_dataset("aime25")
def _aime(path: str, split: str, type: str, tokenizer=None, max_length=None, **kw):
    """AIME competition problems (canonical hub ids
    AI-MO/aimo-validation-aime, math-ai/aime24/aime25) — pass@k on these
    is the reference's boba² quality metric (blog/AReaL_v0_3.md)."""
    import datasets as hf_datasets

    name = path.split("/")[-1].lower() if path else "aime"
    if name in ("aime", ""):
        ds = hf_datasets.load_dataset("AI-MO/aimo-validation-aime", split=split)
    elif name in ("aime24", "aime25"):
        ds = hf_datasets.load_dataset(f"math-ai/{name}", split=split)
    else:
        ds = hf_datasets.load_dataset(path, split=split)
    return _math_items(ds)


@register_dataset("synthetic-arith")
def _synthetic_arith(path: str, split: str, type: str, tokenizer=None, max_length=None, **kwargs):
    """Offline verifiable math (no download): integer arithmetic in the
    RLVR schema with pre-tokenized prompts (`dataset/arith.py`); its SFT
    view (JAX :300-326), where `input_ids` is prompt + answer + eos and
    `loss_mask` covers the answer tokens, both cut to `max_length`; and
    its pairwise view for reward models (`type="rw"`, JAX :327-344):
    `chosen_input_ids` the well-formed answer and `rejected_input_ids` the
    answer with a dangling `+`, each + eos and cut to `max_length`. A
    malformed rejection, not a wrong number, keeps the preference
    learnable by the smoke model."""
    from areal_tpu_torch.dataset.arith import ArithTokenizer, make_arith_dataset

    items = make_arith_dataset(
        n_items=kwargs.get("n_items", 4096),
        max_operand=kwargs.get("max_operand", 99),
        seed=kwargs.get("seed", 0),
        split=split,
    )
    if type == "sft":
        tok = ArithTokenizer()
        for x in items:
            ids = tok.encode(x["prompt"] + x["answer"]) + [tok.eos_token_id]
            n_prompt = len(x["input_ids"])
            x["input_ids"] = ids[:max_length] if max_length else ids
            # supervise the answer tokens only; the mask follows a cut
            n = len(x["input_ids"])
            x["loss_mask"] = ([0] * n_prompt + [1] * max(0, n - n_prompt))[:n]
    elif type == "rw":
        tok = ArithTokenizer()
        for x in items:
            chosen = tok.encode(x["prompt"] + x["answer"]) + [tok.eos_token_id]
            rejected = tok.encode(x["prompt"] + x["answer"] + "+") + [tok.eos_token_id]
            if max_length:
                chosen, rejected = chosen[:max_length], rejected[:max_length]
            x["chosen_input_ids"] = chosen
            x["rejected_input_ids"] = rejected
    return items


@register_dataset("countdown")
def _countdown(
    path: str, split: str, type: str, tokenizer=None, max_length=None, **kw
):
    """Offline countdown problems (parity: the reference's
    examples/countdown/countdown.py) — pick numbers, build a random +-*/ expression
    over ALL of them, and use its (integer) value as the target, so every
    problem is solvable by construction. Items carry `target` and
    `numbers`, which flow into countdown_reward via reward_kwargs."""
    rng = np.random.RandomState(
        kw.get("seed", 0) + (1_000_003 if split != "train" else 0)
    )
    n_items = kw.get("n_items", 2048)
    items = []
    while len(items) < n_items:
        k = int(rng.randint(3, 5))
        nums = [int(rng.randint(1, 20)) for _ in range(k)]
        # random left-to-right expression over a shuffled copy
        order = list(rng.permutation(k))
        expr = str(nums[order[0]])
        val = float(nums[order[0]])
        ok = True
        for i in order[1:]:
            op = str(rng.choice(["+", "-", "*", "/"]))
            b = nums[i]  # always >= 1
            if op == "/" and val % b != 0:
                op = "+"  # keep targets integral
            expr = f"({expr} {op} {b})"
            val = {"+": val + b, "-": val - b, "*": val * b, "/": val / b}[op]
            if abs(val) > 10_000:
                ok = False
                break
        if not ok or val != int(val):
            continue
        target = int(val)
        prompt = (
            f"Using the numbers {nums}, create an equation that equals "
            f"{target}. You can use basic arithmetic operations (+, -, *, /) "
            "and each number can only be used once. Show your work and "
            "return the final equation in <answer> </answer> tags."
        )
        item = dict(
            messages=[{"role": "user", "content": prompt}],
            prompt=prompt,
            target=target,
            numbers=nums,
            solution=expr,
        )
        items.append(item)  # RLVR workflows tokenize prompts themselves
    return items


@register_dataset("hh-rlhf")
def _hh_rlhf(path: str, split: str, type: str, tokenizer=None, max_length=None, **kw):
    """Anthropic HH-RLHF pairwise preferences for reward-model training
    (parity: areal/dataset hh-rlhf loader). Items: {chosen_input_ids,
    rejected_input_ids} when a tokenizer is given, else raw text pairs."""
    import datasets as hf_datasets

    ds = hf_datasets.load_dataset(
        path if path not in ("", "hh-rlhf", None) else "Anthropic/hh-rlhf",
        split=split,
    )

    def to_item(x):
        out = dict(chosen=x["chosen"], rejected=x["rejected"])
        if tokenizer is not None:
            for k in ("chosen", "rejected"):
                ids = tokenizer.encode(x[k])
                out[f"{k}_input_ids"] = ids[:max_length] if max_length else ids
        return out

    return ds.map(to_item, remove_columns=ds.column_names)


@register_dataset("torl_data")
def _torl(path: str, split: str, type: str, tokenizer=None, max_length=None, **kw):
    """ToRL tool-integrated math reasoning prompts (parity: areal/dataset
    torl_data). Items: {messages, prompt, answer}."""
    import datasets as hf_datasets

    ds = hf_datasets.load_dataset(path, split=split)

    def to_item(x):
        q = x.get("question", x.get("prompt", x.get("problem", "")))
        ans = x.get("answer", x.get("solution", ""))
        return dict(
            messages=[{"role": "user", "content": q}],
            prompt=q,
            answer=str(ans),
        )

    return ds.map(to_item, remove_columns=ds.column_names)


def _code_rows(path: str, default_hub: str, split: str):
    """Rows for a code benchmark: a local .jsonl fixture (offline eval,
    tests) or the canonical hub id."""
    import json as _json
    import os as _os

    if path and _os.path.isfile(path):
        with open(path) as f:
            return [_json.loads(ln) for ln in f if ln.strip()]
    import datasets as hf_datasets

    hub = path if path and "/" in path else default_hub
    return hf_datasets.load_dataset(hub, split=split)


@register_dataset("humaneval")
@register_dataset("openai_humaneval")
def _humaneval(path: str, split: str, type: str, tokenizer=None, max_length=None, **kw):
    """HumanEval completion benchmark (canonical hub id
    openai/openai_humaneval; local .jsonl fixtures load directly) mapped to
    the code-eval schema: `code_prompt` is the function-signature prefix
    (Codex continuation convention), `input_output.asserts` carries the
    check(candidate) harness for the sandbox runner. pass@k flows through
    evaluation/offline.py with reward/code_verify.code_eval_reward_fn —
    the pipeline behind the reference's LCB/code numbers
    (functioncall/code/verify.py)."""
    rows = _code_rows(path, "openai/openai_humaneval", split or "test")
    items = []
    for r in rows:
        harness = f"{r['test']}\n\ncheck({r['entry_point']})\n"
        items.append(
            dict(
                task_id=r.get("task_id", ""),
                prompt=r["prompt"],
                code_prompt=r["prompt"],
                messages=[
                    {
                        "role": "user",
                        "content": (
                            "Complete the following Python function. "
                            "Reply with the full implementation in a "
                            "```python code block.\n\n```python\n"
                            f"{r['prompt']}\n```"
                        ),
                    }
                ],
                input_output=dict(asserts=[harness]),
            )
        )
    return items


@register_dataset("mbpp")
def _mbpp(path: str, split: str, type: str, tokenizer=None, max_length=None, **kw):
    """MBPP (canonical hub id google-research-datasets/mbpp; local .jsonl
    fixtures load directly): each row's `test_list` asserts become sandbox
    harness cases, prefixed by `test_setup_code` when present."""
    rows = _code_rows(path, "google-research-datasets/mbpp", split or "test")
    items = []
    for r in rows:
        setup = (r.get("test_setup_code") or "").strip()
        asserts = [
            (setup + "\n" + t) if setup else t for t in r["test_list"]
        ]
        text = r.get("text") or r.get("prompt") or ""
        items.append(
            dict(
                task_id=str(r.get("task_id", "")),
                prompt=text,
                messages=[
                    {
                        "role": "user",
                        "content": (
                            f"{text}\n\nReply with a complete Python "
                            "solution in a ```python code block. Your "
                            "solution must satisfy these tests:\n"
                            + "\n".join(r["test_list"])
                        ),
                    }
                ],
                input_output=dict(asserts=asserts),
            )
        )
    return items


class SimpleDataLoader:
    """Minimal stateful dataloader over a list-like dataset, yielding lists
    of items; `state_dict`/`load_state_dict` make the position
    recoverable."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        self._pos = 0

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _order(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        return order

    def __iter__(self):
        order = self._order()
        n = len(self.dataset)
        while self._pos + self.batch_size <= n or (
            not self.drop_last and self._pos < n
        ):
            # chaos seam: death between fetching a batch and any effect of
            # it; the restored position re-yields the batch
            fault_injection.fire("dataloader.next", epoch=self._epoch, pos=self._pos)
            idx = order[self._pos : self._pos + self.batch_size]
            self._pos += len(idx)
            yield [self.dataset[int(i)] for i in idx]
        self._epoch += 1
        self._pos = 0

    def state_dict(self) -> dict:
        return dict(epoch=self._epoch, pos=self._pos, seed=self.seed)

    def load_state_dict(self, state: dict) -> None:
        self._epoch = state["epoch"]
        self._pos = state["pos"]
        self.seed = state["seed"]
