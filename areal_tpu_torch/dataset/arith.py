"""Synthetic arithmetic dataset + character tokenizer for offline smoke
runs (a copy of `areal_tpu/dataset/arith.py`).

Single-step integer arithmetic rendered as text, with ground-truth
answers in the RLVR schema (``{"prompt", "input_ids", "answer"}``), a
self-contained character-level tokenizer, and the binary reward that
checks the answer. It needs no download, so the GRPO entry point runs
against it anywhere; with small operands a toy policy can learn it.
"""

from __future__ import annotations

from typing import Any

import numpy as np

__all__ = ["ArithTokenizer", "make_arith_dataset", "arith_reward_fn"]

# Character vocabulary: digits, operators, letters used in the prompt
# template, whitespace. Token 0 is pad, 1 is BOS, 2 is EOS.
_CHARS = "0123456789+-*= ?.\n"
PAD, BOS, EOS = 0, 1, 2
_OFFSET = 3


class ArithTokenizer:
    """Character tokenizer with the subset of the HF interface the stack
    uses (encode/decode/apply_chat_template, pad/eos ids)."""

    def __init__(self):
        self.vocab_size = _OFFSET + len(_CHARS)
        self.pad_token_id = PAD
        self.eos_token_id = EOS
        self.bos_token_id = BOS
        self._c2i = {c: i + _OFFSET for i, c in enumerate(_CHARS)}
        self._i2c = {i + _OFFSET: c for i, c in enumerate(_CHARS)}

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        ids = [self._c2i[c] for c in text if c in self._c2i]
        if add_special_tokens:
            ids = [BOS] + ids
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = []
        for i in np.asarray(ids).reshape(-1).tolist():
            if i in (PAD, BOS, EOS):
                if not skip_special_tokens:
                    out.append({PAD: "<pad>", BOS: "<s>", EOS: "</s>"}[i])
                continue
            out.append(self._i2c.get(int(i), ""))
        return "".join(out)

    def apply_chat_template(
        self, messages, add_generation_prompt: bool = True, tokenize: bool = True,
        **kw,
    ):
        text = "\n".join(m["content"] for m in messages)
        if add_generation_prompt:
            text += "="
        return self.encode(text) if tokenize else text

    def __call__(self, text, **kw):
        return {"input_ids": self.encode(text)}


def make_arith_dataset(
    n_items: int = 4096,
    max_operand: int = 99,
    seed: int = 0,
    ops: str = "+-",
    split: str = "train",
) -> list[dict[str, Any]]:
    """Items in the RLVR schema; ``input_ids`` pre-tokenized so no external
    tokenizer is needed."""
    tok = ArithTokenizer()
    # disjoint train/test streams
    rng = np.random.RandomState(seed + (0 if split == "train" else 10_000))
    items = []
    for _ in range(n_items):
        a = int(rng.randint(0, max_operand + 1))
        b = int(rng.randint(0, max_operand + 1))
        op = ops[int(rng.randint(0, len(ops)))]
        ans = a + b if op == "+" else a - b if op == "-" else a * b
        prompt = f"{a}{op}{b}="
        items.append(
            dict(
                prompt=prompt,
                input_ids=tok.encode(prompt),
                answer=str(ans),
            )
        )
    return items


def arith_reward_fn(prompt, completion, prompt_ids, completion_ids, **data):
    """Binary reward: the generated text starts with the exact answer."""
    target = str(data.get("answer", "")).strip()
    if completion is None:
        tok = ArithTokenizer()
        completion = tok.decode(completion_ids)
    got = completion.strip().split()[0] if completion.strip() else ""
    # strip trailing template chars so "19." or "19\n" match
    got = got.rstrip(".?=\n ")
    return 1.0 if got == target else 0.0
