"""Datasets and the dataloader of the entry points (counterpart of
`areal_tpu/dataset/__init__.py`), trimmed to the offline paths: the
built-in arithmetic tokenizer, the `synthetic-arith` dataset's RL, SFT
and reward-model views, and `SimpleDataLoader`. Hub datasets and
tokenizers are refused with the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from areal_tpu_torch.models.smoke import OFFLINE_SENTINELS

_HUB = (
    "is not in the PyTorch port yet: ROADMAP.md queue 1, item 6 (model "
    "breadth: tokenizers and datasets from local paths)"
)


def load_tokenizer(path: str):
    """The built-in arithmetic tokenizer for the offline sentinels."""
    if path in OFFLINE_SENTINELS:
        from areal_tpu_torch.dataset.arith import ArithTokenizer

        return ArithTokenizer()
    raise NotImplementedError(f"tokenizer {path!r} {_HUB}")


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
    """Load a dataset by name; the port has `synthetic-arith`: integer
    arithmetic in the RLVR schema with pre-tokenized prompts
    (`dataset/arith.py`); its SFT view (JAX :300-326), where `input_ids`
    is prompt + answer + eos and `loss_mask` covers the answer tokens,
    both cut to `max_length`; and its pairwise view for reward models
    (`type="rw"`, JAX :327-344): `chosen_input_ids` the well-formed answer
    and `rejected_input_ids` the answer with a dangling `+`, each + eos
    and cut to `max_length`. A malformed rejection, not a wrong number,
    keeps the preference learnable by the smoke model."""
    name = path.split("/")[-1].lower()
    if name != "synthetic-arith":
        raise NotImplementedError(f"dataset {path!r} {_HUB}")
    if world_size > 1:
        raise NotImplementedError(
            "sharding a dataset over hosts is not in the PyTorch port yet: "
            "ROADMAP.md queue 1, item 5"
        )
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
