"""Allocation-mode expressions (counterpart of `areal_tpu/api/alloc_mode.py`):
how devices split between generation and training.

The JAX module parses its grammar (`ALLOCATION_GRAMMAR`, :177-211) with
`lark`, which the card machine does not have, so this one parses the same
grammar by hand, whitespace between tokens included, and then applies
the JAX module's checks in the same order (`_from_node`, :373-440): a
string JAX rejects raises the same error class here, and a string JAX
accepts gives the same type, backends and strategy sizes. On top of
that the port refuses what it cannot run yet, with its ROADMAP.md item:

- a side of more than one device (`jax:d2+d1`, `d4t2`): queue 1, item 5;
- a training backend other than `jax` (`fsdp`, `megatron`): item 5;
- a generation backend other than `jax` (`sglang`, `vllm`,
  `jetstream`) and the MoE hybrid sections (`attn:...|ffn:...`): item 6.7.

What is left is one device per side: the empty string (COLOCATE),
`jax:d1+d1`, `jax:d1t1+d1` (DECOUPLED_TRAIN) and their spellings.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class AllocationType(enum.Enum):
    COLOCATE = 0
    DECOUPLED_TRAIN = 1
    LLM_SERVER_ONLY = 2
    DECOUPLED_EVAL = 3


class AllocationValidationError(Exception):
    pass


class InvalidAllocationModeError(Exception):
    pass


@dataclass
class ParallelStrategy:
    """5-D parallel strategy (JAX :57) with its sizes."""

    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    data_parallel_size: int = 1
    context_parallel_size: int = 1
    expert_parallel_size: int = 1
    expert_tensor_parallel_size: int = 1

    def __post_init__(self):
        if self.expert_parallel_size > 1:
            emp = self.expert_model_parallel_size
            if self.world_size % emp != 0:
                raise AllocationValidationError(
                    f"Expert model parallel size {emp} does not divide "
                    f"world size {self.world_size}"
                )

    @property
    def world_size(self) -> int:
        return (
            self.tensor_parallel_size
            * self.pipeline_parallel_size
            * self.data_parallel_size
            * self.context_parallel_size
        )

    @property
    def expert_model_parallel_size(self) -> int:
        return (
            self.pipeline_parallel_size
            * self.expert_tensor_parallel_size
            * self.expert_parallel_size
        )


INFERENCE_BACKENDS = ("jax", "jetstream", "sglang", "vllm")
TRAIN_BACKENDS = ("jax", "fsdp", "megatron")
_BACKENDS = ("jetstream", "sglang", "vllm", "megatron", "fsdp", "jax")
_EVAL = ("cpu", "eval")
_INF_DIMS = ("d", "t", "p")
_DIM_FIELD = {
    "d": "data_parallel_size",
    "t": "tensor_parallel_size",
    "p": "pipeline_parallel_size",
    "c": "context_parallel_size",
    "e": "expert_parallel_size",
}
_ATTN_DIMS = ("c", "d", "t", "p")
_FFN_DIMS = ("d", "e", "t", "p")


def _tokens(expr: str) -> list[tuple[str, object]]:
    """Lex: ("dim", (letter, n)), ("word", w), or a punctuation mark."""
    out, i, n = [], 0, len(expr)
    while i < n:
        ch = expr[i]
        if ch.isspace():
            i += 1
        elif ch in ":+|()":
            out.append((ch, ch))
            i += 1
        elif "a" <= ch <= "z":
            j = i
            while j < n and "a" <= expr[j] <= "z":
                j += 1
            word = expr[i:j]
            if len(word) == 1:
                while j < n and expr[j].isspace():
                    j += 1
                k = j
                while k < n and expr[k].isdigit():
                    k += 1
                num = expr[j:k]
                if not num or num[0] == "0":
                    raise InvalidAllocationModeError(
                        f"cannot parse allocation mode {expr!r}: dimension {word!r} "
                        "needs a positive number"
                    )
                out.append(("dim", (word, int(num))))
                i = k
            else:
                out.append(("word", word))
                i = j
        else:
            raise InvalidAllocationModeError(
                f"cannot parse allocation mode {expr!r}: unexpected {ch!r} at {i}"
            )
    return out


class _Parser:
    """Recursive descent over `ALLOCATION_GRAMMAR`; builds the nodes of
    the JAX module's `_AllocTransformer`."""

    def __init__(self, expr: str):
        self.expr = expr
        self.toks = _tokens(expr)
        self.i = 0

    def fail(self, what: str):
        raise InvalidAllocationModeError(f"cannot parse allocation mode {self.expr!r}: {what}")

    def peek(self, k: int = 0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else (None, None)

    def take(self, kind: str, value=None):
        tok = self.peek()
        if tok[0] != kind or (value is not None and tok[1] != value):
            self.fail(f"expected {value or kind}, got {tok[1]!r}")
        self.i += 1
        return tok[1]

    def is_backend(self) -> bool:
        kind, val = self.peek()
        return kind == "word" and val in _BACKENDS

    def parse(self):
        if self.is_backend():
            left = self.backend_para()
            kind, _ = self.peek()
            if kind is None:
                node = left
            elif kind == "+":
                self.i += 1
                w_kind, w = self.peek()
                if w_kind == "word" and w in _EVAL:
                    self.i += 1
                    node = ("eval", left)
                else:
                    node = ("disagg", left, self.rhs_para())
            elif kind == "|":
                self.i += 1
                node = ("colo", left, self.rhs_para())
            else:
                self.fail(f"unexpected {self.peek()[1]!r}")
        else:
            node = self.plain_train()
        if self.peek()[0] is not None:
            self.fail(f"trailing {self.peek()[1]!r}")
        return node

    def rhs_para(self):
        return self.backend_para() if self.is_backend() else self.plain_train()

    def dims(self, allowed=None) -> list[tuple[str, int]]:
        out = []
        while self.peek()[0] == "dim":
            tag, n = self.peek()[1]
            if tag not in (allowed or _DIM_FIELD):
                self.fail(f"dimension {tag!r} not allowed here")
            out.append((tag, n))
            self.i += 1
        if not out:
            self.fail(f"expected a dimension, got {self.peek()[1]!r}")
        return out

    def starts_moe(self) -> bool:
        kind, val = self.peek()
        return kind == "(" or (kind == "word" and val == "attn")

    def backend_para(self):
        backend = self.take("word")
        self.take(":")
        if self.starts_moe():
            return ("para", backend, self.hybrid_moe(), ())
        dims = self.dims()
        return ("para", backend, _strategy_from_dims(dims, backend), tuple(t for t, _ in dims))

    def plain_train(self):
        if self.starts_moe():
            return ("para", None, self.hybrid_moe(), ())
        dims = self.dims()
        return ("para", None, _strategy_from_dims(dims, "train"), tuple(t for t, _ in dims))

    def hybrid_moe(self) -> ParallelStrategy:
        paren = self.peek()[0] == "("
        if paren:
            self.i += 1
        self.take("word", "attn")
        self.take(":")
        attn = self.dims(_ATTN_DIMS)
        self.take("|")
        self.take("word", "ffn")
        self.take(":")
        ffn = self.dims(_FFN_DIMS)
        if paren:
            self.take(")")
        return _hybrid_strategy(attn, ffn)


def _strategy_from_dims(dims: list[tuple[str, int]], what: str) -> ParallelStrategy:
    kwargs: dict[str, int] = {}
    for tag, size in dims:
        name = _DIM_FIELD[tag]
        if name in kwargs:
            raise AllocationValidationError(f"duplicate dimension '{tag}' in {what} strategy")
        kwargs[name] = size
    return ParallelStrategy(**kwargs)


def _hybrid_strategy(attn_dims, ffn_dims) -> ParallelStrategy:
    """The JAX transformer's `hybrid_moe` (:282-310)."""
    attn = _strategy_from_dims(attn_dims, "attention")
    ffn = dict(ffn_dims)
    strategy = ParallelStrategy(
        tensor_parallel_size=attn.tensor_parallel_size,
        pipeline_parallel_size=attn.pipeline_parallel_size,
        data_parallel_size=attn.data_parallel_size,
        context_parallel_size=attn.context_parallel_size,
        expert_parallel_size=ffn.get("e", 1),
        expert_tensor_parallel_size=ffn.get("t", 1),
    )
    ffn_world = ffn.get("d", 1) * ffn.get("e", 1) * ffn.get("t", 1) * ffn.get("p", 1)
    if ffn_world != strategy.world_size:
        raise AllocationValidationError(
            f"MoE hybrid: ffn world size {ffn_world} != attn world size {strategy.world_size}"
        )
    if ffn.get("p", 1) != attn.pipeline_parallel_size:
        raise AllocationValidationError("MoE hybrid: ffn and attn pipeline sizes must match")
    strategy.moe_hybrid = True  # type: ignore[attr-defined]
    return strategy


def _check_inference_para(node, expr: str):
    _, backend, strategy, dim_tags = node
    if backend is None:
        raise AllocationValidationError(
            f"inference side of {expr!r} must name a backend (one of {INFERENCE_BACKENDS})"
        )
    if backend not in INFERENCE_BACKENDS:
        raise AllocationValidationError(
            f"{backend!r} is not an inference backend (expected one of "
            f"{INFERENCE_BACKENDS}); in 'A+B' / 'A|B' the left side is the "
            "inference deployment"
        )
    bad = [t for t in dim_tags if t not in _INF_DIMS]
    for t, sz in (("c", strategy.context_parallel_size), ("e", strategy.expert_parallel_size)):
        if sz > 1 and t not in bad:
            bad.append(t)
    if bad:
        raise AllocationValidationError(
            f"dimension(s) {bad} are not valid for an inference deployment "
            f"(allowed: {_INF_DIMS}); for a train-only allocation write bare dims, e.g. 'd4c2'"
        )
    return backend, strategy


def _check_train_para(node, expr: str):
    _, backend, strategy, _ = node
    backend = backend or "jax"
    if backend not in TRAIN_BACKENDS:
        raise AllocationValidationError(
            f"{backend!r} is not a train backend (expected one of {TRAIN_BACKENDS}); "
            "in 'A+B' / 'A|B' the right side is the trainer"
        )
    return backend, strategy


def _refuse_unported(mode: "AllocationMode", expr: str) -> None:
    sides = [("generation", mode.gen_backend, mode.gen), ("training", mode.train_backend,
                                                          mode.train)]
    for side, backend, strategy in sides:
        if strategy is None:
            continue
        if side == "generation" and backend not in (None, "jax"):
            raise NotImplementedError(
                f"allocation_mode={expr!r}: the {backend!r} serving backend is not in the "
                "PyTorch port yet: ROADMAP.md queue 1, item 6.7"
            )
        if side == "training" and backend not in (None, "jax"):
            raise NotImplementedError(
                f"allocation_mode={expr!r}: the {backend!r} training backend is not in the "
                "PyTorch port yet: ROADMAP.md queue 1, item 5"
            )
        if getattr(strategy, "moe_hybrid", False) and (
            strategy.world_size > 1 or strategy.expert_parallel_size > 1
        ):
            # a one-device hybrid section is the one-device strategy, as
            # JAX reads it (its :251-282)
            raise NotImplementedError(
                f"allocation_mode={expr!r}: a MoE hybrid {side} section over more than one "
                "device is expert parallelism, which spans devices: ROADMAP.md queue 1, item 5"
            )
        if strategy.world_size > 1 or strategy.expert_parallel_size > 1:
            raise NotImplementedError(
                f"allocation_mode={expr!r}: a {side} side over more than one device is not "
                "in the PyTorch port yet: ROADMAP.md queue 1, item 5"
            )


@dataclass
class AllocationMode:
    """A parsed allocation (JAX :347)."""

    type_: AllocationType
    gen: ParallelStrategy = field(default_factory=ParallelStrategy)
    train: ParallelStrategy | None = None
    gen_backend: str | None = None
    train_backend: str | None = None

    @classmethod
    def from_str(cls, allocation_mode: str) -> "AllocationMode":
        if not (allocation_mode or "").strip():
            return cls(type_=AllocationType.COLOCATE, train=None)
        try:
            node = _Parser(allocation_mode).parse()
        except AllocationValidationError as e:
            # lark wraps the JAX transformer's own checks (duplicate dims,
            # the MoE hybrid's sizes) in its VisitError: a parse failure
            raise InvalidAllocationModeError(
                f"cannot parse allocation mode {allocation_mode!r}: {e}"
            ) from e
        mode = cls._from_node(node, allocation_mode)
        _refuse_unported(mode, allocation_mode)
        return mode

    @classmethod
    def _from_node(cls, node, expr: str) -> "AllocationMode":
        kind = node[0]
        if kind == "para":
            backend = node[1]
            if backend is None or backend not in INFERENCE_BACKENDS:
                backend, strategy = _check_train_para(node, expr)
                return cls(type_=AllocationType.COLOCATE, gen=ParallelStrategy(),
                           train=strategy, train_backend=backend)
            backend, strategy = _check_inference_para(node, expr)
            return cls(type_=AllocationType.LLM_SERVER_ONLY, gen=strategy, gen_backend=backend)
        if kind == "eval":
            backend, strategy = _check_inference_para(node[1], expr)
            return cls(type_=AllocationType.DECOUPLED_EVAL, gen=strategy, gen_backend=backend)
        gen_backend, gen = _check_inference_para(node[1], expr)
        train_backend, train = _check_train_para(node[2], expr)
        if kind == "colo" and gen.world_size != train.world_size:
            raise AllocationValidationError(
                f"colocated allocation {expr!r} requires matching world sizes, got "
                f"gen={gen.world_size} train={train.world_size}"
            )
        return cls(
            type_=AllocationType.DECOUPLED_TRAIN if kind == "disagg" else AllocationType.COLOCATE,
            gen=gen, gen_backend=gen_backend, train=train, train_backend=train_backend,
        )

    def check_hbm(
        self,
        model_cfg,
        device_kind: str,
        *,
        microbatch_tokens: int = 8192,
        remat: bool = True,
        decode_slots: int = 64,
        decode_context: int = 32768,
        decode_pool_tokens: int | None = None,
        decode_weight_dtype: str = "fp",
        utilization: float = 0.9,
    ) -> dict:
        """Check that this allocation's train and gen halves each fit the
        device's memory by the closed-form estimator (`utils/hbm.py`; JAX
        :442-505). Raises AllocationValidationError with the per-component
        breakdown; returns {"train": ..., "gen": ...} breakdowns when both
        fit. Each half is checked alone, as in JAX: a colocated run holds
        both on one device, and its caller adds them. JAX's `fsdp`, `zero1`,
        `pipeline_schedule` and `virtual_pp` act only across devices, so at
        the one device a side the port accepts they take the estimator's
        defaults."""
        from areal_tpu_torch.utils import hbm

        report: dict = {}
        if self.train is not None:
            t = self.train
            est = hbm.estimate_train_hbm(
                model_cfg,
                dp=t.data_parallel_size,
                tp=t.tensor_parallel_size,
                pp=t.pipeline_parallel_size,
                sp=t.context_parallel_size,
                microbatch_tokens=microbatch_tokens,
                remat=remat,
            )
            try:
                hbm.check_fit(est, device_kind, utilization=utilization)
            except MemoryError as e:
                raise AllocationValidationError(f"train half: {e}") from None
            report["train"] = est.breakdown()
        if self.gen is not None and self.gen.world_size > 0:
            est = hbm.estimate_decode_hbm(
                model_cfg,
                tp=self.gen.tensor_parallel_size,
                slots=decode_slots,
                context_length=decode_context,
                pool_tokens=decode_pool_tokens,
                weight_dtype=decode_weight_dtype,
            )
            try:
                hbm.check_fit(est, device_kind, utilization=utilization)
            except MemoryError as e:
                raise AllocationValidationError(f"gen half: {e}") from None
            report["gen"] = est.breakdown()
        return report
