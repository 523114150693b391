"""Offline benchmark evaluation (counterpart of
`areal_tpu/evaluation/offline.py`; parity: the reference's `evaluation/`
harness + AutomaticEvaluator, realhf/scheduler/evaluator.py — minus the
vendored latex2sympy, which areal_tpu_torch.reward.math_parser covers).

Generates n samples per problem against any InferenceEngine, scores with a
verifiable reward function, and reports mean reward, pass@1 and pass@k
(unbiased estimator), maj@n and length stats: a checkpoint benchmarked on
AIME/MATH/GSM8K-style sets, in process or against decode servers
(`evaluation/eval_and_aggregate.py`)."""

from __future__ import annotations

import asyncio
import dataclasses
import uuid
from typing import Any, Callable

import numpy as np

from areal_tpu_torch.api.cli_args import GenerationHyperparameters
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.api.reward_api import AsyncRewardWrapper
from areal_tpu_torch.utils import logging

logger = logging.getLogger("evaluation")


@dataclasses.dataclass
class EvalResult:
    n_problems: int
    n_samples: int
    mean_reward: float
    pass_at_1: float
    pass_at_k: dict[int, float]
    mean_output_len: float
    maj_at_n: float = 0.0

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update({f"pass@{k}": v for k, v in d.pop("pass_at_k").items()})
        return d


def pass_at_k_estimate(n: int, c: int, k: int) -> float:
    """Unbiased pass@k (Codex paper): 1 - C(n-c, k)/C(n, k)."""
    if n - c < k:
        return 1.0
    prod = 1.0
    for i in range(k):
        prod *= (n - c - i) / (n - i)
    return 1.0 - prod


def evaluate_offline(
    engine: Any,
    items: list[dict[str, Any]],
    *,
    reward_fn: Callable[..., float],
    gconfig: GenerationHyperparameters,
    tokenizer: Any = None,
    n_samples: int | None = None,
    ks: tuple[int, ...] = (1, 4, 8),
    max_concurrency: int = 64,
    reward_timeout_seconds: float = 60.0,
    dump_path: str | None = None,
) -> EvalResult:
    """Run the benchmark: for each item, sample `n_samples` completions and
    score each; aggregate."""
    n = n_samples or gconfig.n_samples
    areward = AsyncRewardWrapper(reward_fn, timeout_seconds=reward_timeout_seconds)
    sem = asyncio.Semaphore(max_concurrency)

    def encode(item):
        if "input_ids" in item:
            return list(np.asarray(item["input_ids"]).reshape(-1))
        if "messages" in item and tokenizer is not None:
            return tokenizer.apply_chat_template(
                item["messages"], add_generation_prompt=True, tokenize=True
            )
        assert tokenizer is not None, "need a tokenizer for text prompts"
        return tokenizer.encode(item.get("prompt", item.get("question")))

    async def one_sample(item, ids):
        async with sem:
            resp = await engine.agenerate(
                ModelRequest(
                    rid=str(uuid.uuid4()),
                    input_ids=ids,
                    gconfig=gconfig.new(n_samples=1),
                    tokenizer=tokenizer,
                )
            )
        completion = (
            tokenizer.decode(resp.output_tokens) if tokenizer is not None else None
        )
        from areal_tpu_torch.api.reward_api import reward_kwargs

        reward = await areward(
            None,
            completion,
            resp.input_tokens,
            resp.output_tokens,
            **reward_kwargs(item),
        )
        return float(reward), resp.output_len, completion

    async def run():
        tasks = []
        for item in items:
            ids = encode(item)
            tasks.append(
                asyncio.gather(*[one_sample(item, ids) for _ in range(n)])
            )
        return await asyncio.gather(*tasks)

    per_problem = asyncio.run(run())

    rewards = np.array(
        [[r for r, _, _ in samples] for samples in per_problem],
        dtype=np.float64,
    )  # [P, n]
    lens = np.array([[l for _, l, _ in samples] for samples in per_problem])
    correct = (rewards > 0).sum(axis=1)  # [P]
    pass_k = {
        k: float(np.mean([pass_at_k_estimate(n, int(c), k) for c in correct]))
        for k in ks
        if k <= n
    }
    # maj@n (parity: the reference's rm_maj_eval group_pred): plurality vote
    # over extracted answers; a problem counts iff the plurality answer's
    # samples were rewarded correct. Votes cluster by mathematical
    # EQUIVALENCE, not string identity — "\\frac{1}{2}" and "0.5" are the
    # same vote (string-only voting splits majorities and understates
    # maj@n on LaTeX-answer benchmarks). Clustering is two-stage to stay
    # cheap and hang-proof: (1) canonicalize each answer once (numeric
    # value or normalized string — no sympy); (2) merge the few remaining
    # symbolic representatives pairwise through the SUBPROCESS grader,
    # whose hard timeout contains adversarial sympy inputs.
    from areal_tpu_torch.reward.math_parser import (
        math_equal_subprocess,
        normalize_answer,
        parse_number,
    )

    def vote_key(ans: str):
        norm = normalize_answer(ans)
        num = parse_number(norm)
        if num is not None:
            return ("num", round(num, 8))
        return ("sym", norm.lower())

    # bound the pairwise merge: a weak checkpoint emitting dozens of
    # distinct unparseable answers must not trigger O(clusters^2) forked
    # comparisons (each up to its hang timeout)
    MAX_MERGE_CLUSTERS = 12

    maj = []
    for p_idx, samples in enumerate(per_problem):
        votes: dict[tuple, list[float]] = {}
        originals: dict[tuple, str] = {}
        for r, _, completion in samples:
            ans = _extracted_answer(completion)
            key = vote_key(ans)
            if key not in votes and key[0] == "sym":
                # residual symbolic merge AGAINST EVERY cluster (numeric
                # too: \sqrt{4} must join the "2" cluster), via the
                # subprocess grader so adversarial sympy cannot hang
                if len(votes) <= MAX_MERGE_CLUSTERS:
                    for k in votes:
                        if math_equal_subprocess(
                            ans, originals[k], timeout_s=3.0
                        ):
                            key = k
                            break
            votes.setdefault(key, []).append(r)
            originals.setdefault(key, ans)
        if not votes:
            maj.append(0.0)
            continue
        top = max(votes.values(), key=len)
        maj.append(float(np.mean(top) > 0))
    res = EvalResult(
        n_problems=len(items),
        n_samples=n,
        mean_reward=float(rewards.mean()),
        pass_at_1=float((rewards > 0).mean()),
        pass_at_k=pass_k,
        maj_at_n=float(np.mean(maj)),
        mean_output_len=float(lens.mean()),
    )
    if dump_path is not None:
        import json
        import os

        os.makedirs(os.path.dirname(dump_path) or ".", exist_ok=True)
        with open(dump_path, "w") as f:
            for item, samples in zip(items, per_problem):
                f.write(
                    json.dumps(
                        dict(
                            prompt=item.get("prompt"),
                            answer=item.get("answer"),
                            samples=[
                                dict(reward=r, output_len=int(l),
                                     completion=c)
                                for r, l, c in samples
                            ],
                        )
                    )
                    + "\n"
                )
    logger.info(f"offline eval: {res.to_dict()}")
    return res


def _extracted_answer(completion: str | None) -> str:
    from areal_tpu_torch.reward.math_parser import extract_answer

    if not completion:
        return ""
    return extract_answer(completion) or completion.strip()[-32:]
