"""Offline benchmark CLI (counterpart of
`areal_tpu/evaluation/eval_and_aggregate.py`; parity: the reference's
evaluation/eval_and_aggregate.py).

Samples n completions per problem for each dataset against a decode
engine — in-process (``--model-path``: a `TorchDecodeEngine` on the card,
or on the CPU when `main` is called with ``device="cpu"``) or a running
decode-server fleet (``--servers`` / name_resolve discovery, through
`RemoteInfEngine`) — scores them with the task's verifiable reward, and writes per-dataset ``samples.jsonl`` +
``metrics.json`` (mean reward, pass@1, pass@k, maj@n, lengths), and
``result.json`` over all of them.

    python -m areal_tpu_torch.evaluation.eval_and_aggregate \
        --data-names gsm8k --model-path /models/Qwen2.5-0.5B-Instruct \
        --n-sampling 8 --max-gen-tokens 1024 --output-path ./eval_out

``--task code`` scores with `reward/code_verify.code_reward_fn`, as the
JAX CLI does: the last fenced code block of a completion runs against the
item's testcases (`input_output`), so a fence-less HumanEval continuation
scores 0 (`code_eval_reward_fn` would assemble it with `code_prompt`).

    python -m areal_tpu_torch.evaluation.eval_and_aggregate --task code \
        --data-names /data/humaneval --model-path /models/Qwen2.5-Coder \
        --output-path ./eval_out

(a local `.jsonl` named after its loader, `humaneval` or `mbpp`, loads
directly.)
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any


def _reward_for(task: str):
    if task == "math":
        from areal_tpu_torch.reward.math_parser import math_verify_reward

        return math_verify_reward
    if task == "code":
        from areal_tpu_torch.reward.code_verify import code_reward_fn

        return code_reward_fn
    raise ValueError(f"unknown task {task!r} (math | code)")


def main(argv: list[str] | None = None, device: Any = None) -> None:
    """Run the CLI on `argv`; `device` places the in-process engine: the
    card by default, `"cpu"` for the kernels' plain versions."""
    p = argparse.ArgumentParser()
    p.add_argument("--data-names", required=True,
                   type=lambda x: x.split(","))
    p.add_argument("--model-path", default="")
    p.add_argument("--tokenizer-path", default="",
                   help="HF tokenizer (defaults to --model-path); REQUIRED "
                        "with --servers — without a tokenizer completions "
                        "can't be decoded and every reward scores 0")
    p.add_argument("--servers", default="",
                   help="comma-separated decode-server host:port (instead of "
                        "an in-process engine)")
    p.add_argument("--experiment-name", default="")
    p.add_argument("--trial-name", default="")
    p.add_argument("--split", default="test")
    p.add_argument("--output-path", default="./eval_out")
    p.add_argument("--n-sampling", type=int, default=8)
    p.add_argument("--max-gen-tokens", type=int, default=4096)
    p.add_argument("--temperature", type=float, default=0.6)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--task", default="math")
    p.add_argument("--max-problems", type=int, default=None)
    args = p.parse_args(argv)

    from areal_tpu_torch.api.cli_args import (
        GenerationHyperparameters,
        InferenceEngineConfig,
        TorchDecodeConfig,
    )
    from areal_tpu_torch.dataset import get_custom_dataset, load_tokenizer
    from areal_tpu_torch.evaluation.offline import evaluate_offline

    reward_fn = _reward_for(args.task)
    tok_path = args.tokenizer_path or args.model_path
    if not tok_path:
        p.error("--tokenizer-path (or --model-path) is required: without a "
                "tokenizer every completion decodes to None and all rewards "
                "score 0")
    # the offline sentinels get the built-in arithmetic tokenizer, as in
    # the entry points; anything else goes to AutoTokenizer
    tokenizer = load_tokenizer(tok_path)

    if args.servers or (args.experiment_name and args.trial_name):
        from areal_tpu_torch.core.remote_inf_engine import (
            JaxDecodeBackend,
            RemoteInfEngine,
        )

        engine = RemoteInfEngine(
            InferenceEngineConfig(
                experiment_name=args.experiment_name or None,
                trial_name=args.trial_name or None,
            ),
            JaxDecodeBackend(),
            tokenizer=tokenizer,
        )
        engine.initialize(
            [s for s in args.servers.split(",") if s] or None
        )
    else:
        assert args.model_path, "--model-path or --servers required"
        from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine

        engine = TorchDecodeEngine(
            TorchDecodeConfig(
                model_path=args.model_path,
                context_length=args.max_gen_tokens + 2048,
            ),
            InferenceEngineConfig(),
            tokenizer=tokenizer,
            device=device,
        )
        engine.initialize()

    gconfig = GenerationHyperparameters(
        n_samples=args.n_sampling,
        max_new_tokens=args.max_gen_tokens,
        temperature=args.temperature,
        top_p=args.top_p,
    )

    all_metrics = {}
    try:
        for name in args.data_names:
            ds = get_custom_dataset(
                path=name, split=args.split, type="rl", tokenizer=tokenizer
            )
            items = list(ds)[: args.max_problems]
            out_dir = os.path.join(args.output_path, name)
            res = evaluate_offline(
                engine,
                items,
                reward_fn=reward_fn,
                gconfig=gconfig,
                tokenizer=tokenizer,
                ks=(1, 4, args.n_sampling),
                dump_path=os.path.join(out_dir, "samples.jsonl"),
            )
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "metrics.json"), "w") as f:
                json.dump(res.to_dict(), f, indent=2)
            all_metrics[name] = res.to_dict()
    finally:
        engine.destroy()
    # top-level summary — the AutomaticEvaluator's per-checkpoint artifact
    os.makedirs(args.output_path, exist_ok=True)
    with open(os.path.join(args.output_path, "result.json"), "w") as f:
        json.dump(all_metrics, f, indent=2)
    print(json.dumps(all_metrics, indent=2))


if __name__ == "__main__":
    main()
