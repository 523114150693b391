"""The port's TIR workflow and `tir_math` entry point against the JAX
package's, on the CPU.

- The 13 cases of `tests/test_tir.py`, each run through both packages:
  the sandboxed python tool (its output, timeout, truncation, errors and
  grandchildren), the calculator and search tools, and `TIRWorkflow` on
  a scripted engine (the two-phase marker state machine, the match of a
  fence by position after a stop cut on a token boundary, tool tokens
  with loss mask 0, logprob 0 and version -1, `remaining` charged for
  tool tokens, `max_tool_calls`). Rows (`input_ids`, `loss_mask`,
  `logprobs`, `versions`, `rewards`, `begin_of_answer`) and the prompts
  the engine saw are equal exactly; so are the `dump_dir` records.
- `TIRWorkflow` on a greedy `TorchDecodeEngine` and a greedy
  `JaxDecodeEngine` with the same smoke weights (moved by
  `models/convert.py`), a python tool and the calculator whose markers are
  arithmetic characters: the rounds run both tools, the tokens are equal
  and the logprobs agree within 1e-5 (`test_torch_decode.py`'s
  tolerance); each round after the first is served from the prefix
  registry alike (equal prefill, fork and suffix-prefill counts).
- The slice as a whole: the port's `tir_math.main` and JAX's
  `examples/tir_math.py` on `examples/configs/tir_math.yaml` with the
  offline smoke overrides of `tests/test_examples_smoke.py`, 2 steps,
  synchronous and greedy so that both loops see the same episodes, with
  the same initial weights: each step's trained rows are equal, their
  logprobs within 1e-5 (`test_torch_grpo_loop.py`'s tolerance), and the
  losses within 1e-5.
"""

import asyncio
import importlib.util
import json
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from areal_tpu.api import cli_args as j_cli
from areal_tpu.api.io_struct import ModelResponse as JResponse
from areal_tpu.dataset import get_custom_dataset as j_dataset
from areal_tpu.dataset.arith import ArithTokenizer as JTok
from areal_tpu.engine.jax_decode import JaxDecodeEngine
from areal_tpu.models import qwen2 as jq
from areal_tpu.workflow import tir as jtir
from areal_tpu_torch.api import cli_args as t_cli
from areal_tpu_torch.api.io_struct import ModelResponse as TResponse
from areal_tpu_torch.dataset import get_custom_dataset as t_dataset
from areal_tpu_torch.dataset.arith import ArithTokenizer as TTok
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy
from areal_tpu_torch.models.smoke import SMOKE_MODEL_DICT
from areal_tpu_torch.workflow import tir as ttir
from tests.test_tir import _CharTok
from tests.test_torch_multi_turn import Rounds

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"jax": (jtir, j_cli, JResponse), "torch": (ttir, t_cli, TResponse)}
ROW_KEYS = ("input_ids", "loss_mask", "logprobs", "versions", "rewards", "begin_of_answer",
            "attention_mask")
LOGP_ATOL = 1e-5


class _ScriptedEngine:
    """Returns pre-scripted generations (`tests/test_tir.py`'s engine, with
    each package's response type); records the prompts it saw."""

    def __init__(self, tok, outputs, response):
        self.tok = tok
        self.outputs = list(outputs)
        self.response = response
        self.seen_prompts = []

    async def agenerate(self, req):
        self.seen_prompts.append(self.tok.decode(req.input_ids))
        text, stop_reason = self.outputs.pop(0)
        ids = self.tok.encode(text)
        if len(ids) > req.gconfig.max_new_tokens:  # engines honor the cap
            ids = ids[: req.gconfig.max_new_tokens]
            stop_reason = "length"
        return self.response(input_tokens=list(req.input_ids), output_tokens=ids,
                             output_logprobs=[-0.5] * len(ids),
                             output_versions=[0] * len(ids), stop_reason=stop_reason)


def run_both(outputs, reward_fn, gconfig: dict, data=None, tool_fn=None, tools=None, **kw):
    """The episode of `outputs` through each package's `TIRWorkflow`;
    checks the rows and the prompts seen are equal and returns the port's
    (rows, prompts, tool inputs executed)."""
    got = {}
    for name, (mod, cli, response) in PKGS.items():
        tok = _CharTok()
        eng = _ScriptedEngine(tok, outputs, response)
        executed = []
        fn = None if tool_fn is None else (lambda code, f=tool_fn: executed.append(code) or f(code))
        wf = mod.TIRWorkflow(reward_fn=reward_fn, gconfig=cli.GenerationHyperparameters(**gconfig),
                             tokenizer=tok, tool_fn=fn,
                             tools=None if tools is None else tools(mod), **kw)
        rows = asyncio.run(wf.arun_episode(eng, dict(data or dict(prompt="q"))))
        got[name] = (rows, eng.seen_prompts, executed)
    (jr, jp, je), (tr, tp, te) = got["jax"], got["torch"]
    assert sorted(tr) == sorted(jr) == sorted(ROW_KEYS)
    for k in ROW_KEYS:
        assert tr[k].dtype == np.asarray(jr[k]).dtype, k
        np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)
    assert tp == jp and te == je
    return tr, tp, te


def both_tool(name: str, *args, **kwargs):
    """`tir.<name>(*args, **kwargs)` in each package (a tool factory when
    it returns a `Tool`); the port's result after checking it equals JAX's."""
    out = {}
    for pkg, (mod, _, _) in PKGS.items():
        out[pkg] = getattr(mod, name)(*args, **kwargs)
    assert out["torch"] == out["jax"], out
    return out["torch"]


def test_run_python_tool_sandbox():
    assert both_tool("run_python_tool", "print(6*7)") == "42\n"
    out = both_tool("run_python_tool", "import time; time.sleep(60)", timeout_seconds=1.0)
    assert "TimeoutError" in out
    out = both_tool("run_python_tool", "print('x' * 10000)", max_output_chars=100)
    assert out.endswith("...(truncated)\n")
    assert "NameError" in both_tool("run_python_tool", "nope()")
    # isolated mode: the repository is not on sys.path, the cwd a fresh one
    out = both_tool("run_python_tool", "import os, sys\nprint(os.listdir('.'), sys.flags.isolated)")
    assert out == "[] 1\n"


def test_tool_output_budgeted_against_max_new_tokens():
    rows, _, _ = run_both([("x ```python\n", "stop"), ("print(1)\n```\n", "stop"),
                           ("done", "length")],
                          reward_fn=lambda p, c, pi, ci, **kw: 0.0,
                          gconfig=dict(n_samples=1, max_new_tokens=40),
                          tool_fn=lambda code: "x" * 500)
    assert int(np.asarray(rows["attention_mask"]).sum()) - len("q") <= 40


def test_tool_loop_executes_code_and_masks_output():
    rows, prompts, _ = run_both(
        [("I'll compute. ```python\n", "stop"), ("print(2+3)\n```\n", "stop"),
         ("So the answer is 5.", "length")],
        reward_fn=lambda p, c, pi, ci, **kw: 1.0 if "5" in c else 0.0,
        gconfig=dict(n_samples=1, max_new_tokens=256), data=dict(prompt="what is 2+3?"))
    assert float(rows["rewards"][0]) == 1.0
    assert "```output\n5\n```" in prompts[2]
    tok = _CharTok()
    ids, mask = rows["input_ids"][0], rows["loss_mask"][0]
    n = int(rows["attention_mask"].sum())
    text = tok.decode(ids[:n])
    out_start, out_end = text.index("```output"), text.index("So the answer")
    assert mask[out_start:out_end].sum() == 0 and mask[out_end:n].sum() > 0
    # tool tokens: logprob 0 and version -1
    assert (rows["logprobs"][0][out_start:out_end] == 0).all()
    assert (rows["versions"][0][out_start:out_end] == -1).all()
    assert rows["begin_of_answer"][0] == len("what is 2+3?")


def test_no_code_block_means_single_round():
    _, prompts, _ = run_both([("just an answer: 7", "stop")],
                             reward_fn=lambda p, c, pi, ci, **kw: 0.0,
                             gconfig=dict(n_samples=1, max_new_tokens=64))
    assert len(prompts) == 1


def test_tool_call_budget_bounds_rounds_and_executions():
    _, prompts, executed = run_both(
        [("```python\n", "stop"), ("print(1)\n```\n", "stop")] * 3 + [("done", "stop")],
        reward_fn=lambda p, c, pi, ci, **kw: 0.0,
        gconfig=dict(n_samples=1, max_new_tokens=2048), max_tool_calls=2,
        tool_fn=lambda code: "1\n")
    assert len(executed) == 2 and len(prompts) == 6


def test_bare_markdown_fence_does_not_end_episode():
    rows, _, executed = run_both(
        [("table:\n```\n1 2 3\n```\nanswer is 6", "length")],
        reward_fn=lambda p, c, pi, ci, **kw: 1.0 if "answer is 6" in c else 0.0,
        gconfig=dict(n_samples=1, max_new_tokens=256), tool_fn=lambda code: "x\n")
    assert not executed and float(rows["rewards"][0]) == 1.0


def test_bpe_boundary_overshoot_joins_code_correctly():
    _, _, executed = run_both(
        [("ok ```python\nimp", "stop"), ("ort math\nprint(7)\n```\nSo", "stop"),
         (" the answer is 7", "length")],
        reward_fn=lambda p, c, pi, ci, **kw: 0.0,
        gconfig=dict(n_samples=1, max_new_tokens=256), tool_fn=lambda code: "7\n")
    assert executed == ["import math\nprint(7)\n"]


CORPUS = ["The Eiffel Tower is in Paris France", "Mount Everest is the tallest mountain on Earth",
          "Paris is the capital of France"]


def test_calculator_and_search_tools_dispatch():
    _, prompts, _ = run_both(
        [("let me compute <calculator>", "stop"), ("(3 + 4) * 2</calculator>", "stop"),
         ("now look up <search>", "stop"), ("eiffel tower paris</search>", "stop"),
         ("answer: 14, Paris", "length")],
        reward_fn=lambda p, c, pi, ci, **kw: 0.0,
        gconfig=dict(n_samples=1, max_new_tokens=512),
        tools=lambda mod: [mod.calculator_tool(), mod.search_tool(CORPUS, top_k=2)])
    assert "14" in prompts[2] and "Eiffel Tower" in prompts[4]


def test_search_tool_ranking_and_misses():
    corpus = ["alpha beta gamma", "alpha only here", "unrelated text"]
    outs = {pkg: (mod.search_tool(corpus, top_k=2).fn("alpha beta"),
                  mod.search_tool(corpus, top_k=2).fn("zzz qqq"))
            for pkg, (mod, _, _) in PKGS.items()}
    assert outs["torch"] == outs["jax"]
    out, miss = outs["torch"]
    assert out.startswith("[1] alpha beta gamma") and "[2] alpha only here" in out
    assert "unrelated" not in out and miss == "no results\n"


@pytest.mark.parametrize("expr,want", [(" (3 + 4) * 2 ", "14\n"), ("1234567*2", "2469134\n"),
                                       ("3.5*2", "7\n"), ("1/3", None),
                                       ("123456789123456789+1", "123456789123456790\n"),
                                       ("__import__('os')", "error: invalid expression\n")],
                         ids=["paren", "int", "integral-float", "float", "big-int", "unsafe"])
def test_calculator_tool(expr, want):
    outs = {pkg: mod.calculator_tool().fn(expr) for pkg, (mod, _, _) in PKGS.items()}
    assert outs["torch"] == outs["jax"]
    if want is not None:
        assert outs["torch"] == want
    tool = ttir.calculator_tool()
    assert (tool.name, tool.start_marker, tool.end_marker) == (
        "calculator", "<calculator>", "</calculator>")


def test_task_stop_inside_tool_block_ends_episode():
    _, prompts, executed = run_both(
        [("```python\n", "stop"), ('s = "``` fake" ' + "x" * 60 + "</answer>", "stop")],
        reward_fn=lambda p, c, pi, ci, **kw: 0.0,
        gconfig=dict(n_samples=1, max_new_tokens=512, stop=["</answer>"]),
        tool_fn=lambda code: "never\n")
    assert not executed and len(prompts) == 2


def test_python_tool_reaps_grandchildren():
    for mod, _, _ in PKGS.values():
        t0 = time.monotonic()
        out = mod.run_python_tool("import subprocess\nsubprocess.Popen(['sleep', '100'])\n"
                                  "print('spawned')\n", timeout_seconds=3.0)
        assert time.monotonic() - t0 < 10.0
        assert "spawned" in out or "TimeoutError" in out


def test_python_tool_defaults():
    for mod, _, _ in PKGS.values():
        t = mod.python_tool()
        assert (t.name, t.start_marker, t.end_marker, t.output_template) == (
            "python", "```python\n", "```\n", "```output\n{out}```\n")


def test_group_and_dump_dir(tmp_path):
    """Two samples of one prompt (the GRPO group) with a dump: equal rows
    and equal dump records, under the newest version."""
    outputs = [("```python\n", "stop"), ("print(1)\n```\n", "stop"), ("one", "length")] * 2
    dumps = {}
    for name, (mod, cli, response) in PKGS.items():
        tok = _CharTok()
        wf = mod.TIRWorkflow(reward_fn=lambda p, c, pi, ci, **kw: float("1" in c),
                             gconfig=cli.GenerationHyperparameters(n_samples=2,
                                                                   max_new_tokens=64),
                             tokenizer=tok, tool_fn=lambda code: "1\n",
                             dump_dir=str(tmp_path / name))
        eng = _ScriptedEngine(tok, outputs, response)

        async def go():
            # one sample at a time, so both packages pop the script alike
            a = await wf._one_sample(eng, dict(prompt="q"), tok.encode("q"))
            b = await wf._one_sample(eng, dict(prompt="q"), tok.encode("q"))
            return a, b

        rows = asyncio.run(go())
        for r in rows:
            assert float(r["rewards"]) == 1.0 and (r["versions"] == -1).sum() > 1
        dumps[name] = rows
        eng2 = _ScriptedEngine(tok, outputs, response)
        asyncio.run(wf.arun_episode(eng2, dict(prompt="q")))
    for a, b in zip(dumps["jax"], dumps["torch"]):
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    files = {}
    for name in PKGS:
        (d,) = (tmp_path / name).iterdir()
        (f,) = d.iterdir()
        files[name] = (d.name, [json.loads(x) for x in f.read_text().splitlines()])
    assert files["torch"] == files["jax"] and files["torch"][0] == "0"
    assert len(files["torch"][1]) == 2


# ---------------------------------------------------------------------------
# the real engines
# ---------------------------------------------------------------------------

KW = dict(SMOKE_MODEL_DICT, dtype="float32", param_dtype="float32")
DECODE = dict(context_length=256, max_running_requests=16, new_tokens_per_chunk=16,
              dtype="float32", kv_cache_dtype="float32")
ROLLOUT = dict(max_concurrent_rollouts=8, consumer_batch_size=8, max_head_offpolicyness=0)
# markers of arithmetic characters that these weights' greedy streams write
PY_MARKERS = ("?", "=")
CALC_MARKERS = ("-", " ")


def _arith_tools(mod):
    return [mod.Tool(name="python", start_marker=PY_MARKERS[0], end_marker=PY_MARKERS[1],
                     fn=lambda code: mod.run_python_tool(code, 8.0)),
            mod.Tool(name="calculator", start_marker=CALC_MARKERS[0],
                     end_marker=CALC_MARKERS[1], fn=mod.calculator_tool().fn)]


def _counts(eng):
    return dict(prefills=eng._n_prefills, forks=eng._n_prefix_forks,
                suffix_prefills=eng._n_suffix_prefills)


def _sorted_rows(batch):
    rows = []
    for i in range(batch["input_ids"].shape[0]):
        n = int(batch["attention_mask"][i].sum())
        rows.append((batch["input_ids"][i, :n].tolist(), batch["loss_mask"][i, :n].tolist(),
                     batch["versions"][i, :n].tolist(), float(batch["rewards"][i]),
                     int(batch["begin_of_answer"][i]), batch["logprobs"][i, :n]))
    return sorted(rows, key=lambda r: r[0])


def test_greedy_engines_run_both_tools_alike():
    jparams = jq.init_params(jq.ModelConfig(**KW), jax.random.PRNGKey(3))
    tcfg = tq.ModelConfig(**KW)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    items = t_dataset("synthetic-arith", split="train", n_items=8)
    assert items == j_dataset("synthetic-arith", split="train", n_items=8)
    gconf = dict(n_samples=2, max_new_tokens=64, greedy=True)
    out, counts, calls = {}, {}, {}
    for name in ("jax", "torch"):
        mod, cli, _ = PKGS[name]
        called = []
        tools = _arith_tools(mod)
        for t in tools:
            t.fn = (lambda f, n: lambda x: called.append(n) or f(x))(t.fn, t.name)
        if name == "jax":
            eng = JaxDecodeEngine(j_cli.JaxDecodeConfig(**DECODE),
                                  j_cli.InferenceEngineConfig(**ROLLOUT), tokenizer=JTok())
            eng.set_model(jparams, jq.ModelConfig(**KW))
            tok = JTok()
        else:
            eng = TorchDecodeEngine(t_cli.TorchDecodeConfig(**DECODE),
                                    t_cli.InferenceEngineConfig(**ROLLOUT), tokenizer=TTok(),
                                    device="cpu")
            eng.set_model(tparams, tcfg)
            tok = TTok()
        eng.initialize()
        try:
            wf = mod.TIRWorkflow(lambda p, c, pi, ci, **kw: float(len(c) % 2),
                                 cli.GenerationHyperparameters(**gconf), tok, max_tool_calls=4,
                                 tools=tools)
            # each sample is a trajectory; see Rounds
            Rounds(eng, wf, "_one_sample", len(items) * gconf["n_samples"])
            out[name] = eng.rollout_batch([dict(x) for x in items], workflow=wf)
            counts[name] = _counts(eng)
        finally:
            eng.destroy()
        calls[name] = sorted(called)
    rj, rt = _sorted_rows(out["jax"]), _sorted_rows(out["torch"])
    assert len(rt) == 16
    for a, b in zip(rj, rt):
        assert a[:5] == b[:5]
        np.testing.assert_allclose(b[5], a[5], atol=LOGP_ATOL, rtol=0)
    assert calls["torch"] == calls["jax"]
    assert {"python", "calculator"} <= set(calls["torch"])
    # tool tokens: loss mask 0, logprob 0, version -1 past the prompt
    n_tool = 0
    for ids, mask, ver, _, boa, lp in rt:
        tool = [i for i in range(boa, len(ids)) if mask[i] == 0]
        assert all(ver[i] == -1 and lp[i] == 0.0 for i in tool)
        assert all(ver[i] == 0 for i in range(boa, len(ids)) if mask[i] == 1)
        n_tool += len(tool)
    assert n_tool > 0
    assert counts["torch"] == counts["jax"], counts
    assert counts["torch"]["suffix_prefills"] + counts["torch"]["forks"] > 0, counts


# ---------------------------------------------------------------------------
# the slice as a whole: tir_math on tir_math.yaml, offline
# ---------------------------------------------------------------------------

# tests/test_examples_smoke.py's offline overrides of the yaml
OFFLINE_RL_OVERRIDES = [
    "total_train_steps=2", "total_train_epochs=1", "tokenizer_path=synthetic-arith",
    "allocation_mode=", "train_dataset.batch_size=4", "valid_dataset.path=synthetic-arith",
    "valid_dataset.batch_size=8", "gconfig.n_samples=4", "gconfig.max_new_tokens=8",
    "rollout.max_concurrent_rollouts=32", "rollout.consumer_batch_size=16",
    "decode.model_path=", "decode.context_length=64", "decode.max_running_requests=16",
    "decode.new_tokens_per_chunk=8", "decode.dtype=float32", "decode.kv_cache_dtype=float32",
    "actor.path=", "actor.init_from_scratch=true", "actor.dtype=float32",
    "actor.gradient_checkpointing=false", "actor.group_size=4", "actor.ppo_n_minibatches=2",
    "actor.mb_spec.max_tokens_per_mb=512", "actor.optimizer.lr=3.0e-3",
    "actor.adv_norm.group_size=4", "saver.freq_steps=null", "evaluator.freq_steps=null",
    "recover.mode=disabled",
]
# the offline data (as the JAX test adds it), and the same episodes in both
# loops: synchronous rollouts of greedy samples
SAME_EPISODES = ["train_dataset.path=synthetic-arith", "async_training=false",
                 "gconfig.greedy=true"]


def _record_updates(monkeypatch, actor_cls):
    seen = []
    update = actor_cls.ppo_update

    def ppo_update(self, batch, *a, **kw):
        seen.append({k: np.array(v) for k, v in batch.items()})
        out = update(self, batch, *a, **kw)
        seen[-1]["_loss"] = [float(s["grpo_actor/loss"]) for s in out] if isinstance(
            out, list) else None
        return out

    monkeypatch.setattr(actor_cls, "ppo_update", ppo_update)
    return seen


def test_tir_math_two_steps_equals_jax(tmp_path, monkeypatch, cpu_devices):
    from areal_tpu.engine.ppo.actor import JaxPPOActor
    from areal_tpu_torch.engine import torch_engine
    from areal_tpu_torch.engine.ppo.actor import TorchPPOActor
    from areal_tpu_torch.examples import tir_math

    # the port's trainer starts from the JAX trainer's initial weights
    def init_like_jax(mcfg, gen, device):
        jcfg = jq.ModelConfig(**{**SMOKE_MODEL_DICT, "dtype": mcfg.dtype,
                                 "param_dtype": mcfg.param_dtype})
        tree = jax.tree.map(np.asarray, jq.init_params(jcfg, jax.random.PRNGKey(1)))
        return {k: v.to(device) for k, v in params_from_numpy(tree, mcfg).items()}

    monkeypatch.setattr(torch_engine, "init_params", init_like_jax)
    seen = {"jax": _record_updates(monkeypatch, JaxPPOActor),
            "torch": _record_updates(monkeypatch, TorchPPOActor)}
    argv = ["--config", str(ROOT / "examples" / "configs" / "tir_math.yaml"),
            *OFFLINE_RL_OVERRIDES, *SAME_EPISODES]
    spec = importlib.util.spec_from_file_location("j_tir_math", ROOT / "examples" / "tir_math.py")
    j_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_example)
    j_example.main(argv + [f"cluster.fileroot={tmp_path}/jax", "experiment_name=tir-jax"])
    history = tir_math.main(argv + [f"cluster.fileroot={tmp_path}/torch",
                                    "experiment_name=tir-torch"], device="cpu")
    assert len(history) == 2 and len(seen["torch"]) == len(seen["jax"]) == 2
    for step, (j, t) in enumerate(zip(seen["jax"], seen["torch"])):
        assert t["input_ids"].shape[0] == 16  # 4 prompts x 4 samples
        rj, rt = _sorted_rows(j), _sorted_rows(t)
        for a, b in zip(rj, rt):
            assert a[:5] == b[:5], step
            np.testing.assert_allclose(b[5], a[5], atol=LOGP_ATOL, rtol=0)
        np.testing.assert_allclose(t["_loss"], j["_loss"], atol=1e-5, rtol=0)
        assert all(np.isfinite(t["_loss"]))
        st = history[step]["stats"][0]
        assert st["grpo_actor/loss"] == pytest.approx(t["_loss"][0])
    # the arithmetic tokenizer cannot spell ```python: no tool call, no tool
    # token (loss mask 0 after the answer begins)
    for t in seen["torch"]:
        for i in range(t["input_ids"].shape[0]):
            n, boa = int(t["attention_mask"][i].sum()), int(t["begin_of_answer"][i])
            mask = np.roll(t["loss_mask"][i], 1)  # compute_advantages rolled it by -1
            assert (t["versions"][i, boa:n] >= 0).all() and mask[boa:n].all()
