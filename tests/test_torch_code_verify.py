"""The port's code graders against the JAX package's, on the CPU.

- Every case of `tests/test_code_verify.py` and `tests/test_code_eval.py`
  run through both packages (`reward/code_verify.py` over
  `reward/_code_runner.py`): the stdio, function and assert styles, a
  crash, a timeout, mismatched I/O, the memory limit, batched
  `code_verify` in order, `extract_code`, `code_reward_fn` and
  `code_eval_reward_fn`; verdicts equal exactly, and equal to the
  expected ones.
- The HumanEval and MBPP loaders on local `.jsonl` fixtures: equal items;
  a name or a hub id goes to `datasets.load_dataset` with the canonical
  hub id (recorded, never fetched).
- `evaluate_offline` with `code_eval_reward_fn` on a scripted engine:
  equal pass@k.
- `eval_and_aggregate --task code` of both packages on an HF checkpoint
  of the same smoke weights and a HumanEval fixture: equal `metrics.json`
  and `samples.jsonl`.
- The runner imports nothing but the standard library (no `torch`).
"""

import functools
import json
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from areal_tpu.api import cli_args as jargs
from areal_tpu.dataset import _REGISTRY as J_REGISTRY
from areal_tpu.evaluation import eval_and_aggregate as jea
from areal_tpu.evaluation import offline as jo
from areal_tpu.models import qwen2 as jq
from areal_tpu.reward import code_verify as jcv
from areal_tpu_torch.api import cli_args as targs
from areal_tpu_torch.dataset import _REGISTRY as T_REGISTRY
from areal_tpu_torch.evaluation import eval_and_aggregate as tea
from areal_tpu_torch.evaluation import offline as to
from areal_tpu_torch.models import hf_io
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy
from areal_tpu_torch.models.smoke import SMOKE_MODEL_DICT
from areal_tpu_torch.reward import code_verify as tcv
from tests.test_code_eval import FIXTURE, CodeTokenizer
from tests.test_workflows import ScriptedEngine

ADD_STDIO = "a, b = map(int, input().split())\nprint(a + b)\n"
ADD_FN = "def add(a, b):\n    return a + b\n"
PKGS = {"jax": jcv, "torch": tcv}


def both(name: str, *args, **kwargs):
    """`name(*args, **kwargs)` in each package; the port's result, after
    checking it equals JAX's."""
    j = getattr(jcv, name)(*args, **kwargs)
    t = getattr(tcv, name)(*args, **kwargs)
    assert t == j and type(t) is type(j), (name, t, j)
    return t


@pytest.mark.parametrize("code,io_spec,want", [
    (ADD_STDIO, {"inputs": ["1 2", "10 20"], "outputs": ["3", "30"]}, True),
    (ADD_STDIO, {"inputs": ["1 2"], "outputs": ["4"]}, False),
    (ADD_FN, {"fn_name": "add", "inputs": [[1, 2], [5, 7]], "outputs": [3, 12]}, True),
    ("def add(a, b):\n    return a - b\n",
     {"fn_name": "add", "inputs": [[1, 2], [5, 7]], "outputs": [3, 12]}, False),
    ("class Solution:\n    def add(self, a, b):\n        return a + b\n",
     {"fn_name": "add", "inputs": [[2, 2]], "outputs": [4]}, True),
    ("raise RuntimeError('boom')", {"inputs": ["1 2"], "outputs": ["3"]}, False),
    ("syntax error here ((", {"inputs": ["1 2"], "outputs": ["3"]}, False),
    ("def f(x):\n    return x + 1\n", {"asserts": ["assert f(1) == 2", "assert f(0) == 1"]}, True),
    ("def f(x):\n    return x\n", {"asserts": ["assert f(1) == 2"]}, False),
    ("x = 1\n", {"asserts": ["undefined_name"]}, False),
    ("print(1)\n", {"inputs": [], "outputs": []}, False),  # nothing to verify
], ids=["stdio", "stdio-wrong", "function", "function-wrong", "solution-class", "crash",
        "syntax", "assert", "assert-wrong", "assert-raises", "no-cases"])
def test_run_problem_verdicts(code, io_spec, want):
    assert both("run_problem", code, io_spec) is want


def test_infinite_loop_times_out_quickly():
    io_spec = {"inputs": ["1 2"], "outputs": ["3"]}
    for mod in PKGS.values():
        t0 = time.monotonic()
        ok = mod.run_problem("while True:\n    pass\n", io_spec, timeout_per_case=1.0,
                             total_timeout=10.0)
        assert ok is False and time.monotonic() - t0 < 10.0


def test_total_timeout_kills_the_group():
    """A testcase that sleeps past the whole call's timeout: the process
    group is killed and the verdict is False in both."""
    code = "import time\ntime.sleep(30)\n"
    for mod in PKGS.values():
        t0 = time.monotonic()
        assert mod.run_problem(code, {"inputs": ["1"], "outputs": ["1"]},
                               timeout_per_case=20.0, total_timeout=1.0) is False
        assert time.monotonic() - t0 < 10.0


def test_mismatched_io_raises_and_code_verify_scores_zero():
    bad = {"inputs": ["1", "2"], "outputs": ["1"]}
    for mod in PKGS.values():
        with pytest.raises(ValueError, match="mismatch"):
            mod.run_problem("print(1)", bad)
    assert both("code_verify", {"q": {"input_output": bad}}, ["print(1)"], ["q"]) == [0]


def test_memory_limit():
    """`memory` (MiB) caps the runner's address space: a 2 GiB list fails
    under a 1 GiB cap and passes without one."""
    code = "x = bytearray(2 * 1024 ** 3)\nprint(len(x) > 0)\n"
    io_spec = {"inputs": [""], "outputs": ["True"]}
    assert both("run_problem", code, io_spec, memory_mb=1024) is False
    assert both("run_problem", code, io_spec, memory_mb=0) is True


def test_batched_code_verify_reference_shapes():
    id2info = {
        "q0": {"input_output": json.dumps({"inputs": ["1 2"], "outputs": ["3"]})},
        "q1": {"input_output": json.dumps({"fn_name": "add", "inputs": [[2, 2]],
                                           "outputs": [4]}), "timeout": 2},
        "q2": {"input_output": json.dumps({"inputs": ["1 2"], "outputs": ["999"]})},
        "q3": {"input_output": {"asserts": ["assert add(2, 3) == 5"]}, "timeout": 1000},
    }
    gens = [ADD_STDIO, ADD_FN, ADD_STDIO, ADD_FN, None]
    qids = ["q0", "q1", "q2", "q3", "q0"]
    assert both("code_verify", id2info, gens, qids, max_workers=3) == [1, 1, 0, 1, 0]


@pytest.mark.parametrize("text,want", [
    ("thinking...\n```python\nx = 1\n```\nmore\n```py\nprint('final')\n```", "print('final')"),
    ("```\nplain fence\n```", "plain fence"),
    ("no code at all", None),
    ("", None),
])
def test_extract_code_last_block(text, want):
    assert both("extract_code", text) == want


def test_code_reward_fn_rlvr_signature():
    completion = f"The answer:\n```python\n{ADD_STDIO}```"
    io_spec = {"inputs": ["3 4"], "outputs": ["7"]}
    assert both("code_reward_fn", "p", completion, [], [], input_output=io_spec) == 1.0
    assert both("code_reward_fn", "p", completion, [], [],
                input_output=json.dumps({"inputs": ["3 4"], "outputs": ["8"]})) == 0.0
    assert both("code_reward_fn", "p", "no code", [], [], input_output={}) == 0.0
    assert both("code_reward_fn", "p", completion, [], []) == 0.0


def test_code_eval_reward_continuation_and_block():
    item = {"code_prompt": FIXTURE[0]["prompt"],
            "input_output": {"asserts": [FIXTURE[0]["test"] + "\ncheck(add)\n"]}}
    assert both("code_eval_reward_fn", None, "    return a + b\n", [], [], **item) == 1.0
    assert both("code_eval_reward_fn", None,
                "Here you go:\n```python\ndef add(a, b):\n    return a + b\n```", [], [],
                **item) == 1.0
    assert both("code_eval_reward_fn", None, "    return a - b\n", [], [], **item) == 0.0
    assert both("code_eval_reward_fn", None, "x", [], []) == 0.0
    # --task code's reward: the same fence-less continuation scores 0
    assert both("code_reward_fn", None, "    return a + b\n", [], [], **item) == 0.0


def test_runner_imports_only_the_standard_library():
    spec = {"code": ADD_STDIO, "testcases": [{"input": "1 2", "expectedOutput": "3"}]}
    probe = ("import runpy, sys; sys.argv = ['x']\n"
             "try:\n    runpy.run_module('areal_tpu_torch.reward._code_runner', "
             "run_name='__main__')\n"
             "finally:\n    print(sorted(m for m in ('torch', 'numpy', 'jax') "
             "if m in sys.modules), file=sys.stderr)\n")
    out = subprocess.run([sys.executable, "-c", probe], input=json.dumps(spec),
                         capture_output=True, text=True, timeout=60)
    assert json.loads(out.stdout) == {"results": [True], "error": None}
    assert out.stderr.strip().splitlines()[-1] == "[]"


# ---------------------------------------------------------------------------
# the HumanEval / MBPP loaders
# ---------------------------------------------------------------------------

MBPP_ROWS = [
    {"task_id": 1, "text": "Write a function add(a, b) returning a+b.",
     "code": "def add(a, b):\n    return a + b\n",
     "test_list": ["assert add(1, 2) == 3"], "test_setup_code": ""},
    {"task_id": 2, "prompt": "Write sq(x).", "code": "def sq(x):\n    return x * x\n",
     "test_list": ["assert sq(3) == 9", "assert sq(T) == 16"], "test_setup_code": "T = 4"},
]


def _write(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


@pytest.mark.parametrize("name,rows", [("humaneval", FIXTURE), ("openai_humaneval", FIXTURE),
                                       ("mbpp", MBPP_ROWS)])
def test_loaders_on_local_fixtures(name, rows, tmp_path):
    path = _write(tmp_path / f"{name}_fixture.jsonl", rows)
    t = T_REGISTRY[name](path=path, split="test", type="rl", tokenizer=None)
    j = J_REGISTRY[name](path=path, split="test", type="rl", tokenizer=None)
    assert t == j and len(t) == len(rows)
    for item in t:
        assert set(item) >= {"messages", "input_output"}
        assert "```python" in item["messages"][0]["content"]
    if name == "mbpp":
        assert t[0]["input_output"]["asserts"] == ["assert add(1, 2) == 3"]
        assert t[1]["input_output"]["asserts"][1] == "T = 4\nassert sq(T) == 16"
    else:
        assert t[0]["code_prompt"].startswith("def add")
        assert "check(add)" in t[0]["input_output"]["asserts"][0]
        # the canonical solution passes its own harness in both packages
        assert both("code_eval_reward_fn", None, "    return a + b\n", [], [],
                    code_prompt=t[0]["code_prompt"], input_output=t[0]["input_output"]) == 1.0


@pytest.mark.parametrize("path,hub", [
    ("humaneval", "openai/openai_humaneval"), ("openai_humaneval", "openai/openai_humaneval"),
    ("mbpp", "google-research-datasets/mbpp"), ("some-org/mbpp", "some-org/mbpp"),
])
def test_get_custom_dataset_sends_a_name_to_its_hub_id(path, hub, monkeypatch):
    """A path that is no local file goes to `datasets.load_dataset` (which
    would fail offline): recorded here instead of fetched, the same call
    from both packages."""
    hf_datasets = pytest.importorskip("datasets")
    from areal_tpu.dataset import get_custom_dataset as j_dataset
    from areal_tpu_torch.dataset import get_custom_dataset as t_dataset

    rows = FIXTURE if "humaneval" in hub else MBPP_ROWS
    calls = []

    def load_dataset(p, *a, split=None, **kw):
        calls.append((p, split))
        return rows

    monkeypatch.setattr(hf_datasets, "load_dataset", load_dataset)
    t = t_dataset(path=path, split="test")
    j = j_dataset(path=path, split="test")
    assert t == j and calls == [(hub, "test")] * 2


def test_evaluate_offline_code_pass_at_k(tmp_path):
    path = _write(tmp_path / "humaneval_fixture.jsonl", FIXTURE)
    items = T_REGISTRY["humaneval"](path=path, split="test", type="rl", tokenizer=None)
    res = {}
    for name, mod, cli in (("jax", jo, jargs), ("torch", to, targs)):
        res[name] = mod.evaluate_offline(
            ScriptedEngine([[1], [2], [2], [2], [2], [2]]), items,
            reward_fn=PKGS[name].code_eval_reward_fn,
            gconfig=cli.GenerationHyperparameters(max_new_tokens=8), tokenizer=CodeTokenizer(),
            n_samples=2, ks=(1, 2), max_concurrency=1)
    assert res["torch"].to_dict() == res["jax"].to_dict()
    assert abs(res["torch"].pass_at_1 - 0.5 / 3) < 1e-9
    assert abs(res["torch"].pass_at_k[2] - 1.0 / 3) < 1e-9


# ---------------------------------------------------------------------------
# eval_and_aggregate --task code
# ---------------------------------------------------------------------------

KW = dict(SMOKE_MODEL_DICT, dtype="float32", param_dtype="float32")


def test_eval_and_aggregate_task_code_equals_jax(tmp_path, monkeypatch, cpu_devices):
    jcfg, tcfg = jq.ModelConfig(**KW), tq.ModelConfig(**KW)
    jparams = jq.init_params(jcfg, jax.random.PRNGKey(5))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    ckpt = tmp_path / "ckpt"
    hf_io.save_hf_params(tparams, tcfg, str(ckpt))
    (ckpt / "config.json").write_text(json.dumps(dict(
        model_type="qwen2", architectures=["Qwen2ForCausalLM"], **SMOKE_MODEL_DICT,
        rope_theta=tcfg.rope_theta, rms_norm_eps=tcfg.rms_norm_eps,
        max_position_embeddings=tcfg.max_position_embeddings, tie_word_embeddings=False,
        torch_dtype="float32")))
    # a local file named after its loader loads directly; the name is
    # relative, since each dataset's output directory joins it to
    # --output-path
    monkeypatch.chdir(tmp_path)
    (tmp_path / "data").mkdir()
    _write(tmp_path / "data" / "humaneval", FIXTURE)
    f32 = dict(dtype="float32", kv_cache_dtype="float32")
    monkeypatch.setattr(jargs, "JaxDecodeConfig", functools.partial(jargs.JaxDecodeConfig, **f32))
    monkeypatch.setattr(targs, "TorchDecodeConfig",
                        functools.partial(targs.TorchDecodeConfig, **f32))
    argv = ["--task", "code", "--data-names", "data/humaneval", "--model-path", str(ckpt),
            "--tokenizer-path", "synthetic-arith", "--n-sampling", "2", "--max-gen-tokens", "8",
            "--temperature", "1.0"]
    jea.main(argv + ["--output-path", str(tmp_path / "jax")])
    tea.main(argv + ["--output-path", str(tmp_path / "torch")], device="cpu")
    out = {k: tmp_path / k / "data" / "humaneval" for k in ("jax", "torch")}
    got = json.loads((out["torch"] / "metrics.json").read_text())
    want = json.loads((out["jax"] / "metrics.json").read_text())
    assert got == want and got["n_problems"] == 3 and got["n_samples"] == 2
    # the arithmetic tokenizer writes no code fence: every sample scores 0
    assert got["mean_reward"] == 0.0
    samples = (out["torch"] / "samples.jsonl").read_text()
    assert samples == (out["jax"] / "samples.jsonl").read_text()
    assert len(samples.splitlines()) == 3  # one record per problem
    assert tea._reward_for("code") is tcv.code_reward_fn
