"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
nor, at import time, the packages the card machine lacks (`aiohttp`,
`lark`, `transformers`, `datasets`). The verification client and server
run on the standard library's HTTP modules, never `aiohttp`.

A subprocess whose import system refuses `jax`, `jaxlib`, the top-level
`areal_tpu` package (exactly that name: `areal_tpu_torch` is the port),
`aiohttp`, `lark`, `transformers` and `datasets` imports every module of
the port and `chip_smoke`, and runs the offline paths `chip_smoke.py`
takes (the arithmetic tokenizer, the countdown and synthetic-arith
datasets and rewards, the math grader, the code grader, the verification
service and its client, and the TIR tools). An AST scan of the same files
finds no import of the first five anywhere, lazy ones included, and
imports `transformers` and `datasets` only inside functions: the
loaders of HF tokenizers and hub datasets (`dataset/__init__.py`) and
the decode server's tokenizer load.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "areal_tpu_torch"
NEVER = ("jax", "jaxlib", "areal_tpu", "aiohttp", "lark")
LAZY_ONLY = ("transformers", "datasets")
BLOCKED = NEVER + LAZY_ONLY


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_name(path: Path) -> str:
    rel = path.relative_to(ROOT).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def test_port_has_the_expected_modules():
    names = {_module_name(p) for p in _port_files()}
    for want in (
        "areal_tpu_torch.platforms",
        "areal_tpu_torch.ops.paged_attention",
        "areal_tpu_torch.models.qwen2",
        "areal_tpu_torch.engine.torch_decode",
        "areal_tpu_torch.ops.flash_attention",
        "areal_tpu_torch.ops.fused_xent",
        "areal_tpu_torch.ops.gae",
        "areal_tpu_torch.utils.data",
        "areal_tpu_torch.utils.datapack",
        "areal_tpu_torch.utils.functional",
        "areal_tpu_torch.utils.flops",
        "areal_tpu_torch.utils.stats_tracker",
        "areal_tpu_torch.engine.torch_engine",
        "areal_tpu_torch.engine.ppo.actor",
        "areal_tpu_torch.ops.quant",
        "areal_tpu_torch.ops.kv_quant",
        "areal_tpu_torch.ops.quant_matmul",
        "areal_tpu_torch.ops.threefry",
        "areal_tpu_torch.engine.sampling",
        "areal_tpu_torch.utils.structured",
        "areal_tpu_torch.utils.seeding",
        "areal_tpu_torch.utils.timeutil",
        "areal_tpu_torch.core.fault_injection",
        "areal_tpu_torch.utils.perf_tracer",
        "areal_tpu_torch.utils.hbm",
        "areal_tpu_torch.utils.evaluator",
        "areal_tpu_torch.utils.saver",
        "areal_tpu_torch.utils.stats_logger",
        "areal_tpu_torch.utils.recover",
        "areal_tpu_torch.core.async_task_runner",
        "areal_tpu_torch.core.staleness_manager",
        "areal_tpu_torch.core.sample_ledger",
        "areal_tpu_torch.core.workflow_executor",
        "areal_tpu_torch.api.workflow_api",
        "areal_tpu_torch.api.reward_api",
        "areal_tpu_torch.workflow.rlvr",
        "areal_tpu_torch.dataset",
        "areal_tpu_torch.dataset.arith",
        "areal_tpu_torch.examples.gsm8k_grpo",
        "areal_tpu_torch.models.hf_io",
        "areal_tpu_torch.engine.sft.lm_engine",
        "areal_tpu_torch.examples.gsm8k_sft",
        "areal_tpu_torch.utils.network",
        "areal_tpu_torch.utils.names",
        "areal_tpu_torch.utils.name_resolve",
        "areal_tpu_torch.utils.experiment",
        "areal_tpu_torch.utils.http",
        "areal_tpu_torch.core.weight_transfer",
        "areal_tpu_torch.core.remote_inf_engine",
        "areal_tpu_torch.api.alloc_mode",
        "areal_tpu_torch.launcher.base",
        "areal_tpu_torch.launcher.local",
        "areal_tpu_torch.launcher.decode_server",
        "areal_tpu_torch.launcher.router",
        "areal_tpu_torch.launcher.supervisor",
        "areal_tpu_torch.core.kv_fabric",
        "areal_tpu_torch.engine.ppo.critic",
        "areal_tpu_torch.engine.rw",
        "areal_tpu_torch.engine.rw.rw_engine",
        "areal_tpu_torch.workflow.multi_turn",
        "areal_tpu_torch.examples.gsm8k_ppo",
        "areal_tpu_torch.examples.hhrlhf_rw",
        "areal_tpu_torch.examples.multi_turn_math",
        "areal_tpu_torch.reward",
        "areal_tpu_torch.reward.math_parser",
        "areal_tpu_torch.reward.countdown",
        "areal_tpu_torch.utils.arith_eval",
        "areal_tpu_torch.evaluation",
        "areal_tpu_torch.evaluation.offline",
        "areal_tpu_torch.evaluation.eval_and_aggregate",
        "areal_tpu_torch.reward._code_runner",
        "areal_tpu_torch.reward.code_verify",
        "areal_tpu_torch.reward.remote_verify",
        "areal_tpu_torch.reward.verify_server",
        "areal_tpu_torch.workflow.tir",
        "areal_tpu_torch.examples.tir_math",
        "areal_tpu_torch.api.agent_api",
        "areal_tpu_torch.agent.math_single_step",
        "areal_tpu_torch.agent.math_code_env",
        "areal_tpu_torch.experimental.openai",
        "areal_tpu_torch.experimental.openai.types",
        "areal_tpu_torch.experimental.openai.client",
        "areal_tpu_torch.evaluation.auto",
        "areal_tpu_torch.models.qwen2_vl",
        "areal_tpu_torch.reward.vqa",
        "areal_tpu_torch.workflow.vision_rlvr",
        "areal_tpu_torch.examples.clevr_grpo",
        "chip_smoke",
    ):
        assert want in names


_BLOCKER = f"""
import importlib, importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Block())
"""


def _run_blocked(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-c", _BLOCKER + code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_every_module_imports_with_jax_blocked():
    modules = [_module_name(p) for p in _port_files()]
    out = _run_blocked(f"""
for m in {modules!r}:
    importlib.import_module(m)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r})
assert not leaked, leaked
print("ok", len({modules!r}))
""")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def test_offline_paths_run_without_transformers_and_datasets():
    """What `chip_smoke.py` runs on a machine with neither package: the
    offline tokenizer, the countdown, synthetic-arith and synthetic-vision
    datasets, their rewards and the math grader."""
    out = _run_blocked("""
from areal_tpu_torch.dataset import get_custom_dataset, load_tokenizer
from areal_tpu_torch.examples.gsm8k_grpo import pick_reward_fn
from areal_tpu_torch.reward.math_parser import math_equal

tok = load_tokenizer("synthetic-arith")
items = get_custom_dataset("countdown", split="train", n_items=4)
reward = pick_reward_fn("countdown")
x = items[0]
assert reward(None, "<answer>" + x["solution"] + "</answer>", [], [],
              target=x["target"], numbers=x["numbers"]) == 1.0
arith = get_custom_dataset("synthetic-arith", split="test", type="sft")
assert arith and tok.decode(arith[0]["input_ids"])
assert pick_reward_fn("synthetic-arith")(None, "", [], [], answer="1") == 0.0
vis = get_custom_dataset("synthetic-vision", split="test", n_items=2)
assert vis[0]["images"][0]["pixel_values"].shape == (16, 12)
assert pick_reward_fn("synthetic-vision")(None, None, [], [3, 2], answer="2") == 1.0
assert math_equal(r"\\frac{1}{2}", "0.5") and not math_equal("1/2", "0.6")
try:
    load_tokenizer("/models/some-tokenizer")
except ImportError as e:
    assert "transformers" in str(e)
else:
    raise AssertionError("an HF tokenizer loaded without transformers")
# the code graders, the verification service and its client, the tools
import os
from areal_tpu_torch.agent.math_code_env import MathCodeSingleStepEnv
from areal_tpu_torch.reward.code_verify import code_reward_fn
from areal_tpu_torch.reward.verify_server import VerifyServer
from areal_tpu_torch.workflow.tir import calculator_tool, run_python_tool

io = {"inputs": ["2 3"], "outputs": ["5"]}
good = "```python\\na, b = map(int, input().split())\\nprint(a + b)\\n```"
assert code_reward_fn(None, good, [], [], input_output=io) == 1.0
srv = VerifyServer(max_workers=2)
os.environ["AREAL_VERIFIER_SERVICE"] = srv.start("127.0.0.1", 0)
try:
    import asyncio
    env = MathCodeSingleStepEnv({"q": {"task": "code", "input_output": io}})
    assert asyncio.run(env.step(("q", [good, "no code"])))[1] == [1.0, 0.0]
finally:
    srv.stop()
assert run_python_tool("print(6*7)") == "42\\n" and calculator_tool().fn("6*7") == "42\\n"
leaked = sorted(m for m in sys.modules if m.split(".")[0] in %r)
assert not leaked, leaked
print("ok")
""" % (BLOCKED,))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def _imports(tree: ast.AST):
    """(import node, imported names, whether it sits inside a function)."""
    def walk(node, in_fn):
        for child in ast.iter_child_nodes(node):
            fn = in_fn or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if isinstance(child, ast.Import):
                yield child, [a.name for a in child.names], in_fn
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child, [child.module or ""], in_fn
            yield from walk(child, fn)

    yield from walk(tree, False)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node, names, in_fn in _imports(tree):
        for name in names:
            top = name.split(".")[0]
            assert top not in NEVER, f"{path}:{node.lineno}: imports {name}"
            assert top not in LAZY_ONLY or in_fn, (
                f"{path}:{node.lineno}: imports {name} outside a function")
