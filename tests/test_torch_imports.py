"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
nor the packages the card machine lacks (`aiohttp`, `lark`, `transformers`).

A subprocess whose import system refuses `jax`, `jaxlib`, the top-level
`areal_tpu` package (exactly that name: `areal_tpu_torch` is the port),
`aiohttp`, `lark` and `transformers` imports every module of the port and
`chip_smoke`; an AST scan of the same files finds no such import
anywhere, lazy ones included.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "areal_tpu_torch"
BLOCKED = ("jax", "jaxlib", "areal_tpu", "aiohttp", "lark", "transformers")


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
        "areal_tpu_torch.engine.ppo.critic",
        "areal_tpu_torch.engine.rw",
        "areal_tpu_torch.engine.rw.rw_engine",
        "areal_tpu_torch.workflow.multi_turn",
        "areal_tpu_torch.examples.gsm8k_ppo",
        "areal_tpu_torch.examples.hhrlhf_rw",
        "areal_tpu_torch.examples.multi_turn_math",
        "chip_smoke",
    ):
        assert want in names


def test_every_module_imports_with_jax_blocked():
    modules = [_module_name(p) for p in _port_files()]
    code = f"""
import importlib, importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Block())
for m in {modules!r}:
    importlib.import_module(m)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {BLOCKED!r})
assert not leaked, leaked
print("ok", len({modules!r}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, f"{path}: imports {name}"
