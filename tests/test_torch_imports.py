"""The PyTorch port stands alone: it imports neither JAX nor the JAX package.

A subprocess whose import system refuses `jax`, `jaxlib` and the top-level
`areal_tpu` package (exactly that name: `areal_tpu_torch` is the port)
imports every module of the port and `chip_smoke`; an AST scan of the same
files finds no such import anywhere, lazy ones included.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "areal_tpu_torch"
BLOCKED = ("jax", "jaxlib", "areal_tpu")


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
