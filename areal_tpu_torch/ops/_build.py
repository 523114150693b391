"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under `ops/csrc/` has a plain C interface and includes no
PyTorch header, so nvcc compiles it in seconds. The shared library goes
into `build/areal_tpu_torch/` at the repository root, named by a hash of
the source and the flags: a changed source builds anew, an unchanged one
loads what the first use built. Building happens at first use, never at
import, and only on a machine with the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "areal_tpu_torch"
SOURCES = {
    "paged_attention": CSRC / "paged_attention.cu",
    "flash_attention": CSRC / "flash_attention.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills per kernel, kept in the log
    "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


@dataclass
class Built:
    name: str
    path: Path
    log: str  # nvcc's output, including the -Xptxas -v report
    seconds: float  # 0.0 when the library was already built
    cached: bool


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or the
    one on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        Path(home) / "bin" / "nvcc" if home else None,
        Path("/usr/local/cuda/bin/nvcc"),
    ):
        if cand is not None and cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the port's kernels are built "
            "from source on the machine with the card"
        )
    return found


def _target(name: str) -> Path:
    src = SOURCES[name].read_bytes()
    digest = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, Built]:
    """Build every named source (all by default) that is not built yet,
    one nvcc per source, all started together. Raises on a failed build,
    with nvcc's output."""
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, Built] = {}
    running = {}
    for name in names:
        target = _target(name)
        log = target.with_suffix(".log")
        if target.exists():
            out[name] = Built(
                name, target, log.read_text() if log.exists() else "", 0.0, True
            )
            continue
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, target, log, time.perf_counter())
    for name, (proc, tmp, target, log, t0) in running.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for {SOURCES[name]} (exit {proc.returncode}):\n"
                f"{text}"
            )
        log.write_text(text)
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or none
        out[name] = Built(name, target, text, seconds, False)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `name`, built first if needed (once per
    process)."""
    lib = _loaded.get(name)
    if lib is None:
        built = build_all([name])[name]
        lib = ctypes.CDLL(str(built.path))
        _loaded[name] = lib
    return lib
