"""The port's tracer (`areal_tpu_torch/utils/perf_tracer.py`) on the CPU.

- `tests/test_perf_tracer.py`'s six cases on the port: scopes, async
  pairs and instants round trip, a disabled tracer, rank merge, env
  initialisation, `xprof_trace` without a directory, and the env-gated
  `maybe_xprof_step` window (a `torch.profiler` Chrome trace here, an
  xplane in JAX).
- The catapult events of the same scope sequence equal the JAX tracer's
  in name, category, phase, pid and args.
- `xprof_trace` with a directory exports a Chrome trace holding an
  `annotate` range.
- The window's owner rule on a tiny `TorchTrainEngine` actor beside a
  critic: the first engine to reach the start step owns the window, the
  other's later steps neither end it nor leave it, and each
  `train_batch` inside it shows as one `train_batch` range.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from areal_tpu.utils import perf_tracer as j_pt
from areal_tpu_torch.api import cli_args as targs
from areal_tpu_torch.api.alloc_mode import ParallelStrategy
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.utils import perf_tracer
from areal_tpu_torch.utils.perf_tracer import PerfTracer


@pytest.fixture(autouse=True)
def _fresh_window():
    perf_tracer.reset_xprof_window()
    yield
    perf_tracer.reset_xprof_window()


def test_scopes_async_and_instant_round_trip(tmp_path):
    out = str(tmp_path / "t.json")
    tr = PerfTracer(rank=3, save_path=out)
    with tr.trace_scope("fwd", "compute", step=1):
        pass
    tr.atrace_begin("rollout", "r1")
    tr.atrace_end("rollout", "r1")
    tr.instant("weights_pushed", "comm", version=2)
    with tr.trace_scope("oddcat", "not-a-category"):
        pass
    assert tr.save() == out
    events = json.load(open(out))["traceEvents"]
    by_ph = {}
    for e in events:
        by_ph.setdefault(e["ph"], []).append(e)
    assert len(by_ph["X"]) == 2 and by_ph["X"][0]["name"] == "fwd"
    assert by_ph["X"][0]["args"] == {"step": 1}
    assert by_ph["X"][1]["cat"] == "misc"
    assert [e["ph"] for e in by_ph["b"] + by_ph["e"]] == ["b", "e"]
    assert by_ph["i"][0]["args"]["version"] == 2
    assert all(e["pid"] == 3 for e in events)


def test_disabled_tracer_is_free_and_saves_nothing(tmp_path):
    tr = PerfTracer(rank=0, save_path=str(tmp_path / "x.json"), enabled=False)
    with tr.trace_scope("a"):
        pass
    tr.instant("b")
    assert tr.save() is None
    assert not os.path.exists(tmp_path / "x.json")


def test_merge_ranks(tmp_path):
    files = []
    for r in (0, 1):
        tr = PerfTracer(rank=r, save_path=str(tmp_path / f"r{r}.json"))
        with tr.trace_scope(f"work{r}"):
            pass
        files.append(tr.save())
    merged = PerfTracer.merge(files + [str(tmp_path / "missing.json")], str(tmp_path / "m.json"))
    assert {e["pid"] for e in json.load(open(merged))["traceEvents"]} == {0, 1}


def test_init_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("AREAL_TPU_PERF_TRACE", "1")
    monkeypatch.setenv("AREAL_TPU_PERF_TRACE_DIR", str(tmp_path))
    tr = perf_tracer.init_from_env(rank=5)
    assert tr.enabled and tr.save_path.endswith("trace-rank5.json")
    monkeypatch.setenv("AREAL_TPU_PERF_TRACE", "0")
    assert not perf_tracer.init_from_env(rank=5).enabled


def test_xprof_trace_noop_without_dir(monkeypatch):
    monkeypatch.delenv("AREAL_TPU_XPROF_DIR", raising=False)
    with perf_tracer.xprof_trace() as t:
        assert t is None


def _trace_events(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_maybe_xprof_step_window(tmp_path, monkeypatch):
    """The window starts at the first configured step and ends once, after
    the last, with a Chrome trace of the steps inside it."""
    monkeypatch.setenv("AREAL_TPU_XPROF_DIR", str(tmp_path))
    monkeypatch.setenv("AREAL_TPU_XPROF_STEPS", "1-2")
    x = torch.ones(8)
    for step in range(5):
        perf_tracer.maybe_xprof_step(step, device="cpu")
        with perf_tracer.annotate(f"step{step}"):
            x = x + 1
    assert perf_tracer._xprof_state["done"] and not perf_tracer._xprof_state["active"]
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    names = {e.get("name") for e in _trace_events(path)}
    assert {"step1", "step2"} <= names and not names & {"step0", "step3", "step4"}


def test_xprof_trace_exports_annotated_ranges(tmp_path):
    with perf_tracer.xprof_trace(str(tmp_path), device="cpu") as target:
        with perf_tracer.annotate("outer"):
            torch.ones(4).sum()
    assert target == str(tmp_path)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert any(e.get("name") == "outer" for e in _trace_events(path))


def _scopes(tr):
    with tr.trace_scope("fwd", "compute", step=1, mb=0):
        with tr.trace_scope("inner", "io"):
            pass
    tr.atrace_begin("rollout", "r7", "scheduler")
    tr.instant("push", "comm", version=3)
    tr.atrace_end("rollout", "r7")
    with tr.trace_scope("bad", "nope"):
        pass
    tr.instant("plain")


def test_catapult_events_match_jax(tmp_path):
    paths = {}
    for name, cls in (("jax", j_pt.PerfTracer), ("torch", PerfTracer)):
        tr = cls(rank=2, save_path=str(tmp_path / f"{name}.json"))
        _scopes(tr)
        paths[name] = tr.save()

    def shape(path):
        ev = json.load(open(path))
        return ev["displayTimeUnit"], [
            (e["name"], e["cat"], e["ph"], e["pid"], e.get("id"), e.get("s"), e.get("args"),
             sorted(e)) for e in ev["traceEvents"]]

    assert shape(paths["torch"]) == shape(paths["jax"])


MODEL = dict(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, dtype="float32",
             param_dtype="float32")


def _engine(is_critic: bool) -> TorchTrainEngine:
    eng = TorchTrainEngine(targs.TrainEngineConfig(
        init_from_scratch=True, dtype="float32", optimizer=targs.OptimizerConfig(),
        mb_spec=targs.MicroBatchSpec(max_tokens_per_mb=64)), device="cpu")
    eng.create_process_group(ParallelStrategy())
    eng.model_config = tq.ModelConfig(**MODEL, is_critic=is_critic)
    eng.initialize(None, FinetuneSpec(1, 8, 2))
    return eng


def _batch():
    rng = np.random.default_rng(0)
    attn = np.ones((2, 12), dtype=np.int64)
    return dict(input_ids=rng.integers(1, 64, (2, 12)), attention_mask=attn)


def _step(eng):
    return eng.train_batch(_batch(), loss_fn=lambda out, mb: out.float().square().mean(),
                           loss_weight_fn=lambda mb: 1.0)


def test_window_owner_rule_with_actor_and_critic(tmp_path, monkeypatch):
    """The actor reaches the start step first and claims the window; the
    critic's steps run inside it, and its step past the window's end
    neither ends nor leaves it; the actor's step 3 ends it. Six
    train_batch calls ran inside, each one range of the trace."""
    monkeypatch.setenv("AREAL_TPU_XPROF_DIR", str(tmp_path))
    monkeypatch.setenv("AREAL_TPU_XPROF_STEPS", "1-2")
    actor, critic = _engine(False), _engine(True)
    inside = []
    order = [actor, actor] + [critic] * 4 + [actor, actor, critic]
    for eng in order:
        _step(eng)
        if perf_tracer._xprof_state["active"]:
            inside.append(eng is actor)
            assert perf_tracer._xprof_state["owner"] == id(actor)
    assert inside == [True, False, False, False, False, True]
    assert perf_tracer._xprof_state["done"] and not perf_tracer._xprof_state["active"]
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    ranges = [e for e in _trace_events(path) if e.get("name") == "train_batch"
              and e.get("ph") == "X"]
    assert len(ranges) == 6
