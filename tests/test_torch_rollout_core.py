"""The port's rollout core against the JAX package's, on the CPU.

Each check feeds the same inputs (made from a numpy seed) to the JAX
module and to its copy in `areal_tpu_torch`, in one process, and wants
the same answer: the staleness capacity over submit / accept / reject
sequences with `state_dict` round-trips; the `WorkflowExecutor`
scenarios of `tests/test_workflow_executor.py` on both executors with one
stub engine and workflow (accepted counts, rejected and deduped episodes,
the failure streak, a paused `wait` timing out); `RLVRWorkflow.
arun_episode` on fixed responses (every tensor exactly); the padding and
concatenation helpers (exactly); `synthetic-arith` items, the tokenizer,
the reward and `SimpleDataLoader` batches; the seeding helpers; and
`load_expr_config` on `examples/configs/arith_grpo_smoke.yaml`, bare and
with the chip check's overrides, on every key the file and the overrides
set.
"""

import asyncio
import random
import time
from pathlib import Path

import numpy as np
import pytest
import yaml

from areal_tpu.api import cli_args as j_cli
from areal_tpu.api import io_struct as j_io
from areal_tpu.api import reward_api as j_reward
from areal_tpu.core import staleness_manager as j_sm
from areal_tpu.core import workflow_executor as j_wx
from areal_tpu import dataset as j_ds
from areal_tpu.dataset import arith as j_arith
from areal_tpu.utils import data as j_data
from areal_tpu.utils import seeding as j_seed
from areal_tpu.utils import structured as j_struct
from areal_tpu.workflow import rlvr as j_rlvr
from areal_tpu_torch.api import cli_args as t_cli
from areal_tpu_torch.api import io_struct as t_io
from areal_tpu_torch.api import reward_api as t_reward
from areal_tpu_torch.core import staleness_manager as t_sm
from areal_tpu_torch.core import workflow_executor as t_wx
from areal_tpu_torch import dataset as t_ds
from areal_tpu_torch.dataset import arith as t_arith
from areal_tpu_torch.utils import data as t_data
from areal_tpu_torch.utils import seeding as t_seed
from areal_tpu_torch.utils import structured as t_struct
from areal_tpu_torch.workflow import rlvr as t_rlvr

ROOT = Path(__file__).resolve().parents[1]
YAML = ROOT / "examples" / "configs" / "arith_grpo_smoke.yaml"
PKGS = {
    "jax": dict(cli=j_cli, io=j_io, sm=j_sm, wx=j_wx, ds=j_ds, arith=j_arith,
                data=j_data, seed=j_seed, struct=j_struct, rlvr=j_rlvr),
    "torch": dict(cli=t_cli, io=t_io, sm=t_sm, wx=t_wx, ds=t_ds, arith=t_arith,
                  data=t_data, seed=t_seed, struct=t_struct, rlvr=t_rlvr),
}

# the chip check's overrides of the smoke yaml: the learning run (b) and
# the full-width run (c)
LEARN_OVERRIDES = [
    "async_training=false", "gconfig.n_samples=8", "actor.group_size=8",
    "actor.adv_norm.group_size=8", "train_dataset.batch_size=8",
    "rollout.consumer_batch_size=8", "gconfig.max_new_tokens=2",
    "actor.ppo_n_minibatches=1", "actor.optimizer.lr=3e-2", "total_train_steps=12",
    "evaluator.freq_steps=null",
]
FULL_OVERRIDES = [
    "train_dataset.batch_size=8", "gconfig.n_samples=4", "gconfig.max_new_tokens=256",
    "rollout.consumer_batch_size=8", "decode.context_length=512",
    "decode.max_running_requests=32", "decode.new_tokens_per_chunk=128",
    "decode.dtype=bfloat16", "decode.kv_cache_dtype=bfloat16", "actor.dtype=bfloat16",
    "actor.group_size=4", "actor.adv_norm.group_size=4", "actor.optimizer.lr=1e-4",
    "total_train_steps=3", "actor.mb_spec.max_tokens_per_mb=8192",
    "actor.gradient_checkpointing=true",
]
RUN_OVERRIDES = ["total_train_steps=9", "cluster.fileroot=/tmp/x", "experiment_name=e"]


# -- staleness capacity ------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_staleness_capacity_matches(seed):
    """A random sequence of submits, accepts, rejects and version reads
    (with a state_dict round-trip in the middle) gives the same capacity
    and counters on both managers."""
    rng = np.random.default_rng(seed)
    args = (int(rng.integers(1, 40)), int(rng.integers(0, 9)), int(rng.integers(0, 4)))
    mgrs = [j_sm.StalenessManager(*args), t_sm.StalenessManager(*args)]
    running = 0
    for step in range(200):
        op = rng.integers(0, 4)
        if op == 0 or running == 0:
            for m in mgrs:
                m.on_rollout_submitted()
            running += 1
        elif op == 1:
            for m in mgrs:
                m.on_rollout_accepted()
            running -= 1
        elif op == 2:
            for m in mgrs:
                m.on_rollout_rejected()
            running -= 1
        v = int(rng.integers(0, 12))
        caps = [m.get_capacity(v) for m in mgrs]
        assert caps[0] == caps[1], (step, v, caps)
        stats = [m.get_stats() for m in mgrs]
        assert (stats[0].submitted, stats[0].accepted, stats[0].running) == (
            stats[1].submitted, stats[1].accepted, stats[1].running)
        if step == 100:
            st = [m.state_dict() for m in mgrs]
            assert st[0] == st[1]
            mgrs = [j_sm.StalenessManager(*args), t_sm.StalenessManager(*args)]
            for m, s in zip(mgrs, st):
                m.load_state_dict(s)
            assert mgrs[0].state_dict() == mgrs[1].state_dict() == st[1]


# -- WorkflowExecutor scenarios ------------------------------------------------


class StubEngine:
    def get_version(self):
        return 0


class EchoWorkflow:
    """A 1-sample trajectory built from the item, None when `reject` is
    set, an exception when `boom` is set."""

    async def arun_episode(self, engine, data):
        await asyncio.sleep(0.005)
        if data.get("boom"):
            raise RuntimeError("rollout died")
        if data.get("reject"):
            return None
        n = int(data.get("len", 4))
        return dict(
            input_ids=np.full((1, n), data["value"], dtype=np.int32),
            attention_mask=np.ones((1, n), dtype=bool),
            rewards=np.array([float(data["value"])], dtype=np.float32),
        )


class Loader:
    def __init__(self, items, batch_size):
        self.items, self.batch_size = items, batch_size

    def __iter__(self):
        for i in range(0, len(self.items), self.batch_size):
            yield self.items[i: i + self.batch_size]


def _executor(pkg):
    p = PKGS[pkg]
    cfg = p["cli"].InferenceEngineConfig(
        max_concurrent_rollouts=16, consumer_batch_size=4, max_head_offpolicyness=2,
        check_trajectory_format=True,
    )
    ex = p["wx"].WorkflowExecutor(cfg, StubEngine())
    ex.initialize()
    return ex


def _scenario(name: str, ex) -> dict:
    """One scenario of `tests/test_workflow_executor.py`; returns what it
    observed, to be held equal across the two executors."""
    wf = EchoWorkflow()
    out = {}
    if name == "rollout_batch":
        batch = ex.rollout_batch([dict(value=i, len=3 + i % 2) for i in range(6)], workflow=wf)
        out["rewards"] = sorted(batch["rewards"].tolist())
        out["shape"] = batch["input_ids"].shape
    elif name == "rejected":
        for i in range(4):
            ex.submit(dict(value=i), workflow=wf)
        ex.submit(dict(value=99, reject=True), workflow=wf)
        out["n"] = ex.wait(4, timeout=10)["input_ids"].shape[0]
        deadline = time.monotonic() + 10
        while ex.get_stats().running and time.monotonic() < deadline:
            ex._collect()
            time.sleep(0.01)
        st = ex.get_stats()
        out["stats"] = (st.submitted, st.accepted, st.running)
    elif name == "should_accept":
        for i in range(6):
            ex.submit(dict(value=i), workflow=wf,
                      should_accept=lambda t: float(t["rewards"][0]) % 2 == 0)
        out["rewards"] = sorted(ex.wait(3, timeout=10)["rewards"].tolist())
    elif name == "staleness":
        for i in range(20):
            ex.submit(dict(value=i), workflow=wf)
        out["first"] = ex.wait(12, timeout=10)["input_ids"].shape[0]
        out["submitted"] = ex.get_stats().submitted
        ex.set_version(1)
        out["second"] = ex.wait(4, timeout=10)["input_ids"].shape[0]
        out["submitted_after"] = ex.get_stats().submitted
    elif name == "prepare_batch":
        loader = Loader([dict(value=i) for i in range(32)], batch_size=4)
        b1 = ex.prepare_batch(loader, workflow=wf)
        ex.set_version(1)
        b2 = ex.prepare_batch(loader, workflow=wf)
        out["shapes"] = (b1["input_ids"].shape, b2["input_ids"].shape)
        out["keys"] = sorted(b1)
        out["stamps"] = (b1["rollout_version"].tolist(), b2["rollout_version"].tolist())
    elif name == "dedup":
        for _ in range(2):
            ex.submit(dict(value=7), workflow=wf, rollout_id=5)
        batch = ex.wait(1, timeout=10)
        deadline = time.monotonic() + 10
        while ex.ledger.deduped_total() == 0 and time.monotonic() < deadline:
            ex._collect()
            time.sleep(0.01)
        out["rid"] = batch["rollout_id"].tolist()
        out["deduped"] = ex.ledger.deduped_total()
        st = ex.get_stats()
        out["stats"] = (st.submitted, st.accepted, st.running)
        out["consumed"] = ex.ledger.consumed_count()
        out["state"] = ex.state_dict()
    elif name == "failure_released":
        for i in range(6):
            ex.submit({"value": i, "boom": True}, workflow=wf)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            ex._admit_pending()
            ex._collect()
            st = ex.staleness_manager.get_stats()
            if st.submitted == 6 and st.running == 0:
                break
            time.sleep(0.01)
        st = ex.staleness_manager.get_stats()
        out["stats"] = (st.submitted, st.accepted, st.running)
    elif name == "failure_streak":
        for i in range(20):
            ex.submit({"value": i, "boom": True}, workflow=wf)
        with pytest.raises(RuntimeError, match="16 consecutive rollout episodes failed") as e:
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                ex._admit_pending()
                ex._collect()
                time.sleep(0.01)
        out["cause"] = repr(e.value.__cause__)
        unprocessed = len(ex.runner.poll_results())
        st = ex.staleness_manager.get_stats()
        out["balanced"] = st.running == unprocessed + ex.runner.inflight
    elif name == "paused_wait":
        ex.pause()
        ex.submit(dict(value=3), workflow=wf)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match=r"wait\(1\): only 0 accepted"):
            ex.wait(1, timeout=0.3)
        out["timed_out_after_s"] = round(time.monotonic() - t0, 1)
        out["submitted_while_paused"] = ex.get_stats().submitted
        ex.resume()
        out["after_resume"] = ex.wait(1, timeout=10)["rewards"].tolist()
    return out


SCENARIOS = ["rollout_batch", "rejected", "should_accept", "staleness", "prepare_batch",
             "dedup", "failure_released", "failure_streak", "paused_wait"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_executor_scenario_matches(name):
    seen = {}
    for pkg in PKGS:
        random.seed(0)
        ex = _executor(pkg)
        try:
            seen[pkg] = _scenario(name, ex)
        finally:
            ex.destroy()
    assert seen["jax"] == seen["torch"]
    if name == "paused_wait":
        assert seen["torch"]["submitted_while_paused"] == 0
        assert seen["torch"]["after_resume"] == [3.0]
    if name == "dedup":
        assert seen["torch"]["deduped"] == 1 and seen["torch"]["rid"] == [5]
    if name == "failure_streak":
        assert "rollout died" in seen["torch"]["cause"] and seen["torch"]["balanced"]


def test_trajectory_format_check_matches():
    bad = [
        {},
        dict(input_ids=np.zeros((2, 3))),
        dict(input_ids=np.zeros((2, 3)), attention_mask=np.zeros((2, 4))),
        dict(input_ids=np.zeros((2, 3)), attention_mask=np.zeros((2, 3)), rewards=np.zeros(5)),
    ]
    for traj in bad:
        for p in PKGS.values():
            with pytest.raises(ValueError):
                p["wx"].check_trajectory_format(traj)
    ok = dict(input_ids=np.zeros((2, 3)), attention_mask=np.zeros((2, 3)), rewards=np.zeros(2))
    for p in PKGS.values():
        p["wx"].check_trajectory_format(ok)


# -- RLVR workflow on fixed responses -------------------------------------------


class FixedEngine:
    """Answers the n-th `agenerate` call with the n-th fixed response."""

    def __init__(self, io, responses):
        self.io, self.responses, self.calls = io, responses, 0

    async def agenerate(self, req):
        r = self.responses[self.calls]
        self.calls += 1
        await asyncio.sleep(0)
        return self.io.ModelResponse(
            input_tokens=list(req.input_ids), output_tokens=list(r["tokens"]),
            output_logprobs=list(r["logprobs"]), output_versions=list(r["versions"]),
            stop_reason="stop",
        )

    def get_version(self):
        return 3


@pytest.mark.parametrize("seed", range(4))
def test_rlvr_episode_matches(seed):
    rng = np.random.default_rng(seed)
    item = j_arith.make_arith_dataset(n_items=8, seed=seed)[int(rng.integers(0, 8))]
    n = int(rng.integers(1, 6))
    tok = j_arith.ArithTokenizer()
    responses = []
    for i in range(n):
        m = int(rng.integers(1, 9))
        # sometimes the right answer, so the reward takes both values
        toks = (tok.encode(item["answer"]) + [2])[:m] if i % 2 else rng.integers(3, 21, m).tolist()
        responses.append(dict(tokens=toks, logprobs=rng.normal(size=len(toks)).tolist(),
                              versions=rng.integers(0, 4, len(toks)).tolist()))
    out = {}
    for name, p in PKGS.items():
        g = p["cli"].GenerationHyperparameters(n_samples=n, max_new_tokens=8)
        wf = p["rlvr"].RLVRWorkflow(p["arith"].arith_reward_fn, g,
                                    tokenizer=p["arith"].ArithTokenizer())
        out[name] = asyncio.run(wf.arun_episode(FixedEngine(p["io"], responses), dict(item)))
    assert sorted(out["jax"]) == sorted(out["torch"])
    for k, v in out["jax"].items():
        assert v.dtype == out["torch"][k].dtype, k
        np.testing.assert_array_equal(v, out["torch"][k], err_msg=k)
    assert out["torch"]["input_ids"].shape[0] == n


# -- padding and concatenation ----------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_pad_and_concat_match(seed):
    rng = np.random.default_rng(seed)

    def seqs():
        out = []
        for _ in range(int(rng.integers(1, 6))):
            n = int(rng.integers(1, 12))
            out.append(dict(input_ids=rng.integers(0, 50, n).astype(np.int32),
                            logprobs=rng.normal(size=n).astype(np.float32),
                            emb=rng.normal(size=(n, 3)).astype(np.float32),
                            rewards=np.float32(rng.normal()),
                            begin_of_answer=np.int32(rng.integers(0, n))))
        return out

    groups = [seqs() for _ in range(3)]
    padded = {name: [p["data"].pad_sequences_to_tensors(g, pad_value=-1.0) for g in groups]
              for name, p in PKGS.items()}
    for a, b in zip(padded["jax"], padded["torch"]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    cat = {name: p["data"].concat_padded_tensors(padded[name], pad_value=7.0)
           for name, p in PKGS.items()}
    for k in cat["jax"]:
        assert cat["jax"][k].dtype == cat["torch"][k].dtype
        np.testing.assert_array_equal(cat["jax"][k], cat["torch"][k])
    assert t_data.pad_sequences_to_tensors([]) == {} and t_data.concat_padded_tensors([]) == {}


# -- data, tokenizer, reward, loader, seeding ----------------------------------------


@pytest.mark.parametrize("split", ["train", "test"])
def test_arith_dataset_and_loader_match(split):
    kw = dict(path="synthetic-arith", split=split, type="rl")
    items = [p["ds"].get_custom_dataset(**kw) for p in PKGS.values()]
    assert items[0] == items[1] and len(items[1]) == 4096
    tj, tt = j_arith.ArithTokenizer(), t_arith.ArithTokenizer()
    assert (tj.vocab_size, tj.pad_token_id, tj.eos_token_id, tj.bos_token_id) == (
        tt.vocab_size, tt.pad_token_id, tt.eos_token_id, tt.bos_token_id)
    for x in items[1][:64]:
        text = x["prompt"] + x["answer"] + "?\n"
        assert tj.encode(text, add_special_tokens=True) == tt.encode(text, add_special_tokens=True)
        ids = [1] + tt.encode(text) + [2, 0]
        for skip in (True, False):
            assert tj.decode(ids, skip_special_tokens=skip) == tt.decode(ids, skip_special_tokens=skip)
        msgs = [{"role": "user", "content": x["prompt"]}]
        assert tj.apply_chat_template(msgs) == tt.apply_chat_template(msgs)
        for completion in (x["answer"], x["answer"] + ".", " 1" + x["answer"], "", None):
            args = (x["prompt"], completion, x["input_ids"], tt.encode(x["answer"]))
            kw = t_reward.reward_kwargs(x)
            assert kw == j_reward.reward_kwargs(x)
            assert j_arith.arith_reward_fn(*args, **kw) == t_arith.arith_reward_fn(*args, **kw)
    loaders = [p["ds"].SimpleDataLoader(it, batch_size=16, shuffle=split == "train", seed=3)
               for p, it in zip(PKGS.values(), items)]
    assert len(loaders[0]) == len(loaders[1])
    for _ in range(2):  # two epochs: the shuffle follows the epoch
        assert list(loaders[0]) == list(loaders[1])
    assert loaders[0].state_dict() == loaders[1].state_dict()


def test_seeding_matches():
    for p in PKGS.values():
        p["seed"].set_random_seed(11, key="trainer0")
    a = (random.random(), np.random.rand())
    t_seed.set_random_seed(11, key="trainer0")
    b = (random.random(), np.random.rand())
    j_seed.set_random_seed(11, key="trainer0")
    assert a == b == (random.random(), np.random.rand())
    assert j_seed.get_seed() == t_seed.get_seed()
    g1, g2 = t_seed.new_generator("x"), t_seed.new_generator("x")
    import torch

    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
    assert not torch.equal(torch.rand(4, generator=t_seed.new_generator("y")),
                           torch.rand(4, generator=t_seed.new_generator("x")))


def test_step_info_matches():
    a, b = j_io.StepInfo(0, 0, 0, 3), t_io.StepInfo(0, 0, 0, 3)
    for _ in range(7):
        a, b = a.next(), b.next()
        assert (a.epoch, a.epoch_step, a.global_step) == (b.epoch, b.epoch_step, b.global_step)


# -- config loading --------------------------------------------------------------


def _leaf_paths(d: dict, prefix=()) -> list[tuple]:
    out = []
    for k, v in d.items():
        if isinstance(v, dict) and v:
            out += _leaf_paths(v, prefix + (k,))
        else:
            out.append(prefix + (k,))
    return out


def _get(d, path):
    for k in path:
        d = d[k]
    return d


@pytest.mark.parametrize("overrides", [[], RUN_OVERRIDES, LEARN_OVERRIDES, FULL_OVERRIDES],
                         ids=["bare", "run", "learn", "full"])
def test_load_expr_config_matches(overrides, tmp_path):
    argv = ["--config", str(YAML), *overrides]
    cj, dj = j_cli.load_expr_config(argv, j_cli.GRPOConfig)
    ct, dt = t_cli.load_expr_config(argv, t_cli.GRPOConfig)
    assert dj == dt
    tj, tt = j_struct.to_dict(cj), t_struct.to_dict(ct)
    paths = _leaf_paths(dt) + [tuple(o.split("=")[0].split(".")) for o in overrides]
    # the names the loader propagates into sub-configs
    for sub in ("saver", "evaluator", "stats_logger", "recover", "rollout", "actor", "ref"):
        paths += [(sub, "experiment_name"), (sub, "trial_name")]
    for sub in ("saver", "evaluator", "stats_logger", "recover"):
        paths.append((sub, "fileroot"))
    for path in paths:
        if path == ("saver",):  # `saver: {}`
            continue
        assert _get(tj, path) == _get(tt, path), path
    assert isinstance(ct.decode, t_cli.TorchDecodeConfig)
    # save_config writes what to_dict gives, readable by a YAML reader
    saved = t_cli.save_config(ct, str(tmp_path))
    with open(saved) as f:
        assert yaml.safe_load(f) == tt


def test_load_expr_config_refuses_unknown_keys():
    with pytest.raises(t_struct.UnknownFieldError):
        t_cli.load_expr_config(["--config", str(YAML), "actor.no_such_knob=1"], t_cli.GRPOConfig)
    with pytest.raises(ValueError, match="unknown config field"):
        t_struct.from_dict(t_cli.GRPOConfig, {"rollout": {"no_such_knob": 1}})
    with pytest.raises(ValueError, match="key=value"):
        t_cli.load_expr_config(["--config", str(YAML), "total_train_steps"], t_cli.GRPOConfig)
