"""The port's multi-turn self-correction workflow against the JAX
package's, on the CPU.

- Both workflows over one scripted engine (wrong answers, then a right
  one) give equal rows: `input_ids`, `loss_mask`, `logprobs`,
  `versions`, the discounted `rewards`, `begin_of_answer`; and equal
  dumps. Feedback spans carry loss mask 0, logprob 0 and version -1.
- The port's workflow over a greedy `TorchDecodeEngine` and JAX's over a
  greedy `JaxDecodeEngine`, with the same smoke weights: equal token
  streams, logprobs within 1e-5 (`test_torch_decode.py`'s tolerance); the
  second turns re-send the conversation, and both engines serve them
  from their prefix registries alike (the same counts of prefills, forks
  and suffix prefills).
- The GRPO entry point with `workflow=multi_turn` on
  `arith_grpo_multiturn_smoke.yaml`, and the `multi_turn_math` wrapper,
  for 2 steps.
"""

import asyncio
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from areal_tpu.api import cli_args as j_cli
from areal_tpu.dataset import get_custom_dataset as j_dataset
from areal_tpu.dataset.arith import ArithTokenizer as JTok
from areal_tpu.dataset.arith import arith_reward_fn as j_reward
from areal_tpu.engine.jax_decode import JaxDecodeEngine
from areal_tpu.models import qwen2 as jq
from areal_tpu.workflow.multi_turn import MultiTurnWorkflow as JMultiTurn
from areal_tpu_torch.api import cli_args as t_cli
from areal_tpu_torch.dataset import get_custom_dataset as t_dataset
from areal_tpu_torch.dataset.arith import ArithTokenizer as TTok
from areal_tpu_torch.dataset.arith import arith_reward_fn as t_reward
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.examples import gsm8k_grpo, multi_turn_math
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy
from areal_tpu_torch.models.smoke import SMOKE_MODEL_DICT
from areal_tpu_torch.workflow.multi_turn import DEFAULT_FEEDBACK
from areal_tpu_torch.workflow.multi_turn import MultiTurnWorkflow as TMultiTurn

YAML = "examples/configs/arith_grpo_multiturn_smoke.yaml"
KW = dict(SMOKE_MODEL_DICT, dtype="float32", param_dtype="float32")
# 64 new tokens and no stop id: every first turn's conversation reaches the
# engines' 64-token floor for sharing a prefix, so the retries can be
# served by suffix prefills
DECODE = dict(context_length=256, max_running_requests=16, new_tokens_per_chunk=16,
              dtype="float32", kv_cache_dtype="float32")
ROLLOUT = dict(max_concurrent_rollouts=8, consumer_batch_size=4, max_head_offpolicyness=0)
ROW_KEYS = ("input_ids", "loss_mask", "logprobs", "versions", "rewards", "begin_of_answer",
            "attention_mask")


class ScriptedEngine:
    """Answers turn k with `answers[k]`, version k, logprobs -0.1·(k+1)."""

    def __init__(self, answers: list[str]):
        self.answers = answers
        self.prompts: list[list[int]] = []

    async def agenerate(self, req):
        k = len(self.prompts)
        self.prompts.append([int(t) for t in req.input_ids])
        out = TTok().encode(self.answers[k]) + [2]
        return SimpleNamespace(input_tokens=list(req.input_ids), output_tokens=out,
                               output_len=len(out), output_logprobs=[-0.1 * (k + 1)] * len(out),
                               output_versions=[k] * len(out))


@pytest.mark.parametrize("answers,turns,reward", [
    (["5", "{answer}"], 2, 0.8),  # wrong, then right: one discount
    (["{answer}"], 1, 1.0),
    (["5", "6", "7"], 3, 0.0),  # wrong to the last turn
], ids=["retry", "first", "never"])
def test_rows_and_dumps_match_jax_on_a_scripted_engine(answers, turns, reward, tmp_path):
    item = t_dataset("synthetic-arith", n_items=3)[1]
    assert item == j_dataset("synthetic-arith", n_items=3)[1]
    script = [a.format(answer=item["answer"]) for a in answers]
    gconf = dict(n_samples=4, max_new_tokens=8, greedy=True)
    rows, engines = {}, {}
    for name, cls, cli, tok, reward_fn in (("jax", JMultiTurn, j_cli, JTok, j_reward),
                                           ("torch", TMultiTurn, t_cli, TTok, t_reward)):
        engines[name] = ScriptedEngine(script)
        wf = cls(reward_fn, cli.GenerationHyperparameters(**gconf), tok(), max_turns=3,
                 turn_discount=0.8, dump_dir=str(tmp_path / name))
        rows[name] = asyncio.run(wf.arun_episode(engines[name], dict(item)))
    assert engines["jax"].prompts == engines["torch"].prompts
    assert len(engines["torch"].prompts) == turns
    j, t = rows["jax"], rows["torch"]
    assert sorted(j) == sorted(t) == sorted(ROW_KEYS)
    for k in ROW_KEYS:
        assert t[k].dtype == np.asarray(j[k]).dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert t["rewards"][0] == pytest.approx(reward)
    # the spans: prompt, then per turn the answer and (if wrong) feedback
    ids, mask, ver, lp = (t[k][0].tolist() for k in ("input_ids", "loss_mask", "versions",
                                                      "logprobs"))
    feedback = TTok().encode(DEFAULT_FEEDBACK)
    pos = len(item["input_ids"])
    assert t["begin_of_answer"][0] == pos and mask[:pos] == [0] * pos
    for k in range(turns):
        n = len(script[k]) + 1
        assert mask[pos:pos + n] == [1] * n and ver[pos:pos + n] == [k] * n
        pos += n
        if k < turns - 1:
            span = slice(pos, pos + len(feedback))
            assert ids[span] == feedback and mask[span] == [0] * len(feedback)
            assert ver[span] == [-1] * len(feedback) and lp[span] == [0.0] * len(feedback)
            pos += len(feedback)
    assert pos == len(ids)
    # one dump per episode, under the newest version, with the same record
    dumps = {}
    for name in ("jax", "torch"):
        (d,) = (tmp_path / name).iterdir()
        (f,) = d.iterdir()
        dumps[name] = (d.name, json.loads(f.read_text()))
    assert dumps["jax"] == dumps["torch"]
    assert dumps["torch"][0] == str(turns - 1) and dumps["torch"][1]["turns"] == turns


def _conversations(batch):
    rows = []
    for i in range(batch["input_ids"].shape[0]):
        n = int(batch["attention_mask"][i].sum())
        rows.append((batch["input_ids"][i, :n].tolist(), batch["loss_mask"][i, :n].tolist(),
                     batch["versions"][i, :n].tolist(), float(batch["rewards"][i]),
                     batch["logprobs"][i, :n]))
    return sorted(rows, key=lambda r: r[0])


def _counts(eng):
    return dict(prefills=eng._n_prefills, forks=eng._n_prefix_forks,
                suffix_prefills=eng._n_suffix_prefills)


class Rounds:
    """Hand a workflow's requests to an engine in rounds, so that the
    engine's schedule, and so its prefill and fork counters, do not depend
    on when the episodes' requests reach it.

    A trajectory is one call of `wf.<method>` (its requests go one after
    another). A round starts once all `expected` trajectories have started,
    none of the last round's requests is still in the engine, and every
    live trajectory waits on a request: the round's requests, sorted by
    prompt, are queued while the engine is paused and admitted as one wave.
    Which slot a request takes, and which donor registrations survive, then
    follow from the inputs alone, in either package. Without rounds they
    follow the order in which tool calls and reward threads return, which
    differs between two runs under load."""

    def __init__(self, eng, wf, method: str, expected: int):
        self.eng, self.inner = eng, eng.agenerate
        self.expected, self.started, self.live, self.in_flight = expected, 0, 0, 0
        self.pending: list = []
        trajectory = getattr(wf, method)

        async def counted(*args, **kwargs):
            self.started += 1
            self.live += 1
            try:
                return await trajectory(*args, **kwargs)
            finally:
                self.live -= 1
                self._maybe_release()

        setattr(wf, method, counted)
        eng.agenerate = self.agenerate  # the workflows call engine.agenerate

    async def agenerate(self, req):
        fut = asyncio.get_running_loop().create_future()
        self.pending.append((list(req.input_ids), req, fut))
        self._maybe_release()
        return await fut

    def _maybe_release(self) -> None:
        if (self.started < self.expected or self.in_flight or not self.pending
                or len(self.pending) < self.live):
            return
        batch = sorted(self.pending, key=lambda p: p[0])
        self.pending, self.in_flight = [], len(batch)
        asyncio.ensure_future(self._run(batch))

    async def _run(self, batch) -> None:
        self.eng.pause_generation()
        tasks = [asyncio.ensure_future(self.inner(req)) for _, req, _ in batch]
        while self.eng._request_q.qsize() < len(batch):
            await asyncio.sleep(0.001)
        self.eng.continue_generation()
        for (_, _, fut), task in zip(batch, tasks):
            try:
                fut.set_result(await task)
            except BaseException as e:  # noqa: BLE001 — the trajectory raises it
                fut.set_exception(e)
            self.in_flight -= 1
        self._maybe_release()


def test_greedy_engines_give_equal_conversations():
    jparams = jq.init_params(jq.ModelConfig(**KW), jax.random.PRNGKey(3))
    tcfg = tq.ModelConfig(**KW)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    gconf = dict(n_samples=1, max_new_tokens=64, greedy=True)
    items = t_dataset("synthetic-arith", split="train", n_items=4)
    assert items == j_dataset("synthetic-arith", split="train", n_items=4)
    out, counts = {}, {}
    jeng = JaxDecodeEngine(j_cli.JaxDecodeConfig(**DECODE), j_cli.InferenceEngineConfig(**ROLLOUT),
                           tokenizer=JTok())
    jeng.set_model(jparams, jq.ModelConfig(**KW))
    jeng.initialize()
    try:
        wf = JMultiTurn(j_reward, j_cli.GenerationHyperparameters(**gconf), JTok(), max_turns=2,
                        turn_discount=0.8)
        Rounds(jeng, wf, "arun_episode", len(items))
        out["jax"] = jeng.rollout_batch([dict(x) for x in items], workflow=wf)
        counts["jax"] = _counts(jeng)
    finally:
        jeng.destroy()
    teng = TorchDecodeEngine(t_cli.TorchDecodeConfig(**DECODE),
                             t_cli.InferenceEngineConfig(**ROLLOUT), tokenizer=TTok(), device="cpu")
    teng.set_model(tparams, tcfg)
    teng.initialize()
    try:
        wf = TMultiTurn(t_reward, t_cli.GenerationHyperparameters(**gconf), TTok(), max_turns=2,
                        turn_discount=0.8)
        Rounds(teng, wf, "arun_episode", len(items))
        out["torch"] = teng.rollout_batch([dict(x) for x in items], workflow=wf)
        counts["torch"] = _counts(teng)
    finally:
        teng.destroy()
    rj, rt = _conversations(out["jax"]), _conversations(out["torch"])
    assert len(rt) == 4
    for a, b in zip(rj, rt):
        assert a[:4] == b[:4]
        np.testing.assert_allclose(b[4], a[4], atol=1e-5, rtol=0)
    # random weights answer wrong: every episode takes a second turn
    second = sum(-1 in r[2][len(x["input_ids"]):] for r, x in zip(rt, items))
    assert second == 4 and all(r[3] == 0.0 for r in rt)
    assert counts["torch"] == counts["jax"], counts
    assert counts["torch"]["suffix_prefills"] >= 1, counts


@pytest.mark.parametrize("entry", ["gsm8k_grpo", "multi_turn_math"])
def test_entry_point_two_steps(entry, tmp_path):
    argv = ["--config", YAML, "total_train_steps=2", f"cluster.fileroot={tmp_path}"]
    if entry == "gsm8k_grpo":
        history = gsm8k_grpo.main(argv, device="cpu")
    else:
        history = multi_turn_math.main(argv[:2] + ["workflow=rlvr"] + argv[2:], device="cpu")
    assert len(history) == 2
    feedback = TTok().encode(DEFAULT_FEEDBACK)
    n_retries = 0
    for rec in history:
        b = rec["batch"]
        assert np.isfinite(rec["stats"][0]["grpo_actor/loss"])
        for i in range(b["input_ids"].shape[0]):
            n = int(b["attention_mask"][i].sum())
            ids, ver = b["input_ids"][i, :n].tolist(), b["versions"][i, :n].tolist()
            # compute_advantages left the loss mask rolled by -1: undo it
            mask = np.roll(b["loss_mask"][i], 1)[:n].tolist()
            start = int(b["begin_of_answer"][i])
            while True:  # each feedback span: loss mask 0, version -1
                at = next((p for p in range(start, n - len(feedback) + 1)
                           if ids[p:p + len(feedback)] == feedback), None)
                if at is None:
                    break
                span = slice(at, at + len(feedback))
                assert mask[span] == [0] * len(feedback) and ver[span] == [-1] * len(feedback)
                n_retries += 1
                start = at + len(feedback)
        # one row per episode (n_samples=1 per turn), discounted rewards
        assert set(np.round(b["rewards"], 6).tolist()) <= {0.0, 0.8, 1.0}
    assert n_retries > 0
