"""The port's agent layer and OpenAI-style client against the JAX
package's, on the CPU.

- The agent, environment and client cases of `tests/test_agents_eval.py`
  and `tests/test_openai_client.py`, each run through both packages on
  scripted engines: `MathSingleStepAgent` through `AgentWorkflow` (its
  group, its rejection band), the environment registry and
  `NullEnvironment`, `MathCodeSingleStepEnv` over obs/act queues (math
  and code groups, an unknown qid raising), and `ArealOpenAI` (the chat
  surface, the parent chain of a multi-turn conversation, the reward
  discount, the export). Rows, rewards, interactions and exports are
  equal between the packages.
- `MathCodeSingleStepEnv` with `AREAL_VERIFIER_SERVICE` pointing at the
  port's verification service grades as it does locally.
- `AgentWorkflow` and `ArealOpenAI` on a greedy `TorchDecodeEngine` and a
  greedy `JaxDecodeEngine` with the same smoke weights: equal rows and
  conversations, logprobs within 1e-5, and each exported logprob equal
  to the engine's own.
"""

import asyncio

import jax
import numpy as np
import pytest

from areal_tpu.agent import math_single_step as jms
from areal_tpu.api import agent_api as japi
from areal_tpu.api import cli_args as j_cli
from areal_tpu.dataset.arith import ArithTokenizer as JTok
from areal_tpu.engine.jax_decode import JaxDecodeEngine
from areal_tpu.experimental import openai as joai
from areal_tpu.models import qwen2 as jq
from areal_tpu_torch.agent import math_single_step as tms
from areal_tpu_torch.api import agent_api as tapi
from areal_tpu_torch.api import cli_args as t_cli
from areal_tpu_torch.dataset import get_custom_dataset as t_dataset
from areal_tpu_torch.dataset.arith import ArithTokenizer as TTok
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.experimental import openai as toai
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy
from areal_tpu_torch.models.smoke import SMOKE_MODEL_DICT
from tests.test_agents_eval import MathTokenizer
from tests.test_openai_client import ChatTokenizer
from tests.test_workflows import ScriptedEngine

PKGS = {"jax": (jms, japi, j_cli, joai), "torch": (tms, tapi, t_cli, toai)}
ROW_KEYS = ("input_ids", "loss_mask", "logprobs", "versions", "rewards", "begin_of_answer",
            "attention_mask")


def _equal_rows(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)


def test_math_agent_collects_group():
    out = {}
    for name, (ms, _, cli, _) in PKGS.items():
        agent = ms.MathSingleStepAgent(cli.GenerationHyperparameters(n_samples=4,
                                                                     max_new_tokens=4),
                                       MathTokenizer())
        wf = ms.AgentWorkflow(agent, ms.MathSingleStepEnv)
        out[name] = asyncio.run(wf.arun_episode(ScriptedEngine([[42], [7], [42], [7]]),
                                                {"input_ids": [1, 2], "answer": "4"}))
    _equal_rows(out["jax"], out["torch"])
    assert sorted(out["torch"]["rewards"].tolist()) == [0.0, 0.0, 1.0, 1.0]
    assert out["torch"]["input_ids"].shape[0] == 4
    assert sorted(out["torch"]) == sorted(ROW_KEYS)


@pytest.mark.parametrize("script,want_none", [([[42], [42]], True), ([[42], [7]], False),
                                              ([[7], [7]], True)],
                         ids=["all-solved", "mixed", "all-failed"])
def test_math_agent_rejects_out_of_band_groups(script, want_none):
    out = {}
    for name, (ms, _, cli, _) in PKGS.items():
        agent = ms.MathSingleStepAgent(cli.GenerationHyperparameters(n_samples=2,
                                                                     max_new_tokens=4),
                                       MathTokenizer(), success_rate_lb=0.1, success_rate_ub=0.9)
        wf = ms.AgentWorkflow(agent, ms.MathSingleStepEnv)
        out[name] = asyncio.run(wf.arun_episode(ScriptedEngine(script),
                                                {"input_ids": [1], "answer": "4"}))
    assert (out["torch"] is None) == (out["jax"] is None) == want_none
    if not want_none:
        _equal_rows(out["jax"], out["torch"])


def test_math_agent_encodes_messages_and_questions():
    class Tok(MathTokenizer):
        def apply_chat_template(self, messages, **kw):
            return [len(m["content"]) for m in messages] + [2]

        def encode(self, text):
            return [ord(c) % 50 for c in text]

    for prompt in ({"messages": [{"role": "user", "content": "2+2?"}], "answer": "4"},
                   {"question": "what is 2+2", "answer": "4"}):
        seen = {}
        for name, (ms, _, cli, _) in PKGS.items():
            eng = ScriptedEngine([[42]])
            prompts = []
            agenerate = eng.agenerate

            async def spy(req, agenerate=agenerate, prompts=prompts):
                prompts.append(list(req.input_ids))
                return await agenerate(req)

            eng.agenerate = spy
            agent = ms.MathSingleStepAgent(cli.GenerationHyperparameters(n_samples=1), Tok())
            asyncio.run(agent.collect_trajectory(eng, prompt, ms.MathSingleStepEnv()))
            seen[name] = prompts
        assert seen["torch"] == seen["jax"] and seen["torch"][0]


def test_env_registry_and_null_env():
    for _, api, _, _ in PKGS.values():
        env = api.make_env("null")
        obs, reward, term, trunc, info = asyncio.run(env.step("anything"))
        assert obs is None and term and not trunc and reward == 0.0 and info == {}
        assert {"null", "math-code-single-step"} <= set(api.ALL_ENV_CLASSES)
        with pytest.raises(AssertionError):
            api.register_environment("null", api.NullEnvironment)
    assert sorted(tapi.ALL_ENV_CLASSES) == sorted(japi.ALL_ENV_CLASSES)


ID2INFO = {
    "q-math": dict(task="math", solutions=[r"\boxed{\frac{1}{2}}"]),
    "q-code": dict(task="code", input_output=dict(inputs=["3 4\n"], outputs=["7\n"], fn_name="")),
    "q-lean": dict(task="lean"),
}
GOOD = "```python\na, b = map(int, input().split())\nprint(a + b)\n```"
BAD = "```python\nprint(0)\n```"
ACTIONS = [("q-math@0", ["the answer is $\\frac{2}{4}$... \\boxed{2/4}", "\\boxed{3}"]),
           ("q-code", [f"reasoning... {GOOD}", BAD])]


def _env_queues(api):
    """`tests/test_agents_eval.py`'s obs/act queue loop; the observations."""
    env = api.make_env("math-code-single-step", id2info=ID2INFO)

    async def run():
        act_q, obs_q = asyncio.Queue(), asyncio.Queue()

        async def env_loop():
            await env.reset()
            while True:
                action = await act_q.get()
                if action is None:
                    return
                await obs_q.put(await env.step(action))

        task = asyncio.create_task(env_loop())
        obs = []
        for action in ACTIONS:
            await act_q.put(action)
            obs.append(await obs_q.get())
        await act_q.put(None)
        await task
        return obs

    return asyncio.run(run())


def test_math_code_env_obs_act_queues(monkeypatch):
    monkeypatch.delenv("AREAL_VERIFIER_SERVICE", raising=False)
    monkeypatch.delenv("FUNCTIONCALL_SERVICE_DOMAIN", raising=False)
    obs = {name: _env_queues(api) for name, (_, api, _, _) in PKGS.items()}
    assert obs["torch"] == obs["jax"] == [(None, [1.0, 0.0], True, False, {"task": "math"}),
                                          (None, [1.0, 0.0], True, False, {"task": "code"})]


def test_math_code_env_through_the_verify_service(monkeypatch):
    from areal_tpu_torch.reward.verify_server import VerifyServer

    local = _env_queues(tapi)
    srv = VerifyServer(max_workers=2)
    monkeypatch.setenv("AREAL_VERIFIER_SERVICE", srv.start("127.0.0.1", 0))
    try:
        assert _env_queues(tapi) == _env_queues(japi) == local
    finally:
        srv.stop()


def test_math_code_env_unknown_qid_and_task():
    for _, api, _, _ in PKGS.values():
        with pytest.raises(KeyError):
            asyncio.run(api.make_env("math-code-single-step", id2info={}).step(("missing", ["x"])))
        env = api.make_env("math-code-single-step", id2info=ID2INFO)
        with pytest.raises(ValueError, match="unknown task 'lean'"):
            asyncio.run(env.step(("q-lean", ["x"])))
        # reset may swap the metadata
        asyncio.run(env.reset(options={"id2info": {}}))
        with pytest.raises(KeyError):
            asyncio.run(env.step(("q-math", ["x"])))


# ---------------------------------------------------------------------------
# the OpenAI-style client
# ---------------------------------------------------------------------------


def _client(oai, cli, completions):
    eng = ScriptedEngine(completions)
    return oai.ArealOpenAI(eng, ChatTokenizer(),
                           gconfig=cli.GenerationHyperparameters(max_new_tokens=8)), eng


def test_chat_completion_surface():
    seen = {}
    for name, (_, _, cli, oai) in PKGS.items():
        client, eng = _client(oai, cli, [[11, 12, 13]])
        requests = []
        agenerate = eng.agenerate

        async def spy(req, agenerate=agenerate, requests=requests):
            requests.append(req.gconfig)
            return await agenerate(req)

        eng.agenerate = spy
        resp = asyncio.run(client.chat.completions.create(
            messages=[{"role": "user", "content": "hi"}], temperature=0.0, top_p=0.5,
            max_completion_tokens=5, stop=["x"], frequency_penalty=1.0))
        assert resp.choices[0].message.role == "assistant"
        assert resp.choices[0].message.content == "11 12 13"
        assert resp.choices[0].message.model_dump() == {"role": "assistant",
                                                        "content": "11 12 13"}
        assert resp.choices[0].finish_reason == "stop" and resp.id.startswith("chatcmpl-")
        assert (resp.usage.prompt_tokens, resp.usage.completion_tokens,
                resp.usage.total_tokens) == (2, 3, 5)
        assert (resp.model, resp.object) == ("areal-tpu", "chat.completion")
        it = client.get_interaction(resp.id)
        assert it.output_tokens == [11, 12, 13] and it.output_versions == [3, 3, 3]
        assert it.parent_id is None and it.messages == [{"role": "user", "content": "hi"}]
        g = requests[0]
        seen[name] = (g.greedy, g.temperature, g.top_p, g.max_new_tokens, g.n_samples,
                      it.input_tokens, it.output_logprobs)
    assert seen["torch"] == seen["jax"] == (True, 0.0, 0.5, 5, 1, [7, 2], [-0.5] * 3)


def test_multi_turn_parent_chain_and_discount():
    out = {}
    for name, (_, _, cli, oai) in PKGS.items():
        client, _ = _client(oai, cli, [[11, 12], [21], [31]])

        async def convo(client=client):
            messages = [{"role": "user", "content": "solve"}]
            r1 = await client.chat.completions.create(messages=messages)
            it1 = client.get_interaction(r1.id)
            client.tokenizer.apply_chat_template = lambda msgs, **kw: it1.seq + [7, 2]
            r2 = await client.chat.completions.create(
                messages=messages + [{"role": "assistant", "content": "..."}])
            # an unrelated call: no parent
            client.tokenizer.apply_chat_template = lambda msgs, **kw: [9, 9, 2]
            r3 = await client.chat.completions.create(messages=messages)
            return r1, r2, r3

        r1, r2, r3 = asyncio.run(convo())
        assert client.get_interaction(r2.id).parent_id == r1.id
        assert client.get_interaction(r3.id).parent_id is None
        with pytest.raises(RuntimeError, match="no rewarded interactions"):
            client.export_interactions()
        client.set_reward(r2.id, 1.0)
        client.apply_reward_discount(turn_discount=0.5)
        assert client.get_interaction(r1.id).reward == 0.5
        assert client.get_interaction(r3.id).reward is None
        out[name] = client.export_interactions()
    _equal_rows(out["jax"], out["torch"])
    batch = out["torch"]
    assert batch["input_ids"].shape[0] == 2
    assert sorted(float(x) for x in batch["rewards"]) == [0.5, 1.0]
    assert batch["loss_mask"].sum() == 2 + 1


# ---------------------------------------------------------------------------
# the real engines
# ---------------------------------------------------------------------------

KW = dict(SMOKE_MODEL_DICT, dtype="float32", param_dtype="float32")
DECODE = dict(context_length=256, max_running_requests=16, new_tokens_per_chunk=16,
              dtype="float32", kv_cache_dtype="float32")
ROLLOUT = dict(max_concurrent_rollouts=8, consumer_batch_size=8, max_head_offpolicyness=0)


class ChatTok(TTok):
    """The arithmetic tokenizer made lossless for a chat client: every id
    decodes to a character of its own (ids without one to private-use
    code points), and the chat template concatenates the turns (a user's
    content and "=", an assistant's content as it was decoded), so a
    conversation's next prompt extends the previous call's tokens."""

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        return "".join(self._i2c.get(int(i)) or chr(0xE000 + int(i))
                       for i in np.asarray(ids).reshape(-1))

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        return [self._c2i[c] if c in self._c2i else ord(c) - 0xE000 for c in text]

    def apply_chat_template(self, messages, add_generation_prompt=True, tokenize=True, **kw):
        text = "".join(m["content"] + ("=" if m["role"] == "user" else "") for m in messages)
        return self.encode(text) if tokenize else text


def _engines():
    jparams = jq.init_params(jq.ModelConfig(**KW), jax.random.PRNGKey(7))
    tcfg = tq.ModelConfig(**KW)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    jeng = JaxDecodeEngine(j_cli.JaxDecodeConfig(**DECODE), j_cli.InferenceEngineConfig(**ROLLOUT),
                           tokenizer=JTok())
    jeng.set_model(jparams, jq.ModelConfig(**KW))
    teng = TorchDecodeEngine(t_cli.TorchDecodeConfig(**DECODE),
                             t_cli.InferenceEngineConfig(**ROLLOUT), tokenizer=TTok(), device="cpu")
    teng.set_model(tparams, tcfg)
    return {"jax": (jeng, JTok), "torch": (teng, TTok)}


def _spy_responses(eng):
    seen = []
    agenerate = eng.agenerate

    async def spy(req):
        resp = await agenerate(req)
        seen.append(resp)
        return resp

    eng.agenerate = spy
    return seen


def test_agents_and_client_on_greedy_engines():
    items = t_dataset("synthetic-arith", split="train", n_items=4)
    rows, convos = {}, {}
    for name, (eng, tok_cls) in _engines().items():
        ms, _, cli, oai = PKGS[name]
        eng.initialize()
        try:
            gconf = cli.GenerationHyperparameters(n_samples=2, max_new_tokens=12, greedy=True)
            wf = ms.AgentWorkflow(ms.MathSingleStepAgent(gconf, tok_cls()),
                                  ms.MathSingleStepEnv)
            rows[name] = eng.rollout_batch([dict(x) for x in items], workflow=wf)
            seen = _spy_responses(eng)
            client = oai.ArealOpenAI(eng, ChatTok(), gconfig=cli.GenerationHyperparameters(
                max_new_tokens=12, greedy=True))

            async def two_turns(q):
                messages = [{"role": "user", "content": q}]
                r1 = await client.chat.completions.create(messages=messages)
                messages += [{"role": "assistant", "content": r1.choices[0].message.content},
                             {"role": "user", "content": "1+1"}]
                r2 = await client.chat.completions.create(messages=messages)
                client.set_reward(r2.id, 1.0)
                return r1.id, r2.id

            async def both():
                return await asyncio.gather(two_turns("2+3"), two_turns("40-1"))

            ids = asyncio.run(both())
            client.apply_reward_discount(turn_discount=0.9)
            export = client.export_interactions()
            convos[name] = (ids, export, seen, client)
        finally:
            eng.destroy()
    rj, rt = rows["jax"], rows["torch"]
    order_j, order_t = (np.lexsort(r["input_ids"].T[::-1]) for r in (rj, rt))
    for k in ROW_KEYS:
        a, b = np.asarray(rj[k])[order_j], np.asarray(rt[k])[order_t]
        if k == "logprobs":
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
    assert rt["input_ids"].shape[0] == 8
    # the exports: two conversations of two turns each
    (_, ej, sj, _), (ids, et, st, client) = convos["jax"], convos["torch"]
    assert et["input_ids"].shape[0] == 4
    oj, ot = (np.lexsort(e["input_ids"].T[::-1]) for e in (ej, et))
    for k in ROW_KEYS:
        a, b = np.asarray(ej[k])[oj], np.asarray(et[k])[ot]
        if k == "logprobs":
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
    for r1, r2 in ids:
        assert client.get_interaction(r2).parent_id == r1
        assert client.get_interaction(r1).reward == pytest.approx(0.9)
    # every exported logprob is the engine's own, in float32
    by_tokens = {tuple(r.input_tokens + r.output_tokens): r for r in st}
    for i in range(et["input_ids"].shape[0]):
        n = int(et["attention_mask"][i].sum())
        resp = by_tokens[tuple(et["input_ids"][i, :n].tolist())]
        got = et["logprobs"][i, resp.input_len:n]
        np.testing.assert_array_equal(got, np.asarray(resp.output_logprobs, np.float32))
        assert (et["versions"][i, resp.input_len:n] == 0).all()
