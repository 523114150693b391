"""OpenAI-compatible client over `InferenceEngine.agenerate` (counterpart
of `areal_tpu/experimental/openai/client.py`; parity:
areal/experimental/openai/client.py `ArealOpenAI`).

Agent code written against `client.chat.completions.create(messages=...)`
runs unchanged on the port's decode engine or decode servers, while the
client records each call's token-level interaction (ids, logprobs,
versions). `set_reward` and `apply_reward_discount` give turn-discounted
credit, and `export_interactions` emits training rows, a turn's parent
found by token-prefix matching.

It does not subclass `openai.AsyncOpenAI` (the package is not a
dependency); the response objects mirror the attributes agent code reads
(`choices[0].message.content`, `id`, `usage`).
"""

from __future__ import annotations

import uuid
from typing import Any

from areal_tpu_torch.api.cli_args import GenerationHyperparameters
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.experimental.openai.types import (
    ChatCompletion,
    ChatMessage,
    Choice,
    InteractionWithTokenLogpReward,
    Usage,
)
from areal_tpu_torch.utils.data import pad_sequences_to_tensors


class _Completions:
    def __init__(self, client: "ArealOpenAI"):
        self._client = client

    async def create(
        self,
        *,
        messages: list[dict[str, Any]],
        temperature: float | None = None,
        top_p: float | None = None,
        max_tokens: int | None = None,
        max_completion_tokens: int | None = None,
        stop: list[str] | None = None,
        **_ignored: Any,
    ) -> ChatCompletion:
        c = self._client
        gconfig = c.gconfig.new(n_samples=1)
        if temperature is not None:
            gconfig.temperature = temperature
            gconfig.greedy = temperature == 0.0
        if top_p is not None:
            gconfig.top_p = top_p
        limit = max_completion_tokens or max_tokens
        if limit is not None:
            gconfig.max_new_tokens = limit

        input_ids = c.tokenizer.apply_chat_template(
            messages, add_generation_prompt=True, tokenize=True
        )
        resp = await c.engine.agenerate(
            ModelRequest(
                rid=str(uuid.uuid4()),
                input_ids=list(input_ids),
                gconfig=gconfig,
                tokenizer=c.tokenizer,
            )
        )
        text = c.tokenizer.decode(resp.output_tokens)
        cid = f"chatcmpl-{uuid.uuid4().hex}"
        interaction = InteractionWithTokenLogpReward(
            id=cid,
            messages=[dict(m) for m in messages],
            input_tokens=list(resp.input_tokens),
            output_tokens=list(resp.output_tokens),
            output_logprobs=list(resp.output_logprobs),
            output_versions=list(resp.output_versions),
            parent_id=c._match_parent(resp.input_tokens),
        )
        c._interactions[cid] = interaction
        return ChatCompletion(
            id=cid,
            choices=[
                Choice(
                    index=0,
                    message=ChatMessage(role="assistant", content=text),
                    finish_reason=(
                        "stop" if resp.stop_reason == "stop" else "length"
                    ),
                )
            ],
            usage=Usage(
                prompt_tokens=resp.input_len,
                completion_tokens=resp.output_len,
            ),
        )


class _Chat:
    def __init__(self, client: "ArealOpenAI"):
        self.completions = _Completions(client)


class ArealOpenAI:
    def __init__(
        self,
        engine: Any,
        tokenizer: Any,
        gconfig: GenerationHyperparameters | None = None,
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.gconfig = gconfig or GenerationHyperparameters()
        self.chat = _Chat(self)
        self._interactions: dict[str, InteractionWithTokenLogpReward] = {}

    # -- reward plumbing ------------------------------------------------
    def get_interaction(self, completion_id: str) -> InteractionWithTokenLogpReward:
        return self._interactions[completion_id]

    def set_reward(self, completion_id: str, reward: float) -> None:
        self._interactions[completion_id].reward = float(reward)

    def _match_parent(self, input_tokens: list[int]) -> str | None:
        """Multi-turn detection: the previous interaction whose full token
        sequence is a strict prefix of this call's prompt (reference
        client.py export_interactions prefix matching). Longest match wins."""
        best, best_len = None, 0
        for other in self._interactions.values():
            seq = other.seq
            n = len(seq)
            if n > best_len and n < len(input_tokens) and input_tokens[:n] == seq:
                best, best_len = other.id, n
        return best

    def apply_reward_discount(self, turn_discount: float = 1.0) -> None:
        """Back-propagate rewards along parent chains: a turn with no
        explicit reward inherits `turn_discount ×` its latest child's
        reward (reference: turn-level discounted credit assignment)."""
        children: dict[str, list[InteractionWithTokenLogpReward]] = {}
        for it in self._interactions.values():
            if it.parent_id is not None:
                children.setdefault(it.parent_id, []).append(it)

        def resolve(it: InteractionWithTokenLogpReward) -> float | None:
            kids = children.get(it.id, [])
            for kid in kids:
                if kid.reward is None:
                    resolve(kid)
            rewards = [k.reward for k in kids if k.reward is not None]
            if it.reward is None and rewards:
                it.reward = turn_discount * max(rewards)
            return it.reward

        for it in self._interactions.values():
            resolve(it)

    def export_interactions(self, style: str = "individual") -> dict[str, Any]:
        """Build one padded training batch from all recorded interactions.

        style="individual": one row per completion (each row's prompt is the
        full conversation prefix, loss on that turn's tokens only) — the
        multi-turn-safe default, matching the reference's per-interaction
        export.
        """
        assert style == "individual", style
        rows = [
            it.to_training_row()
            for it in self._interactions.values()
            if it.reward is not None
        ]
        if not rows:
            raise RuntimeError(
                "no rewarded interactions to export — call set_reward "
                "(and optionally apply_reward_discount) first"
            )
        return pad_sequences_to_tensors(rows)
