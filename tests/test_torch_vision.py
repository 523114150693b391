"""Vision RLVR in the port on the CPU: the decode engine's image requests,
the rewards, the workflow, the client's payload and `clevr_grpo.py`.

- **The engine against JAX.** At `tests/test_qwen2_vl.py`'s TEXT/VIS
  sizes in f32 with the same weights, the port engine's greedy tokens for
  an image request equal a per-step oracle built from the JAX package's
  functions (`forward_vision`, `splice_image_embeds`, `mrope_positions`,
  `mrope_table` and `prefill` from embeddings), token for token; the
  slot's rope delta is -2; a text request served beside it streams as it
  does alone; an image request with no tower raises.
- **Image slots inside the port** (no JAX): an image request never forks
  and never registers as a donor, and a text request with the same
  tokens (or a longer one) never forks or suffix-prefills from it; an
  image request never suffix-prefills from a text donor either; no image
  block enters the fabric index or leaves as identity only. A parked
  image slot evicted to the host tier and promoted, one exported and
  imported into another engine, and one whose resume misses the tier
  and prefills again from its image_data, each give the never-moved
  stream with its rope delta; spec decode gives the spec-off stream; an
  image prefill into an int8 pool runs.
- **Rewards, workflow, payload, entry point.** The three vision rewards
  on a table of completions equal JAX's; the workflow against a scripted
  engine builds JAX's requests and batch; the client's payload
  base64-encodes images as JAX's does; `clevr_grpo.main` runs the JAX
  docstring's offline recipe for one step.
"""

import asyncio
import base64
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from areal_tpu.api.cli_args import GenerationHyperparameters as JGen
from areal_tpu.api.io_struct import ModelRequest as JRequest
from areal_tpu.api.io_struct import ModelResponse as JResponse
from areal_tpu.core.remote_inf_engine import RemoteBackend as JBackend
from areal_tpu.models import qwen2 as jq
from areal_tpu.models import qwen2_vl as jv
from areal_tpu.reward import vqa as jvqa
from areal_tpu.workflow.vision_rlvr import VisionRLVRWorkflow as JWorkflow
from areal_tpu_torch.api.cli_args import GenerationHyperparameters, TorchDecodeConfig
from areal_tpu_torch.api.io_struct import ModelRequest, ModelResponse
from areal_tpu_torch.core import kv_fabric
from areal_tpu_torch.core.remote_inf_engine import RemoteBackend
from areal_tpu_torch.engine import torch_decode as td
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models import qwen2_vl as tv
from areal_tpu_torch.models.convert import params_from_numpy, vision_params_from_numpy
from areal_tpu_torch.reward import vqa as tvqa
from areal_tpu_torch.workflow.vision_rlvr import VisionRLVRWorkflow

TEXT = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, dtype="float32",
            param_dtype="float32")
JCFG, TCFG = jq.ModelConfig(**TEXT), tq.ModelConfig(**TEXT)
VIS = dict(embed_dim=16, depth=2, num_heads=2, mlp_dim=32, in_channels=3, patch_size=2,
           temporal_patch_size=1, spatial_merge_size=2, hidden_size=32)
JVIS, TVIS = jv.VisionConfig(**VIS), tv.VisionConfig(**VIS)
IMG = 63
HD = TCFG.head_dim_
SECTIONS = (HD // 4, HD // 8, HD // 8)
TIMEOUT = 120


@pytest.fixture(scope="module")
def weights():
    jparams = jq.init_params(JCFG, jax.random.PRNGKey(0))
    jvparams = jv.init_vision_params(JVIS, jax.random.PRNGKey(1))
    return (jparams, jvparams, params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG),
            vision_params_from_numpy(jax.tree.map(np.asarray, jvparams), TVIS))


def _image(seed: int, h: int = 4, w: int = 4) -> dict:
    rng = np.random.RandomState(seed)
    return dict(pixel_values=rng.randn(h * w, TVIS.patch_dim).astype(np.float32),
                image_grid_thw=np.array([[1, h, w]]))


def _engine(weights, tower: bool = True, **over) -> TorchDecodeEngine:
    cfg = dict(context_length=64, max_running_requests=2, new_tokens_per_chunk=4,
               kv_cache_dtype="float32", page_size=16)
    cfg.update(over)
    eng = TorchDecodeEngine(TorchDecodeConfig(**cfg), device="cpu")
    eng.set_model(weights[2], TCFG)
    if tower:
        eng.set_vision_model(weights[3], TVIS, IMG, mrope_sections=SECTIONS)
    return eng.initialize()


def _greedy(n: int) -> GenerationHyperparameters:
    return GenerationHyperparameters(greedy=True, max_new_tokens=n)


def _run(eng, reqs) -> list:
    """Serve `reqs` concurrently from one event loop in a thread."""
    out: dict = {}

    def go():
        async def main():
            return await asyncio.gather(*[eng.agenerate(r) for r in reqs])
        try:
            out["r"] = asyncio.run(main())
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["e"] = e

    t = threading.Thread(target=go, daemon=True)
    t.start()
    t.join(TIMEOUT)
    if "e" in out:
        raise out["e"]
    assert "r" in out, "the requests did not finish"
    return out["r"]


def _jax_oracle(jparams, jvparams, prompt, image_data, n_new):
    """Per-step greedy oracle from JAX's functions: a full prefill of the
    sequence so far from spliced embeddings and m-rope tables
    (`tests/test_qwen2_vl.py::_greedy_vlm_reference`)."""
    pv = np.concatenate([np.asarray(d["pixel_values"]) for d in image_data])
    thw = np.concatenate([np.asarray(d["image_grid_thw"]).reshape(-1, 3) for d in image_data])
    img = jv.forward_vision(jvparams, jnp.asarray(pv), jnp.asarray(jv.patch_grid_coords(thw, 2)),
                            JVIS)
    seq = list(prompt)
    for _ in range(n_new):
        ids = jnp.asarray(np.array(seq, dtype=np.int32))
        embeds = jparams["embed"]["embedding"][ids].astype(jnp.float32)
        splice_ids = np.array(seq, dtype=np.int32)
        splice_ids[len(prompt):] = 0  # generated tokens never splice
        embeds = jv.splice_image_embeds(embeds, jnp.asarray(splice_ids), img, IMG)
        pos3, _ = jv.mrope_positions(np.array(seq), thw, IMG, 2)
        cos, sin = jv.mrope_table(pos3, HD, JCFG.rope_theta, SECTIONS)
        logits, _, _ = jq.prefill(jparams, ids, jnp.arange(len(seq), dtype=jnp.int32), JCFG,
                                  input_embeds=embeds, rope_cos=cos, rope_sin=sin)
        seq.append(int(np.argmax(np.asarray(logits[-1]))))
    return seq[len(prompt):]


PROMPT = [5, IMG, IMG, IMG, IMG, 9, 2]


def test_image_request_equals_the_jax_oracle(weights):
    """Greedy tokens equal JAX's per-step oracle; the rope delta is -2; a
    text request served beside the image request streams as alone."""
    image = _image(3)
    want = _jax_oracle(weights[0], weights[1], PROMPT, [image], 6)
    eng = _engine(weights)
    try:
        text = ModelRequest(input_ids=[1, 2, 3, 4], gconfig=_greedy(5))
        solo = _run(eng, [text.copy()])[0]
        img, beside = _run(eng, [ModelRequest(input_ids=PROMPT, gconfig=_greedy(6),
                                              image_data=[image]), text.copy()])
        assert img.output_tokens == want
        assert int(eng._slot_rope_delta.min()) == -2
        assert beside.output_tokens == solo.output_tokens
        np.testing.assert_allclose(beside.output_logprobs, solo.output_logprobs, atol=1e-6)
    finally:
        eng.destroy()
    assert eng._vision_params is None  # destroy drops the tower


def test_image_request_without_a_tower_raises(weights):
    eng = _engine(weights, tower=False)
    try:
        req = ModelRequest(input_ids=[1, 2], gconfig=_greedy(2),
                           image_data=[{"pixel_values": np.zeros((4, 12))}])
        with pytest.raises(NotImplementedError, match="no vision tower"):
            eng.generate(req, timeout=60)
        with pytest.raises(NotImplementedError, match="no vision tower"):
            eng.prefill(req, timeout=60)
    finally:
        eng.destroy()


def _counters(eng) -> tuple:
    return (eng._n_prefills, eng._n_prefix_forks, eng._n_prefix_inplace, eng._n_suffix_prefills)


def test_image_slots_never_fork_or_donate(weights):
    """Two samples of one image prompt prefill twice; a text request with
    the image prompt's tokens, or one extending them past the shared-
    prefix floor, prefills in full after them and streams as on a fresh
    engine; an image request extending a registered text prompt does not
    suffix-prefill from it; no image block is in the fabric index."""
    rng = np.random.RandomState(1)
    head = [int(x) for x in rng.randint(1, 60, 70)]
    img_prompt = head[:10] + [IMG] * 4 + head[10:]
    image = _image(4)
    fresh = _engine(weights, context_length=256, max_running_requests=4)
    try:
        for follow in (img_prompt, img_prompt + [7] * 8):
            eng = _engine(weights, context_length=256, max_running_requests=4)
            try:
                a, b = _run(eng, [ModelRequest(input_ids=img_prompt, gconfig=_greedy(4),
                                               image_data=[image]) for _ in range(2)])
                assert a.output_tokens == b.output_tokens
                assert _counters(eng) == (2, 0, 0, 0)
                assert not eng._prefix_lookup and not eng._fabric_dev
                text = _run(eng, [ModelRequest(input_ids=follow, gconfig=_greedy(4))])[0]
                assert _counters(eng) == (3, 0, 0, 0)
                assert text.output_tokens == _run(
                    fresh, [ModelRequest(input_ids=follow, gconfig=_greedy(4))])[0].output_tokens
            finally:
                eng.destroy()
        # a text donor registered over the head: the image request with
        # that head and its image after it prefills in full
        eng = _engine(weights, context_length=256, max_running_requests=4)
        try:
            _run(eng, [ModelRequest(input_ids=head, gconfig=_greedy(2))])
            assert eng._prefix_lookup and eng._fabric_dev
            tail = head + [IMG] * 4 + [3, 4]
            img2 = _run(eng, [ModelRequest(input_ids=tail, gconfig=_greedy(4),
                                           image_data=[image])])[0]
            assert _counters(eng) == (2, 0, 0, 0)
            assert img2.output_tokens == _run(fresh, [ModelRequest(
                input_ids=tail, gconfig=_greedy(4), image_data=[image])])[0].output_tokens
            # the fabric and the registry index the text registration only
            assert all(not eng._slot_image[s] for s, _ in eng._fabric_dev.values())
            assert all(not eng._slot_image[s] for s in eng._prefix_lookup.values())
        finally:
            eng.destroy()
    finally:
        fresh.destroy()


def _park(eng, rid: str, prompt, image, chunks: int, n_new: int):
    """Admit one image request by hand, run `chunks` chunks, abort it: its
    KV parks under `rid` with its rope delta. Returns the interrupted
    slot's record."""
    eng.pause_generation()
    loop = asyncio.new_event_loop()
    item = td._Slot(rid, list(prompt), _greedy(n_new), future=loop.create_future(), loop=loop,
                    image_data=[image])
    eng._request_q.put(item)
    with eng._sched_lock, torch.no_grad():
        eng._admit()
        for _ in range(chunks):
            eng._run_chunk(eng._active_mask())
    eng.abort_all()
    eng.continue_generation()
    loop.close()
    assert item.stop_reason == "interrupt" and item.tokens
    return item


def _resume(eng, rid, prompt, item, image, n_new):
    g = _greedy(n_new - len(item.tokens))
    return _run(eng, [ModelRequest(rid=rid, input_ids=list(prompt) + item.tokens, gconfig=g,
                                   image_data=[image])])[0]


@pytest.mark.parametrize("move", ["host_tier", "migrate", "miss"])
def test_moved_image_slot_keeps_its_stream(weights, move):
    """A parked image slot evicted to the host tier and promoted, exported
    and imported into a second engine, or dropped so that its resume
    prefills again from its image_data: the resumed stream equals the
    never-moved one (tokens equal, logprobs within 1e-6; 1e-5 for the
    re-prefill), with its rope delta."""
    image = _image(5)
    n_new = 12
    base = _engine(weights)
    try:
        never = _run(base, [ModelRequest(input_ids=PROMPT, gconfig=_greedy(n_new),
                                         image_data=[image])])[0]
    finally:
        base.destroy()
    tier = dict(kv_host_pool_mb=4) if move != "miss" else {}
    src = _engine(weights, new_tokens_per_chunk=2, **tier)
    dst = _engine(weights, new_tokens_per_chunk=2) if move == "migrate" else src
    try:
        item = _park(src, "v", PROMPT, image, 2, n_new)
        slot = src._parked["v"][0]
        assert int(src._slot_rope_delta[slot]) == -2
        atol = 1e-6
        if move == "host_tier":
            with src._sched_lock:
                src._evict_parked_lru()
            entry = src._host_store.peek("v")
            assert entry.rope_delta == -2 and entry.image and not entry.block_keys
        elif move == "migrate":
            chain = set(kv_fabric.chain_keys(PROMPT[:-1] + item.tokens, 16, 0, "fp"))
            sess = src.export_session("v", refetchable=chain)
            assert not sess["meta"].get("meta_only") and sess["meta"]["rope_delta"] == -2
            assert sess["meta"]["image"] is True
            assert dst.import_session(sess["meta"], sess["k"], sess["v"]) == "ok"
            landed = dst._host_store.peek("v")
            assert landed.image and not landed.block_keys
        else:
            with src._sched_lock:
                src._evict_parked_lru()  # no tier: dropped
            atol = 1e-5
        before = dst._n_prefills
        out = _resume(dst, "v", PROMPT, item, image, n_new)
        assert dst._n_prefills == before + (1 if move == "miss" else 0)
        assert item.tokens + out.output_tokens == never.output_tokens
        np.testing.assert_allclose(item.logprobs + out.output_logprobs,
                                   never.output_logprobs, atol=atol, rtol=0)
        assert int(dst._slot_rope_delta.min()) == -2
    finally:
        src.destroy()
        if dst is not src:
            dst.destroy()


def test_image_session_without_a_delta_stays_out_of_the_fabric(weights):
    """A tower with no m-rope sections gives an image slot 1-D positions
    and rope delta 0: the slot's image flag alone keeps its KV out of the
    fabric index, off the identity-only drain, and out of the importer's
    index."""
    def engine():
        eng = TorchDecodeEngine(TorchDecodeConfig(
            context_length=64, max_running_requests=2, new_tokens_per_chunk=2,
            kv_cache_dtype="float32", page_size=16, kv_host_pool_mb=4), device="cpu")
        eng.set_model(weights[2], TCFG)
        eng.set_vision_model(weights[3], TVIS, IMG)
        return eng.initialize()

    src, dst = engine(), engine()
    try:
        prompt = PROMPT + [int(x) for x in np.random.RandomState(2).randint(1, 60, 20)]
        item = _park(src, "v", prompt, _image(5), 2, 8)
        slot = src._parked["v"][0]
        assert int(src._slot_rope_delta[slot]) == 0 and src._slot_image[slot]
        assert not src._fabric_dev and not src._prefix_lookup
        with src._sched_lock:
            src._evict_parked_lru()
        entry = src._host_store.peek("v")
        assert entry.image and entry.rope_delta == 0 and not entry.block_keys
        chain = set(kv_fabric.chain_keys(entry.tokens, 16, 0, "fp"))
        assert chain
        sess = src.export_session("v", refetchable=chain)
        assert not sess["meta"].get("meta_only") and sess["meta"]["image"] is True
        assert dst.import_session(sess["meta"], sess["k"], sess["v"]) == "ok"
        landed = dst._host_store.peek("v")
        assert landed.image and not landed.block_keys
        assert len(item.tokens) + len(_resume(dst, "v", prompt, item, _image(5), 8)
                                      .output_tokens) == 8
    finally:
        src.destroy()
        dst.destroy()


def test_image_slot_under_spec_decode_equals_spec_off(weights):
    """Image 10's greedy stream repeats itself, so the drafter proposes
    and the verify forward accepts drafts (image 6's accepts none)."""
    image = _image(10)
    prompt = [5, IMG, IMG, IMG, IMG, 9, 2, 5, 9, 2, 5, 9]
    outs = []
    for spec in ({}, dict(spec_decode="ngram", spec_k=3)):
        eng = _engine(weights, **spec)
        try:
            outs.append(_run(eng, [ModelRequest(input_ids=prompt, gconfig=_greedy(16),
                                                image_data=[image])])[0])
            if spec:
                assert eng.verify_dispatches > 0 and eng.spec_accepted > 0
        finally:
            eng.destroy()
    assert outs[0].output_tokens == outs[1].output_tokens
    np.testing.assert_allclose(outs[0].output_logprobs, outs[1].output_logprobs, atol=1e-5)


def test_image_prefill_into_an_int8_pool(weights):
    image = _image(7)
    eng = _engine(weights, kv_dtype="int8")
    try:
        out = _run(eng, [ModelRequest(input_ids=PROMPT, gconfig=_greedy(6),
                                      image_data=[image])])[0]
        assert len(out.output_tokens) == 6 and np.isfinite(out.output_logprobs).all()
        assert eng._k_pool.dtype == torch.int8 and eng._k_scale.abs().sum() > 0
        assert int(eng._slot_rope_delta.min()) == -2
    finally:
        eng.destroy()


# ---------------------------------------------------------------------------
# rewards, workflow, payload, entry point
# ---------------------------------------------------------------------------

COMPLETIONS = [
    ("There are <answer>3</answer> objects.", "3"), ("I count \\boxed{4}", "4"),
    ("<answer>three</answer>", "3"), ("The answer is 2", "3"), (None, "1"),
    ("<answer>x = 12</answer>", "12"), ("so \\boxed{\\frac{1}{2}}", "0.5"),
    ("<answer> b </answer>", "B"), ("\\boxed{C}", "D"), ("<answer>-2</answer>", "-2"),
]


@pytest.mark.parametrize("name", ["clevr_count_reward", "geometry3k_reward",
                                  "synthetic_vision_reward"])
def test_rewards_equal_jax(name):
    t, j = getattr(tvqa, name), getattr(jvqa, name)

    def call(fn, *args, **data):  # the value, or the error's type (both raise alike)
        try:
            return fn(*args, **data)
        except Exception as e:  # noqa: BLE001 — compared below
            return type(e)

    for completion, answer in COMPLETIONS:
        ids = [1, 2, int(answer)] if answer.lstrip("-").isdigit() else [1, 2]
        for data in (dict(answer=answer), dict(answer=None), {}):
            assert call(t, None, completion, [], ids, **data) == call(
                j, None, completion, [], ids, **data)
    assert t(None, "<answer>3</answer>", [], [3], answer="3") == 1.0


class _Scripted:
    """An engine answering every request with fixed tokens, recording the
    requests."""

    def __init__(self, resp_cls):
        self.reqs = []
        self.resp_cls = resp_cls

    async def agenerate(self, req):
        self.reqs.append(req)
        return self.resp_cls(input_tokens=list(req.input_ids), output_tokens=[3, 2],
                             output_logprobs=[-0.5, -0.25], output_versions=[4, 4],
                             stop_reason="stop")

    def get_version(self):
        return 4


def test_workflow_against_a_scripted_engine_equals_jax():
    """Offline items (pre-tokenized, processed patch dicts): both
    workflows send the patch dicts with the prompt and build the same
    batch; a processor, when given, renders the prompt and processes the
    images, and its patches go instead."""
    from areal_tpu_torch.dataset import get_custom_dataset

    item = get_custom_dataset("synthetic-vision", split="test", n_items=1)[0]
    batches, sent = [], []
    for wf_cls, gen, resp in ((VisionRLVRWorkflow, GenerationHyperparameters, ModelResponse),
                              (JWorkflow, JGen, JResponse)):
        eng = _Scripted(resp)
        wf = wf_cls(reward_fn=tvqa.synthetic_vision_reward, gconfig=gen(n_samples=2))
        batches.append(asyncio.run(wf.arun_episode(eng, item)))
        sent.append(eng.reqs)
    for t, j in zip(*sent):
        assert t.input_ids == j.input_ids == item["input_ids"]
        assert t.image_data[0] is item["images"][0] and j.image_data[0] is item["images"][0]
        assert t.gconfig.n_samples == 1
    assert set(batches[0]) == set(batches[1])
    for k in batches[0]:
        np.testing.assert_array_equal(np.asarray(batches[0][k]), np.asarray(batches[1][k]))
    assert float(np.asarray(batches[0]["rewards"]).max()) == float(item["answer"] in ("2", "3"))

    class Proc:
        def apply_chat_template(self, msgs, **kw):
            return "chat:" + msgs[0]["content"][1]["text"]

        def __call__(self, text, images, return_tensors):
            return dict(input_ids=np.array([[1, 2, IMG, 5]]),
                        pixel_values=np.ones((4, 12), np.float32),
                        image_grid_thw=np.array([[1, 2, 2]]))

    msgs = [{"role": "user", "content": [{"type": "image"}, {"type": "text", "text": "n?"}]}]
    eng = _Scripted(ModelResponse)
    wf = VisionRLVRWorkflow(reward_fn=tvqa.clevr_count_reward,
                            gconfig=GenerationHyperparameters(n_samples=1), processor=Proc())
    asyncio.run(wf.arun_episode(eng, dict(messages=msgs, images=["raw"], answer="2")))
    req = eng.reqs[0]
    assert req.input_ids == [1, 2, IMG, 5]
    assert req.image_data[0]["pixel_values"].shape == (4, 12)


def test_payload_base64_encodes_images_as_jax():
    raw = b"\x89PNG-bytes"
    enc = base64.b64encode(raw).decode()
    for imgs in ([raw, enc], None):
        t = RemoteBackend().build_generate_payload(
            ModelRequest(rid="r", input_ids=[1, 2], image_data=imgs))
        j = JBackend().build_generate_payload(JRequest(rid="r", input_ids=[1, 2],
                                                       image_data=imgs))
        assert t == j
    assert t.get("image_data") is None
    # processed patch dicts do not cross the wire, in either package
    for backend, req in ((RemoteBackend(), ModelRequest(image_data=[_image(1)])),
                         (JBackend(), JRequest(image_data=[_image(1)]))):
        with pytest.raises(TypeError, match="image_data entries"):
            backend.build_generate_payload(req)


@pytest.mark.parametrize("route", ["/generate", "/prefill"])
def test_server_routes_pass_image_data(weights, route):
    """A port `DecodeServer` hands `body["image_data"]` (patch dicts as
    JSON lists) to its engine on `/generate` and `/prefill`: the image
    request's greedy tokens equal the engine's in process, and its prefill
    parks a slot with the image's rope delta."""
    from areal_tpu_torch.launcher.decode_server import DecodeServer
    from areal_tpu_torch.utils.http import request_with_retry

    image = _image(3)
    eng = _engine(weights)
    srv = DecodeServer(eng.config, engine=eng)
    addr = srv.start("127.0.0.1", 0)
    try:
        want = _run(eng, [ModelRequest(input_ids=PROMPT, gconfig=_greedy(6),
                                       image_data=[image])])[0]
        body = dict(rid="img", input_ids=PROMPT,
                    gconfig=dict(greedy=True, max_new_tokens=6),
                    image_data=[{k: v.tolist() for k, v in image.items()}])
        out = request_with_retry(addr, route, payload=body, max_retries=1, timeout=120)
        if route == "/generate":
            assert out["output_tokens"] == want.output_tokens
        else:
            assert out["stop_reason"] == "prefill"
            assert int(eng._slot_rope_delta[eng._parked["img"][0]]) == -2
    finally:
        srv.stop()
        eng.destroy()


def test_clevr_grpo_offline_recipe_one_step(tmp_path):
    """The JAX docstring's offline recipe on the CPU, cut to one step of 2
    prompts x 2 samples: the smoke tower serves every image request, the
    trainer steps on token-only batches."""
    from areal_tpu_torch.examples.clevr_grpo import main

    history = main(["--config", "examples/configs/clevr_grpo.yaml",
                    "tokenizer_path=synthetic-arith", "train_dataset.path=synthetic-vision",
                    "actor.path=", "decode.model_path=", "actor.init_from_scratch=true",
                    f"cluster.fileroot={tmp_path}", "total_train_steps=1",
                    "train_dataset.batch_size=2", "gconfig.n_samples=2",
                    "gconfig.max_new_tokens=8", "actor.group_size=2", "actor.dtype=float32",
                    "decode.context_length=64", "decode.max_running_requests=4",
                    "decode.new_tokens_per_chunk=4", "rollout.consumer_batch_size=2",
                    "rollout.max_concurrent_rollouts=4", "actor.mb_spec.max_tokens_per_mb=256",
                    "saver.freq_epochs=null", "recover.mode=disabled",
                    "evaluator.freq_steps=null", "decode.dtype=float32"],
                   device="cpu")
    assert len(history) == 1
    stats = history[0]["stats"][0]
    assert np.isfinite(stats["grpo_actor/loss"])
    batch = history[0]["batch"]
    ids = np.asarray(batch["input_ids"])
    assert ids.shape[0] == 4 and (ids == 31).sum(axis=1).min() == 4


# ---------------------------------------------------------------------------
# a VLM checkpoint: the engine's own tower load and the loop on it
# ---------------------------------------------------------------------------

VL_HF = dict(model_type="qwen2", vocab_size=64, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             tie_word_embeddings=False,
             rope_scaling={"type": "mrope", "mrope_section": list(SECTIONS)},
             image_token_id=IMG,
             vision_config=dict(hidden_size=16, depth=2, num_heads=2, intermediate_size=32,
                                patch_size=2, temporal_patch_size=1, spatial_merge_size=2,
                                out_hidden_size=32))


@pytest.fixture(scope="module")
def vl_checkpoint(weights, tmp_path_factory):
    """A Qwen2.5-VL-layout checkpoint: TEXT's weights written as
    model_type "qwen2" with m-rope and the image token, and a 2-block
    Qwen2.5-VL tower under its HF `visual.*` names (chip_smoke's writer)."""
    import json

    import chip_smoke
    from areal_tpu_torch.models import hf_io

    d = tmp_path_factory.mktemp("vl_ckpt")
    cfg = tq.ModelConfig.from_hf_config(VL_HF, dtype="float32", param_dtype="float32")
    hf_io.save_hf_params(weights[2], cfg, str(d))
    vcfg = tv.VisionConfig.from_hf_dict(VL_HF["vision_config"])
    vparams = tv.init_vision_params(vcfg, torch.Generator().manual_seed(9))
    hf_io.write_safetensors(chip_smoke._vl_hf_visual(vparams, vcfg),
                            str(d / "visual.safetensors"))
    names = list(hf_io.read_safetensors(str(d / "model.safetensors")))
    names_v = list(hf_io.read_safetensors(str(d / "visual.safetensors")))
    (d / "model.safetensors.index.json").write_text(json.dumps(dict(
        metadata={}, weight_map={**{n: "model.safetensors" for n in names},
                                 **{n: "visual.safetensors" for n in names_v}})))
    (d / "config.json").write_text(json.dumps(VL_HF))
    return str(d), vcfg, vparams


def test_engine_loads_a_qwen25_vl_checkpoint_tower(weights, vl_checkpoint):
    """`initialize` on the checkpoint installs its tower (the
    vision_config's own width; the JAX engine lays the language width
    over a Qwen2.5-VL tower's `hidden_size`), its m-rope sections and image
    token, and serves an image request as the in-memory tower does."""
    path, vcfg, vparams = vl_checkpoint
    vc = VL_HF["vision_config"]
    assert jv.VisionConfig.from_hf_dict({**vc, "hidden_size": 32}).embed_dim == 32  # JAX's
    eng = TorchDecodeEngine(TorchDecodeConfig(model_path=path, dtype="float32",
                                              kv_cache_dtype="float32", context_length=64,
                                              max_running_requests=2, page_size=16),
                            device="cpu").initialize()
    mem = TorchDecodeEngine(TorchDecodeConfig(context_length=64, max_running_requests=2,
                                              kv_cache_dtype="float32", page_size=16),
                            device="cpu")
    mem.set_model(weights[2], TCFG)
    mem.set_vision_model(vparams, vcfg, IMG, mrope_sections=SECTIONS)
    mem.initialize()
    try:
        assert eng._vision_config == vcfg and vcfg.embed_dim == 16
        assert eng._mrope_sections == SECTIONS and eng._image_token_id == IMG
        for name, t in vparams.items():
            assert torch.equal(eng._vision_params[name], t), name
        req = ModelRequest(input_ids=PROMPT, gconfig=_greedy(6), image_data=[_image(3)])
        a, b = _run(eng, [req.copy()])[0], _run(mem, [req.copy()])[0]
        assert a.output_tokens == b.output_tokens
        assert int(eng._slot_rope_delta.min()) == -2
    finally:
        eng.destroy()
        mem.destroy()


def _oracle_logps(weights, vl_checkpoint, prompt, tokens, image) -> tuple:
    """Each of `tokens`' logprob after `prompt` from one dense prefill of
    prompt + tokens[:-1] (plain attention, no kernel): (the decode
    engine's view: the tower's vectors spliced over the image-pad
    positions and m-rope tables; the trainer's view: token embeddings
    and 1-D positions)."""
    _, vcfg, vparams = vl_checkpoint
    seq = list(prompt) + list(tokens[:-1])
    ids = torch.as_tensor(seq)
    thw = np.asarray(image["image_grid_thw"]).reshape(-1, 3)
    with torch.no_grad():
        img = tv.forward_vision(vparams, torch.as_tensor(image["pixel_values"]),
                                torch.as_tensor(tv.patch_grid_coords(thw, 2)), vcfg)
        splice_ids = ids.clone()
        splice_ids[len(prompt):] = 0  # generated tokens never splice
        embeds = tv.splice_image_embeds(weights[2]["embed/embedding"][ids], splice_ids, img, IMG)
        pos3, _ = tv.mrope_positions(np.asarray(seq), thw, IMG, 2)
        cos, sin = tv.mrope_table(pos3, HD, TCFG.rope_theta, SECTIONS)
        views = [tq.prefill(weights[2], ids, torch.arange(len(seq)), TCFG, input_embeds=embeds,
                            rope_cos=cos, rope_sin=sin)[0],
                 tq.prefill(weights[2], ids, torch.arange(len(seq)), TCFG)[0]]
        want = torch.as_tensor(tokens)[:, None]
        return tuple(torch.log_softmax(lg[len(prompt) - 1:], -1).gather(1, want)[:, 0].numpy()
                     for lg in views)


def test_vision_loop_on_a_checkpoint(weights, vl_checkpoint, tmp_path):
    """The GRPO entry point with `workflow=vision_rlvr`, `actor.path` and
    `decode.model_path` on the checkpoint: the colocated engine installs
    the checkpoint's tower (the JAX example's colocated engine installs
    none), and a step trains on image rollouts. Under the decoupled loss,
    at each trained position the batch's `logprobs` (rolled by
    `compute_advantages`) are the decode engine's logprobs of the next
    token with the image (the plain oracle's, atol 1e-5) and `prox_logp`
    the trainer's, token-only with 1-D positions (atol 1e-5): the two
    differ by the image alone, and a one-token shift matches neither."""
    from areal_tpu_torch.dataset import register_dataset
    from areal_tpu_torch.examples.gsm8k_grpo import main

    path = vl_checkpoint[0]

    @register_dataset("test-vision-ckpt")
    def _items(path, split, type, tokenizer=None, max_length=None, **kw):
        # the last prompt token names the item's image
        return [dict(input_ids=[5, IMG, IMG, IMG, IMG, 9, 10 + i],
                     images=[_image(i)], answer=str(i % 4 + 1)) for i in range(4)]

    history = main(["--config", "examples/configs/clevr_grpo.yaml", "workflow=vision_rlvr",
                    "tokenizer_path=synthetic-arith", "train_dataset.path=test-vision-ckpt",
                    f"actor.path={path}", f"decode.model_path={path}",
                    "actor.init_from_scratch=false", f"cluster.fileroot={tmp_path}",
                    "total_train_steps=1", "train_dataset.batch_size=2", "gconfig.n_samples=2",
                    "gconfig.max_new_tokens=6", "actor.group_size=2", "actor.dtype=float32",
                    "decode.dtype=float32", "decode.kv_cache_dtype=float32",
                    "decode.context_length=64", "decode.max_running_requests=4",
                    "decode.new_tokens_per_chunk=4", "rollout.consumer_batch_size=2",
                    "actor.mb_spec.max_tokens_per_mb=256", "saver.freq_epochs=null",
                    "recover.mode=disabled", "evaluator.freq_steps=null",
                    "actor.use_decoupled_loss=true"],
                   reward_fn=tvqa.synthetic_vision_reward, device="cpu")
    assert len(history) == 1 and np.isfinite(history[0]["stats"][0]["grpo_actor/loss"])
    batch = history[0]["batch"]
    ids = np.asarray(batch["input_ids"])
    assert ids.shape[0] == 4 and ((ids == IMG).sum(axis=1) == 4).all()
    gaps, shifted = [], []
    for i in range(ids.shape[0]):
        n, p = int(batch["attention_mask"][i].sum()), int(batch["begin_of_answer"][i])
        at = np.arange(p - 1, n - 1)  # position t predicts token t + 1
        assert (batch["loss_mask"][i, at] == 1).all() and batch["loss_mask"][i].sum() == len(at)
        seen, text = _oracle_logps(weights, vl_checkpoint, ids[i, :p].tolist(),
                                   ids[i, p:n].tolist(), _image(int(ids[i, p - 1]) - 10))
        np.testing.assert_allclose(batch["logprobs"][i, at], seen, atol=1e-5, rtol=0)
        np.testing.assert_allclose(batch["prox_logp"][i, at], text, atol=1e-5, rtol=0)
        gaps.append(np.abs(seen - text).mean())
        shifted.append(np.abs(batch["logprobs"][i, at + 1] - seen).mean())
    assert min(gaps) > 1e-2 and min(shifted) > 1e-2
