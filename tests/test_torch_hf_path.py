"""HF checkpoints from local paths: the port against transformers and the JAX package.

Tiny `Qwen2ForCausalLM` models built with transformers and written with
`save_pretrained` (tied and untied heads; one file, and shards under a
`model.safetensors.index.json`; f32, and bf16 as HF ships it), a tied
checkpoint that carries `lm_head.weight` anyway, and Llama and Mistral
models (the qwen2 names without q/k/v biases) are read by both packages;
the families JAX loads and the port does not are refused with item 6.
Tolerances: the loaded tensors bit for bit; f32 logits atol
2e-3 / rtol 1e-3 against transformers (as `tests/test_model_qwen2.py`)
and atol 1e-5 against JAX; `compute_logp` of engines built from the path
atol 1e-5; greedy tokens of decode engines and of the decode server
started with `--model-path` exactly.
"""

import asyncio
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api import cli_args as jargs
from areal_tpu.api.alloc_mode import ParallelStrategy as JaxParallelStrategy
from areal_tpu.api.io_struct import FinetuneSpec as JaxFinetuneSpec
from areal_tpu.api.io_struct import ModelRequest as JaxModelRequest
from areal_tpu.engine.jax_decode import JaxDecodeEngine
from areal_tpu.engine.ppo.actor import JaxPPOActor
from areal_tpu.models import hf_io as jhf
from areal_tpu.models import qwen2 as jq
from areal_tpu_torch.api import cli_args as targs
from areal_tpu_torch.api.io_struct import FinetuneSpec, ModelRequest, SaveLoadMeta
from areal_tpu_torch.engine.ppo.actor import TorchPPOActor
from areal_tpu_torch.engine.ppo.critic import TorchPPOCritic
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.models import hf_io as thf
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import unstack_layers

ROOT = Path(__file__).resolve().parents[1]
HF = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
          rope_theta=10000.0, rms_norm_eps=1e-6)
# name -> (tied head, shard size for save_pretrained or None, dtype on disk)
KINDS = {
    "untied_single": (False, None, torch.float32),
    "untied_sharded": (False, "40KB", torch.float32),
    "tied_single": (True, None, torch.float32),
    "tied_sharded_bf16": (True, "40KB", torch.bfloat16),
}
FAMILIES = ("llama", "mistral")
F32_KINDS = [k for k, v in KINDS.items() if v[2] == torch.float32] + list(FAMILIES)
ACTOR = dict(experiment_name="", trial_name="", init_from_scratch=False, dtype="float32",
             gradient_checkpointing=False, group_size=2, ppo_n_minibatches=1,
             kl_ctl=0.0, use_decoupled_loss=True, recompute_logprob=True, temperature=1.0)


def _hf_model(tied: bool, seed: int, family: str = "qwen2"):
    import transformers

    prefix = {"qwen2": "Qwen2", "llama": "Llama", "mistral": "Mistral"}[family]
    extra = dict(sliding_window=None) if family == "mistral" else {}
    cfg = getattr(transformers, f"{prefix}Config")(
        **HF, **extra, tie_word_embeddings=tied, attn_implementation="eager")
    torch.manual_seed(seed)
    return getattr(transformers, f"{prefix}ForCausalLM")(cfg).eval().float()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{kind: (directory, the transformers model)}, and "tied_with_head":
    the tied f32 checkpoint with `lm_head.weight` written beside it."""
    root = tmp_path_factory.mktemp("hf")
    out = {}
    for i, (kind, (tied, shard, dtype)) in enumerate(KINDS.items()):
        model = _hf_model(tied, seed=i)
        d = root / kind
        kw = dict(max_shard_size=shard) if shard else {}
        model.to(dtype).save_pretrained(d, safe_serialization=True, **kw)
        out[kind] = (str(d), model.float())
    d = root / "tied_with_head"
    d.mkdir()
    src = Path(out["tied_single"][0])
    (d / "config.json").write_text((src / "config.json").read_text())
    tensors = thf.read_safetensors(str(src / "model.safetensors"))
    assert "lm_head.weight" not in tensors
    tensors["lm_head.weight"] = tensors["model.embed_tokens.weight"].clone()
    thf.write_safetensors(tensors, str(d / "model.safetensors"))
    out["tied_with_head"] = (str(d), out["tied_single"][1])
    # the families that share qwen2's tensor names (no q/k/v biases)
    for i, family in enumerate(FAMILIES):
        model = _hf_model(False, seed=10 + i, family=family)
        model.save_pretrained(root / family, safe_serialization=True)
        out[family] = (str(root / family), model)
    return out


def test_checkpoints_have_the_intended_layout(ckpts):
    for kind, (tied, shard, dtype) in KINDS.items():
        d = Path(ckpts[kind][0])
        index = d / "model.safetensors.index.json"
        assert index.exists() == bool(shard), kind
        if shard:
            assert len(set(json.loads(index.read_text())["weight_map"].values())) >= 2
        names = {n for n, _ in thf._iter_hf_tensors(str(d))}
        assert ("lm_head.weight" in names) == (not tied), kind
        stored = {t.dtype for _, t in thf._iter_hf_tensors(str(d))}
        assert stored == {dtype}, kind


def _configs(d: str, dtype: str):
    kw = dict(dtype=dtype, param_dtype=dtype)
    return (tq.ModelConfig.from_hf_config(d, scan_layers=False, **kw),
            jq.ModelConfig.from_hf_config(d, **kw))


@pytest.mark.parametrize("kind", [*KINDS, "tied_with_head", *FAMILIES])
def test_load_hf_params_bit_equal_to_jax(ckpts, kind):
    d = ckpts[kind][0]
    dtype = "bfloat16" if kind.endswith("bf16") else "float32"
    tcfg, jcfg = _configs(d, dtype)
    assert tcfg.tie_word_embeddings == jcfg.tie_word_embeddings
    ours = thf.load_hf_params(d, tcfg)
    want = tq.flatten_names(unstack_layers(jhf.load_hf_params(d, jcfg)))
    assert set(ours) == set(want)
    assert ("lm_head/kernel" in ours) == (not tcfg.tie_word_embeddings)
    for name, t in ours.items():
        w = np.asarray(want[name])
        assert t.dtype == tq.torch_dtype(dtype) and tuple(t.shape) == w.shape, name
        view = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
        assert np.array_equal(t.view(view).numpy(), w.view(np.int16 if view == torch.int16
                                                             else np.int32)), name


@pytest.mark.parametrize("kind", [*F32_KINDS, "tied_with_head"])
def test_logits_match_transformers_and_jax(ckpts, kind):
    d, model = ckpts[kind]
    tcfg, jcfg = _configs(d, "float32")
    T = 12
    ids = np.random.RandomState(1).randint(0, HF["vocab_size"], T)
    with torch.no_grad():
        hf_logits = model(torch.tensor(ids)[None]).logits[0].numpy()
        ours = tq.forward(thf.load_hf_params(d, tcfg), torch.tensor(ids), torch.arange(T),
                          torch.zeros(T, dtype=torch.int32), tcfg).numpy()
    jax_logits = np.asarray(jq.forward(jhf.load_hf_params(d, jcfg), ids, np.arange(T),
                                       np.zeros(T, np.int32), jcfg))
    np.testing.assert_allclose(ours, hf_logits, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(ours, jax_logits, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hf", [
    dict(model_type="gemma"),
    dict(model_type="gpt2", n_embd=64, n_layer=2, n_head=4, n_positions=256),
    dict(model_type="qwen2", use_sliding_window=True, sliding_window=64, max_window_layers=0),
    dict(model_type="mistral", sliding_window=64),
])
def test_other_families_are_refused(hf):
    """JAX loads these; the port refuses them with item 6 (model breadth).
    Qwen3 and the MoE families load since they were ported
    (tests/test_torch_model_families.py)."""
    base = dict(HF, num_hidden_layers=2)
    with pytest.raises(NotImplementedError, match="item 6"):
        tq.ModelConfig.from_hf_config(dict(base, **hf))
    jq.ModelConfig.from_hf_config(dict(base, **hf))


def _logp_batch(vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    B, T = 4, 14
    lens = np.array([14, 11, 9, 12])
    attn = (np.arange(T)[None] < lens[:, None]).astype(np.int64)
    return dict(input_ids=rng.integers(0, vocab, (B, T)) * attn, attention_mask=attn,
                loss_mask=attn.astype(np.int32), rewards=np.zeros(B, np.float32),
                logprobs=np.zeros((B, T), np.float32))


@pytest.mark.parametrize("kind", ["untied_sharded", "tied_single"])
def test_actor_from_path_matches_jax(ckpts, cpu_devices, kind):
    """`TorchPPOActor` and `JaxPPOActor` built from the same `path` (the
    model config from its config.json, the weights from its shards)
    give equal `compute_logp` (atol 1e-5)."""
    d = ckpts[kind][0]

    def cfg(mod):
        return mod.PPOActorConfig(**ACTOR, path=d,
                                  mb_spec=mod.MicroBatchSpec(max_tokens_per_mb=32))

    jactor = JaxPPOActor(cfg(jargs))
    jactor.create_process_group(JaxParallelStrategy(data_parallel_size=8))
    jactor.initialize(None, JaxFinetuneSpec(1, 8, 4))
    tactor = TorchPPOActor(cfg(targs), device="cpu")
    tactor.create_process_group()
    tactor.initialize(None, FinetuneSpec(1, 8, 4))
    assert tactor.model_config.tie_word_embeddings == (kind == "tied_single")
    batch = _logp_batch(HF["vocab_size"])
    np.testing.assert_allclose(tactor.compute_logp(dict(batch)),
                               np.asarray(jactor.compute_logp(dict(batch))), atol=1e-5, rtol=0)
    jactor.destroy()
    tactor.destroy()


def test_save_then_load_by_path_round_trips(ckpts, tmp_path):
    """An engine loaded from a path, saved as "hf" (config.json copied from
    the path) and loaded again by path holds the same tensors bit for bit."""
    d = ckpts["tied_sharded_bf16"][0]
    cfg = targs.PPOActorConfig(**dict(ACTOR, dtype="bfloat16"), path=d)
    a = TorchPPOActor(cfg, device="cpu")
    a.create_process_group()
    a.initialize(None, FinetuneSpec(1, 8, 4))
    out = str(tmp_path / "export")
    a.save(SaveLoadMeta(path=out, weight_format="hf"))
    assert json.loads(Path(out, "config.json").read_text()) == json.loads(
        Path(d, "config.json").read_text())
    b = TorchPPOActor(targs.PPOActorConfig(**dict(ACTOR, dtype="bfloat16"), path=out),
                      device="cpu")
    b.create_process_group()
    b.initialize(None, FinetuneSpec(1, 8, 4))
    assert set(a.params) == set(b.params)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def test_critic_from_a_causal_lm_starts_from_a_zero_value_head(ckpts):
    d = ckpts["untied_single"][0]
    cfg = targs.PPOCriticConfig(path=d, init_from_scratch=False, dtype="float32",
                                mb_spec=targs.MicroBatchSpec(max_tokens_per_mb=32))
    critic = TorchPPOCritic(cfg, device="cpu")
    critic.create_process_group()
    critic.initialize(None, FinetuneSpec(1, 8, 4))
    assert critic.model_config.is_critic
    assert "lm_head/kernel" not in critic.params
    assert not critic.params["value_head/kernel"].any()
    assert not critic.params["value_head/bias"].any()
    trunk = thf.load_hf_params(d, _configs(d, "float32")[0])
    for k, t in trunk.items():
        if not k.startswith("lm_head"):
            assert torch.equal(critic.params[k], t), k
    values = critic.compute_values(_logp_batch(HF["vocab_size"]))
    assert np.all(values == 0.0)


PROMPTS = [[5, 9, 2, 40, 3], [7, 7, 1], [60, 2, 33, 18, 4, 90, 11]]
N_NEW = 10
DECODE = dict(context_length=128, max_running_requests=4, page_size=16,
              new_tokens_per_chunk=8, dtype="float32", kv_cache_dtype="float32")


def _greedy_tokens(engine, gconfig, request_cls) -> list[list[int]]:
    async def run():
        return await asyncio.gather(*[
            engine.agenerate(request_cls(input_ids=list(p), gconfig=gconfig))
            for p in PROMPTS])

    return [r.output_tokens for r in asyncio.run(run())]


@pytest.fixture(scope="module")
def jax_greedy(ckpts, cpu_devices):
    """The JAX engine's greedy tokens from `model_path` (untied, sharded)."""
    d = ckpts["untied_sharded"][0]
    eng = JaxDecodeEngine(jargs.JaxDecodeConfig(model_path=d, **DECODE),
                          jargs.InferenceEngineConfig())
    eng.initialize()
    try:
        return _greedy_tokens(eng, jargs.GenerationHyperparameters(
            max_new_tokens=N_NEW, greedy=True), JaxModelRequest)
    finally:
        eng.destroy()


def test_decode_engine_from_model_path_matches_jax(ckpts, jax_greedy):
    d = ckpts["untied_sharded"][0]
    eng = TorchDecodeEngine(targs.TorchDecodeConfig(model_path=d, **DECODE), device="cpu")
    eng.initialize()
    try:
        assert eng.model_config.dtype == "float32"
        ours = _greedy_tokens(eng, targs.GenerationHyperparameters(
            max_new_tokens=N_NEW, greedy=True), ModelRequest)
    finally:
        eng.destroy()
    assert ours == jax_greedy
    assert all(len(t) == N_NEW for t in ours)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_server_with_model_path_answers_with_the_jax_tokens(ckpts, jax_greedy):
    """`python -m areal_tpu_torch.launcher.decode_server --model-path <dir>
    --device cpu` serves the checkpoint; with no tokenizer in the
    directory the load is logged and the server runs on."""
    d = ckpts["untied_sharded"][0]
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), HF_HUB_OFFLINE="1",
               TRANSFORMERS_OFFLINE="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "areal_tpu_torch.launcher.decode_server", "--model-path", d,
         "--dtype", "float32", "--context-length", "128", "--max-running-requests", "4",
         "--new-tokens-per-chunk", "8", "--device", "cpu", "--host", "127.0.0.1",
         "--port", str(port)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(base + "/health", timeout=2) as r:
                    if json.loads(r.read())["status"] == "ok":
                        break
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(proc.stdout.read()) from None
                time.sleep(0.3)
        out = [_post(base + "/generate", dict(input_ids=p, gconfig=dict(
            max_new_tokens=N_NEW, greedy=True)))["output_tokens"] for p in PROMPTS]
    finally:
        proc.terminate()
        log = proc.communicate(timeout=30)[0]
    assert out == jax_greedy
    assert "tokenizer load failed" in log
