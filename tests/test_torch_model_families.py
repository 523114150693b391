"""Qwen3 and the MoE families from HF configs and checkpoints: the port
against transformers and the JAX package.

`ModelConfig.from_hf_config` field for field against JAX's for qwen3,
qwen3_moe, qwen2_moe and mixtral (tiny configs, the published
Qwen3-30B-A3B and Qwen1.5-MoE-A2.7B configs, and the families' defaults),
and its refusals beside JAX's. Tiny transformers models of each family
(written with `save_pretrained`) load bit for bit as JAX's loader loads
them; their logits match transformers (atol 2e-3 / rtol 1e-3, f32, as
`tests/test_model_families.py`) and JAX (atol 1e-5), with
`capacity_factor` = E / K so that no pick is dropped: HF routes without a
capacity, the JAX package with one (ROADMAP.md queue 3). The port's
writer writes JAX's tensors (names, dtypes, bits) under each family's
names, Mixtral's `w1/w3/w2` included, and reads them back; an expert
outside the model's E, or missing from a stack, is refused. A decode
server started with `--model-path` on a qwen3_moe checkpoint answers
with the JAX engine's greedy tokens, one request at a time.
"""

import asyncio
import dataclasses
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
from areal_tpu.api.io_struct import ModelRequest as JaxModelRequest
from areal_tpu.engine.jax_decode import JaxDecodeEngine
from areal_tpu.models import hf_io as jhf
from areal_tpu.models import qwen2 as jq
from areal_tpu_torch.models import hf_io as thf
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.smoke import QWEN3_30B_A3B_HF, QWEN15_MOE_A27B_HF

ROOT = Path(__file__).resolve().parents[1]
BASE = dict(vocab_size=96, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False)
HF_FAMILIES = {
    "qwen3": ("Qwen3", dict(head_dim=8)),
    "qwen3_moe": ("Qwen3Moe", dict(head_dim=8, num_experts=4, num_experts_per_tok=2,
                                   moe_intermediate_size=16, norm_topk_prob=True,
                                   decoder_sparse_step=1, mlp_only_layers=[])),
    "qwen2_moe": ("Qwen2Moe", dict(num_experts=4, num_experts_per_tok=2,
                                   moe_intermediate_size=16,
                                   shared_expert_intermediate_size=24, norm_topk_prob=False,
                                   decoder_sparse_step=1, mlp_only_layers=[])),
    "mixtral": ("Mixtral", dict(num_local_experts=4, num_experts_per_tok=2,
                                sliding_window=None)),
}


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

CONFIG_CASES = {
    "qwen3": dict(BASE, model_type="qwen3", head_dim=8),
    "qwen3_moe": dict(BASE, model_type="qwen3_moe", head_dim=8, num_experts=4,
                      num_experts_per_tok=2, moe_intermediate_size=16,
                      router_aux_loss_coef=0.001),
    "qwen3_moe-defaults": dict(BASE, model_type="qwen3_moe"),
    "qwen2_moe": dict(BASE, model_type="qwen2_moe", num_experts=4, num_experts_per_tok=2,
                      moe_intermediate_size=16, shared_expert_intermediate_size=24),
    "qwen2_moe-defaults": dict(BASE, model_type="qwen2_moe", moe_intermediate_size=16),
    "mixtral": dict(BASE, model_type="mixtral", num_local_experts=4, num_experts_per_tok=2,
                    router_aux_loss_coef=0.02),
    "mixtral-defaults": dict(BASE, model_type="mixtral"),
    "qwen3_moe-unwindowed": dict(BASE, model_type="qwen3_moe", use_sliding_window=True,
                                 sliding_window=64, max_window_layers=2),
    "Qwen3-30B-A3B": QWEN3_30B_A3B_HF,
    "Qwen1.5-MoE-A2.7B": QWEN15_MOE_A27B_HF,
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_from_hf_config_matches_jax(case):
    hf = CONFIG_CASES[case]
    for kw in ({}, dict(dtype="float32", capacity_factor=2.0)):
        assert _fields(tq.ModelConfig.from_hf_config(hf, **kw)) == \
            _fields(jq.ModelConfig.from_hf_config(hf, **kw))


def test_published_moe_configs():
    q3 = tq.ModelConfig.from_hf_config(QWEN3_30B_A3B_HF)
    assert (q3.num_experts, q3.num_experts_per_tok, q3.moe_intermediate_size_) == (128, 8, 768)
    assert q3.qk_norm and not q3.qkv_bias and q3.norm_topk_prob and q3.head_dim_ == 128
    assert q3.router_aux_loss_coef == 0.001
    n = sum(int(np.prod(s)) for s in tq.named_shapes(q3).values())
    assert n == 30_532_122_624
    q15 = tq.ModelConfig.from_hf_config(QWEN15_MOE_A27B_HF)
    assert q15.shared_expert_intermediate_size == 5632 and q15.qkv_bias
    assert q15.num_attention_heads == q15.num_key_value_heads == 16
    assert not q15.norm_topk_prob and not q15.qk_norm


REFUSALS = {
    # refused by both packages
    "qwen2_moe-mixed-layers": (dict(model_type="qwen2_moe", mlp_only_layers=[1]), True),
    "qwen2_moe-sparse-step": (dict(model_type="qwen2_moe", decoder_sparse_step=2), True),
    "gemma2": (dict(model_type="gemma2"), True),
    "qwen3_moe-mixed-window": (dict(model_type="qwen3_moe", use_sliding_window=True,
                                    sliding_window=64, max_window_layers=1), True),
    # loaded by JAX, item 6.7 (sliding windows) in the port
    "mixtral-window": (dict(model_type="mixtral", sliding_window=64), False),
    "qwen3-window": (dict(model_type="qwen3", use_sliding_window=True, sliding_window=64,
                          max_window_layers=0), False),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_from_hf_config_refusals(case):
    over, jax_refuses = REFUSALS[case]
    hf = dict(BASE, **over)
    with pytest.raises(NotImplementedError, match=None if jax_refuses else "item 6.7"):
        tq.ModelConfig.from_hf_config(hf)
    if jax_refuses:
        with pytest.raises(NotImplementedError):
            jq.ModelConfig.from_hf_config(hf)
    else:
        jq.ModelConfig.from_hf_config(hf)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{family: (directory, the transformers model)}."""
    import transformers

    root = tmp_path_factory.mktemp("hf_families")
    out = {}
    for i, (family, (prefix, extra)) in enumerate(sorted(HF_FAMILIES.items())):
        cfg = getattr(transformers, f"{prefix}Config")(**BASE, **extra,
                                                      attn_implementation="eager")
        torch.manual_seed(20 + i)
        model = getattr(transformers, f"{prefix}ForCausalLM")(cfg).eval().float()
        model.save_pretrained(root / family, safe_serialization=True)
        assert json.loads((root / family / "config.json").read_text())["model_type"] == family
        out[family] = (str(root / family), model)
    return out


def _configs(d: str, **kw):
    kw = dict(dtype="float32", param_dtype="float32", **kw)
    hf = json.loads(Path(d, "config.json").read_text())
    E = hf.get("num_experts") or hf.get("num_local_experts")
    if E:  # no drops: HF routes without a capacity
        kw["capacity_factor"] = E / hf["num_experts_per_tok"]
    return tq.ModelConfig.from_hf_config(d, **kw), jq.ModelConfig.from_hf_config(d, **kw)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("family", sorted(HF_FAMILIES))
def test_load_hf_params_bit_equal_to_jax(ckpts, family, scan):
    d = ckpts[family][0]
    tcfg, jcfg = _configs(d, scan_layers=scan)
    ours = thf.load_hf_params(d, tcfg)
    jtree = jax.tree.map(np.asarray, jhf.load_hf_params(d, jcfg))
    want = tq.flatten_names(jtree)
    assert set(ours) == set(want) == set(tq.named_shapes(tcfg))
    for name, t in ours.items():
        assert tuple(t.shape) == want[name].shape, name
        assert np.array_equal(_bits(t), want[name].view(np.int32)), name


@pytest.mark.parametrize("family", sorted(HF_FAMILIES))
def test_logits_match_transformers_and_jax(ckpts, family):
    d, model = ckpts[family]
    tcfg, jcfg = _configs(d)
    T = 12
    ids = np.random.RandomState(1).randint(0, BASE["vocab_size"], T)
    with torch.no_grad():
        hf_logits = model(torch.tensor(ids)[None]).logits[0].numpy()
        ours = tq.forward(thf.load_hf_params(d, tcfg), torch.tensor(ids), torch.arange(T),
                          torch.zeros(T, dtype=torch.int32), tcfg).numpy()
    jax_logits = np.asarray(jq.forward(jhf.load_hf_params(d, jcfg), ids, np.arange(T),
                                       np.zeros(T, np.int32), jcfg))
    np.testing.assert_allclose(ours, hf_logits, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(ours, jax_logits, atol=1e-5, rtol=0)


@pytest.mark.parametrize("family", sorted(HF_FAMILIES))
def test_save_hf_params_writes_jax_tensors(ckpts, family, tmp_path):
    """The port's writer and JAX's on the same weights: the same tensor
    names (the family's own), dtypes and bits; both read back bit-equal."""
    d = ckpts[family][0]
    tcfg, jcfg = _configs(d)
    params = thf.load_hf_params(d, tcfg)
    jhf.save_hf_params(jhf.load_hf_params(d, jcfg), jcfg, str(tmp_path / "jax"))
    thf.save_hf_params(params, tcfg, str(tmp_path / "port"))
    a = thf.read_safetensors(str(tmp_path / "jax" / "model.safetensors"))
    b = thf.read_safetensors(str(tmp_path / "port" / "model.safetensors"))
    assert sorted(a) == sorted(b)
    # the checkpoint's own names: the writer is the inverse of HF's
    src = dict(thf._iter_hf_tensors(d))
    assert set(b) == {n for n in src if n in b} and len(b) == len(src)
    for name in a:
        assert a[name].dtype == b[name].dtype and torch.equal(a[name], b[name]), name
        assert torch.equal(b[name], src[name].float()), name
    if family == "mixtral":
        assert "model.layers.1.block_sparse_moe.experts.3.w3.weight" in b
    back = thf.load_hf_params(str(tmp_path / "port"), tcfg)
    for name, t in params.items():
        assert torch.equal(back[name], t), name


def test_expert_outside_or_missing_from_the_stack_is_refused(ckpts, tmp_path):
    d = ckpts["qwen3_moe"][0]
    tcfg, _ = _configs(d)
    tensors = dict(thf._iter_hf_tensors(d))
    extra = dict(tensors)
    extra["model.layers.0.mlp.experts.4.up_proj.weight"] = \
        tensors["model.layers.0.mlp.experts.0.up_proj.weight"]
    missing = {k: v for k, v in tensors.items()
               if k != "model.layers.1.mlp.experts.2.down_proj.weight"}
    for name, ts, match in (("extra", extra, "outside"), ("missing", missing, "missing")):
        (tmp_path / name).mkdir()
        (tmp_path / name / "config.json").write_text(Path(d, "config.json").read_text())
        thf.write_safetensors(ts, str(tmp_path / name / "model.safetensors"))
        with pytest.raises(ValueError, match=match):
            thf.load_hf_params(str(tmp_path / name), tcfg)


def test_hf_io_still_refuses_gpt2_and_gemma():
    for family in ("gpt2", "gemma"):
        cfg = tq.ModelConfig(**{k: v for k, v in BASE.items()
                                if k in ("vocab_size", "hidden_size")}, model_type=family)
        with pytest.raises(NotImplementedError, match="item 6.7"):
            thf.save_hf_params({}, cfg, "/nonexistent")
        with pytest.raises(NotImplementedError, match="item 6.7"):
            thf.ours_name_to_hf(("final_norm",), family)


# ---------------------------------------------------------------------------
# serving a MoE checkpoint from its path
# ---------------------------------------------------------------------------

PROMPTS = [[5, 9, 2, 40, 3, 17, 8], [7, 7, 1], [60, 2, 33, 18, 4, 90, 11, 12, 13]]
N_NEW = 8
DECODE = dict(context_length=64, max_running_requests=4, page_size=16,
              new_tokens_per_chunk=8, dtype="float32", kv_cache_dtype="float32")


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_server_serves_a_moe_checkpoint_from_its_path(ckpts):
    """`decode_server --model-path <qwen3_moe dir> --device cpu` answers
    each prompt, one request at a time, with the greedy tokens of a
    JaxDecodeEngine built from the same path."""
    d = ckpts["qwen3_moe"][0]
    jeng = JaxDecodeEngine(jargs.JaxDecodeConfig(model_path=d, **DECODE),
                           jargs.InferenceEngineConfig())
    jeng.initialize()
    try:
        want = [asyncio.run(jeng.agenerate(JaxModelRequest(
            input_ids=list(p), gconfig=jargs.GenerationHyperparameters(
                max_new_tokens=N_NEW, greedy=True)))).output_tokens for p in PROMPTS]
    finally:
        jeng.destroy()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT), HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "areal_tpu_torch.launcher.decode_server", "--model-path", d,
         "--dtype", "float32", "--context-length", "64", "--max-running-requests", "4",
         "--new-tokens-per-chunk", "8", "--device", "cpu", "--host", "127.0.0.1",
         "--port", str(port), "--skip-tokenizer-init"],
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
        proc.communicate(timeout=30)
    assert out == want
    assert all(len(t) == N_NEW for t in out)
