"""The offline evaluator in the port against the JAX package's.

- `evaluate_offline` on the port's CPU decode engine and on a
  `JaxDecodeEngine`, the same f32 smoke weights, the same synthetic-arith
  problems, 4 samples each at temperature 1 (the position-keyed sampler
  gives both engines the same streams): equal `EvalResult` (mean reward,
  pass@k, maj@n, lengths), under a reward that parts the samples.
- `eval_and_aggregate.main` of both packages on an HF checkpoint of the
  same weights (`--model-path`, `--tokenizer-path synthetic-arith`, f32
  engines): equal `metrics.json` and `samples.jsonl`; `--task code` takes
  the code grader.
- `--servers`: the same evaluation through `RemoteInfEngine` against a
  port `DecodeServer`, at temperature 0, equal to the in-process run.
- `pass_at_k_estimate` equal on a grid.
"""

import functools
import json

import jax
import numpy as np
import pytest

from areal_tpu.api import cli_args as jargs
from areal_tpu.dataset import get_custom_dataset as j_dataset
from areal_tpu.dataset.arith import ArithTokenizer as JTok
from areal_tpu.engine.jax_decode import JaxDecodeEngine
from areal_tpu.evaluation import eval_and_aggregate as jea
from areal_tpu.evaluation import offline as jo
from areal_tpu.models import qwen2 as jq
from areal_tpu_torch.api import cli_args as targs
from areal_tpu_torch.dataset import get_custom_dataset as t_dataset
from areal_tpu_torch.dataset.arith import ArithTokenizer as TTok
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.evaluation import eval_and_aggregate as tea
from areal_tpu_torch.evaluation import offline as to
from areal_tpu_torch.models import hf_io
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy
from areal_tpu_torch.models.smoke import SMOKE_MODEL_DICT

KW = dict(SMOKE_MODEL_DICT, dtype="float32", param_dtype="float32")
JCFG, TCFG = jq.ModelConfig(**KW), tq.ModelConfig(**KW)
SMALL = dict(context_length=64, max_running_requests=8, page_size=16, new_tokens_per_chunk=8,
             dtype="float32", kv_cache_dtype="float32")


@pytest.fixture(scope="module")
def weights():
    jparams = jq.init_params(JCFG, jax.random.PRNGKey(11))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG)


def parted_reward(prompt, completion, prompt_ids, completion_ids, **kw):
    """1 for a completion whose first token is even: some samples of a
    problem pass and some fail."""
    return float(len(completion_ids) > 0 and completion_ids[0] % 2 == 0)


def test_evaluate_offline_equals_jax(weights, cpu_devices):
    jparams, tparams = weights
    kw = dict(n_samples=4, ks=(1, 2, 4), reward_fn=parted_reward)
    items = t_dataset("synthetic-arith", split="test")[:6]
    assert items == j_dataset("synthetic-arith", split="test")[:6]
    jeng = JaxDecodeEngine(jargs.JaxDecodeConfig(**SMALL), jargs.InferenceEngineConfig())
    jeng.set_model(jparams, JCFG)
    jeng.initialize()
    try:
        want = jo.evaluate_offline(
            jeng, items, gconfig=jargs.GenerationHyperparameters(max_new_tokens=6),
            tokenizer=JTok(), **kw)
    finally:
        jeng.destroy()
    teng = TorchDecodeEngine(targs.TorchDecodeConfig(**SMALL), device="cpu")
    teng.set_model(tparams, TCFG)
    teng.initialize()
    try:
        got = to.evaluate_offline(
            teng, items, gconfig=targs.GenerationHyperparameters(max_new_tokens=6),
            tokenizer=TTok(), **kw)
    finally:
        teng.destroy()
    assert got.to_dict() == want.to_dict()
    assert 0.0 < got.mean_reward < 1.0 and got.pass_at_k[4] >= got.pass_at_1


def _hf_checkpoint(tparams, path) -> str:
    hf_io.save_hf_params(tparams, TCFG, str(path))
    cfg = dict(model_type="qwen2", architectures=["Qwen2ForCausalLM"], **SMOKE_MODEL_DICT,
               rope_theta=TCFG.rope_theta, rms_norm_eps=TCFG.rms_norm_eps,
               max_position_embeddings=TCFG.max_position_embeddings,
               tie_word_embeddings=False, torch_dtype="float32")
    (path / "config.json").write_text(json.dumps(cfg))
    return str(path)


def test_eval_and_aggregate_writes_the_jax_metrics(weights, cpu_devices, tmp_path, monkeypatch):
    ckpt = _hf_checkpoint(weights[1], tmp_path / "ckpt")
    # both CLIs build their engine in the default bf16: f32 here, so the
    # two packages' streams agree token for token
    f32 = dict(dtype="float32", kv_cache_dtype="float32")
    monkeypatch.setattr(jargs, "JaxDecodeConfig", functools.partial(jargs.JaxDecodeConfig, **f32))
    monkeypatch.setattr(targs, "TorchDecodeConfig",
                        functools.partial(targs.TorchDecodeConfig, **f32))
    argv = ["--data-names", "synthetic-arith", "--model-path", ckpt, "--tokenizer-path",
            "synthetic-arith", "--max-problems", "5", "--n-sampling", "4",
            "--max-gen-tokens", "8", "--temperature", "1.0"]
    jea.main(argv + ["--output-path", str(tmp_path / "jax")])
    tea.main(argv + ["--output-path", str(tmp_path / "torch")], device="cpu")
    sub = "synthetic-arith"
    got = json.loads((tmp_path / "torch" / sub / "metrics.json").read_text())
    want = json.loads((tmp_path / "jax" / sub / "metrics.json").read_text())
    assert got == want
    assert set(got) == {"n_problems", "n_samples", "mean_reward", "pass_at_1", "pass@1",
                        "pass@4", "mean_output_len", "maj_at_n"}
    assert got["n_problems"] == 5 and got["n_samples"] == 4
    assert ((tmp_path / "torch" / sub / "samples.jsonl").read_text()
            == (tmp_path / "jax" / sub / "samples.jsonl").read_text())
    assert json.loads((tmp_path / "torch" / "result.json").read_text()) == {sub: got}
    # --task code scores with the code grader, as in JAX (its run on a code
    # dataset: tests/test_torch_code_verify.py)
    from areal_tpu_torch.reward.code_verify import code_reward_fn

    assert tea._reward_for("code") is code_reward_fn
    with pytest.raises(ValueError, match="unknown task"):
        tea._reward_for("lean")


def test_eval_over_servers_equals_the_in_process_engine(weights, tmp_path, monkeypatch):
    """`--servers` runs the same evaluation through `RemoteInfEngine`
    against a port `DecodeServer` holding the weights; at temperature 0
    (the argmax) its `metrics.json` and samples equal the in-process
    engine's on the checkpoint of the same weights."""
    from areal_tpu_torch.launcher.decode_server import DecodeServer

    ckpt = _hf_checkpoint(weights[1], tmp_path / "ckpt")
    monkeypatch.setattr(targs, "TorchDecodeConfig", functools.partial(
        targs.TorchDecodeConfig, dtype="float32", kv_cache_dtype="float32"))
    argv = ["--data-names", "synthetic-arith", "--tokenizer-path", "synthetic-arith",
            "--max-problems", "4", "--n-sampling", "2", "--max-gen-tokens", "8",
            "--temperature", "0"]
    tea.main(argv + ["--model-path", ckpt, "--output-path", str(tmp_path / "local")],
             device="cpu")
    # the in-process engine's settings and tokenizer (its eos ends a
    # request anywhere in a 128-token chunk, past max_new_tokens too: a
    # reference behaviour, ROADMAP queue 3)
    srv = DecodeServer(targs.TorchDecodeConfig(context_length=8 + 2048), tokenizer=TTok(),
                       device="cpu")
    srv.engine.set_model(weights[1], TCFG)
    srv.start("127.0.0.1", 0)
    try:
        tea.main(argv + ["--servers", srv.addr, "--output-path", str(tmp_path / "remote")])
    finally:
        srv.stop()
    for f in ("metrics.json", "samples.jsonl"):
        local = (tmp_path / "local" / "synthetic-arith" / f).read_text()
        assert (tmp_path / "remote" / "synthetic-arith" / f).read_text() == local, f


def test_pass_at_k_estimate_equals_jax():
    for n in range(1, 9):
        for c in range(n + 1):
            for k in range(1, n + 1):
                assert to.pass_at_k_estimate(n, c, k) == jo.pass_at_k_estimate(n, c, k)
