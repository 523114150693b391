"""The port's SFT path against the JAX package's, on the CPU in f32.

- The `synthetic-arith` SFT view, item for item (prompt + answer + eos,
  the answer-only loss mask, the cut at `max_length`): exact.
- `compute_packed_sft_loss` (dense logits, and through each package's
  `LMHead`) and `sft_loss_weight` on the same packed micro-batch: the loss
  within 1e-6 (f32, one logsumexp per token in another order), the weight
  exact.
- Four `train_lm` steps and one `evaluate_lm` of `TorchLMEngine` against a
  live `JaxLMEngine` from the same weights and batches (never against
  `tests/golden_sft_losses.json`): losses and eval loss within 1e-5 and
  parameters within 2e-5 after every step (f32 sums in another order; an
  Adam step is about lr whatever the gradient, so f32 noise in a tiny
  gradient moves a parameter by at most lr * noise / eps). The first
  update has lr 0 in both packages.
- The entry point on `examples/configs/arith_sft_smoke.yaml` for 10 steps
  on the CPU: the batches are the JAX example's (`to_batch`), the loss
  falls, and the evaluator fires at step 9.
"""

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api import cli_args as j_cli
from areal_tpu.api.alloc_mode import ParallelStrategy as JParallelStrategy
from areal_tpu.api.io_struct import FinetuneSpec as JFinetuneSpec
from areal_tpu.dataset import get_custom_dataset as j_dataset
from areal_tpu.engine.sft import lm_engine as j_lm
from areal_tpu.models import qwen2 as jq
from areal_tpu_torch.api import cli_args as t_cli
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.dataset import get_custom_dataset as t_dataset
from areal_tpu_torch.dataset.arith import ArithTokenizer
from areal_tpu_torch.engine.sft import lm_engine as t_lm
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy, unstack_layers
from areal_tpu_torch.utils.data import pad_sequences_to_tensors

TINY = dict(vocab_size=48, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, dtype="float32",
            param_dtype="float32")


@pytest.mark.parametrize("split,max_length", [("train", None), ("test", None), ("train", 6)])
def test_sft_view_matches_jax(split, max_length):
    j = j_dataset("synthetic-arith", split=split, type="sft", max_length=max_length, n_items=512)
    t = t_dataset("synthetic-arith", split=split, type="sft", max_length=max_length,
                  n_items=512)
    assert t == j
    assert all(len(x["loss_mask"]) == len(x["input_ids"]) for x in t)
    if max_length:
        assert max(len(x["input_ids"]) for x in t) == max_length


def test_rw_view_is_refused_with_item_6():
    """The `rw` view, refused until the reward model was ported (the name
    is kept from then), is now accepted: each item pairs the well-formed answer (chosen) with the
    malformed one (rejected, a dangling `+`), as JAX's does."""
    items = t_dataset("synthetic-arith", type="rw", n_items=64)
    assert items == j_dataset("synthetic-arith", type="rw", n_items=64)
    tok = ArithTokenizer()
    for x in items:
        assert x["chosen_input_ids"] == tok.encode(x["prompt"] + x["answer"]) + [2]
        assert x["rejected_input_ids"] == tok.encode(x["prompt"] + x["answer"] + "+") + [2]


def _packed_mb(seed=0, V=48):
    rng = np.random.default_rng(seed)
    lens = [7, 11, 5]
    T = sum(lens) + 3  # a pad tail, its own segment
    cu = np.concatenate([[0], np.cumsum(lens), [T]]).astype(np.int32)
    return dict(
        input_ids=rng.integers(0, V, T).astype(np.int32),
        loss_mask=(rng.random(T) > 0.4).astype(np.int32),
        cu_seqlens=cu,
    ), rng.standard_normal((T, V)).astype(np.float32) * 2


def test_sft_loss_weight_matches_jax():
    mb, _ = _packed_mb()
    assert t_lm.sft_loss_weight(mb) == j_lm.sft_loss_weight(mb)
    cu = mb["cu_seqlens"]
    seg = tq.segment_ids_from_cu_seqlens(cu, int(cu[-1]))
    assert t_lm.sft_loss_weight(dict(mb, segment_ids=seg)) == j_lm.sft_loss_weight(mb)


def test_packed_sft_loss_matches_jax():
    mb, logits = _packed_mb(1)
    cu = mb["cu_seqlens"]
    seg = tq.segment_ids_from_cu_seqlens(cu, int(cu[-1]))
    jmb = dict(input_ids=mb["input_ids"], loss_mask=mb["loss_mask"], segment_ids=seg)
    tmb = {k: torch.from_numpy(np.asarray(v)) for k, v in jmb.items()}
    want = float(j_lm.compute_packed_sft_loss(logits, jmb))
    got = float(t_lm.compute_packed_sft_loss(torch.from_numpy(logits), tmb))
    assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("tie", [True, False])
def test_fused_sft_loss_matches_jax(tie):
    """The loss through each package's `LMHead` on the same hidden states
    and head."""
    kw = dict(TINY, tie_word_embeddings=tie)
    jcfg = jq.ModelConfig(**kw)
    jparams = jax.jit(jq.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(2))
    tcfg = tq.ModelConfig(**kw, scan_layers=False)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    mb, _ = _packed_mb(2)
    cu = mb["cu_seqlens"]
    seg = tq.segment_ids_from_cu_seqlens(cu, int(cu[-1]))
    hidden = np.random.default_rng(3).standard_normal((len(seg), 32)).astype(np.float32)
    jmb = dict(input_ids=mb["input_ids"], loss_mask=mb["loss_mask"], segment_ids=seg)
    tmb = {k: torch.from_numpy(np.asarray(v)) for k, v in jmb.items()}
    want = float(j_lm.compute_packed_sft_loss_fused(jq.LMHead(hidden, jparams, jcfg), jmb))
    got = float(t_lm.compute_packed_sft_loss_fused(
        tq.LMHead(torch.from_numpy(hidden), tparams, tcfg), tmb))
    assert abs(got - want) <= 1e-6
    assert t_lm.compute_packed_sft_loss_fused.hidden_loss


def _sft_batch(seed):
    rng = np.random.RandomState(seed)
    seqs = []
    for L in (9, 13, 7, 11, 6):
        mask = np.zeros(L, dtype=np.int32)
        mask[L // 2:] = 1
        seqs.append(dict(input_ids=rng.randint(1, 48, (L,)), loss_mask=mask))
    return pad_sequences_to_tensors(seqs)


@pytest.fixture(scope="module")
def engines(cpu_devices):
    def cfg(mod):
        return mod.TrainEngineConfig(
            experiment_name="sft", trial_name="t", init_from_scratch=True, dtype="float32",
            gradient_checkpointing=False, mb_spec=mod.MicroBatchSpec(max_tokens_per_mb=24),
            optimizer=mod.OptimizerConfig(lr=1e-2, warmup_steps_proportion=0.0,
                                          lr_scheduler_type="constant"))

    jeng = j_lm.JaxLMEngine(cfg(j_cli))
    jeng.model_config = jq.ModelConfig(**TINY)
    jeng.create_process_group(JParallelStrategy(data_parallel_size=8))
    jeng.initialize(None, JFinetuneSpec(1, 40, 5))
    teng = t_lm.TorchLMEngine(cfg(t_cli), device="cpu")
    teng.model_config = tq.ModelConfig(**TINY, scan_layers=False)
    teng.create_process_group()
    teng.initialize(None, FinetuneSpec(1, 40, 5),
                    params=params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                             teng.model_config))
    return jeng, teng


def test_train_and_eval_match_a_live_jax_engine(engines):
    jeng, teng = engines
    before = {k: v.detach().clone() for k, v in teng.params.items()}
    for step in range(4):
        batch = _sft_batch(step)
        js, ts = jeng.train_lm(batch), teng.train_lm(batch)
        assert ts["n_mbs"] == js["n_mbs"] > 1  # the global normalisation is exercised
        assert abs(ts["loss"] - js["loss"]) <= 1e-5, (step, ts["loss"], js["loss"])
        assert ts["lr"] == pytest.approx(js["lr"], rel=1e-6)
        want = tq.flatten_names(unstack_layers(jax.tree.map(np.asarray, jeng.params)))
        for name, t in teng.params.items():
            np.testing.assert_allclose(t.detach().numpy(), want[name], atol=2e-5, rtol=0,
                                       err_msg=f"step {step}: {name}")
        if step == 0:  # lr 0 on the first update, in both packages
            assert all(torch.equal(before[k], v) for k, v in teng.params.items())
    batch = _sft_batch(9)
    assert abs(teng.evaluate_lm(batch) - float(jeng.evaluate_lm(batch))) <= 1e-5


def test_entry_point_runs_the_smoke_yaml(tmp_path):
    from areal_tpu.dataset import SimpleDataLoader as JLoader
    from areal_tpu_torch.examples.gsm8k_sft import main, to_batch
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "j_sft_example", Path(__file__).resolve().parents[1] / "examples" / "gsm8k_sft.py")
    j_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_example)
    items = next(iter(JLoader(j_dataset("synthetic-arith", type="sft"), batch_size=16, seed=1)))
    jb, tb = j_example.to_batch(items), to_batch(items)
    assert jb.keys() == tb.keys() and all(np.array_equal(jb[k], tb[k]) for k in jb)

    history = main(["--config", "examples/configs/arith_sft_smoke.yaml",
                    f"cluster.fileroot={tmp_path}", "total_train_steps=10"], device="cpu")
    assert [r["global_step"] for r in history] == list(range(10))
    assert all(np.isfinite(r["loss"]) for r in history)
    assert history[-1]["loss"] < history[0]["loss"]
    assert [r["global_step"] for r in history if "eval_loss" in r] == [9]
    assert np.isfinite(history[9]["eval_loss"])
    assert (tmp_path / "logs" / "arith-sft-smoke" / "run0" / "config.yaml").exists()


def test_entry_point_refusals(tmp_path):
    from areal_tpu_torch.examples.gsm8k_sft import main

    base = ["--config", "examples/configs/arith_sft_smoke.yaml", f"cluster.fileroot={tmp_path}"]
    with pytest.raises(NotImplementedError, match="item 5"):
        main(base + ["allocation_mode=jax:d2"], device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        main(base + ["cluster.n_nodes=2"], device="cpu")
    # the vision datasets are ported (tests/test_torch_vision.py); a model
    # family outside the port still names its item
    gpt2 = tmp_path / "gpt2"
    gpt2.mkdir()
    (gpt2 / "config.json").write_text('{"model_type": "gpt2"}')
    with pytest.raises(NotImplementedError, match="item 6.7"):
        main(base + [f"model.path={gpt2}", "model.init_from_scratch=false"], device="cpu")
