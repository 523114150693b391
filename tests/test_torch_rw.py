"""The port's Bradley-Terry reward model against the JAX package's, on the
CPU in f32.

`rw_pairwise_loss` is held against JAX's on packed streams with a pad
segment on an even and on an odd index and a pair missing its second
half (atol 1e-6 on the loss and its gradient). A `JaxRWEngine` and a
`TorchRWEngine` on `tests/test_critic_rw.py`'s TINY_CRITIC geometry, with
the same weights, take 3 `train_rw` steps over several micro-batches,
then `eval_rw` and `compute_scores`, at `tests/test_torch_ppo_actor.py`'s
tolerances (atol 1e-5 on losses and scores, rtol 1e-4 on the gradient
norm, parameters atol 2e-5). The `rw` view of `synthetic-arith` equals
JAX's item for item; a batch whose token budget would cut a pair at
granularity 1 stays paired; the entry point runs `arith_rw_smoke.yaml`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api import cli_args as jargs
from areal_tpu.api.alloc_mode import ParallelStrategy as JaxParallelStrategy
from areal_tpu.api.io_struct import FinetuneSpec as JaxFinetuneSpec
from areal_tpu.dataset import get_custom_dataset as j_dataset
from areal_tpu.engine.rw import rw_engine as jrw
from areal_tpu.models import qwen2 as jq
from areal_tpu_torch.api import cli_args as targs
from areal_tpu_torch.api.io_struct import FinetuneSpec
from areal_tpu_torch.dataset import get_custom_dataset as t_dataset
from areal_tpu_torch.engine.rw import rw_engine as trw
from areal_tpu_torch.examples import hhrlhf_rw
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.convert import params_from_numpy, unstack_layers
from areal_tpu_torch.utils import stats_tracker
from areal_tpu_torch.utils.data import split_padded_tensor_dict_into_mb_list

TINY_CRITIC = dict(
    vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, dtype="float32", param_dtype="float32",
    is_critic=True,
)
STATS = ("loss", "grad_norm", "lr", "n_mbs")


def _packed(lens, ends, seed=0):
    """A packed stream of sequences of `lens` (the last one the pad tail),
    `ends[i]` whether sequence i carries its end marker."""
    rng = np.random.default_rng(seed)
    T = sum(lens)
    seg = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    end = np.zeros(T, np.int32)
    stops = np.cumsum(lens) - 1
    end[stops[np.asarray(ends, bool)]] = 1
    return rng.standard_normal(T).astype(np.float32) * 2, dict(segment_ids=seg, rw_seq_end=end)


# 3 pairs + pad (even index); 2 pairs and a lone chosen + pad (the pad
# pairs with it on an odd index); 2 pairs, the second's rejected half
# carrying no end marker, + pad
# (lens, ends, complete pairs)
LOSS_CASES = [
    ([5, 7, 3, 4, 6, 2, 9], [1, 1, 1, 1, 1, 1, 0], 3),
    ([4, 4, 6, 3, 5, 11], [1, 1, 1, 1, 1, 0], 2),
    ([3, 8, 5, 5, 7], [1, 1, 1, 0, 0], 1),
]


@pytest.mark.parametrize("lens,ends,n_pairs", LOSS_CASES, ids=["pad-even", "lone-half", "no-end"])
def test_pairwise_loss_matches_jax(lens, ends, n_pairs):
    values, mb = _packed(lens, ends)
    jl, jg = jax.value_and_grad(lambda v: jrw.rw_pairwise_loss(
        v, {k: jnp.asarray(x) for k, x in mb.items()}))(jnp.asarray(values))
    tv = torch.tensor(values, requires_grad=True)
    tl = trw.rw_pairwise_loss(tv, {k: torch.from_numpy(x) for k, x in mb.items()})
    (tg,) = torch.autograd.grad(tl, tv)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    # only the complete pairs carry gradient, at their two end tokens
    assert int((tg != 0).sum()) == 2 * n_pairs


def _cfg(mod, **kw):
    return mod.TrainEngineConfig(
        experiment_name="t", trial_name="t", path="", init_from_scratch=True, dtype="float32",
        gradient_checkpointing=False, mb_spec=mod.MicroBatchSpec(max_tokens_per_mb=40),
        optimizer=mod.OptimizerConfig(lr=5e-3, warmup_steps_proportion=0.0,
                                      lr_scheduler_type="constant", gradient_clipping=1.0),
        **kw,
    )


def _pair_batch(N=5, T=14, seed=1):
    """`tests/test_critic_rw.py`'s pairs: chosen rows end in token 7,
    rejected rows in token 3."""
    rng = np.random.RandomState(seed)
    B = 2 * N
    input_ids = np.zeros((B, T), dtype=np.int64)
    attention_mask = np.zeros((B, T), dtype=np.int64)
    for i in range(B):
        n = rng.randint(T // 2, T + 1)
        input_ids[i, :n] = rng.randint(1, 64, n)
        input_ids[i, n - 1] = 7 if i % 2 == 0 else 3
        attention_mask[i, :n] = 1
    return dict(input_ids=input_ids, attention_mask=attention_mask)


@pytest.fixture(scope="module")
def engines(cpu_devices):
    jeng = jrw.JaxRWEngine(_cfg(jargs))
    jeng.model_config = jq.ModelConfig(**TINY_CRITIC)
    jeng.create_process_group(JaxParallelStrategy(data_parallel_size=8))
    jeng.initialize(None, JaxFinetuneSpec(1, 64, 4))
    teng = trw.TorchRWEngine(_cfg(targs), device="cpu")
    assert teng.config.is_critic and teng.config.mb_spec.granularity == 2
    teng.model_config = tq.ModelConfig(**TINY_CRITIC, scan_layers=False)
    teng.create_process_group()
    tree = jax.tree.map(np.asarray, jeng.params)
    teng.initialize(None, FinetuneSpec(1, 64, 4), params=params_from_numpy(tree, teng.model_config))
    return jeng, teng


def test_train_eval_and_scores_match_jax(engines):
    jeng, teng = engines
    for step in range(3):
        batch = _pair_batch(seed=step)
        jstat = jeng.train_rw(dict(batch))
        tstat = teng.train_rw(dict(batch))
        assert tstat["n_mbs"] > 1
        for k in STATS:
            tol = dict(rtol=1e-4) if k == "grad_norm" else dict(atol=1e-5)
            np.testing.assert_allclose(tstat[k], jstat[k], err_msg=f"step {step} {k}", **tol)
        want = tq.flatten_names(unstack_layers(jax.tree.map(np.asarray, jeng.params)))
        for name, t in teng.params.items():
            np.testing.assert_allclose(t.detach().numpy(), want[name], atol=2e-5, rtol=0,
                                       err_msg=f"step {step} {name}")
    batch = _pair_batch(seed=9)
    np.testing.assert_allclose(teng.eval_rw(dict(batch)), jeng.eval_rw(dict(batch)), atol=1e-5)
    tscores = teng.compute_scores(dict(batch))
    np.testing.assert_allclose(tscores, jeng.compute_scores(dict(batch)), atol=1e-5)
    # a score is the value at the sequence's last token of the forward
    flat = teng.forward(dict(batch), post_hook=trw._identity_hook, aggregate_fn=list)
    lens = batch["attention_mask"].sum(-1)
    np.testing.assert_array_equal(tscores, [seq[n - 1] for seq, n in zip(flat, lens)])
    with pytest.raises(ValueError, match="pairs"):
        teng.train_rw({k: v[:3] for k, v in batch.items()})


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("max_length", [None, 6])
def test_rw_view_matches_jax(split, max_length):
    kw = dict(split=split, type="rw", max_length=max_length, n_items=512)
    t = t_dataset("synthetic-arith", **kw)
    assert t == j_dataset("synthetic-arith", **kw)
    for x in t:
        c, r = x["chosen_input_ids"], x["rejected_input_ids"]
        if max_length is None:
            assert r[:-2] == c[:-1] and c[-1] == r[-1] == 2  # "+" before the eos


def test_budget_that_would_cut_a_pair_keeps_pairs():
    """Pairs (0, 1), (2, 3), (4, 5) of 12, 16 and 9 tokens under a
    17-token budget: split row by row, first-fit decreasing puts rows 0
    and 2 (9 + 8 tokens) together and cuts two pairs. The engine's spec
    (granularity 2) keeps every pair in one micro-batch."""
    lens = [9, 3, 8, 8, 7, 2]
    T = max(lens)
    attn = (np.arange(T)[None] < np.array(lens)[:, None]).astype(np.int64)
    batch = trw._attach_seq_end(dict(input_ids=attn * 5, attention_mask=attn))
    spec = targs.MicroBatchSpec(max_tokens_per_mb=17)
    cut = split_padded_tensor_dict_into_mb_list(batch, spec)
    assert any(sorted(ix) not in ([0, 1], [2, 3], [4, 5]) for ix in cut.forward_indices)
    eng = trw.TorchRWEngine(targs.TrainEngineConfig(mb_spec=spec), device="cpu")
    kept = split_padded_tensor_dict_into_mb_list(batch, eng.config.mb_spec)
    assert sorted(sorted(ix) for ix in kept.forward_indices) == [[0, 1], [2, 3], [4, 5]]
    for mb in kept.mbs:
        assert int(mb["rw_seq_end"].sum()) == 2


def test_entry_point_on_the_smoke_yaml(tmp_path):
    stats_tracker.export_all()  # drop what earlier tests left in the tracker
    history = hhrlhf_rw.main(["--config", "examples/configs/arith_rw_smoke.yaml",
                              "total_train_steps=3", f"cluster.fileroot={tmp_path}"],
                             device="cpu")
    assert [h["global_step"] for h in history] == [0, 1, 2]
    for h in history:
        assert np.isfinite(h["rw_loss"]) and h["rw_loss"] == h["loss"]
        assert h["critic/throughput/n_tokens"] > 0
    batch = hhrlhf_rw.to_pair_batch(t_dataset("synthetic-arith", type="rw", n_items=4))
    assert batch["input_ids"].shape[0] == 8
    np.testing.assert_array_equal(batch["input_ids"][0][: batch["attention_mask"][0].sum()],
                                  t_dataset("synthetic-arith", type="rw",
                                            n_items=4)[0]["chosen_input_ids"])
