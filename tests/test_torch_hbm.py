"""The port's memory estimator (`areal_tpu_torch/utils/hbm.py`) and
`AllocationMode.check_hbm` against the JAX package's, on the CPU.

Over a grid of model configurations (Qwen2.5-0.5B, 1.5B and 7B's
published widths, a tied and a MoE toy, a critic) and of plan options
(micro-batch tokens, remat, the fused head, dp/tp/pp/sp, fsdp and ZeRO-1,
the pipeline schedules, decode pools, int8 weights), `param_count`,
`wq_elem_counts`, `estimate_train_hbm`, `estimate_decode_hbm` (every
field and the breakdown), `check_fit`'s verdicts and messages on each TPU
row, and `check_hbm`'s reports and refusals for the allocations the port
accepts are equal to JAX's exactly. The H100 row holds the card's total
memory, and Qwen2.5-7B training is refused on one H100 while the
1.5B plans the chip phases run are accepted.
"""

import dataclasses
import itertools

import pytest

from areal_tpu.api import alloc_mode as j_alloc
from areal_tpu.models import qwen2 as jq
from areal_tpu.utils import hbm as j_hbm
from areal_tpu_torch.api import alloc_mode as t_alloc
from areal_tpu_torch.models import qwen2 as tq
from areal_tpu_torch.models.smoke import QWEN25_1_5B, QWEN25_7B
from areal_tpu_torch.utils import hbm as t_hbm

GEOM = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "tie_word_embeddings", "qkv_bias",
        "dtype", "param_dtype", "num_experts", "moe_intermediate_size",
        "shared_expert_intermediate_size", "is_critic")

MODELS = {
    "qwen25_0_5b": dict(vocab_size=151936, hidden_size=896, intermediate_size=4864,
                        num_hidden_layers=24, num_attention_heads=14, num_key_value_heads=2,
                        tie_word_embeddings=True),
    "qwen25_1_5b": {k: getattr(QWEN25_1_5B, k) for k in GEOM},
    "qwen25_7b": {k: getattr(QWEN25_7B, k) for k in GEOM},
    "tiny_f32": dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2, dtype="float32",
                     param_dtype="float32"),
    "tiny_moe": dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2, num_experts=4,
                     num_experts_per_tok=2, moe_intermediate_size=48,
                     shared_expert_intermediate_size=16, dtype="float32",
                     param_dtype="float32"),
    "critic_1_5b": dict({k: getattr(QWEN25_1_5B, k) for k in GEOM}, is_critic=True),
}

KINDS = ("TPU v5 lite", "tpu-v5-lite-podslice", "TPU v5e", "TPU v5p", "TPU v5", "TPU v4",
         "TPU v6e", "unknown chip")


def _cfgs(name):
    kw = MODELS[name]
    return jq.ModelConfig(**kw), tq.ModelConfig(**kw)


def _est_dict(est):
    return dataclasses.asdict(est), est.total_bytes, est.breakdown()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_param_and_int8_counts_equal_jax(name):
    jc, tc = _cfgs(name)
    assert t_hbm.param_count(tc) == j_hbm.param_count(jc)
    assert t_hbm.wq_elem_counts(tc) == j_hbm.wq_elem_counts(jc)


def test_param_count_of_the_port_init():
    """The count is the port's own parameters' (the 1.5B at 2 layers)."""
    from areal_tpu_torch.models.qwen2 import named_shapes

    cfg = dataclasses.replace(QWEN25_1_5B, num_hidden_layers=2)
    n = sum(int(__import__("math").prod(s)) for s in named_shapes(cfg).values())
    assert t_hbm.param_count(cfg) == n


TRAIN_GRID = [
    dict(zip(("microbatch_tokens", "remat", "fused_lm_head", "dp", "tp", "pp", "sp", "fsdp",
              "zero1", "pipeline_schedule", "virtual_pp"), v))
    for v in [
        (8192, True, True, 1, 1, 1, 1, True, False, "1f1b", 1),
        (4096, False, True, 1, 1, 1, 1, True, False, "1f1b", 1),
        (8192, True, False, 1, 1, 1, 1, True, False, "1f1b", 1),
        (16384, True, True, 8, 4, 1, 1, True, False, "1f1b", 1),
        (8192, True, True, 8, 4, 1, 1, False, True, "1f1b", 1),
        (8192, True, True, 8, 4, 1, 1, False, False, "1f1b", 1),
        (8192, True, True, 2, 2, 4, 2, True, False, "1f1b", 1),
        (8192, True, True, 2, 1, 4, 1, True, False, "1f1b_interleaved", 3),
        (1000, False, False, 3, 1, 2, 1, False, True, "gpipe", 1),
    ]
]


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("opts", TRAIN_GRID, ids=[str(i) for i in range(len(TRAIN_GRID))])
def test_train_estimate_equals_jax(name, opts):
    jc, tc = _cfgs(name)
    je = j_hbm.estimate_train_hbm(jc, **opts)
    te = t_hbm.estimate_train_hbm(tc, **opts)
    assert _est_dict(te) == _est_dict(je)
    for kind in KINDS:
        verdicts = []
        for mod, est in ((j_hbm, je), (t_hbm, te)):
            try:
                mod.check_fit(est, kind)
                verdicts.append("fits")
            except MemoryError as e:
                verdicts.append(str(e))
        assert verdicts[0] == verdicts[1], kind


DECODE_GRID = [
    dict(tp=1, pool_tokens=None, slots=64, context_length=32768),
    dict(tp=1, pool_tokens=16 * 512, kv_cache_dtype="bfloat16"),
    dict(tp=4, pool_tokens=256 * 1024, kv_cache_dtype="int8", weight_dtype="int8"),
    dict(tp=2, slots=16, context_length=4096, kv_cache_dtype="float32"),
    dict(tp=8, weight_dtype="int8"),
]


@pytest.mark.parametrize("name", sorted(set(MODELS) - {"critic_1_5b"}))
@pytest.mark.parametrize("opts", DECODE_GRID, ids=[str(i) for i in range(len(DECODE_GRID))])
def test_decode_estimate_equals_jax(name, opts):
    jc, tc = _cfgs(name)
    assert _est_dict(t_hbm.estimate_decode_hbm(tc, **opts)) == _est_dict(
        j_hbm.estimate_decode_hbm(jc, **opts))


def test_decode_estimate_refuses_unknown_weight_dtype():
    with pytest.raises(ValueError):
        t_hbm.estimate_decode_hbm(QWEN25_7B, weight_dtype="int4")


@pytest.mark.parametrize("kind", KINDS)
def test_tpu_rows_equal_jax(kind):
    assert t_hbm.hbm_bytes(kind) == j_hbm.hbm_bytes(kind)


# the allocations the port accepts (one device a side)
ALLOCS = ("", "jax:d1+d1", "jax:d1t1+d1", "jax:d1p1+d1", "jax:d1")
CHECK_OPTS = [
    dict(microbatch_tokens=8192),
    dict(microbatch_tokens=8192, decode_pool_tokens=256 * 1024),
    dict(microbatch_tokens=32768, remat=False, decode_slots=8, decode_context=4096),
    dict(microbatch_tokens=4096, decode_weight_dtype="int8", utilization=0.8),
]


@pytest.mark.parametrize("expr", ALLOCS)
@pytest.mark.parametrize("name", ("qwen25_1_5b", "qwen25_7b", "tiny_f32"))
def test_check_hbm_equals_jax(expr, name):
    jc, tc = _cfgs(name)
    jm, tm = j_alloc.AllocationMode.from_str(expr), t_alloc.AllocationMode.from_str(expr)
    for opts, kind in itertools.product(CHECK_OPTS, ("TPU v5p", "TPU v5e", "TPU v4")):
        out = []
        for mode, err, cfg in ((jm, j_alloc.AllocationValidationError, jc),
                               (tm, t_alloc.AllocationValidationError, tc)):
            try:
                out.append(("ok", mode.check_hbm(cfg, kind, **opts)))
            except err as e:
                out.append(("refused", str(e)))
        assert out[1] == out[0], (opts, kind)


H100 = "NVIDIA H100 80GB HBM3"


def test_h100_row_is_the_cards_total_memory():
    assert t_hbm.hbm_bytes(H100) == t_hbm.H100_TOTAL_MEMORY
    assert t_hbm.hbm_bytes(H100.lower().replace(" ", "-")) == t_hbm.H100_TOTAL_MEMORY
    # an H100 80GB reports a little under 80 GiB to torch
    assert 79 * t_hbm.GiB < t_hbm.H100_TOTAL_MEMORY < 80 * t_hbm.GiB
    # no TPU kind reaches the H100 row
    assert all(t_hbm.hbm_bytes(k) != t_hbm.H100_TOTAL_MEMORY for k in KINDS)


def test_check_hbm_on_one_h100():
    mode = t_alloc.AllocationMode.from_str("jax:d1+d1")
    with pytest.raises(t_alloc.AllocationValidationError, match="train half") as ei:
        mode.check_hbm(QWEN25_7B, H100, microbatch_tokens=8192, decode_pool_tokens=1 << 16)
    assert "opt_gib" in str(ei.value)
    report = mode.check_hbm(dataclasses.replace(QWEN25_1_5B, remat=True), H100,
                            microbatch_tokens=8192, decode_pool_tokens=32 * 512)
    assert report["train"]["total_gib"] < report["train"]["params_gib"] * 10
    assert set(report) == {"train", "gen"}
