"""Model configurations the port ships (counterpart of
`areal_tpu/models/smoke.py`).

`SMOKE_MODEL_DICT` is a copy of the JAX package's tiny offline geometry
(the tests hold the two equal). `QWEN25_7B` is the full-width,
full-depth Qwen2.5-7B decoder the chip check serves with random weights;
`QWEN25_1_5B` the Qwen2.5-1.5B decoder it trains.
"""

from __future__ import annotations

from areal_tpu_torch.models.qwen2 import ModelConfig

# model/tokenizer paths that mean "offline smoke" (no download)
OFFLINE_SENTINELS = ("", "synthetic-arith", "arith", "synthetic-vision")

SMOKE_MODEL_DICT = dict(
    vocab_size=32,
    hidden_size=64,
    intermediate_size=128,
    num_hidden_layers=2,
    num_attention_heads=4,
    num_key_value_heads=2,
)

# Qwen2.5-7B at its published widths: Qwen/Qwen2.5-7B config.json on the
# Hugging Face hub (the geometry of `__graft_entry__._7b_geometry_config`
# and of the north-star recipe's model).
QWEN25_7B_SOURCE = "https://huggingface.co/Qwen/Qwen2.5-7B/blob/main/config.json"
QWEN25_7B_HF = dict(
    model_type="qwen2",
    vocab_size=152064,
    hidden_size=3584,
    intermediate_size=18944,
    num_hidden_layers=28,
    num_attention_heads=28,
    num_key_value_heads=4,
    max_position_embeddings=131072,
    rope_theta=1000000.0,
    rms_norm_eps=1e-06,
    tie_word_embeddings=False,
    hidden_act="silu",
    use_sliding_window=False,
    sliding_window=131072,
    max_window_layers=28,
    torch_dtype="bfloat16",
)
QWEN25_7B = ModelConfig.from_hf_config(
    QWEN25_7B_HF, dtype="bfloat16", param_dtype="bfloat16"
)

# Qwen2.5-1.5B-Instruct at its published widths, the model of the
# north-star GRPO recipe (`BASELINE.json`) and of
# `examples/configs/countdown_grpo.yaml`; it trains whole on one H100.
QWEN25_1_5B_SOURCE = (
    "https://huggingface.co/Qwen/Qwen2.5-1.5B-Instruct/blob/main/config.json"
)
QWEN25_1_5B_HF = dict(
    model_type="qwen2",
    vocab_size=151936,
    hidden_size=1536,
    intermediate_size=8960,
    num_hidden_layers=28,
    num_attention_heads=12,
    num_key_value_heads=2,
    max_position_embeddings=32768,
    rope_theta=1000000.0,
    rms_norm_eps=1e-06,
    tie_word_embeddings=True,
    hidden_act="silu",
    use_sliding_window=False,
    sliding_window=32768,
    max_window_layers=21,
    torch_dtype="bfloat16",
)
QWEN25_1_5B = ModelConfig.from_hf_config(
    QWEN25_1_5B_HF, dtype="bfloat16", param_dtype="bfloat16"
)


def smoke_model_config(dtype: str = "float32", vocab_size: int | None = None,
                       is_critic: bool = False) -> ModelConfig:
    """The FIXED smoke geometry in `dtype`, with a value head for
    `is_critic`. `vocab_size` (a tokenizer's) is validated, never
    enlarged, as in JAX (`areal_tpu/models/smoke.py:55`): trainer and
    decode engine must agree on shapes, so the vocab cannot silently
    follow a tokenizer."""
    d = SMOKE_MODEL_DICT
    if vocab_size is not None and vocab_size > d["vocab_size"]:
        raise ValueError(
            f"smoke model vocab is fixed at {d['vocab_size']} but the "
            f"tokenizer has {vocab_size} tokens: offline smoke mode only "
            "supports the built-in character tokenizer"
        )
    return ModelConfig(**d, dtype=dtype, param_dtype=dtype, is_critic=is_critic)
