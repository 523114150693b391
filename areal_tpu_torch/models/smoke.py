"""Model configurations the port ships (counterpart of
`areal_tpu/models/smoke.py`).

`SMOKE_MODEL_DICT` is a copy of the JAX package's tiny offline geometry
(the tests hold the two equal). `QWEN25_7B` is the full-width,
full-depth Qwen2.5-7B decoder the chip check serves with random weights.
"""

from __future__ import annotations

from areal_tpu_torch.models.qwen2 import ModelConfig

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


def smoke_model_config(dtype: str = "float32") -> ModelConfig:
    """The fixed smoke geometry in `dtype`."""
    return ModelConfig(**SMOKE_MODEL_DICT, dtype=dtype, param_dtype=dtype)
