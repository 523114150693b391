"""Model configurations the port ships (counterpart of
`areal_tpu/models/smoke.py`).

`SMOKE_MODEL_DICT` is a copy of the JAX package's tiny offline geometry
(the tests hold the two equal). `QWEN25_7B` is the full-width,
full-depth Qwen2.5-7B decoder the chip check serves with random weights;
`QWEN25_1_5B` the Qwen2.5-1.5B decoder it trains; `QWEN25_VL_3B_HF` the
Qwen2.5-VL-3B-Instruct checkpoint's config (its language model and its
vision tower) that the chip check's vision phase serves and trains.
`SMOKE_IMAGE_TOKEN`, `smoke_vision_config` and `smoke_mrope_sections`
are the offline vision smoke's tower beside the smoke decoder (JAX
:23-54).
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


# Qwen2.5-VL-3B-Instruct at its published widths. The language model is
# written as model_type "qwen2" (the Qwen2 decoder with q/k/v biases, which
# the VL checkpoint's decoder has), with the checkpoint's m-rope sections
# and image token; `vision_config` is the checkpoint's tower (the
# Qwen2.5-VL branch of `VisionConfig.from_hf_dict`; `window_size` and
# `fullatt_block_indexes` are not read, ROADMAP queue 3).
QWEN25_VL_3B_SOURCE = (
    "https://huggingface.co/Qwen/Qwen2.5-VL-3B-Instruct/blob/main/config.json"
)
QWEN25_VL_3B_HF = dict(
    model_type="qwen2",
    vocab_size=151936,
    hidden_size=2048,
    intermediate_size=11008,
    num_hidden_layers=36,
    num_attention_heads=16,
    num_key_value_heads=2,
    max_position_embeddings=128000,
    rope_theta=1000000.0,
    rms_norm_eps=1e-06,
    tie_word_embeddings=True,
    hidden_act="silu",
    use_sliding_window=False,
    sliding_window=32768,
    max_window_layers=70,
    torch_dtype="bfloat16",
    rope_scaling={"type": "mrope", "mrope_section": [16, 24, 24]},
    image_token_id=151655,
    vision_start_token_id=151652,
    vision_end_token_id=151653,
    vision_config=dict(
        depth=32,
        hidden_act="silu",
        hidden_size=1280,
        intermediate_size=3420,
        num_heads=16,
        in_chans=3,
        out_hidden_size=2048,
        patch_size=14,
        spatial_merge_size=2,
        spatial_patch_size=14,
        window_size=112,
        fullatt_block_indexes=[7, 15, 23, 31],
        tokens_per_second=2,
        temporal_patch_size=2,
    ),
)

# Offline vision smoke: a tiny Qwen2-VL-class tower beside the smoke
# decoder. The image token is the smoke vocab's last id; a 1x4x4 patch
# grid merges 2x2 into 4 image-token embeddings.
SMOKE_IMAGE_TOKEN = 31


def smoke_vision_config():
    """The tiny tower whose merged embeddings land in the smoke decoder's
    hidden size (64)."""
    from areal_tpu_torch.models.qwen2_vl import VisionConfig

    return VisionConfig(
        embed_dim=16,
        depth=2,
        num_heads=2,
        mlp_dim=32,
        in_channels=3,
        patch_size=2,
        temporal_patch_size=1,
        spatial_merge_size=2,
        hidden_size=SMOKE_MODEL_DICT["hidden_size"],
    )


def smoke_mrope_sections() -> tuple[int, int, int]:
    """(t, h, w) rotary sections for the smoke decoder's head_dim."""
    hd = SMOKE_MODEL_DICT["hidden_size"] // SMOKE_MODEL_DICT["num_attention_heads"]
    return (hd // 4, hd // 8, hd // 8)


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
