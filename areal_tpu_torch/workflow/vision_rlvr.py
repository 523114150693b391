"""Vision RLVR workflow (counterpart of `areal_tpu/workflow/vision_rlvr.py`).

RLVR for vision-language models: the episode of `RLVRWorkflow` (n samples,
a reward each, one padded group batch), except that an HF AutoProcessor,
when given, renders the multimodal chat prompt and processes the images,
and the request carries `image_data` to the decode engine's tower.
Training tensors are token-only: the images live on the inference side
(ROADMAP queue 3: the trainer's logprobs see no image features and 1-D
positions, so they differ from the rollout's).
"""

from __future__ import annotations

import uuid
from typing import Any, Callable

import numpy as np

from areal_tpu_torch.api.cli_args import GenerationHyperparameters
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.workflow.rlvr import RLVRWorkflow


class VisionRLVRWorkflow(RLVRWorkflow):
    def __init__(
        self,
        reward_fn: Callable[..., float],
        gconfig: GenerationHyperparameters,
        tokenizer: Any = None,
        processor: Any = None,
        enable_thinking: bool = False,
        dump_dir: str | None = None,
        reward_timeout_seconds: float = 15.0,
    ):
        super().__init__(
            reward_fn,
            gconfig,
            tokenizer=tokenizer,
            enable_thinking=enable_thinking,
            dump_dir=dump_dir,
            reward_timeout_seconds=reward_timeout_seconds,
        )
        self.processor = processor

    def _encode_prompt(self, data: dict[str, Any]) -> list[int]:
        if self.processor is not None and "messages" in data:
            text = self.processor.apply_chat_template(
                data["messages"],
                add_generation_prompt=True,
                tokenize=False,
                enable_thinking=self.enable_thinking,
            )
            enc = self.processor(
                text=[text], images=data.get("images"), return_tensors="np"
            )
            # the processed patches, in the format the decode engine's
            # tower takes (window-major pixel rows and grid_thw), shipped
            # by _build_request
            if "pixel_values" in enc:
                self._last_pixels = dict(
                    pixel_values=np.asarray(enc["pixel_values"]),
                    image_grid_thw=np.asarray(enc["image_grid_thw"]),
                )
            else:
                self._last_pixels = None
            return list(np.asarray(enc["input_ids"]).reshape(-1))
        self._last_pixels = None
        if "input_ids" in data:
            return list(np.asarray(data["input_ids"]).reshape(-1))
        return super()._encode_prompt(data)

    def _build_request(
        self, data: dict[str, Any], prompt_ids: list[int]
    ) -> ModelRequest:
        pixels = getattr(self, "_last_pixels", None)
        if pixels is None and data.get("images") is not None:
            # no processor: what the dataset supplies goes as it is
            # (processed patch dicts, or raw images for a server that
            # owns the processor)
            image_data = list(data["images"])
        else:
            image_data = [pixels] if pixels is not None else None
        return ModelRequest(
            rid=str(uuid.uuid4()),
            input_ids=prompt_ids,
            gconfig=self.gconfig.new(n_samples=1),
            tokenizer=self.tokenizer,
            image_data=image_data,
        )
