from areal_tpu_torch.experimental.openai.client import ArealOpenAI
from areal_tpu_torch.experimental.openai.types import InteractionWithTokenLogpReward

__all__ = ["ArealOpenAI", "InteractionWithTokenLogpReward"]
