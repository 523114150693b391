from areal_tpu_torch.reward.math_parser import math_verify_reward  # noqa: F401
