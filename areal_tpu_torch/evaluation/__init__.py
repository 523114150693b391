from areal_tpu_torch.evaluation.offline import EvalResult, evaluate_offline

__all__ = ["EvalResult", "evaluate_offline"]
