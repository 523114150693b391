"""Key layout of the name_resolve discovery service (a copy of
`areal_tpu/utils/names.py`): every key lives under
`areal_tpu/{experiment}/{trial}`, so records written by either package
are read by the other."""

from __future__ import annotations

ROOT = "areal_tpu"


def _base(experiment_name: str, trial_name: str) -> str:
    return f"{ROOT}/{experiment_name}/{trial_name}"


def gen_servers(experiment_name: str, trial_name: str) -> str:
    return f"{_base(experiment_name, trial_name)}/gen_servers"


def gen_server(experiment_name: str, trial_name: str, server_id: str) -> str:
    return f"{_base(experiment_name, trial_name)}/gen_servers/{server_id}"


def update_weights_from_disk(
    experiment_name: str, trial_name: str, model_version: int
) -> str:
    return f"{_base(experiment_name, trial_name)}/update_weights_from_disk/{model_version}"


def experiment_status(experiment_name: str, trial_name: str) -> str:
    return f"{_base(experiment_name, trial_name)}/experiment_status"


def trainer_rank(experiment_name: str, trial_name: str, rank: int) -> str:
    return f"{_base(experiment_name, trial_name)}/trainer/{rank}"


def distributed_peer(experiment_name: str, trial_name: str, group: str, rank: int) -> str:
    return f"{_base(experiment_name, trial_name)}/peers/{group}/{rank}"


def distributed_barrier(experiment_name: str, trial_name: str, barrier: str) -> str:
    return f"{_base(experiment_name, trial_name)}/barrier/{barrier}"


def model_version(experiment_name: str, trial_name: str, role: str = "default") -> str:
    return f"{_base(experiment_name, trial_name)}/model_version/{role}"


def training_samples(experiment_name: str, trial_name: str) -> str:
    """The trainer's count of consumed samples (the staleness gate's
    numerator)."""
    return f"{_base(experiment_name, trial_name)}/training_samples"


def rollout_router(experiment_name: str, trial_name: str) -> str:
    """Address of the decode-fleet router service."""
    return f"{_base(experiment_name, trial_name)}/rollout_router"
