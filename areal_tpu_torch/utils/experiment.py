"""Experiment status broadcast over name_resolve (counterpart of
`areal_tpu/utils/experiment.py`): the trainer publishes RUNNING while its
loop lives and a terminal status when it ends, and decode servers watch
the key to stop themselves instead of outliving the trainer."""

from __future__ import annotations

import enum
import threading

from areal_tpu_torch.utils import logging, name_resolve, names

logger = logging.getLogger("experiment")


class ExpStatus(str, enum.Enum):
    RUNNING = "RUNNING"
    COMPLETE = "COMPLETE"
    ABORTED = "ABORTED"


def publish_status(experiment_name: str, trial_name: str, status: ExpStatus | str) -> None:
    # delete_on_exit=False: watchers read a terminal status after its
    # publisher is gone
    name_resolve.add(
        names.experiment_status(experiment_name, trial_name),
        str(getattr(status, "value", status)),
        replace=True,
        delete_on_exit=False,
    )


def get_status(experiment_name: str, trial_name: str) -> ExpStatus | None:
    """The published status, or None while there is none (or it is not
    one of `ExpStatus`)."""
    try:
        raw = name_resolve.get(names.experiment_status(experiment_name, trial_name))
    except name_resolve.NameEntryNotFoundError:
        return None
    try:
        return ExpStatus(raw)
    except ValueError:
        return None


def watch_until_terminal(experiment_name: str, trial_name: str, on_terminal,
                         poll_interval: float = 5.0,
                         stop_event: threading.Event | None = None) -> threading.Thread:
    """A daemon thread that polls the status key and calls
    `on_terminal(status)` once it reads COMPLETE or ABORTED, then ends.

    A missing key is not terminal (the trainer may not have started), and
    a terminal status counts only after this watcher has seen the current
    run's RUNNING: terminal records persist across runs, and a relaunched
    server must not read the previous run's COMPLETE and stop at boot."""
    stop_event = stop_event or threading.Event()

    def loop():
        seen_running = False
        while not stop_event.wait(poll_interval):
            status = get_status(experiment_name, trial_name)
            if status == ExpStatus.RUNNING:
                seen_running = True
            elif seen_running and status in (ExpStatus.COMPLETE, ExpStatus.ABORTED):
                logger.info(f"experiment status {status.value}; notifying watcher")
                on_terminal(status)
                return

    t = threading.Thread(target=loop, daemon=True, name="exp-status-watch")
    t.stop_event = stop_event  # type: ignore[attr-defined]
    t.start()
    return t


def run_with_status(main_fn, argv: list[str], **kwargs):
    """Entry-point wrapper: publish RUNNING before `main_fn(argv, **kwargs)`
    and COMPLETE or ABORTED after it, on the name_resolve store the config
    and its overrides select. Returns what `main_fn` returns."""
    from areal_tpu_torch.api.cli_args import NameResolveConfig, parse_cli_args

    cfg_dict, kv = parse_cli_args(argv)
    over = dict(kv)
    expr = (
        over.get("experiment_name") or cfg_dict.get("experiment_name", ""),
        over.get("trial_name") or cfg_dict.get("trial_name", ""),
    )
    if all(expr):
        nr = dict((cfg_dict.get("cluster") or {}).get("name_resolve") or {})
        for k, v in kv:
            if k.startswith("cluster.name_resolve."):
                nr[k.rsplit(".", 1)[1]] = v
        name_resolve.reconfigure(NameResolveConfig(**nr))
        publish_status(*expr, ExpStatus.RUNNING)
    try:
        out = main_fn(argv, **kwargs)
    except BaseException:
        if all(expr):
            publish_status(*expr, ExpStatus.ABORTED)
        raise
    if all(expr):
        publish_status(*expr, ExpStatus.COMPLETE)
    return out
