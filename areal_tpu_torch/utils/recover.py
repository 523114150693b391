"""Step-level fault recovery: crash-atomic, versioned checkpoints of the
whole training state and their restore (counterpart of
`areal_tpu/utils/recover.py`, :110-460). Layout:

  {fileroot}/recover/{experiment}/{trial}/
      step-{G}/            one committed recovery point per dump
          checkpoint/      the engine's state in the port's recovery
                           format (`TorchTrainEngine.save`,
                           weight_format="torch": parameters, optimizer,
                           train_meta.json)
          recover_info.pkl StepInfo, the saver's, evaluator's and this
                           handler's gate states, the dataloader position,
                           the sample ledger's state and the version
          MANIFEST.json    path, size and sha256 of every file above,
                           fsynced before the rename commits the step (the
                           pickle is read only after its checksum verifies)
      step-{G}.tmp/        a dump in progress or one that crashed; never a
                           candidate for load
      ledger.wal           the consumed-batch journal (core/sample_ledger)

A dump writes everything into `step-{G}.tmp`, fsyncs the files and then
the manifest, renames the directory to `step-{G}` (the commit point),
fsyncs the parent, and only then prunes to the newest `keep_last`. A dump
that fails at any point degrades to a log line and the
`recover_dump_failures_total` counter, and the gate fires again at its
next cadence. `load` walks the committed steps newest to oldest and skips
a torn, mismatched or half-deleted candidate (`recover_torn_skipped_total`)
instead of crashing.

Left out: the JAX module's fault-injection seams
(`core/fault_injection.fire` at `recover.dump.save`, `.info`, `.marker` and
`recover.load`), whose harness is ROADMAP queue 1, item 7.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil
import threading
from dataclasses import dataclass, field

from areal_tpu_torch.api.cli_args import RecoverConfig
from areal_tpu_torch.api.io_struct import FinetuneSpec, SaveLoadMeta, StepInfo
from areal_tpu_torch.utils import logging
from areal_tpu_torch.utils.timeutil import FrequencyControl

logger = logging.getLogger("recover")

_STEP_PREFIX = "step-"
_TMP_SUFFIX = ".tmp"
_MANIFEST = "MANIFEST.json"
_INFO_FILE = "recover_info.pkl"
# the engine's checkpoint format inside a recovery point
CHECKPOINT_FORMAT = "torch"
# name of the sample-ledger write-ahead journal colocated with the steps
LEDGER_WAL = "ledger.wal"


class _RecoverMetrics:
    """Process-wide recovery counters: a handler made anew after a restart
    must not zero them."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}

    def bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()


_METRICS = _RecoverMetrics()


def get_metrics() -> dict[str, int]:
    """recover_dumps_total, recover_dump_failures_total,
    recover_torn_skipped_total, recover_pruned_total, recover_loads_total."""
    return _METRICS.snapshot()


def reset_metrics() -> None:
    _METRICS.reset()


@dataclass
class RecoverInfo:
    last_step_info: StepInfo
    saver_info: dict = field(default_factory=dict)
    evaluator_info: dict = field(default_factory=dict)
    dataloader_info: dict = field(default_factory=dict)
    # the handler's own gate state: without it a resumed run's gate starts
    # cold and re-fires at once or skips a dump
    recover_ctl_info: dict = field(default_factory=dict)
    # WorkflowExecutor.state_dict(): sample ledger and staleness accounting
    ledger_info: dict = field(default_factory=dict)
    version: int = 0


def recover_root(config: RecoverConfig) -> str:
    return os.path.join(config.fileroot, "recover", config.experiment_name, config.trial_name)


def ledger_wal_path(config: RecoverConfig) -> str:
    """The sample-ledger WAL colocated with, and discarded with, the
    recovery state."""
    return os.path.join(recover_root(config), LEDGER_WAL)


# -- manifest ---------------------------------------------------------------


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # a file system without directory fds: best effort
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_manifest(step_dir: str, global_step: int) -> None:
    """Seal `step_dir`: path, size and sha256 of every file, the payloads
    fsynced, then the manifest itself. The last write before the rename:
    a directory whose manifest does not verify is torn."""
    files = []
    for dirpath, _dirnames, filenames in os.walk(step_dir):
        for name in sorted(filenames):
            if dirpath == step_dir and name == _MANIFEST:
                continue
            full = os.path.join(dirpath, name)
            files.append(dict(path=os.path.relpath(full, step_dir),
                              size=os.path.getsize(full), sha256=_sha256(full)))
            with open(full, "rb") as f:
                os.fsync(f.fileno())
    manifest = dict(global_step=global_step, files=sorted(files, key=lambda d: d["path"]))
    with open(os.path.join(step_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(step_dir)


def verify_step_dir(step_dir: str) -> tuple[bool, str]:
    """Check a committed step directory against its manifest: (ok, reason).
    Never raises."""
    try:
        with open(os.path.join(step_dir, _MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return False, f"manifest unreadable: {e!r}"
    entries = manifest.get("files", [])
    if not any(e["path"] == _INFO_FILE for e in entries):
        return False, f"manifest lists no {_INFO_FILE}"
    for entry in entries:
        full = os.path.join(step_dir, entry["path"])
        if not os.path.exists(full):
            return False, f"missing file {entry['path']}"
        if os.path.getsize(full) != entry["size"]:
            return False, f"size mismatch for {entry['path']}"
        if _sha256(full) != entry["sha256"]:
            return False, f"checksum mismatch for {entry['path']}"
    return True, "ok"


def _step_dirs_newest_first(root: str) -> list[tuple[int, str]]:
    """Committed [(global_step, path)], newest first; `.tmp` and `.old`
    directories are never candidates."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        full = os.path.join(root, name)
        if not name.startswith(_STEP_PREFIX) or not os.path.isdir(full):
            continue
        try:
            out.append((int(name[len(_STEP_PREFIX):]), full))
        except ValueError:
            continue
    return sorted(out, reverse=True)


def check_if_auto_recover(config: RecoverConfig) -> bool:
    """True when the mode resumes and a manifest-verified recovery point
    exists; a torn or half-deleted one reads as no recoverable state."""
    if config.mode not in ("auto", "resume", "fault"):
        return False
    candidates = _step_dirs_newest_first(recover_root(config))
    for g, path in candidates:
        ok, reason = verify_step_dir(path)
        if ok:
            return True
        logger.warning(f"recover candidate step-{g} fails verification ({reason}); "
                       f"checking older checkpoints")
    if candidates:
        logger.warning("no recoverable state: every recover candidate failed "
                       "manifest verification")
    return False


class RecoverHandler:
    def __init__(self, config: RecoverConfig, ft_spec: FinetuneSpec):
        self.config = config
        self.ft_spec = ft_spec
        self.freq_ctl = FrequencyControl(
            freq_epoch=config.freq_epochs,
            freq_step=config.freq_steps,
            freq_sec=config.freq_secs,
        )

    # -- dump -----------------------------------------------------------
    def dump(self, engine, step_info: StepInfo, saver=None, evaluator=None, dataloader=None,
             tokenizer=None, force: bool = False, rollout=None) -> str | None:
        """Write one crash-atomic recovery point; returns the committed
        `step-{G}` path, or None when the gate did not fire or the dump
        failed. `rollout` (the decode engine, delegating to its
        `WorkflowExecutor`) has its sample ledger journaled with it."""
        if self.config.mode == "disabled":
            return None
        if not force and not self.freq_ctl.check(
            epochs=int(step_info.epoch_step == step_info.steps_per_epoch - 1), steps=1
        ):
            return None
        try:
            return self._dump_step(engine, step_info, saver, evaluator, dataloader, tokenizer,
                                   rollout)
        except Exception as e:  # noqa: BLE001 — a failed dump must not kill training
            _METRICS.bump("recover_dump_failures_total")
            logger.error(
                f"recover dump failed at global_step {step_info.global_step} ({e!r}); "
                f"previous recovery points are intact, retrying at the next frequency gate"
            )
            return None

    def _dump_step(self, engine, step_info, saver, evaluator, dataloader, tokenizer,
                   rollout) -> str:
        root = recover_root(self.config)
        os.makedirs(root, exist_ok=True)
        g = step_info.global_step
        final = os.path.join(root, f"{_STEP_PREFIX}{g}")
        tmp = final + _TMP_SUFFIX
        # a crashed attempt at this step leaves a stale tmp; a replayed step
        # after recovery finds a committed step-{G}, which stays valid until
        # this dump commits (displaced at the rename below)
        for stale in (tmp, final + ".old"):
            if os.path.exists(stale):
                shutil.rmtree(stale)
        ckpt = os.path.join(tmp, "checkpoint")
        os.makedirs(ckpt)
        engine.save(SaveLoadMeta(path=ckpt, weight_format=CHECKPOINT_FORMAT, with_optim=True,
                                 tokenizer=tokenizer))
        info = RecoverInfo(
            last_step_info=step_info,
            saver_info=saver.state_dict() if saver is not None else {},
            evaluator_info=evaluator.state_dict() if evaluator is not None else {},
            dataloader_info=(dataloader.state_dict()
                             if dataloader is not None and hasattr(dataloader, "state_dict")
                             else {}),
            recover_ctl_info=self.freq_ctl.state_dict(),
            ledger_info=(rollout.state_dict()
                         if rollout is not None and hasattr(rollout, "state_dict") else {}),
            version=engine.get_version(),
        )
        with open(os.path.join(tmp, _INFO_FILE), "wb") as f:
            pickle.dump(info, f)
            f.flush()
            os.fsync(f.fileno())
        _write_manifest(tmp, g)
        if os.path.exists(final):
            # a replayed step: move the old directory to a name that is no
            # candidate, so the window without a recovery point for G is
            # two renames long
            os.rename(final, final + ".old")
            os.rename(tmp, final)  # the commit point
            shutil.rmtree(final + ".old")
        else:
            os.rename(tmp, final)  # the commit point
        _fsync_dir(root)
        _METRICS.bump("recover_dumps_total")
        logger.info(f"dumped recover checkpoint at global_step {g} -> {final}")
        self._prune(root)
        return final

    def _prune(self, root: str) -> None:
        keep = max(1, int(self.config.keep_last))
        for g, path in _step_dirs_newest_first(root)[keep:]:
            try:
                shutil.rmtree(path)
                _METRICS.bump("recover_pruned_total")
            except OSError as e:  # a stuck prune costs disk, not correctness
                logger.warning(f"failed to prune recover step-{g}: {e!r}")

    # -- load -----------------------------------------------------------
    def load(self, engine, saver=None, evaluator=None, dataloader=None, inference_engine=None,
             weight_update_meta=None) -> RecoverInfo | None:
        """Restore everything from the newest verified recovery point and
        return its RecoverInfo (resume at `.last_step_info.next()`), or None
        when none is usable. With `inference_engine`, its version and sample
        ledger are restored too, and with `weight_update_meta` the restored
        weights are pushed to it."""
        if self.config.mode not in ("auto", "resume", "fault"):
            return None
        for g, path in _step_dirs_newest_first(recover_root(self.config)):
            try:
                ok, reason = verify_step_dir(path)
                if not ok:
                    raise RuntimeError(reason)
                # the manifest checksummed the pickle: only now is it read
                with open(os.path.join(path, _INFO_FILE), "rb") as f:
                    info: RecoverInfo = pickle.load(f)
                engine.load(SaveLoadMeta(path=os.path.join(path, "checkpoint"),
                                         weight_format=CHECKPOINT_FORMAT, with_optim=True))
            except Exception as e:  # noqa: BLE001 — walk to the next-older candidate
                _METRICS.bump("recover_torn_skipped_total")
                logger.warning(f"skipping recover candidate step-{g} ({e!r}); "
                               f"falling back to an older checkpoint")
                continue
            engine.set_version(info.version)
            if saver is not None and info.saver_info:
                saver.load_state_dict(info.saver_info)
            if evaluator is not None and info.evaluator_info:
                evaluator.load_state_dict(info.evaluator_info)
            if dataloader is not None and info.dataloader_info:
                dataloader.load_state_dict(info.dataloader_info)
            if info.recover_ctl_info:
                self.freq_ctl.load_state_dict(info.recover_ctl_info)
            if inference_engine is not None:
                inference_engine.set_version(info.version)
                if info.ledger_info and hasattr(inference_engine, "load_state_dict"):
                    inference_engine.load_state_dict(info.ledger_info)
                if weight_update_meta is not None:
                    # the decode engine serves the restored weights
                    engine.update_weights(weight_update_meta)
            _METRICS.bump("recover_loads_total")
            logger.info(f"recovered from global_step {info.last_step_info.global_step} "
                        f"(version {info.version}, checkpoint {path})")
            return info
        return None

    def state_dict(self) -> dict:
        return self.freq_ctl.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.freq_ctl.load_state_dict(state)


def discard_recover_state(config: RecoverConfig) -> None:
    root = recover_root(config)
    if os.path.exists(root):
        shutil.rmtree(root)
