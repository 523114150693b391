"""Distributed key-value discovery (counterpart of
`areal_tpu/utils/name_resolve.py`), with its two always-available
backends:

- `MemoryNameRecordRepository`: an in-process dict, for one process.
- `NfsNameRecordRepository`: one file per key, `<root>/<key>/ENTRY`,
  under a shared filesystem root; what one process (of either package)
  writes there, another reads.

The etcd3 and ray backends are refused by `reconfigure` (ROADMAP.md
queue 1, item 5).
"""

from __future__ import annotations

import os
import shutil
import threading
import time
import uuid
from pathlib import Path

from areal_tpu_torch.api.cli_args import NameResolveConfig
from areal_tpu_torch.utils import logging

logger = logging.getLogger("name_resolve")

__all__ = ["NameResolveConfig", "NameEntryExistsError", "NameEntryNotFoundError"]


class NameEntryExistsError(Exception):
    pass


class NameEntryNotFoundError(Exception):
    pass


class NameRecordRepository:
    """A name-record store. Keys are slash-separated paths."""

    def add(self, name: str, value: str, delete_on_exit: bool = True,
            keepalive_ttl: float | None = None, replace: bool = False) -> None:
        raise NotImplementedError()

    def get(self, name: str) -> str:
        raise NotImplementedError()

    def get_subtree(self, name_root: str) -> list[str]:
        """The values of every key under `name_root`, in key order."""
        raise NotImplementedError()

    def find_subtree(self, name_root: str) -> list[str]:
        """Every key under `name_root` (sorted)."""
        raise NotImplementedError()

    def delete(self, name: str) -> None:
        raise NotImplementedError()

    def clear_subtree(self, name_root: str) -> None:
        raise NotImplementedError()

    def reset(self) -> None:
        """Remove every entry this process added with delete_on_exit."""
        raise NotImplementedError()

    def wait(self, name: str, timeout: float | None = None, poll_frequency: float = 0.1) -> str:
        """Block until `name` appears, then return its value."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self.get(name)
            except NameEntryNotFoundError:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"name_resolve.wait({name}) timed out") from None
                time.sleep(poll_frequency)


class MemoryNameRecordRepository(NameRecordRepository):
    def __init__(self):
        self._store: dict[str, str] = {}
        self._lock = threading.Lock()
        self._owned: set[str] = set()

    def add(self, name, value, delete_on_exit=True, keepalive_ttl=None, replace=False):
        name = name.rstrip("/")
        with self._lock:
            if name in self._store and not replace:
                raise NameEntryExistsError(name)
            self._store[name] = str(value)
            if delete_on_exit:
                self._owned.add(name)

    def get(self, name):
        name = name.rstrip("/")
        with self._lock:
            if name not in self._store:
                raise NameEntryNotFoundError(name)
            return self._store[name]

    def find_subtree(self, name_root):
        prefix = name_root.rstrip("/")
        with self._lock:
            return sorted(k for k in self._store if k == prefix or k.startswith(prefix + "/"))

    def get_subtree(self, name_root):
        prefix = name_root.rstrip("/")
        with self._lock:
            keys = sorted(k for k in self._store if k == prefix or k.startswith(prefix + "/"))
            return [self._store[k] for k in keys]

    def delete(self, name):
        name = name.rstrip("/")
        with self._lock:
            if name not in self._store:
                raise NameEntryNotFoundError(name)
            del self._store[name]
            self._owned.discard(name)

    def clear_subtree(self, name_root):
        for k in self.find_subtree(name_root):
            with self._lock:
                self._store.pop(k, None)
                self._owned.discard(k)

    def reset(self):
        with self._lock:
            for k in list(self._owned):
                self._store.pop(k, None)
            self._owned.clear()


class NfsNameRecordRepository(NameRecordRepository):
    """One file per key under `record_root`, written by rename (a replace)
    or by link(2) (an atomic create-if-absent). An entry with a TTL has a
    `ENTRY.ttl` file beside it; a keepalive thread refreshes the entry's
    mtime while its owner lives, and readers treat an entry older than its
    TTL as missing."""

    TTL_SUFFIX = ".ttl"

    def __init__(self, record_root: str = "/tmp/areal_tpu/name_resolve"):
        self.record_root = Path(record_root)
        self.record_root.mkdir(parents=True, exist_ok=True)
        self._owned: set[str] = set()
        self._keepalive_stop = threading.Event()
        self._keepalive_entries: dict[str, float] = {}
        self._keepalive_thread: threading.Thread | None = None
        self._lock = threading.Lock()

    def _path(self, name: str) -> Path:
        return self.record_root / name.strip("/") / "ENTRY"

    def add(self, name, value, delete_on_exit=True, keepalive_ttl=None, replace=False):
        p = self._path(name)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.parent / f".tmp-{uuid.uuid4().hex}"
        tmp.write_text(str(value))
        if replace:
            os.replace(tmp, p)
        else:
            try:
                os.link(tmp, p)
            except FileExistsError:
                if not self._expired(p):
                    tmp.unlink()
                    raise NameEntryExistsError(name) from None
                # a stale TTL entry: remove it and claim the name again
                try:
                    p.unlink()
                except FileNotFoundError:
                    pass
                try:
                    os.link(tmp, p)
                except FileExistsError:
                    tmp.unlink()
                    raise NameEntryExistsError(name) from None
            tmp.unlink()
        ttl_file = Path(str(p) + self.TTL_SUFFIX)
        if keepalive_ttl is not None:
            ttl_file.write_text(str(float(keepalive_ttl)))
            with self._lock:
                self._keepalive_entries[str(p)] = float(keepalive_ttl)
            self._ensure_keepalive_thread()
        else:
            if ttl_file.exists():
                ttl_file.unlink()
            with self._lock:
                self._keepalive_entries.pop(str(p), None)
        if delete_on_exit:
            self._owned.add(name)

    def _expired(self, p: Path) -> bool:
        ttl_file = Path(str(p) + self.TTL_SUFFIX)
        if not ttl_file.exists():
            return False
        try:
            return time.time() - p.stat().st_mtime > float(ttl_file.read_text())
        except (OSError, ValueError):
            return False

    def _ensure_keepalive_thread(self):
        if self._keepalive_thread is not None and self._keepalive_thread.is_alive():
            return
        self._keepalive_stop.clear()

        def _loop():
            while True:
                with self._lock:
                    entries = dict(self._keepalive_entries)
                # refresh well within the smallest TTL
                interval = min([1.0] + [ttl / 3.0 for ttl in entries.values()])
                if self._keepalive_stop.wait(timeout=max(interval, 0.01)):
                    return
                with self._lock:
                    entries = dict(self._keepalive_entries)
                for path in entries:
                    try:
                        os.utime(path)
                    except OSError:
                        pass

        self._keepalive_thread = threading.Thread(target=_loop, daemon=True)
        self._keepalive_thread.start()

    def get(self, name):
        p = self._path(name)
        if not p.exists() or self._expired(p):
            raise NameEntryNotFoundError(name)
        return p.read_text()

    def find_subtree(self, name_root):
        root = self.record_root / name_root.strip("/")
        if not root.exists():
            return []
        return sorted(
            str(entry.parent.relative_to(self.record_root))
            for entry in root.rglob("ENTRY")
            if not self._expired(entry)
        )

    def get_subtree(self, name_root):
        out = []
        for k in self.find_subtree(name_root):
            # an entry may go between the listing and the read
            try:
                out.append(self.get(k))
            except (NameEntryNotFoundError, FileNotFoundError):
                continue
        return out

    def delete(self, name):
        p = self._path(name)
        if not p.exists():
            raise NameEntryNotFoundError(name)
        p.unlink()
        ttl_file = Path(str(p) + self.TTL_SUFFIX)
        if ttl_file.exists():
            ttl_file.unlink()
        with self._lock:
            self._keepalive_entries.pop(str(p), None)
        self._owned.discard(name)

    def clear_subtree(self, name_root):
        root = self.record_root / name_root.strip("/")
        if root.exists():
            shutil.rmtree(root, ignore_errors=True)
        prefix = name_root.strip("/")
        self._owned = {
            n for n in self._owned
            if n.strip("/") != prefix and not n.strip("/").startswith(prefix + "/")
        }

    def reset(self):
        self._keepalive_stop.set()
        if self._keepalive_thread is not None:
            self._keepalive_thread.join(timeout=2.0)
            self._keepalive_thread = None
        self._keepalive_stop.clear()
        for name in list(self._owned):
            try:
                self.delete(name)
            except NameEntryNotFoundError:
                pass
        self._owned.clear()


_default_repo: NameRecordRepository = MemoryNameRecordRepository()


def reconfigure(config: NameResolveConfig) -> None:
    """Point this process's module-level functions at `config`'s store."""
    global _default_repo
    if config.type == "memory":
        _default_repo = MemoryNameRecordRepository()
    elif config.type == "nfs":
        _default_repo = NfsNameRecordRepository(config.nfs_record_root)
    elif config.type in ("etcd3", "ray"):
        raise NotImplementedError(
            f"name_resolve type={config.type!r} is not in the PyTorch port yet: "
            "ROADMAP.md queue 1, item 5"
        )
    else:
        raise NotImplementedError(
            f"name_resolve backend {config.type!r} is not known "
            "(memory, nfs, etcd3, ray)"
        )


def to_env(config: NameResolveConfig) -> dict[str, str]:
    """The environment that gives a subprocess (a decode server, a
    trainer) the same store as this process (`reconfigure_from_env`)."""
    return {
        "AREAL_NAME_RESOLVE_TYPE": config.type,
        "AREAL_NAME_RESOLVE_NFS_ROOT": config.nfs_record_root,
        "AREAL_NAME_RESOLVE_ETCD_ADDR": config.etcd3_addr,
        "AREAL_NAME_RESOLVE_RAY_ACTOR": config.ray_actor_name,
    }


def reconfigure_from_env() -> bool:
    """Apply the AREAL_NAME_RESOLVE_* environment a launcher set; returns
    whether there was one."""
    t = os.environ.get("AREAL_NAME_RESOLVE_TYPE")
    if not t:
        return False
    reconfigure(NameResolveConfig(
        type=t,
        nfs_record_root=os.environ.get("AREAL_NAME_RESOLVE_NFS_ROOT",
                                       "/tmp/areal_tpu/name_resolve"),
        etcd3_addr=os.environ.get("AREAL_NAME_RESOLVE_ETCD_ADDR", "localhost:2379"),
        ray_actor_name=os.environ.get("AREAL_NAME_RESOLVE_RAY_ACTOR", "name_resolve"),
    ))
    return True


def add(name, value, **kwargs):
    return _default_repo.add(name, value, **kwargs)


def get(name):
    return _default_repo.get(name)


def get_subtree(name_root):
    return _default_repo.get_subtree(name_root)


def find_subtree(name_root):
    return _default_repo.find_subtree(name_root)


def delete(name):
    return _default_repo.delete(name)


def clear_subtree(name_root):
    return _default_repo.clear_subtree(name_root)


def wait(name, timeout=None, poll_frequency=0.1):
    return _default_repo.wait(name, timeout=timeout, poll_frequency=poll_frequency)


def reset():
    return _default_repo.reset()
