"""Cluster-wide key-value naming and discovery (the port's copy of
``areal_tpu/base/name_resolve.py``).

Workers publish addresses, versions and statuses under the string keys
of ``base/names.py``; peers ``get`` / ``wait`` for them. Two backends:

- ``memory``: an in-process dict (unit tests, single-process runs);
- ``nfs``: a file per key under a shared directory. Its records are the
  reference's byte for byte (value, then an optional ``__TTL__=`` line;
  expiry by mtime), and the default root is the reference's, so a URL
  the port registers is read by ``areal_tpu.base.name_resolve`` and the
  reverse.

The networked lease service of the reference (``kv``) is not ported:
selecting it raises.
"""

from __future__ import annotations

import dataclasses
import os
import random
import shutil
import threading
import time
import uuid
from abc import ABC, abstractmethod
from typing import Dict, List, Optional

from areal_tpu_torch.base import env_registry


class NameEntryExistsError(Exception):
    pass


class NameEntryNotFoundError(Exception):
    pass


class NameRecordRepository(ABC):
    """Abstract KV repository for cluster naming."""

    @abstractmethod
    def add(
        self,
        name: str,
        value: str,
        delete_on_exit: bool = True,
        keepalive_ttl: Optional[float] = None,
        replace: bool = False,
    ):
        ...

    def add_subentry(self, name: str, value: str, **kwargs) -> str:
        """Add under a unique sub-key of `name`; returns the sub-key."""
        sub_name = f"{name.rstrip('/')}/{uuid.uuid4().hex[:8]}"
        self.add(sub_name, value, **kwargs)
        return sub_name

    @abstractmethod
    def delete(self, name: str):
        ...

    @abstractmethod
    def clear_subtree(self, name_root: str):
        ...

    @abstractmethod
    def get(self, name: str) -> str:
        ...

    @abstractmethod
    def get_subtree(self, name_root: str) -> List[str]:
        """Values of all keys under `name_root`."""
        ...

    @abstractmethod
    def find_subtree(self, name_root: str) -> List[str]:
        """Keys (sorted) under `name_root`."""
        ...

    def wait(
        self,
        name: str,
        timeout: Optional[float] = None,
        poll_frequency: float = 0.1,
    ) -> str:
        """Block until `name` exists, then return its value."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self.get(name)
            except NameEntryNotFoundError:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"name_resolve.wait timeout on key: {name}")
                time.sleep(poll_frequency * (0.8 + 0.4 * random.random()))

    def reset(self):
        """Remove every entry added by this repository instance."""

    def close(self):
        self.reset()


class MemoryNameRecordRepository(NameRecordRepository):
    """In-process dict backend (single-process tests)."""

    # Class-level store so that separate instances within one process share
    # names, mirroring how a external KV service would behave.
    _store: Dict[str, str] = {}
    _lock = threading.Lock()

    def __init__(self):
        self._my_keys = set()

    def add(self, name, value, delete_on_exit=True, keepalive_ttl=None, replace=False):
        name = name.rstrip("/")
        with self._lock:
            if name in self._store and not replace:
                raise NameEntryExistsError(name)
            self._store[name] = str(value)
            if delete_on_exit:
                self._my_keys.add(name)

    def delete(self, name):
        name = name.rstrip("/")
        with self._lock:
            if name not in self._store:
                raise NameEntryNotFoundError(name)
            del self._store[name]
            self._my_keys.discard(name)

    def clear_subtree(self, name_root):
        root = name_root.rstrip("/")
        with self._lock:
            for k in [k for k in self._store if k == root or k.startswith(root + "/")]:
                del self._store[k]
                self._my_keys.discard(k)

    def get(self, name):
        name = name.rstrip("/")
        with self._lock:
            if name not in self._store:
                raise NameEntryNotFoundError(name)
            return self._store[name]

    def get_subtree(self, name_root):
        root = name_root.rstrip("/")
        with self._lock:
            keys = sorted(
                k for k in self._store if k == root or k.startswith(root + "/")
            )
            return [self._store[k] for k in keys]

    def find_subtree(self, name_root):
        root = name_root.rstrip("/")
        with self._lock:
            return sorted(k for k in self._store if k == root or k.startswith(root + "/"))

    def reset(self):
        with self._lock:
            for k in list(self._my_keys):
                self._store.pop(k, None)
            self._my_keys.clear()


class NfsNameRecordRepository(NameRecordRepository):
    """File-per-key backend under a shared directory.

    Works across processes on one host (default root under /tmp) and across
    hosts when the root lives on NFS. TTL records carry a heartbeat mtime;
    a reader treats records older than their TTL as absent.
    """

    RECORD_ROOT = env_registry.get_str("AREAL_NAME_RESOLVE_ROOT")

    def __init__(self, record_root: Optional[str] = None):
        self._root = record_root or self.RECORD_ROOT
        self._my_keys: Dict[str, bool] = {}
        self._keepalive_threads: Dict[str, threading.Event] = {}

    def _path(self, name: str) -> str:
        return os.path.join(self._root, name.strip("/"), "ENTRY")

    def add(self, name, value, delete_on_exit=True, keepalive_ttl=None, replace=False):
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp.{uuid.uuid4().hex[:8]}"
        with open(tmp, "w") as f:
            f.write(str(value))
            if keepalive_ttl is not None:
                f.write(f"\n__TTL__={keepalive_ttl}")
        if replace:
            os.replace(tmp, path)
        else:
            # Atomic create-if-absent: hard-link fails with EEXIST if a live
            # record is present, so two concurrent adders cannot both win.
            # A TTL'd record whose owner died can be replaced.
            while True:
                try:
                    os.link(tmp, path)
                    os.remove(tmp)
                    break
                except FileExistsError:
                    if self._is_expired(path):
                        try:
                            os.remove(path)
                        except FileNotFoundError:
                            pass
                        continue
                    os.remove(tmp)
                    raise NameEntryExistsError(name)
        if delete_on_exit:
            self._my_keys[name] = True
        if keepalive_ttl is not None:
            self._start_keepalive(name, path, keepalive_ttl)

    def _start_keepalive(self, name: str, path: str, ttl: float):
        old = self._keepalive_threads.pop(name, None)
        if old is not None:
            old.set()
        stop = threading.Event()
        self._keepalive_threads[name] = stop

        def _touch():
            while not stop.wait(max(ttl / 3, 0.2)):
                try:
                    os.utime(path, None)
                except OSError:
                    return

        threading.Thread(target=_touch, daemon=True).start()

    @staticmethod
    def _read(path: str):
        with open(path) as f:
            content = f.read()
        ttl = None
        if "\n__TTL__=" in content:
            content, ttl_s = content.rsplit("\n__TTL__=", 1)
            ttl = float(ttl_s)
        return content, ttl

    @classmethod
    def _is_expired(cls, path: str) -> bool:
        try:
            _, ttl = cls._read(path)
            if ttl is None:
                return False
            return time.time() - os.path.getmtime(path) > ttl * 3
        except OSError:
            return True

    def delete(self, name):
        path = self._path(name)
        if not os.path.isfile(path):
            raise NameEntryNotFoundError(name)
        os.remove(path)
        stop = self._keepalive_threads.pop(name, None)
        if stop is not None:
            stop.set()
        self._my_keys.pop(name, None)
        # Prune now-empty directories up the tree. Best-effort: a concurrent
        # add may repopulate (ENOTEMPTY) or a sibling delete may win the
        # rmdir race (ENOENT); either just ends the pruning.
        d = os.path.dirname(path)
        try:
            while d != self._root and os.path.isdir(d) and not os.listdir(d):
                os.rmdir(d)
                d = os.path.dirname(d)
        except OSError:
            pass

    def clear_subtree(self, name_root):
        d = os.path.join(self._root, name_root.strip("/"))
        if os.path.isdir(d):
            shutil.rmtree(d, ignore_errors=True)

    def get(self, name):
        path = self._path(name)
        try:
            if self._is_expired(path):
                raise NameEntryNotFoundError(name)
            value, _ = self._read(path)
        except (FileNotFoundError, NotADirectoryError):
            raise NameEntryNotFoundError(name)
        return value

    def find_subtree(self, name_root):
        d = os.path.join(self._root, name_root.strip("/"))
        found = []
        for dirpath, _, filenames in os.walk(d):
            if "ENTRY" in filenames and not self._is_expired(os.path.join(dirpath, "ENTRY")):
                found.append(os.path.relpath(dirpath, self._root))
        return sorted(found)

    def get_subtree(self, name_root):
        out = []
        for k in self.find_subtree(name_root):
            try:
                out.append(self.get(k))
            except NameEntryNotFoundError:
                # Record vanished between listing and read; skip it.
                pass
        return out

    def reset(self):
        for stop in self._keepalive_threads.values():
            stop.set()
        self._keepalive_threads.clear()
        for name in list(self._my_keys):
            try:
                self.delete(name)
            except NameEntryNotFoundError:
                pass
        self._my_keys.clear()


@dataclasses.dataclass
class _DefaultRepo:
    repo: NameRecordRepository = dataclasses.field(default_factory=NfsNameRecordRepository)


_default = _DefaultRepo()


def reconfigure(backend: str = "nfs", **kwargs):
    """Switch the process-global repository backend: 'memory' or 'nfs'
    (kwargs: record_root=...)."""
    if backend == "memory":
        _default.repo = MemoryNameRecordRepository()
    elif backend == "nfs":
        _default.repo = NfsNameRecordRepository(**kwargs)
    elif backend == "kv":
        raise NotImplementedError(
            "the kv name_resolve backend is not ported; use 'nfs' or 'memory'")
    else:
        raise NotImplementedError(f"name_resolve backend: {backend}")
    return _default.repo


# Module-level facade mirroring the reference's usage style
# (`name_resolve.add(...)`, `name_resolve.wait(...)`).
def add(name, value, **kwargs):
    return _default.repo.add(name, value, **kwargs)


def add_subentry(name, value, **kwargs):
    return _default.repo.add_subentry(name, value, **kwargs)


def delete(name):
    return _default.repo.delete(name)


def clear_subtree(name_root):
    return _default.repo.clear_subtree(name_root)


def get(name):
    return _default.repo.get(name)


def get_subtree(name_root):
    return _default.repo.get_subtree(name_root)


def find_subtree(name_root):
    return _default.repo.find_subtree(name_root)


def wait(name, timeout=None, poll_frequency=0.1):
    return _default.repo.wait(name, timeout=timeout, poll_frequency=poll_frequency)


def reset():
    return _default.repo.reset()
