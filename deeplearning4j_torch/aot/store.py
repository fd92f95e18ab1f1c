"""Content-addressed on-disk store — the port's copy of
``deeplearning4j_tpu/aot/store.py`` (stdlib only, byte-for-byte the same
layout, index, eviction and quarantine). On the card it holds what a
second boot would otherwise have to produce: the built kernel
libraries, tuned configs and cost profiles; coverage records sit beside
the entries, under ``coverage/`` (see the package docstring).

Layout under one root directory::

    <root>/<key[:2]>/<key>.aotx     one entry per cache key (see keys.py)
    <root>/index.json               manifest: key -> {size, created, used, ...}
    <root>/quarantine/<key>.aotx    entries that failed integrity checks

Durability rules, in order of importance:

- **A reader can never observe a half-written entry.** Writes go to a
  temp file in the same directory, fsync, then ``os.replace`` (the POSIX
  atomic-publish idiom).
- **Corruption degrades, never crashes.** Every entry carries a magic tag
  and a SHA-256 of its body; a failed check moves the file to
  ``quarantine/`` (atomically, so it cannot be re-read) and surfaces as a
  typed :class:`AotCorruptEntry` for the caller to count and trace around.
- **The entry files are ground truth.** ``index.json`` is a best-effort
  LRU/bookkeeping cache, rebuilt from the entry files whenever it is
  missing or unreadable: losing it loses recency ordering, not data.
- **Bounded size.** ``max_bytes`` triggers least-recently-used eviction at
  write time; concurrent readers of an evicted entry simply see a miss.

The store root is trusted local state (entries include shared libraries
that a boot loads): point it at a directory with the permissions you would
give the checkpoint directory.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..chaos import faults as _faults

_MAGIC = b"DL4JAOT1"
_SUFFIX = ".aotx"
_DIGEST_LEN = 32  # raw sha256


class AotStoreError(RuntimeError):
    """Base class for typed store failures."""


class AotCorruptEntry(AotStoreError):
    """An entry failed its integrity check and was quarantined."""


class AotVersionError(AotStoreError):
    """A payload was recorded by another runtime (torch, CUDA, card or
    kernel sources)."""


class AotStore:
    """Thread-safe persistent executable store.

    ``max_bytes`` bounds the sum of entry sizes (default 4 GiB — a few
    hundred serving executables); ``0``/``None`` disables eviction.
    """

    def __init__(self, root: str, max_bytes: Optional[int] = 4 << 30):
        self.root = os.path.abspath(os.fspath(root))
        self.max_bytes = int(max_bytes) if max_bytes else 0
        self._lock = threading.Lock()  # guards index read-modify-write
        os.makedirs(self.root, exist_ok=True)
        os.makedirs(self._qdir, exist_ok=True)

    # ------------------------------------------------------------------ paths
    @property
    def _index_path(self) -> str:
        return os.path.join(self.root, "index.json")

    @property
    def _qdir(self) -> str:
        return os.path.join(self.root, "quarantine")

    def _entry_path(self, key: str) -> str:
        self._check_key(key)
        return os.path.join(self.root, key[:2], key + _SUFFIX)

    @staticmethod
    def _check_key(key: str) -> None:
        if not key or not all(c in "0123456789abcdef" for c in key):
            raise ValueError(f"malformed store key {key!r}")

    # ---------------------------------------------------------------- entries
    def put(self, key: str, blob: bytes, meta: Optional[dict] = None) -> bool:
        """Atomically publish one entry; returns False (never raises) on
        I/O failure — a store write must not take the serving path down."""
        path = self._entry_path(key)
        body = _MAGIC + hashlib.sha256(blob).digest() + blob
        tmp = os.path.join(os.path.dirname(path),
                           f".{key}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(body)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)  # atomic publish: readers see all or nothing
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False
        now = time.time()
        with self._lock:
            index = self._load_index()
            index[key] = {"size": len(body), "created": now, "used": now,
                          **({"meta": meta} if meta else {})}
            self._evict_locked(index)
            self._write_index(index)
        return True

    def get(self, key: str) -> Optional[bytes]:
        """Verified payload bytes, or None on a miss. A failed integrity
        check quarantines the entry and raises :class:`AotCorruptEntry`."""
        path = self._entry_path(key)
        try:
            with open(path, "rb") as f:
                body = f.read()
            if _faults.ACTIVE is not None:
                # inside the try so an injected OSError surfaces exactly as
                # a real torn read would (typed AotStoreError); corrupt mode
                # mangles the body and exercises quarantine below
                body = _faults.ACTIVE.hit("aot.store_read", body)
        except FileNotFoundError:
            return None
        except OSError as e:
            raise AotStoreError(f"unreadable store entry {key}: {e}") from e
        head = len(_MAGIC) + _DIGEST_LEN
        if (len(body) < head or not body.startswith(_MAGIC)
                or hashlib.sha256(body[head:]).digest()
                != body[len(_MAGIC):head]):
            self._quarantine(key)
            raise AotCorruptEntry(
                f"store entry {key} failed its integrity check; quarantined")
        with self._lock:
            index = self._load_index()
            if key in index:
                index[key]["used"] = time.time()
                self._write_index(index)
        return body[head:]

    def _quarantine(self, key: str) -> None:
        """Move a bad entry aside atomically so it can never be re-read."""
        try:
            os.replace(self._entry_path(key),
                       os.path.join(self._qdir, key + _SUFFIX))
        except OSError:
            pass  # lost the race with another quarantiner/GC: already gone
        with self._lock:
            index = self._load_index()
            if index.pop(key, None) is not None:
                self._write_index(index)

    # ------------------------------------------------------------------ index
    def _load_index(self) -> Dict[str, dict]:
        """Best-effort manifest; a missing/corrupt file rebuilds from the
        entry files (ground truth) with recency reset to mtime."""
        try:
            with open(self._index_path) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict):
                return {k: v for k, v in loaded.items()
                        if isinstance(v, dict) and "size" in v}
        except (OSError, ValueError):
            pass
        index: Dict[str, dict] = {}
        for key, path in self._scan_entries():
            try:
                st = os.stat(path)
            except OSError:
                continue
            index[key] = {"size": st.st_size, "created": st.st_mtime,
                          "used": st.st_mtime}
        return index

    def _write_index(self, index: Dict[str, dict]) -> None:
        tmp = self._index_path + f".{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(index, f)
            os.replace(tmp, self._index_path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass  # manifest is advisory; entries remain ground truth

    def _scan_entries(self) -> List[Tuple[str, str]]:
        out = []
        for sub in sorted(os.listdir(self.root)):
            d = os.path.join(self.root, sub)
            if len(sub) != 2 or not os.path.isdir(d):
                continue
            for name in sorted(os.listdir(d)):
                if name.endswith(_SUFFIX) and not name.startswith("."):
                    out.append((name[:-len(_SUFFIX)], os.path.join(d, name)))
        return out

    def rebuild_index(self) -> int:
        """Regenerate the manifest from the entry files; returns entry count."""
        with self._lock:
            try:
                os.remove(self._index_path)
            except OSError:
                pass
            index = self._load_index()
            self._write_index(index)
            return len(index)

    # --------------------------------------------------------------- eviction
    def _evict_locked(self, index: Dict[str, dict]) -> List[str]:
        if not self.max_bytes:
            return []
        total = sum(e["size"] for e in index.values())
        evicted = []
        for key in sorted(index, key=lambda k: index[k].get("used", 0.0)):
            if total <= self.max_bytes:
                break
            total -= index[key]["size"]
            del index[key]
            evicted.append(key)
            try:
                os.remove(self._entry_path(key))
            except OSError:
                pass  # already gone; a concurrent reader sees a clean miss
        return evicted

    def gc(self, max_bytes: Optional[int] = None) -> List[str]:
        """LRU-evict down to ``max_bytes`` (default: the store's bound);
        returns the evicted keys. Also drops index entries whose files have
        vanished."""
        with self._lock:
            index = self._load_index()
            on_disk = {k for k, _ in self._scan_entries()}
            for k in list(index):
                if k not in on_disk:
                    del index[k]
            bound = self.max_bytes
            if max_bytes is not None:
                self.max_bytes = int(max_bytes)
            try:
                evicted = self._evict_locked(index)
            finally:
                if max_bytes is not None:
                    self.max_bytes = bound
            self._write_index(index)
            return evicted

    # ------------------------------------------------------------ maintenance
    def verify(self) -> dict:
        """Integrity-check every entry; corrupt ones are quarantined.
        Returns {"ok": [...keys], "quarantined": [...keys]}."""
        ok, bad = [], []
        for key, _path in self._scan_entries():
            try:
                if self.get(key) is not None:
                    ok.append(key)
            except AotStoreError:
                bad.append(key)
        return {"ok": ok, "quarantined": bad}

    def keys(self) -> List[str]:
        return [k for k, _ in self._scan_entries()]

    def entries(self) -> Dict[str, dict]:
        """Manifest snapshot (key -> size/created/used/meta)."""
        with self._lock:
            return self._load_index()

    def stats(self) -> dict:
        with self._lock:
            index = self._load_index()
            try:
                quarantined = len([n for n in os.listdir(self._qdir)
                                   if n.endswith(_SUFFIX)])
            except OSError:
                quarantined = 0
            return {"root": self.root,
                    "entries": len(index),
                    "bytes": sum(e["size"] for e in index.values()),
                    "max_bytes": self.max_bytes,
                    "quarantined": quarantined}
