"""Atomic elastic-training checkpoints — counterpart of
``deeplearning4j_tpu/elastic/checkpoint.py``: stage, fsync,
``os.replace``.

Every resize boundary saves the trainer through
:mod:`~..train.orbax_io` into a **staging** directory, renames the
finished directory into place with ``os.replace`` (atomic on POSIX:
readers see the whole checkpoint or none of it) and fsyncs its parent,
then publishes a ``LATEST.json`` pointer carrying the consistent
``(step, mesh-shape, shard-layout)`` triple the same way (temp file,
fsync, replace, fsync of the directory). A worker dying at any instant
leaves the previous pointer (staging garbage is invisible) or the new
one (the directory it names is complete), never a torn checkpoint.

The pointer's keys and values are the reference's (``path``, ``step``,
``dp``, ``mesh_shape``, ``layout``, ``cause``), so either package's
:func:`latest` reads the other's pointer (the directory it names is
each package's own format, ``train/orbax_io``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import NamedTuple, Optional, Tuple

_POINTER = "LATEST.json"


class CheckpointInfo(NamedTuple):
    """The consistent resume triple and where it lives on disk."""

    path: str
    step: int
    dp: int
    mesh_shape: Tuple[Tuple[str, int], ...]
    layout: str          # shard-layout fingerprint ("zero1")
    cause: str           # what forced this boundary ("post_resize_...", ...)


def _fsync_dir(path: str) -> None:
    # a rename is durable only once the directory entry is synced
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_pointer(workdir: str, payload: dict) -> None:
    final = os.path.join(workdir, _POINTER)
    tmp = os.path.join(workdir, f".{_POINTER}.{os.getpid()}.tmp")
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f, sort_keys=True, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        _fsync_dir(workdir)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_atomic(workdir: str, trainer, *, step: int, dp: int,
                mesh_shape, layout: str = "zero1",
                cause: str = "resize") -> CheckpointInfo:
    """Publish one atomic checkpoint of ``trainer`` (anything
    :func:`~..train.orbax_io.save_trainer` takes) under ``workdir``::

        workdir/staging/<name>.<pid>   written here (crash garbage)
        workdir/ckpt/<name>            os.replace target (all or nothing)
        workdir/LATEST.json            the pointer, replaced atomically

    Re-reaching a published ``(step, dp)`` (a resumed run under the same
    seed) keeps the published copy: its contents are the same."""
    from ..train import orbax_io

    workdir = os.path.abspath(workdir)
    name = f"step{int(step):08d}_dp{int(dp)}"
    ckpt_root = os.path.join(workdir, "ckpt")
    os.makedirs(ckpt_root, exist_ok=True)
    final = os.path.join(ckpt_root, name)
    if not os.path.exists(final):
        staging = os.path.join(workdir, "staging", f"{name}.{os.getpid()}")
        if os.path.exists(staging):  # garbage from an earlier crashed run
            shutil.rmtree(staging)
        os.makedirs(os.path.dirname(staging), exist_ok=True)
        orbax_io.save_trainer(staging, trainer)
        os.replace(staging, final)
        _fsync_dir(ckpt_root)
    info = CheckpointInfo(final, int(step), int(dp),
                          tuple((str(a), int(n)) for a, n in mesh_shape),
                          str(layout), str(cause))
    _write_pointer(workdir, {"path": info.path, "step": info.step,
                             "dp": info.dp,
                             "mesh_shape": [list(p) for p in info.mesh_shape],
                             "layout": info.layout, "cause": info.cause})
    return info


def latest(workdir: str) -> Optional[CheckpointInfo]:
    """The last published checkpoint triple, or None (a fresh workdir)."""
    pointer = os.path.join(os.path.abspath(workdir), _POINTER)
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        rec = json.load(f)
    return CheckpointInfo(rec["path"], int(rec["step"]), int(rec["dp"]),
                          tuple((str(a), int(n))
                                for a, n in rec["mesh_shape"]),
                          str(rec.get("layout", "zero1")),
                          str(rec.get("cause", "resize")))
