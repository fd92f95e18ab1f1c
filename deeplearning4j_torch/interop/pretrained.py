"""Pretrained zoo checkpoints — counterpart of
``deeplearning4j_tpu/interop/pretrained.py``: the sha256 sidecar written
beside a published checkpoint zip and checked when it is loaded, so a
checkpoint published by either package verifies in the other.

The keras.applications conversion is not ported yet (ROADMAP.md, Queue 1,
item 16, ``interop/``): :func:`convert_keras_application` raises.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

# zoo name -> keras.applications factory attribute
KERAS_APPLICATIONS = {
    "vgg16": "VGG16",
    "vgg19": "VGG19",
    "resnet50": "ResNet50",
}


def sha256_of(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_checksum(path) -> Path:
    """Record ``<zip>.sha256`` next to a published checkpoint."""
    side = Path(str(path) + ".sha256")
    side.write_text(sha256_of(path) + "\n")
    return side


class ChecksumMismatch(OSError):
    """A cached checkpoint's digest differs from its recorded sidecar (a
    type of its own, so that deleting a corrupt file is never triggered by
    a transient I/O error)."""


def verify_checksum(path) -> bool:
    """True if no sidecar exists or the digest matches; raises
    :class:`ChecksumMismatch` otherwise."""
    side = Path(str(path) + ".sha256")
    if not side.exists():
        return True
    expected = side.read_text().strip()
    actual = sha256_of(path)
    if actual != expected:
        raise ChecksumMismatch(
            f"pretrained checkpoint {path} is corrupt: sha256 {actual} != "
            f"recorded {expected} — delete it and publish it again")
    return True


def convert_keras_application(name: str, **kwargs):
    """The keras.applications conversion into a zoo checkpoint: not ported
    yet."""
    raise NotImplementedError(
        f"converting keras.applications '{name}' is not ported yet "
        f"(ROADMAP.md, Queue 1, item 16, interop/): publish the checkpoint "
        f"with save_pretrained instead")
