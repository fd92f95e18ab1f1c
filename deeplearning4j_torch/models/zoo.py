"""Model zoo base — counterpart of ``deeplearning4j_tpu/models/zoo.py``
(``zoo/ZooModel.java`` + ``zoo/ModelSelector.java``).

``ZooModel.init()`` builds the randomly initialized network on
``self.device`` (the card unless the caller names another);
``init_pretrained()`` loads this entry's checkpoint zip from the pretrained
cache, ``$DL4J_TPU_CACHE/pretrained/<name>_<type>.zip`` (default
``~/.deeplearning4j_tpu``): the reference's location and format, so a
checkpoint published by either package's ``save_pretrained`` loads in the
other. A cache miss with ``auto_convert`` would run the reference's
keras.applications bridge, which is not ported yet (ROADMAP.md, Queue 1,
item 16).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional, Tuple, Type

from ..device import DeviceLike

CACHE_DIR = Path(os.environ.get("DL4J_TPU_CACHE",
                                Path.home() / ".deeplearning4j_tpu")) \
    / "pretrained"

ZOO_REGISTRY: Dict[str, Type["ZooModel"]] = {}


def register_model(cls):
    ZOO_REGISTRY[cls.__name__.lower()] = cls
    return cls


class ZooModel:
    """Base: subclasses define ``build()`` (a ``Sequential`` or a
    ``Graph``) on ``self.device``
    (the card unless the caller names another)."""

    name: str = "zoo"
    input_shape: Tuple[int, ...] = ()
    num_classes: int = 1000

    def __init__(self, num_classes: Optional[int] = None, seed: int = 12345,
                 input_shape: Optional[Tuple[int, ...]] = None, *,
                 device: DeviceLike = None, **kwargs):
        if num_classes is not None:
            self.num_classes = num_classes
        if input_shape is not None:
            self.input_shape = tuple(input_shape)
        self.seed = seed
        self.device = device
        self.kwargs = kwargs

    def build(self):
        raise NotImplementedError

    def init(self):
        """Build and randomly initialize."""
        model = self.build()
        model.init()
        return model

    def pretrained_path(self, pretrained_type: str = "imagenet") -> Path:
        """This entry's checkpoint zip in the pretrained cache."""
        return CACHE_DIR / f"{type(self).__name__.lower()}_{pretrained_type}.zip"

    def init_pretrained(self, pretrained_type: str = "imagenet",
                        auto_convert: bool = True):
        """initPretrained(PretrainedType): load this entry's checkpoint from
        the cache onto ``self.device``, verifying its recorded sha256. A
        corrupt checkpoint (digest mismatch) is deleted with its sidecar
        and the load fails, as the reference's does."""
        from ..interop.pretrained import ChecksumMismatch, verify_checksum
        from ..train.serialization import load_model

        path = self.pretrained_path(pretrained_type)
        if path.exists():
            try:
                verify_checksum(path)
            except ChecksumMismatch:
                path.unlink(missing_ok=True)
                Path(str(path) + ".sha256").unlink(missing_ok=True)
        if not path.exists() and auto_convert and pretrained_type == "imagenet":
            from ..interop.pretrained import (KERAS_APPLICATIONS,
                                              convert_keras_application)

            name = type(self).__name__.lower()
            if name in KERAS_APPLICATIONS:
                convert_keras_application(name)
        if not path.exists():
            raise FileNotFoundError(
                f"No cached pretrained weights at {path}: produce the zip "
                f"with save_pretrained() (in either package)")
        model, _, _ = load_model(str(path), device=self.device)
        return model

    def save_pretrained(self, model, pretrained_type: str = "imagenet"
                        ) -> Path:
        """Publish ``model``'s weights as this entry's pretrained checkpoint
        with its sha256 sidecar; loads back through ``init_pretrained``."""
        from ..interop.pretrained import write_checksum
        from ..train.serialization import save_model

        path = self.pretrained_path(pretrained_type)
        path.parent.mkdir(parents=True, exist_ok=True)
        save_model(str(path), model, params=model.params, state=model.state)
        write_checksum(path)
        return path


def model_by_name(name: str, **kwargs) -> ZooModel:
    """ModelSelector: the zoo entry of that name (case-insensitive)."""
    key = name.lower()
    if key not in ZOO_REGISTRY:
        raise ValueError(f"Unknown zoo model '{name}'. Known: "
                         f"{sorted(ZOO_REGISTRY)}")
    return ZOO_REGISTRY[key](**kwargs)
