"""Model zoo base — counterpart of ``deeplearning4j_tpu/models/zoo.py``
(pretrained weights are not carried)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

from ..device import DeviceLike

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
