"""Data normalizers — counterpart of ``deeplearning4j_tpu/data/normalizers.py``
(``Standardize``, ``MinMaxScaler``, ``ImageScaler``,
``VGG16Preprocessor``), kept in the port as its own copy.

Each takes numpy arrays or tensors on any device. A numpy input gives the
reference's numpy result bit for bit (the same expressions); a tensor
gives a tensor on its device, from the same f32 statistics and the same
operations (scalars enter as 0-d tensors, so a division is a true
division, not a multiply by a reciprocal). ``to_dict``/``from_dict`` write
and read the reference's JSON, which ``train/serialization.py`` keeps as
``normalizer.json`` in the model zip.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def _is_tensor(a) -> bool:
    return isinstance(a, torch.Tensor)


def _like(v, t: torch.Tensor) -> torch.Tensor:
    """``v`` (a float or an f32 array) as an f32 tensor on ``t``'s
    device."""
    return torch.as_tensor(np.asarray(v, np.float32), device=t.device)


def _float(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_floating_point() else t.to(torch.float32)


class Normalizer:
    def fit(self, features):
        return self

    def transform(self, features):
        raise NotImplementedError

    def revert(self, features):
        raise NotImplementedError

    def to_dict(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_dict(d: dict) -> "Normalizer":
        kind = d["type"]
        cls = {"standardize": Standardize, "minmax": MinMaxScaler,
               "image_scaler": ImageScaler, "vgg16": VGG16Preprocessor}[kind]
        return cls._from_dict(d)


def _host64(features) -> np.ndarray:
    if _is_tensor(features):
        features = features.detach().cpu().numpy()
    return np.asarray(features, np.float64)


@dataclass
class Standardize(Normalizer):
    """NormalizerStandardize: (x - mean) / std per feature."""

    mean: Optional[np.ndarray] = None
    std: Optional[np.ndarray] = None

    def fit(self, features):
        f = _host64(features)
        axes = tuple(range(f.ndim - 1))
        self.mean = f.mean(axis=axes).astype(np.float32)
        self.std = np.maximum(f.std(axis=axes), 1e-6).astype(np.float32)
        return self

    def transform(self, features):
        if _is_tensor(features):
            return ((features - _like(self.mean, features))
                    / _like(self.std, features))
        return (np.asarray(features) - self.mean) / self.std

    def revert(self, features):
        if _is_tensor(features):
            return (features * _like(self.std, features)
                    + _like(self.mean, features))
        return np.asarray(features) * self.std + self.mean

    def to_dict(self):
        return {"type": "standardize", "mean": self.mean.tolist(),
                "std": self.std.tolist()}

    @classmethod
    def _from_dict(cls, d):
        return cls(np.asarray(d["mean"], np.float32),
                   np.asarray(d["std"], np.float32))


@dataclass
class MinMaxScaler(Normalizer):
    """NormalizerMinMaxScaler: scale to [lo, hi]."""

    lo: float = 0.0
    hi: float = 1.0
    data_min: Optional[np.ndarray] = None
    data_max: Optional[np.ndarray] = None

    def fit(self, features):
        f = _host64(features)
        axes = tuple(range(f.ndim - 1))
        self.data_min = f.min(axis=axes).astype(np.float32)
        self.data_max = f.max(axis=axes).astype(np.float32)
        return self

    def _range(self):
        return np.maximum(self.data_max - self.data_min, 1e-8)

    def transform(self, features):
        if _is_tensor(features):
            f = features
            return ((f - _like(self.data_min, f)) / _like(self._range(), f)
                    * _like(self.hi - self.lo, f) + _like(self.lo, f))
        return ((np.asarray(features) - self.data_min) / self._range()
                * (self.hi - self.lo) + self.lo)

    def revert(self, features):
        if _is_tensor(features):
            f = features
            return ((f - _like(self.lo, f)) / _like(self.hi - self.lo, f)
                    * _like(self._range(), f) + _like(self.data_min, f))
        return ((np.asarray(features) - self.lo) / (self.hi - self.lo)
                * self._range() + self.data_min)

    def to_dict(self):
        return {"type": "minmax", "lo": self.lo, "hi": self.hi,
                "data_min": self.data_min.tolist(),
                "data_max": self.data_max.tolist()}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["lo"], d["hi"], np.asarray(d["data_min"], np.float32),
                   np.asarray(d["data_max"], np.float32))


@dataclass
class ImageScaler(Normalizer):
    """ImagePreProcessingScaler: pixel [0, max_pixel] -> [lo, hi] (default
    [0, 1]); the input is taken as f32."""

    lo: float = 0.0
    hi: float = 1.0
    max_pixel: float = 255.0

    def transform(self, features):
        if _is_tensor(features):
            f = features.to(torch.float32)
            return (f / _like(self.max_pixel, f) * _like(self.hi - self.lo, f)
                    + _like(self.lo, f))
        return (np.asarray(features, np.float32) / self.max_pixel
                * (self.hi - self.lo) + self.lo)

    def revert(self, features):
        if _is_tensor(features):
            f = _float(features)
            return ((f - _like(self.lo, f)) / _like(self.hi - self.lo, f)
                    * _like(self.max_pixel, f))
        return ((np.asarray(features) - self.lo) / (self.hi - self.lo)
                * self.max_pixel)

    def to_dict(self):
        return {"type": "image_scaler", "lo": self.lo, "hi": self.hi,
                "max_pixel": self.max_pixel}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["lo"], d["hi"], d["max_pixel"])


@dataclass
class VGG16Preprocessor(Normalizer):
    """VGG16ImagePreProcessor: subtract the ImageNet channel means (NHWC,
    RGB order); the input is taken as f32."""

    means: tuple = (123.68, 116.779, 103.939)

    def transform(self, features):
        if _is_tensor(features):
            f = features.to(torch.float32)
            return f - _like(self.means, f)
        return (np.asarray(features, np.float32)
                - np.asarray(self.means, np.float32))

    def revert(self, features):
        if _is_tensor(features):
            f = _float(features)
            return f + _like(self.means, f)
        return np.asarray(features) + np.asarray(self.means, np.float32)

    def to_dict(self):
        return {"type": "vgg16", "means": list(self.means)}

    @classmethod
    def _from_dict(cls, d):
        return cls(tuple(d["means"]))
