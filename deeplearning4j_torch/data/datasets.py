"""Canned datasets of the port — counterpart of
``deeplearning4j_tpu/data/datasets.py`` (MNIST, EMNIST, Iris, LFW, CIFAR,
SVHN, TinyImageNet, UCI synthetic-control, the char-RNN corpus) and
synthetic YOLOv2 labels.

The loaders read the same local files as the reference's, under the same
``$DL4J_TPU_DATA`` (so one data directory serves both packages), and
otherwise fall back to the same deterministic synthetic replicas, array
for array. Nothing is downloaded. Every synthetic substitution logs a
warning and is recorded in ``synthetic_fallbacks``;
``DL4J_TPU_STRICT_DATA=1`` raises instead. Arrays are numpy: a model's
trainer stages them onto its device.
"""

from __future__ import annotations

import gzip
import logging
import os
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .iterators import ArrayIterator


class _ImageFolder:
    """Images under ``root/<label>/``, labels the sorted subdirectory names
    (those with at least ``min_examples_per_label`` images), each image
    read with PIL as (h, w, c) floats in [0, 1] — the part of the
    reference's ``ImageRecordReader`` its loaders use."""

    EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".gif"}

    def __init__(self, root, height: int, width: int, channels: int = 3,
                 min_examples_per_label: int = 0):
        self.root = Path(root)
        self.h, self.w, self.c = height, width, channels
        by_label: Dict[str, List[Path]] = {}
        for lab in sorted(d.name for d in self.root.iterdir() if d.is_dir()):
            files = [p for p in sorted((self.root / lab).rglob("*"))
                     if p.suffix.lower() in self.EXTS]
            if len(files) >= min_examples_per_label:
                by_label[lab] = files
        self.labels = sorted(by_label)
        self._files: List[Tuple[Path, int]] = [
            (p, li) for li, lab in enumerate(self.labels)
            for p in by_label[lab]]

    def __len__(self):
        return len(self._files)

    def load_image(self, path: Path) -> np.ndarray:
        from PIL import Image

        img = Image.open(path).convert("RGB" if self.c == 3 else "L")
        arr = np.asarray(img.resize((self.w, self.h)), np.float32) / 255.0
        return arr[..., None] if arr.ndim == 2 else arr

    def __iter__(self):
        for p, li in self._files:
            yield [self.load_image(p), li]


DATA_DIR = Path(os.environ.get("DL4J_TPU_DATA", Path.home() / ".deeplearning4j_tpu" / "data"))

logger = logging.getLogger(__name__)

#: dataset names that fell back to synthetic data in this process
synthetic_fallbacks: set = set()


def _synthetic_fallback(name: str, expected_path) -> None:
    """Record + loudly announce a synthetic substitution (or raise under
    DL4J_TPU_STRICT_DATA=1)."""
    msg = (f"dataset '{name}': no local copy at {expected_path}; using a "
           f"deterministic SYNTHETIC replica (zero-egress environment). "
           f"Place the real files there or set DL4J_TPU_DATA.")
    if os.environ.get("DL4J_TPU_STRICT_DATA") == "1":
        raise FileNotFoundError(msg)
    logger.warning(msg)
    synthetic_fallbacks.add(name)


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def _synthetic_images(n: int, h: int, w: int, c: int, num_classes: int, seed: int):
    """Deterministic class-structured synthetic images: each class k gets a
    distinct frequency pattern + noise, so models can actually learn."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([np.sin(xx * (k + 1) * np.pi / w) * np.cos(yy * (k % 3 + 1) * np.pi / h)
                     for k in range(num_classes)])  # (K, h, w)
    imgs = base[labels][..., None] * 0.5 + rng.standard_normal((n, h, w, 1)).astype(np.float32) * 0.25
    if c > 1:
        imgs = np.repeat(imgs, c, axis=-1)
    onehot = np.eye(num_classes, dtype=np.float32)[labels]
    return imgs.astype(np.float32), onehot


def load_mnist(train: bool = True, num_examples: Optional[int] = None,
               ) -> Tuple[np.ndarray, np.ndarray]:
    """MNIST as (N, 28, 28, 1) float [0,1] + one-hot labels.

    Looks for IDX files under $DL4J_TPU_DATA/mnist/ (standard names);
    synthesizes a replica otherwise.
    """
    split = "train" if train else "t10k"
    d = DATA_DIR / "mnist"
    img_p = next((p for p in [d / f"{split}-images-idx3-ubyte", d / f"{split}-images-idx3-ubyte.gz"] if p.exists()), None)
    lab_p = next((p for p in [d / f"{split}-labels-idx1-ubyte", d / f"{split}-labels-idx1-ubyte.gz"] if p.exists()), None)
    if img_p and lab_p:
        imgs = _read_idx(img_p).astype(np.float32)[..., None] / 255.0
        labels = np.eye(10, dtype=np.float32)[_read_idx(lab_p)]
    else:
        _synthetic_fallback("mnist", d)
        n = 8192 if train else 1024
        imgs, labels = _synthetic_images(n, 28, 28, 1, 10, seed=0 if train else 1)
        imgs = (imgs - imgs.min()) / (imgs.max() - imgs.min())
    if num_examples:
        imgs, labels = imgs[:num_examples], labels[:num_examples]
    return imgs, labels


def mnist_iterator(batch_size: int = 128, train: bool = True,
                   num_examples: Optional[int] = None, seed: int = 0) -> ArrayIterator:
    """MnistDataSetIterator parity."""
    f, l = load_mnist(train, num_examples)
    return ArrayIterator(f, l, batch_size, shuffle=train, seed=seed)


def load_iris() -> Tuple[np.ndarray, np.ndarray]:
    """IrisDataSetIterator parity — the classic 150x4; generated from the
    published per-class statistics when no local copy exists."""
    p = DATA_DIR / "iris.npy"
    if p.exists():
        d = np.load(p, allow_pickle=True).item()
        return d["x"], d["y"]
    # statistical regeneration, not a class-blob fake — do not flag strict
    rng = np.random.default_rng(42)
    means = np.array([[5.01, 3.43, 1.46, 0.25], [5.94, 2.77, 4.26, 1.33], [6.59, 2.97, 5.55, 2.03]])
    stds = np.array([[0.35, 0.38, 0.17, 0.11], [0.52, 0.31, 0.47, 0.20], [0.64, 0.32, 0.55, 0.27]])
    xs, ys = [], []
    for k in range(3):
        xs.append(rng.standard_normal((50, 4)) * stds[k] + means[k])
        ys.append(np.full(50, k))
    x = np.concatenate(xs).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.concatenate(ys)]
    return x, y


def load_cifar10(train: bool = True, num_examples: Optional[int] = None):
    """CifarDataSetIterator parity — (N, 32, 32, 3) float [0,1] + one-hot.

    Reads the standard python-pickle batches under $DL4J_TPU_DATA/
    cifar-10-batches-py/; synthetic fallback otherwise."""
    d = DATA_DIR / "cifar-10-batches-py"
    names = ([f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"])
    if all((d / n).exists() for n in names):
        import pickle

        xs, ys = [], []
        for n in names:
            with open(d / n, "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(batch[b"data"], np.uint8))
            ys.append(np.asarray(batch[b"labels"], np.int64))
        x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        imgs = x.astype(np.float32) / 255.0
        labels = np.eye(10, dtype=np.float32)[np.concatenate(ys)]
    else:
        _synthetic_fallback("cifar10", d)
        n = num_examples or (4096 if train else 512)
        return _synthetic_images(n, 32, 32, 3, 10, seed=2 if train else 3)
    if num_examples:
        imgs, labels = imgs[:num_examples], labels[:num_examples]
    return imgs, labels


# --- EMNIST (datasets/fetchers/EmnistDataFetcher.java) ---

EMNIST_CLASSES = {"byclass": 62, "bymerge": 47, "balanced": 47,
                  "letters": 26, "digits": 10, "mnist": 10}


def load_emnist(split: str = "balanced", train: bool = True,
                num_examples: Optional[int] = None):
    """EMNIST as (N, 28, 28, 1) float [0,1] + one-hot over the split's
    classes. Looks for the standard IDX names under $DL4J_TPU_DATA/emnist/."""
    if split not in EMNIST_CLASSES:
        raise ValueError(f"Unknown EMNIST split '{split}' "
                         f"(expected one of {sorted(EMNIST_CLASSES)})")
    k = EMNIST_CLASSES[split]
    part = "train" if train else "test"
    d = DATA_DIR / "emnist"
    img_p = next((p for p in [d / f"emnist-{split}-{part}-images-idx3-ubyte",
                              d / f"emnist-{split}-{part}-images-idx3-ubyte.gz"]
                  if p.exists()), None)
    lab_p = next((p for p in [d / f"emnist-{split}-{part}-labels-idx1-ubyte",
                              d / f"emnist-{split}-{part}-labels-idx1-ubyte.gz"]
                  if p.exists()), None)
    if img_p and lab_p:
        imgs = _read_idx(img_p).astype(np.float32)[..., None] / 255.0
        raw = _read_idx(lab_p).astype(np.int64)
        if split == "letters":  # letters labels are 1..26
            raw = raw - 1
        labels = np.eye(k, dtype=np.float32)[raw]
    else:
        _synthetic_fallback(f"emnist-{split}", d)
        n = 4096 if train else 512
        imgs, labels = _synthetic_images(n, 28, 28, 1, k, seed=4 if train else 5)
    if num_examples:
        imgs, labels = imgs[:num_examples], labels[:num_examples]
    return imgs, labels


# --- SVHN (datasets/fetchers/SvhnDataFetcher.java) ---


def load_svhn(train: bool = True, num_examples: Optional[int] = None):
    """SVHN cropped digits as (N, 32, 32, 3) float [0,1] + one-hot(10).
    Reads the standard {train,test}_32x32.mat under $DL4J_TPU_DATA/svhn/."""
    d = DATA_DIR / "svhn"
    p = d / (f"{'train' if train else 'test'}_32x32.mat")
    if p.exists():
        from scipy.io import loadmat

        m = loadmat(str(p))
        x = np.transpose(m["X"], (3, 0, 1, 2)).astype(np.float32) / 255.0
        raw = m["y"].ravel().astype(np.int64) % 10  # '10' encodes digit 0
        labels = np.eye(10, dtype=np.float32)[raw]
    else:
        _synthetic_fallback("svhn", p)
        n = 4096 if train else 512
        x, labels = _synthetic_images(n, 32, 32, 3, 10, seed=6 if train else 7)
    if num_examples:
        x, labels = x[:num_examples], labels[:num_examples]
    return x, labels


# --- TinyImageNet (datasets/fetchers/TinyImageNetFetcher.java) ---


def load_tiny_imagenet(train: bool = True, num_examples: Optional[int] = None,
                       image_size: int = 64):
    """TinyImageNet-200 as (N, 64, 64, 3). Reads the standard directory
    layout under $DL4J_TPU_DATA/tiny-imagenet-200/ via ImageRecordReader."""
    base = DATA_DIR / "tiny-imagenet-200"
    root = base / ("train" if train else "val")
    if root.exists():
        if train:
            rr = _ImageFolder(root, image_size, image_size, 3)
            files = [(p, li) for p, li in rr._files]
            n_classes = len(rr.labels)
        else:
            # standard val layout: val/images/*.JPEG + val_annotations.txt
            # (no per-class subdirs); class order follows train/ (or wnids.txt)
            wnids_p = base / "wnids.txt"
            if wnids_p.exists():
                wnids = sorted(wnids_p.read_text().split())
            else:
                wnids = sorted(d.name for d in (base / "train").iterdir() if d.is_dir())
            idx = {w: i for i, w in enumerate(wnids)}
            n_classes = len(wnids)
            ann = root / "val_annotations.txt"
            rr = _ImageFolder.__new__(_ImageFolder)
            rr.h, rr.w, rr.c = image_size, image_size, 3
            files = []
            for line in ann.read_text().splitlines():
                parts = line.split("\t")
                if len(parts) >= 2 and parts[1] in idx:
                    files.append((root / "images" / parts[0], idx[parts[1]]))
        n = min(len(files), num_examples or len(files))
        xs = np.zeros((n, image_size, image_size, 3), np.float32)
        ys = np.zeros(n, np.int64)
        for i, (p, li) in enumerate(files[:n]):
            xs[i], ys[i] = rr.load_image(p), li
        labels = np.eye(n_classes, dtype=np.float32)[ys]
        return xs, labels
    _synthetic_fallback("tiny-imagenet", root)
    n = num_examples or (2048 if train else 256)
    return _synthetic_images(n, image_size, image_size, 3, 200,
                             seed=8 if train else 9)


# --- LFW (datasets/fetchers/LFWDataFetcher.java) ---


def load_lfw(num_examples: Optional[int] = None, image_size: int = 64,
             min_faces_per_person: int = 2):
    """Labeled Faces in the Wild as (N, H, W, 3) + one-hot person labels.
    Reads $DL4J_TPU_DATA/lfw/<person>/*.jpg; people with fewer than
    ``min_faces_per_person`` images are dropped (fetcher parity)."""
    root = DATA_DIR / "lfw"
    if root.exists():
        rr = _ImageFolder(root, image_size, image_size, 3,
                          min_examples_per_label=min_faces_per_person)
        n = min(len(rr), num_examples or len(rr))
        xs = np.zeros((n, image_size, image_size, 3), np.float32)
        ys = np.zeros(n, np.int64)
        for i, rec in enumerate(rr):
            if i >= n:
                break
            xs[i], ys[i] = rec[0], rec[1]
        labels = np.eye(len(rr.labels), dtype=np.float32)[ys]
        return xs, labels
    _synthetic_fallback("lfw", root)
    n = num_examples or 1024
    return _synthetic_images(n, image_size, image_size, 3, 40, seed=10)


# --- UCI synthetic-control (datasets/fetchers/UciSequenceDataFetcher.java) ---


def load_uci_synthetic_control(train: bool = True):
    """UCI synthetic-control time series: 600 univariate series of length 60
    in 6 classes. Reads $DL4J_TPU_DATA/uci/synthetic_control.data; otherwise
    regenerates from the published generator equations (this dataset IS
    synthetic by definition, so the regeneration is faithful, not a fake).

    Returns (x (N, 60, 1), y one-hot (N, 6)) with the reference's 450/150
    train/test split.
    """
    p = DATA_DIR / "uci" / "synthetic_control.data"
    if p.exists():
        rows = np.loadtxt(str(p), dtype=np.float32)
        x = rows.reshape(600, 60, 1)
        y = np.repeat(np.arange(6), 100)
    else:
        rng = np.random.default_rng(11)
        t = np.arange(60, dtype=np.float32)
        series = []
        for k in range(6):
            for _ in range(100):
                base = 30 + rng.standard_normal(60) * 2
                if k == 1:   # cyclic
                    base += 15 * np.sin(2 * np.pi * t / rng.uniform(10, 15))
                elif k == 2:  # increasing trend
                    base += rng.uniform(0.2, 0.5) * t
                elif k == 3:  # decreasing trend
                    base -= rng.uniform(0.2, 0.5) * t
                elif k == 4:  # upward shift
                    base += np.where(t >= rng.integers(20, 40), rng.uniform(7.5, 20), 0)
                elif k == 5:  # downward shift
                    base -= np.where(t >= rng.integers(20, 40), rng.uniform(7.5, 20), 0)
                series.append(base)
        x = np.asarray(series, np.float32)[..., None]
        y = np.repeat(np.arange(6), 100)
    onehot = np.eye(6, dtype=np.float32)[y]
    # reference split: interleaved 75/25 per class
    idx = np.arange(600)
    mask = (idx % 4) != 3
    sel = mask if train else ~mask
    return x[sel], onehot[sel]


def char_rnn_corpus(length: int = 100_000,
                    seed: int = 0) -> Tuple[np.ndarray, dict]:
    """Synthetic character corpus for the GravesLSTM char-RNN: words drawn
    from a fixed list with numpy's ``default_rng(seed)``, joined by spaces
    and cut to ``length`` characters. Returns the (length,) int32 ids and
    the char -> id map (sorted characters)."""
    rng = np.random.default_rng(seed)
    words = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
             "neural", "network", "tensor", "gradient", "descent", "learning"]
    text = " ".join(rng.choice(words, size=length // 6))[:length]
    vocab = sorted(set(text))
    ch2id = {c: i for i, c in enumerate(vocab)}
    ids = np.array([ch2id[c] for c in text], np.int32)
    return ids, ch2id


def yolo_labels(rng: np.random.Generator, n: int, grid: int, anchors,
                classes: int, max_objects: int = 8) -> np.ndarray:
    """Synthetic YOLOv2 labels (n, grid, grid, A, 5 + classes) drawn from
    ``rng``: 1 to ``max_objects`` objects an image, each marking the cell
    that holds its centre and the anchor of best IoU with its box, with x,
    y, w, h in grid units, obj 1 and a one-hot class."""
    anchors = np.asarray(anchors, np.float64)
    lab = np.zeros((n, grid, grid, len(anchors), 5 + classes), np.float32)
    for b in range(n):
        for _ in range(rng.integers(1, max_objects + 1)):
            cx, cy = rng.random(2) * grid
            w, h = 0.5 + rng.random(2) * (grid / 2)
            inter = np.minimum(anchors[:, 0], w) * np.minimum(anchors[:, 1], h)
            iou = inter / (anchors[:, 0] * anchors[:, 1] + w * h - inter)
            a = int(np.argmax(iou))
            lab[b, int(cy), int(cx), a, :5] = [cx, cy, w, h, 1.0]
            lab[b, int(cy), int(cx), a, 5 + rng.integers(classes)] = 1.0
    return lab
