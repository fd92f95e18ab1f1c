"""Canned datasets of the port (so far: the char-RNN corpus, each the
same data as the JAX package's loader of the same name, and synthetic
YOLOv2 labels)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
