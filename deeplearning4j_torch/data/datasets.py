"""Canned datasets of the port (so far: the char-RNN corpus), each the
same data as the JAX package's loader of the same name."""

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
