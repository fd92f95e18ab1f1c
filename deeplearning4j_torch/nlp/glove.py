"""GloVe — parity with ``models/glove/`` (``AbstractCoOccurrences.java`` 646
LoC co-occurrence counting + ``learning/impl/elements/GloVe.java`` AdaGrad
training), on the card.

The sparse co-occurrence matrix is flattened to COO index/value arrays on the
host; training is one AdaGrad update over shuffled batches of entries —
weighted least squares  f(X_ij) (w_i·w~_j + b_i + b~_j − log X_ij)² with
scatter-add updates, the GloVe paper's objective that the reference
implements per pair.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .sequencevectors import _on, _scatter_add, _table
from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache, VocabConstructor

# the AdaGrad state, in the order _glove_step takes and returns it
TABLES = ("W", "Wt", "b", "bt", "gW", "gWt", "gb", "gbt")


class CoOccurrences:
    """``AbstractCoOccurrences.java`` — symmetric windowed co-occurrence
    counts weighted by 1/distance."""

    def __init__(self, vocab: VocabCache, window: int = 5, symmetric: bool = True):
        self.vocab = vocab
        self.window = window
        self.symmetric = symmetric
        self.counts: Dict[Tuple[int, int], float] = defaultdict(float)

    def fit(self, token_lists: Iterable[Sequence[str]]) -> "CoOccurrences":
        for toks in token_lists:
            idx = [self.vocab.index_of(t) for t in toks]
            idx = [i for i in idx if i >= 0]
            for i, wi in enumerate(idx):
                for off in range(1, self.window + 1):
                    j = i + off
                    if j >= len(idx):
                        break
                    w = 1.0 / off
                    self.counts[(wi, idx[j])] += w
                    if self.symmetric:
                        self.counts[(idx[j], wi)] += w
        return self

    def coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not self.counts:
            return (np.zeros(0, np.int32),) * 2 + (np.zeros(0, np.float32),)
        ij = np.array(list(self.counts.keys()), dtype=np.int32)
        x = np.array(list(self.counts.values()), dtype=np.float32)
        return ij[:, 0], ij[:, 1], x


def _glove_step(W, Wt, b, bt, gW, gWt, gb, gbt, rows, cols, logx, fx, lr):
    """One AdaGrad batch over COO entries (GloVe.java per-pair math, batched),
    in place. Each accumulator is read after its own scatter-add, as the
    reference reads it."""
    wi, wj = W[rows], Wt[cols]                           # (B, D)
    diff = torch.einsum("bd,bd->b", wi, wj) + b[rows] + bt[cols] - logx
    wdiff = fx * diff                                    # (B,)
    loss = 0.5 * torch.mean(fx * diff * diff)
    g_wi = wdiff[:, None] * wj
    g_wj = wdiff[:, None] * wi
    # AdaGrad: accumulate squared grads, scale update
    _scatter_add(gW, rows, g_wi ** 2)
    _scatter_add(gWt, cols, g_wj ** 2)
    _scatter_add(gb, rows, wdiff ** 2)
    _scatter_add(gbt, cols, wdiff ** 2)
    _scatter_add(W, rows, -lr * g_wi / torch.sqrt(gW[rows] + 1e-8))
    _scatter_add(Wt, cols, -lr * g_wj / torch.sqrt(gWt[cols] + 1e-8))
    _scatter_add(b, rows, -lr * wdiff / torch.sqrt(gb[rows] + 1e-8))
    _scatter_add(bt, cols, -lr * wdiff / torch.sqrt(gbt[cols] + 1e-8))
    return W, Wt, b, bt, gW, gWt, gb, gbt, loss


class Glove:
    """User-facing GloVe model (``models/glove/Glove.java`` builder surface:
    minWordFrequency, layerSize, windowSize, learningRate, xMax, alpha,
    epochs, batchSize, seed). Trains on ``device`` (the card unless the
    caller names another); after ``fit``, ``tables`` holds the trained
    AdaGrad state on it by name (``TABLES``)."""

    def __init__(self, min_word_frequency: int = 1, layer_size: int = 50,
                 window_size: int = 5, learning_rate: float = 0.05,
                 x_max: float = 100.0, alpha: float = 0.75, epochs: int = 5,
                 batch_size: int = 4096, seed: int = 42,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.min_word_frequency = min_word_frequency
        self.layer_size = layer_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.x_max = x_max
        self.alpha = alpha
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.tokenizer = tokenizer_factory or DefaultTokenizerFactory()
        self.vocab: Optional[VocabCache] = None
        self.W: Optional[np.ndarray] = None
        self.tables: Optional[Dict[str, torch.Tensor]] = None
        self._start: Optional[Dict[str, np.ndarray]] = None

    def load_tables(self, W, Wt, b, bt, gW, gWt, gb, gbt) -> None:
        """Start the next ``fit`` from this state (numpy arrays: (V, D)
        W, Wt, gW, gWt and (V,) b, bt, gb, gbt) instead of a fresh one; V
        must be that fit's vocabulary size. The fit still draws its fresh
        tables first, so its shuffles are the same either way."""
        self._start = dict(zip(TABLES, (W, Wt, b, bt, gW, gWt, gb, gbt)))

    def fit(self, sentences: Iterable[str]) -> List[float]:
        token_lists = [self.tokenizer.create(s).get_tokens() for s in sentences]
        self.vocab = VocabConstructor(
            min_word_frequency=self.min_word_frequency,
            build_huffman_tree=False).build(token_lists)
        co = CoOccurrences(self.vocab, window=self.window_size).fit(token_lists)
        rows, cols, x = co.coo()
        if not len(x):
            self.W = np.zeros((len(self.vocab), self.layer_size), np.float32)
            return []
        logx = np.log(x)
        fx = np.minimum((x / self.x_max) ** self.alpha, 1.0).astype(np.float32)
        V, D = len(self.vocab), self.layer_size
        dev = self.device
        rng = np.random.default_rng(self.seed)
        t = {"W": _on(dev, (rng.random((V, D), dtype=np.float32) - 0.5) / D),
             "Wt": _on(dev, (rng.random((V, D), dtype=np.float32) - 0.5) / D)}
        t["b"] = torch.zeros(V, dtype=torch.float32, device=dev)
        t["bt"] = torch.zeros(V, dtype=torch.float32, device=dev)
        for name, shape in (("gW", (V, D)), ("gWt", (V, D)), ("gb", (V,)),
                            ("gbt", (V,))):
            t[name] = torch.full(shape, 1e-8, dtype=torch.float32, device=dev)
        if self._start is not None:
            t = {k: _table(self._start[k], t[k].shape, dev, k) for k in TABLES}
            self._start = None
        state = [t[k] for k in TABLES]
        rows_d, cols_d = _on(dev, rows.astype(np.int64)), _on(dev, cols.astype(np.int64))
        logx_d, fx_d = _on(dev, logx), _on(dev, fx)
        B = min(self.batch_size, len(x))
        losses = []
        for _ in range(self.epochs):
            order = _on(dev, rng.permutation(len(x)))
            ep, nb = 0.0, 0
            for s in range(0, len(order) - B + 1, B):
                sel = order[s:s + B]
                *state, loss = _glove_step(
                    *state, rows_d[sel], cols_d[sel], logx_d[sel], fx_d[sel],
                    self.learning_rate)
                ep += float(loss); nb += 1
            losses.append(ep / max(nb, 1))
        self.tables = dict(zip(TABLES, state))
        # GloVe paper: final embedding = W + W~
        self.W = (self.tables["W"] + self.tables["Wt"]).to("cpu", copy=True).numpy()
        return losses

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.W[i]

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        if va is None or vb is None:
            return float("nan")
        den = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / den) if den > 0 else 0.0
