"""ParagraphVectors (doc2vec) — parity with
``models/paragraphvectors/ParagraphVectors.java`` (1461 LoC) and the sequence
learning algorithms ``learning/impl/sequence/{DBOW,DM}.java``, on the card.

PV-DBOW: the document label's vector predicts each word of the document
(skip-gram with the label as the center). PV-DM: label vector + context
window mean predicts the target word (CBOW with the label mixed into the
window). Labels live in the same table as words (the reference stores them in
one lookup table too), prefixed to the vocab as ``__label__`` tokens.

Inference of unseen docs (``inferVector``) freezes syn1 and trains only a
fresh label row.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from . import sequencevectors as _sv
from .sequencevectors import SequenceVectors, _on
from .tokenization import (DefaultTokenizerFactory, LabelledDocument,
                           TokenizerFactory)
from .vocab import VocabConstructor, vocab_from_counts

LABEL_PREFIX = "__label__"


class ParagraphVectors:
    def __init__(self, min_word_frequency: int = 1, layer_size: int = 100,
                 window_size: int = 5, negative_sample: int = 5,
                 learning_rate: float = 0.025, epochs: int = 1,
                 batch_size: int = 2048, seed: int = 42, dm: bool = False,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.min_word_frequency = min_word_frequency
        self.layer_size = layer_size
        self.window_size = window_size
        self.negative_sample = max(negative_sample, 1)  # NS only (DL4J default path)
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.dm = dm
        self.tokenizer = tokenizer_factory or DefaultTokenizerFactory()
        self.labels: List[str] = []
        self.vocab = None
        self.sv: Optional[SequenceVectors] = None

    def _trainer(self) -> SequenceVectors:
        return SequenceVectors(
            self.vocab, layer_size=self.layer_size, window=self.window_size,
            negative=self.negative_sample, learning_rate=self.learning_rate,
            epochs=1, batch_size=self.batch_size, seed=self.seed,
            device=self.device)

    def fit(self, docs: Iterable[LabelledDocument]) -> List[float]:
        docs = list(docs)
        token_lists = [self.tokenizer.create(d.content).get_tokens() for d in docs]
        self.labels = sorted({lab for d in docs for lab in d.labels})
        label_tokens = [f"{LABEL_PREFIX}{l}" for l in self.labels]
        self.vocab = VocabConstructor(
            min_word_frequency=self.min_word_frequency,
            build_huffman_tree=False).build(token_lists, special_tokens=label_tokens)
        self.sv = self._trainer()
        sv, dev = self.sv, self.device
        rng = np.random.default_rng(self.seed)
        losses = []
        for _ in range(self.epochs):
            centers, contexts = [], []
            cb_tgt, cb_ctx, cb_msk = [], [], []
            W = 2 * self.window_size + 1
            for d, toks in zip(docs, token_lists):
                widx = np.array([self.vocab.index_of(t) for t in toks
                                 if t in self.vocab], dtype=np.int64)
                if not len(widx):
                    continue
                for lab in d.labels:
                    li = self.vocab.index_of(f"{LABEL_PREFIX}{lab}")
                    if self.dm:
                        # PV-DM: window + label -> target
                        for i in range(len(widx)):
                            lo = max(0, i - self.window_size)
                            hi = min(len(widx), i + self.window_size + 1)
                            c = np.concatenate([widx[lo:i], widx[i + 1:hi], [li]])[:W]
                            pad = np.zeros(W, np.int64); m = np.zeros(W, np.float32)
                            pad[:len(c)] = c; m[:len(c)] = 1.0
                            cb_tgt.append(widx[i]); cb_ctx.append(pad); cb_msk.append(m)
                    else:
                        # PV-DBOW: label -> every word
                        centers.append(np.full(len(widx), li))
                        contexts.append(widx)
            ep_loss, nb = 0.0, 0
            if self.dm:
                tgt = np.asarray(cb_tgt); ctx = np.stack(cb_ctx); msk = np.stack(cb_msk)
                order = rng.permutation(len(tgt))
                tgt, ctx, msk = tgt[order], ctx[order], msk[order]
                for s in range(0, len(tgt), self.batch_size):
                    bt, bc, bm = sv._pad_batch3(
                        tgt[s:s + self.batch_size], ctx[s:s + self.batch_size],
                        msk[s:s + self.batch_size])
                    neg = rng.choice(len(self.vocab), size=(len(bt), self.negative_sample),
                                     p=sv._neg_probs)
                    sv.syn0, sv.syn1, loss = _sv._cbow_ns_step(
                        sv.syn0, sv.syn1, _on(dev, bc), _on(dev, bm),
                        _on(dev, bt), _on(dev, neg), self.learning_rate)
                    ep_loss += float(loss); nb += 1
            else:
                cen = np.concatenate(centers); con = np.concatenate(contexts)
                order = rng.permutation(len(cen))
                cen, con = cen[order], con[order]
                for s in range(0, len(cen), self.batch_size):
                    bc = sv._pad_batch(cen[s:s + self.batch_size])
                    bx = sv._pad_batch(con[s:s + self.batch_size])
                    neg = rng.choice(len(self.vocab), size=(len(bc), self.negative_sample),
                                     p=sv._neg_probs)
                    sv.syn0, sv.syn1, loss = _sv._skipgram_ns_step(
                        sv.syn0, sv.syn1, _on(dev, bc), _on(dev, bx),
                        _on(dev, neg), self.learning_rate)
                    ep_loss += float(loss); nb += 1
            losses.append(ep_loss / max(nb, 1))
        return losses

    def load_tables(self, syn0, syn1, words: Optional[Sequence[str]] = None,
                    counts: Optional[Sequence[int]] = None) -> None:
        """Carry trained (V, D) tables in (numpy arrays). With ``words`` and
        ``counts`` (another package's vocabulary in its order, labels as
        ``__label__`` words) the vocabulary and labels are rebuilt first;
        without, the model must have been fit."""
        if words is not None:
            self.vocab = vocab_from_counts(words, counts,
                                           label_prefix=LABEL_PREFIX)
            self.labels = [w.word[len(LABEL_PREFIX):]
                           for w in self.vocab.words if w.is_label]
            self.sv = self._trainer()
        if self.sv is None:
            raise RuntimeError("fit the model, or pass words and counts")
        self.sv.load_tables(syn0, syn1)

    # -- lookup ------------------------------------------------------------

    def get_label_vector(self, label: str) -> Optional[np.ndarray]:
        idx = self.vocab.index_of(f"{LABEL_PREFIX}{label}")
        return None if idx < 0 else self.sv.vector(idx)

    def similarity(self, label_a: str, label_b: str) -> float:
        ia = self.vocab.index_of(f"{LABEL_PREFIX}{label_a}")
        ib = self.vocab.index_of(f"{LABEL_PREFIX}{label_b}")
        return self.sv.similarity(ia, ib)

    def infer_vector(self, text: str, steps: int = 20,
                     learning_rate: float = 0.025) -> np.ndarray:
        """``ParagraphVectors.inferVector`` — train a fresh doc vector against
        the frozen tables."""
        toks = self.tokenizer.create(text).get_tokens()
        widx = np.array([self.vocab.index_of(t) for t in toks if t in self.vocab],
                        dtype=np.int64)
        rng = np.random.default_rng(self.seed)
        D = self.layer_size
        vec = _on(self.device, (rng.random((1, D), dtype=np.float32) - 0.5) / D)
        if not len(widx):
            return vec[0].to("cpu", copy=True).numpy()
        ctx = _on(self.device, widx)
        for _ in range(steps):
            neg = rng.choice(len(self.vocab), size=(len(widx), self.negative_sample),
                             p=self.sv._neg_probs)
            vec = _sv._skipgram_ns_infer_step(
                vec, self.sv.syn1, ctx, _on(self.device, neg), learning_rate)
        return vec[0].to("cpu", copy=True).numpy()

    def nearest_labels(self, text: str, top_n: int = 5) -> List[Tuple[str, float]]:
        v = self.infer_vector(text)
        out = []
        for lab in self.labels:
            lv = self.get_label_vector(lab)
            den = np.linalg.norm(v) * np.linalg.norm(lv)
            out.append((lab, float(v @ lv / den) if den > 0 else 0.0))
        return sorted(out, key=lambda t: -t[1])[:top_n]
