"""SequenceVectors — the generic skip-gram/CBOW engine that Word2Vec,
ParagraphVectors, DeepWalk and Node2Vec train with (``models/
sequencevectors/SequenceVectors.java``, ``learning/impl/elements/
{SkipGram,CBOW}.java``), on the card.

An epoch is sampled on the host into flat index arrays with numpy's
``default_rng(seed)``, in the JAX package's order, then consumed in large
minibatches by one update function on tensors:

    gather rows -> dot products -> sigmoid objective
    -> per-row gradients -> scatter-add into the tables

Negative sampling and hierarchical softmax are both fixed-shape (padded
codes + mask). The update functions change the tables in place and return
them with the batch's loss.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..utils.segments import scatter_add_ as _scatter_add
from .vocab import VocabCache, huffman_tensors, unigram_table

# --------------------------------------------------------------------------
# Update functions. Tables: syn0 (input vectors, V x D), syn1 (output /
# inner-node vectors, V x D); indices are int64 tensors on the tables'
# device, lr a Python float.
#
# Every scatter-add is multiplicity-normalized (1/sqrt(count) per row): a
# natural (Zipfian) corpus puts a high-frequency word ("the") in hundreds of
# rows of one batch; summing all those gradients into one table row at
# word2vec learning rates diverges to inf. Rows that appear once (the common
# case at large vocab) are untouched.
# --------------------------------------------------------------------------


def _counts(n_rows: int, idx: torch.Tensor, weights: torch.Tensor = None
            ) -> torch.Tensor:
    """f32 (n_rows,): how often each row is named in ``idx`` (each naming
    weighted by ``weights`` when given)."""
    if weights is None:
        weights = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    return torch.zeros(n_rows, dtype=torch.float32,
                       device=idx.device).index_add_(0, idx, weights)


def _row_scale(n_rows: int, idx: torch.Tensor, *more_idx: torch.Tensor
               ) -> torch.Tensor:
    """sqrt(multiplicity) divisors for scatter rows ``idx`` (counts pooled
    across all index arrays that target the same table). sqrt — not full
    1/count — keeps frequent rows learning proportionally to sqrt(freq)
    while bounding the summed-update blowup."""
    c = _counts(n_rows, idx)
    for m in more_idx:
        c = c.index_add_(0, m, torch.ones(m.shape, dtype=torch.float32,
                                          device=m.device))
    return torch.sqrt(torch.clamp_min(c, 1.0))


def _skipgram_ns_math(syn0, syn1, centers, contexts, negatives, lr):
    """Skip-gram + negative sampling. centers/contexts: (B,), negatives: (B,K)."""
    v_in = syn0[centers]                       # (B, D)
    v_pos = syn1[contexts]                     # (B, D)
    v_neg = syn1[negatives]                    # (B, K, D)
    pos_score = torch.einsum("bd,bd->b", v_in, v_pos)
    neg_score = torch.einsum("bd,bkd->bk", v_in, v_neg)
    # loss = -log s(pos) - sum log s(-neg)
    loss = -torch.mean(F.logsigmoid(pos_score)) \
        - torch.mean(torch.sum(F.logsigmoid(-neg_score), dim=1))
    g_pos = torch.sigmoid(pos_score) - 1.0     # dL/d(pos_score), per example
    g_neg = torch.sigmoid(neg_score)           # (B, K)
    grad_in = g_pos[:, None] * v_pos + torch.einsum("bk,bkd->bd", g_neg, v_neg)
    c_in = _row_scale(syn0.shape[0], centers)
    grad_in = grad_in / c_in[centers][:, None]
    grad_pos = g_pos[:, None] * v_in
    grad_neg = g_neg[..., None] * v_in[:, None, :]
    neg_flat = negatives.reshape(-1)
    c_out = _row_scale(syn1.shape[0], contexts, neg_flat)
    grad_pos = grad_pos / c_out[contexts][:, None]
    grad_neg_flat = grad_neg.reshape(-1, grad_neg.shape[-1]) \
        / c_out[neg_flat][:, None]
    _scatter_add(syn0, centers, -lr * grad_in)
    _scatter_add(syn1, contexts, -lr * grad_pos)
    _scatter_add(syn1, neg_flat, -lr * grad_neg_flat)
    return syn0, syn1, loss


def _skipgram_hs_math(syn0, syn1, centers, codes, points, mask, lr):
    """Skip-gram + hierarchical softmax. codes/points/mask: (B, L) along the
    context word's Huffman path (padded). Inner nodes near the Huffman root
    appear on nearly every path, so path-row updates are count-normalized
    (masked slots excluded from the counts)."""
    v_in = syn0[centers]                       # (B, D)
    v_path = syn1[points]                      # (B, L, D)
    score = torch.einsum("bd,bld->bl", v_in, v_path)
    codes = codes.to(torch.float32)
    sign = 1.0 - 2.0 * codes                   # code 0 -> +1, 1 -> -1
    loss = -torch.sum(F.logsigmoid(sign * score) * mask) \
        / torch.clamp_min(mask.sum(), 1.0)
    g = (torch.sigmoid(score) - (1.0 - codes)) * mask   # (B, L)
    grad_in = torch.einsum("bl,bld->bd", g, v_path)
    c_in = _row_scale(syn0.shape[0], centers)
    grad_in = grad_in / c_in[centers][:, None]
    grad_path = g[..., None] * v_in[:, None, :]
    pts_flat = points.reshape(-1)
    c_path = torch.sqrt(torch.clamp_min(
        _counts(syn1.shape[0], pts_flat, mask.reshape(-1)), 1.0))
    grad_path_flat = grad_path.reshape(-1, grad_path.shape[-1]) \
        / c_path[pts_flat][:, None]
    _scatter_add(syn0, centers, -lr * grad_in)
    _scatter_add(syn1, pts_flat, -lr * grad_path_flat)
    return syn0, syn1, loss


def _cbow_ns_math(syn0, syn1, context_idx, context_mask, targets, negatives, lr):
    """CBOW + negative sampling. context_idx: (B, W) padded window,
    context_mask: (B, W), targets: (B,), negatives: (B, K)."""
    v_ctx = syn0[context_idx] * context_mask[..., None]       # (B, W, D)
    denom = torch.clamp_min(context_mask.sum(dim=1, keepdim=True), 1.0)
    h = v_ctx.sum(dim=1) / denom                              # (B, D) mean
    v_pos = syn1[targets]
    v_neg = syn1[negatives]
    pos_score = torch.einsum("bd,bd->b", h, v_pos)
    neg_score = torch.einsum("bd,bkd->bk", h, v_neg)
    loss = -torch.mean(F.logsigmoid(pos_score)) \
        - torch.mean(torch.sum(F.logsigmoid(-neg_score), dim=1))
    g_pos = torch.sigmoid(pos_score) - 1.0
    g_neg = torch.sigmoid(neg_score)
    grad_h = g_pos[:, None] * v_pos + torch.einsum("bk,bkd->bd", g_neg, v_neg)
    grad_ctx = (grad_h / denom)[:, None, :] * context_mask[..., None]  # (B, W, D)
    neg_flat = negatives.reshape(-1)
    c_out = _row_scale(syn1.shape[0], targets, neg_flat)
    grad_tgt = (g_pos[:, None] * h) / c_out[targets][:, None]
    grad_neg_flat = (g_neg[..., None] * h[:, None, :]).reshape(-1, h.shape[-1]) \
        / c_out[neg_flat][:, None]
    ctx_flat = context_idx.reshape(-1)
    c_ctx = torch.sqrt(torch.clamp_min(
        _counts(syn0.shape[0], ctx_flat, context_mask.reshape(-1)), 1.0))
    grad_ctx_flat = grad_ctx.reshape(-1, grad_ctx.shape[-1]) \
        / c_ctx[ctx_flat][:, None]
    _scatter_add(syn1, targets, -lr * grad_tgt)
    _scatter_add(syn1, neg_flat, -lr * grad_neg_flat)
    _scatter_add(syn0, ctx_flat, -lr * grad_ctx_flat)
    return syn0, syn1, loss


def _skipgram_ns_infer_step(vec, syn1, contexts, negatives, lr):
    """Inference-only skip-gram NS: a new (1, D) doc vector ``vec`` updated
    against a FROZEN output table (ParagraphVectors.inferVector). Neither
    ``vec`` nor ``syn1`` is written."""
    v_in = vec[0].expand(contexts.shape[0], vec.shape[1])
    v_pos = syn1[contexts]
    v_neg = syn1[negatives]
    pos_score = torch.einsum("bd,bd->b", v_in, v_pos)
    neg_score = torch.einsum("bd,bkd->bk", v_in, v_neg)
    g_pos = torch.sigmoid(pos_score) - 1.0
    g_neg = torch.sigmoid(neg_score)
    grad = (g_pos[:, None] * v_pos
            + torch.einsum("bk,bkd->bd", g_neg, v_neg)).sum(0)
    return vec - lr * grad[None, :]


# the trainers' update steps (module names, as the JAX package has them)
_skipgram_ns_step = _skipgram_ns_math
_skipgram_hs_step = _skipgram_hs_math
_cbow_ns_step = _cbow_ns_math


def _on(device: torch.device, arr: np.ndarray) -> torch.Tensor:
    """A host array as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _table(arr, shape, device: torch.device, what: str) -> torch.Tensor:
    """A carried-over f32 table on ``device``, its shape checked."""
    arr = np.asarray(arr, np.float32)
    if arr.shape != tuple(shape):
        raise ValueError(f"{what} has shape {arr.shape}, want {tuple(shape)}")
    return torch.from_numpy(arr.copy()).to(device)


@dataclass(frozen=True)
class SkipGram:
    """``learning/impl/elements/SkipGram.java`` marker config."""
    name: str = "SkipGram"


@dataclass(frozen=True)
class CBOW:
    """``learning/impl/elements/CBOW.java`` marker config."""
    name: str = "CBOW"


class SequenceVectors:
    """Generic embedding trainer over sequences of vocab indices.

    Builder-parity with ``SequenceVectors.java`` hyperparameters: layer_size,
    window, negative (K; 0 => hierarchical softmax), learning_rate ->
    min_learning_rate linear decay, subsampling of frequent tokens, epochs,
    batch_size, seed. The tables live on ``device`` (the card unless the
    caller names another).
    """

    def __init__(self, vocab: VocabCache, layer_size: int = 100, window: int = 5,
                 negative: int = 5, learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4, sampling: float = 0.0,
                 epochs: int = 1, batch_size: int = 2048, seed: int = 42,
                 algorithm=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.vocab = vocab
        self.layer_size = layer_size
        self.window = window
        self.negative = negative
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.sampling = sampling
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.algorithm = algorithm or SkipGram()
        V = len(vocab)
        rng = np.random.default_rng(seed)
        # Reference init: syn0 uniform in [-0.5/D, 0.5/D], syn1 zeros.
        self.syn0 = _on(self.device, (rng.random((V, layer_size),
                                                 dtype=np.float32) - 0.5)
                        / layer_size)
        self.syn1 = torch.zeros((V, layer_size), dtype=torch.float32,
                                device=self.device)
        self._neg_probs = unigram_table(vocab)
        if negative == 0:
            # the Huffman paths stay on the card; a batch gathers its rows
            self._codes, self._points, self._hs_mask = (
                _on(self.device, a) for a in huffman_tensors(vocab))
        self._step_ns = _skipgram_ns_step
        self._step_hs = _skipgram_hs_step
        self._step_cbow = _cbow_ns_step

    def load_tables(self, syn0, syn1) -> None:
        """Carry (V, D) ``syn0`` and ``syn1`` (numpy arrays, e.g. another
        package's trained tables) onto this trainer's device."""
        shape = self.syn0.shape
        self.syn0 = _table(syn0, shape, self.device, "syn0")
        self.syn1 = _table(syn1, shape, self.device, "syn1")

    # ----- host-side sampling of one epoch of training pairs ---------------

    def _sample_pairs(self, sequences: Sequence[np.ndarray], rng: np.random.Generator
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Dynamic-window skip-gram pair generation (SkipGram.java reduces the
        window uniformly per center, word2vec-style) + frequent-word
        subsampling (SequenceVectors 'sampling' knob)."""
        centers: List[np.ndarray] = []
        contexts: List[np.ndarray] = []
        keep_prob = None
        if self.sampling > 0:
            freq = self.vocab.counts() / max(self.vocab.total_count, 1)
            keep_prob = np.minimum(
                1.0, np.sqrt(self.sampling / np.maximum(freq, 1e-12))
                + self.sampling / np.maximum(freq, 1e-12))
        for seq in sequences:
            seq = np.asarray(seq, dtype=np.int64)
            if keep_prob is not None and len(seq):
                seq = seq[rng.random(len(seq)) < keep_prob[seq]]
            n = len(seq)
            if n < 2:
                continue
            b = rng.integers(1, self.window + 1, size=n)
            for i in range(n):
                lo, hi = max(0, i - int(b[i])), min(n, i + int(b[i]) + 1)
                ctx = np.concatenate([seq[lo:i], seq[i + 1:hi]])
                if len(ctx):
                    centers.append(np.full(len(ctx), seq[i]))
                    contexts.append(ctx)
        if not centers:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(centers), np.concatenate(contexts)

    def _window_arrays(self, sequences: Sequence[np.ndarray], rng: np.random.Generator):
        """CBOW batches: padded context windows per target."""
        W = 2 * self.window
        tgt, ctx, msk = [], [], []
        for seq in sequences:
            seq = np.asarray(seq, dtype=np.int64)
            n = len(seq)
            if n < 2:
                continue
            b = rng.integers(1, self.window + 1, size=n)
            for i in range(n):
                lo, hi = max(0, i - int(b[i])), min(n, i + int(b[i]) + 1)
                c = np.concatenate([seq[lo:i], seq[i + 1:hi]])[:W]
                if not len(c):
                    continue
                pad = np.zeros(W, np.int64)
                m = np.zeros(W, np.float32)
                pad[:len(c)] = c
                m[:len(c)] = 1.0
                tgt.append(seq[i]); ctx.append(pad); msk.append(m)
        if not tgt:
            return (np.zeros(0, np.int64), np.zeros((0, W), np.int64),
                    np.zeros((0, W), np.float32))
        return np.asarray(tgt), np.stack(ctx), np.stack(msk)

    # ----- training --------------------------------------------------------

    def fit(self, sequences: Iterable[Sequence[int]]) -> List[float]:
        """Train on index sequences; returns per-epoch mean losses. Each
        step's loss is read to the host, as the JAX package reads it."""
        seqs = [np.asarray(s, dtype=np.int64) for s in sequences]
        rng = np.random.default_rng(self.seed)
        dev = self.device
        losses: List[float] = []
        total_steps = None
        step = 0
        for epoch in range(self.epochs):
            ep_loss, nb = 0.0, 0
            if isinstance(self.algorithm, CBOW):
                tgt, ctx, msk = self._window_arrays(seqs, rng)
                order = rng.permutation(len(tgt))
                tgt, ctx, msk = tgt[order], ctx[order], msk[order]
                if total_steps is None:
                    total_steps = max(1, self.epochs * ((len(tgt) + self.batch_size - 1)
                                                        // max(self.batch_size, 1)))
                for s in range(0, len(tgt), self.batch_size):
                    bt, bc, bm = tgt[s:s + self.batch_size], ctx[s:s + self.batch_size], \
                        msk[s:s + self.batch_size]
                    bt, bc, bm = self._pad_batch3(bt, bc, bm)
                    neg = rng.choice(len(self.vocab), size=(len(bt), max(self.negative, 1)),
                                     p=self._neg_probs)
                    lr = self._lr(step, total_steps)
                    self.syn0, self.syn1, loss = self._step_cbow(
                        self.syn0, self.syn1, _on(dev, bc), _on(dev, bm),
                        _on(dev, bt), _on(dev, neg), lr)
                    ep_loss += float(loss); nb += 1; step += 1
            else:
                centers, contexts = self._sample_pairs(seqs, rng)
                order = rng.permutation(len(centers))
                centers, contexts = centers[order], contexts[order]
                if total_steps is None:
                    total_steps = max(1, self.epochs * ((len(centers) + self.batch_size - 1)
                                                        // max(self.batch_size, 1)))
                for s in range(0, len(centers), self.batch_size):
                    bc, bx = centers[s:s + self.batch_size], contexts[s:s + self.batch_size]
                    bc, bx = self._pad_batch(bc), self._pad_batch(bx)
                    lr = self._lr(step, total_steps)
                    if self.negative > 0:
                        neg = rng.choice(len(self.vocab), size=(len(bc), self.negative),
                                         p=self._neg_probs)
                        self.syn0, self.syn1, loss = self._step_ns(
                            self.syn0, self.syn1, _on(dev, bc), _on(dev, bx),
                            _on(dev, neg), lr)
                    else:
                        bx = _on(dev, bx)
                        self.syn0, self.syn1, loss = self._step_hs(
                            self.syn0, self.syn1, _on(dev, bc),
                            self._codes[bx], self._points[bx],
                            self._hs_mask[bx], lr)
                    ep_loss += float(loss); nb += 1; step += 1
            losses.append(ep_loss / max(nb, 1))
        return losses

    def _lr(self, step: int, total: int) -> float:
        frac = min(step / max(total, 1), 1.0)
        return max(self.learning_rate * (1.0 - frac), self.min_learning_rate)

    def _pad_batch(self, arr: np.ndarray) -> np.ndarray:
        """Pad the trailing partial batch to batch_size by repeating the
        batch's own rows, so every step runs at one batch shape."""
        if len(arr) == self.batch_size or len(arr) == 0:
            return arr
        reps = int(np.ceil(self.batch_size / len(arr)))
        return np.tile(arr, (reps,) + (1,) * (arr.ndim - 1))[:self.batch_size]

    def _pad_batch3(self, a, b, c):
        return self._pad_batch(a), self._pad_batch(b), self._pad_batch(c)

    # ----- lookup API (WordVectors.java surface) ---------------------------

    def vector(self, index: int) -> np.ndarray:
        return self.syn0[index].to("cpu", copy=True).numpy()

    @property
    def vectors(self) -> np.ndarray:
        """A host copy of syn0 (training goes on in place on the device)."""
        return self.syn0.to("cpu", copy=True).numpy()

    def similarity(self, i: int, j: int) -> float:
        a, b = self.vector(i), self.vector(j)
        den = np.linalg.norm(a) * np.linalg.norm(b)
        return float(a @ b / den) if den > 0 else 0.0

    def nearest(self, index: int, top_n: int = 10) -> List[Tuple[int, float]]:
        """The ``top_n`` rows of largest cosine similarity to row ``index``
        (itself excluded), best first, computed where the table lives."""
        M = self.syn0
        norms = torch.linalg.vector_norm(M, dim=1) + 1e-12
        sims = (M @ M[index]) / (norms * norms[index])
        sims[index] = -torch.inf
        top = torch.topk(sims, min(top_n, len(sims)))
        return list(zip(top.indices.tolist(), top.values.tolist()))
