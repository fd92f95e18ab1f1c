"""Vocabulary construction + Huffman coding — the port's copy of the JAX
package's ``nlp/vocab.py`` (``VocabConstructor.java:167``
buildJointVocabulary, ``VocabularyHolder.java`` and the Huffman tree built
for hierarchical softmax).

The vocab emits padded index arrays (codes/points with an explicit length
mask) so hierarchical softmax runs as one fixed-shape batched step instead
of per-word variable-length loops.
"""

from __future__ import annotations

import heapq
import itertools
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class VocabWord:
    """``models/word2vec/VocabWord.java`` — element + frequency + HS codes."""

    word: str
    count: int = 0
    index: int = -1
    codes: List[int] = field(default_factory=list)   # Huffman bits (0/1)
    points: List[int] = field(default_factory=list)  # inner-node indices
    is_label: bool = False                           # ParagraphVectors labels


class VocabCache:
    """``wordstore/VocabCache.java`` — word <-> index <-> frequency store."""

    def __init__(self):
        self.words: List[VocabWord] = []
        self._by_word: Dict[str, VocabWord] = {}
        self.total_count = 0

    def add(self, vw: VocabWord):
        vw.index = len(self.words)
        self.words.append(vw)
        self._by_word[vw.word] = vw

    def __contains__(self, word: str) -> bool:
        return word in self._by_word

    def __len__(self) -> int:
        return len(self.words)

    def word_for(self, index: int) -> str:
        return self.words[index].word

    def index_of(self, word: str) -> int:
        vw = self._by_word.get(word)
        return -1 if vw is None else vw.index

    def get(self, word: str) -> Optional[VocabWord]:
        return self._by_word.get(word)

    def counts(self) -> np.ndarray:
        return np.array([w.count for w in self.words], dtype=np.int64)


def build_huffman(cache: VocabCache) -> int:
    """Build the Huffman tree over word frequencies and store (codes, points)
    on each VocabWord — the reference does this in ``Huffman.java`` applied by
    ``VocabConstructor``. Returns max code length."""
    n = len(cache.words)
    if n == 0:
        return 0
    if n == 1:
        cache.words[0].codes, cache.words[0].points = [0], [0]
        return 1
    counter = itertools.count()
    # heap of (count, tiebreak, node_id); leaves are 0..n-1, inner n..2n-2
    heap = [(w.count, next(counter), i) for i, w in enumerate(cache.words)]
    heapq.heapify(heap)
    parent = np.zeros(2 * n - 1, dtype=np.int64)
    binary = np.zeros(2 * n - 1, dtype=np.int8)
    next_inner = n
    while len(heap) > 1:
        c1, _, i1 = heapq.heappop(heap)
        c2, _, i2 = heapq.heappop(heap)
        parent[i1] = next_inner
        parent[i2] = next_inner
        binary[i2] = 1
        heapq.heappush(heap, (c1 + c2, next(counter), next_inner))
        next_inner += 1
    root = next_inner - 1
    max_len = 0
    for i, w in enumerate(cache.words):
        codes: List[int] = []
        points: List[int] = []
        node = i
        while node != root:
            codes.append(int(binary[node]))
            points.append(int(parent[node] - n))  # inner-node index in [0, n-1)
            node = int(parent[node])
        codes.reverse()
        points.reverse()
        w.codes, w.points = codes, points
        max_len = max(max_len, len(codes))
    return max_len


def huffman_tensors(cache: VocabCache, max_len: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack per-word (codes, points) into padded ``(V, L)`` int arrays plus a
    ``(V, L)`` float mask — fixed shapes for the batched HS objective."""
    L = max_len or max((len(w.codes) for w in cache.words), default=0)
    V = len(cache.words)
    codes = np.zeros((V, L), dtype=np.int32)
    points = np.zeros((V, L), dtype=np.int32)
    mask = np.zeros((V, L), dtype=np.float32)
    for i, w in enumerate(cache.words):
        k = min(len(w.codes), L)
        codes[i, :k] = w.codes[:k]
        points[i, :k] = w.points[:k]
        mask[i, :k] = 1.0
    return codes, points, mask


class VocabConstructor:
    """``wordstore/VocabConstructor.java`` — count tokens over sources, prune
    below ``min_word_frequency``, index by descending frequency, build the
    Huffman tree. (The reference parallelises counting across threads; the
    Python Counter over a token stream is IO-bound here, and training — the
    hot path — runs on the card.)"""

    def __init__(self, min_word_frequency: int = 1, build_huffman_tree: bool = True):
        self.min_word_frequency = min_word_frequency
        self.build_huffman_tree = build_huffman_tree

    def build(self, token_stream: Iterable[Sequence[str]],
              special_tokens: Sequence[str] = ()) -> VocabCache:
        counts: Counter = Counter()
        total = 0
        for tokens in token_stream:
            counts.update(tokens)
            total += len(tokens)
        cache = VocabCache()
        for tok in special_tokens:
            vw = VocabWord(word=tok, count=max(counts.pop(tok, 1), 1), is_label=True)
            cache.add(vw)
        for word, c in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
            if c >= self.min_word_frequency:
                cache.add(VocabWord(word=word, count=c))
        cache.total_count = total
        if self.build_huffman_tree:
            build_huffman(cache)
        return cache


def vocab_from_counts(words: Sequence[str], counts: Sequence[int],
                      build_huffman_tree: bool = False,
                      label_prefix: Optional[str] = None,
                      total_count: Optional[int] = None) -> VocabCache:
    """A ``VocabCache`` holding ``words`` in the order given, with their
    counts (how another package's vocabulary crosses over); words that
    start with ``label_prefix`` are marked as labels. ``total_count`` (the
    corpus's token count, pruned words included) defaults to the sum of the
    non-label counts."""
    cache = VocabCache()
    for w, c in zip(words, counts):
        is_label = label_prefix is not None and w.startswith(label_prefix)
        cache.add(VocabWord(word=w, count=int(c), is_label=is_label))
    cache.total_count = int(total_count) if total_count is not None else \
        sum(w.count for w in cache.words if not w.is_label)
    if build_huffman_tree:
        build_huffman(cache)
    return cache


def unigram_table(cache: VocabCache, power: float = 0.75) -> np.ndarray:
    """Negative-sampling distribution ``count^0.75`` — the reference's
    ``InMemoryLookupTable`` builds the same table (SURVEY.md §2.5 "Lookup
    tables"). Returned as f32 normalized probabilities for numpy's
    ``Generator.choice`` rather than the reference's 100M-slot alias table."""
    c = cache.counts().astype(np.float64) ** power
    s = c.sum()
    return (c / s).astype(np.float32) if s > 0 else c.astype(np.float32)
