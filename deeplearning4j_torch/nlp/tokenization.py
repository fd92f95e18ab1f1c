"""Tokenizers, preprocessors, sentence/document iterators (the port's copy
of the JAX package's ``nlp/tokenization.py``) — parity with the
reference's ``text/tokenization/``, ``text/sentenceiterator/`` and
``text/documentiterator/`` trees (SURVEY.md §2.5).

The reference defines Tokenizer/TokenizerFactory SPIs with pluggable
preprocessors (``text/tokenization/tokenizer/TokenPreProcess.java``) and a
zoo of sentence iterators. Here the same contracts are plain Python
callables/iterables — the CJK language packs (ansj/Kuromoji vendored in the
reference, §2.5 "Language packs") are covered by the pluggable factory: wrap
any external segmenter as a ``TokenizerFactory``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence


class TokenPreProcess:
    """``tokenizer/TokenPreProcess.java`` — per-token normalization hook."""

    def __call__(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """``preprocessor/CommonPreprocessor.java`` — lowercase + strip
    punctuation/digits (keeps unicode letters)."""

    _STRIP = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def __call__(self, token: str) -> str:
        return self._STRIP.sub("", token).lower()


class LowCasePreprocessor(TokenPreProcess):
    def __call__(self, token: str) -> str:
        return token.lower()


class Tokenizer:
    """``tokenizer/Tokenizer.java`` — iterator over tokens of one string."""

    def __init__(self, tokens: List[str], preprocessor: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._pre = preprocessor

    def get_tokens(self) -> List[str]:
        if self._pre is None:
            return list(self._tokens)
        out = [self._pre(t) for t in self._tokens]
        return [t for t in out if t]

    def count_tokens(self) -> int:
        return len(self.get_tokens())

    def __iter__(self) -> Iterator[str]:
        return iter(self.get_tokens())


class TokenizerFactory:
    """``tokenizerfactory/TokenizerFactory.java`` SPI."""

    def __init__(self):
        self._pre: Optional[TokenPreProcess] = None

    def set_token_preprocessor(self, pre: TokenPreProcess) -> "TokenizerFactory":
        self._pre = pre
        return self

    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    """``DefaultTokenizerFactory.java`` — whitespace tokenization."""

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(text.split(), self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    """``NGramTokenizerFactory.java`` — emits n-grams (joined by '_') from
    min_n to max_n over the base tokenizer's output."""

    def __init__(self, base: Optional[TokenizerFactory] = None, min_n: int = 1, max_n: int = 1):
        super().__init__()
        self.base = base or DefaultTokenizerFactory()
        self.min_n, self.max_n = min_n, max_n

    def create(self, text: str) -> Tokenizer:
        toks = self.base.create(text).get_tokens()
        out: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(0, len(toks) - n + 1):
                out.append("_".join(toks[i:i + n]))
        return Tokenizer(out, self._pre)


# --------------------------------------------------------------------------
# Sentence / document iterators (text/sentenceiterator, text/documentiterator)
# --------------------------------------------------------------------------

class SentenceIterator:
    """``sentenceiterator/SentenceIterator.java`` — resettable stream of
    sentence strings."""

    def __iter__(self) -> Iterator[str]:
        raise NotImplementedError

    def reset(self):
        pass


class CollectionSentenceIterator(SentenceIterator):
    """``CollectionSentenceIterator.java`` — over an in-memory collection."""

    def __init__(self, sentences: Sequence[str]):
        self.sentences = list(sentences)

    def __iter__(self):
        return iter(self.sentences)


class BasicLineIterator(SentenceIterator):
    """``BasicLineIterator.java`` — one sentence per line of a file."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self):
        with open(self.path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


@dataclass
class LabelledDocument:
    """``documentiterator/LabelledDocument.java`` — text + label(s), the unit
    ParagraphVectors trains on."""

    content: str
    labels: List[str] = field(default_factory=list)


class LabelAwareIterator:
    """``documentiterator/LabelAwareIterator.java``."""

    def __iter__(self) -> Iterator[LabelledDocument]:
        raise NotImplementedError


class CollectionLabelledIterator(LabelAwareIterator):
    def __init__(self, docs: Sequence[LabelledDocument]):
        self.docs = list(docs)

    def __iter__(self):
        return iter(self.docs)
