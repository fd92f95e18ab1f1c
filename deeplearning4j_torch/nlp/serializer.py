"""Word-vector serialization (the port's copy of the JAX package's
``nlp/serializer.py``; the files are the same bytes) — parity with
``models/embeddings/loader/WordVectorSerializer.java`` (2761 LoC): the
word2vec C text + binary formats and CSV round-trips, interoperable with the
original word2vec tooling and gensim.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def write_word_vectors(path: str, words: List[str], vectors: np.ndarray):
    """word2vec C *text* format: header 'V D', then 'word v1 v2 ...' lines
    (WordVectorSerializer.writeWordVectors)."""
    V, D = vectors.shape
    assert len(words) == V
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{V} {D}\n")
        for w, vec in zip(words, vectors):
            f.write(w + " " + " ".join(f"{x:.6g}" for x in vec) + "\n")


def read_word_vectors(path: str) -> Tuple[List[str], np.ndarray]:
    """Inverse of write_word_vectors (WordVectorSerializer.loadTxtVectors)."""
    with open(path, "r", encoding="utf-8") as f:
        header = f.readline().split()
        V, D = int(header[0]), int(header[1])
        words: List[str] = []
        vecs = np.zeros((V, D), np.float32)
        for i in range(V):
            parts = f.readline().rstrip("\n").split(" ")
            words.append(parts[0])
            vecs[i] = np.array(parts[1:1 + D], dtype=np.float32)
    return words, vecs


def write_word2vec_binary(path: str, words: List[str], vectors: np.ndarray):
    """word2vec C *binary* format (WordVectorSerializer.writeBinary): header
    'V D\\n', then per word: 'word ' + D little-endian float32 + '\\n'."""
    V, D = vectors.shape
    with open(path, "wb") as f:
        f.write(f"{V} {D}\n".encode("utf-8"))
        for w, vec in zip(words, vectors):
            f.write(w.encode("utf-8") + b" ")
            f.write(np.asarray(vec, np.float32).tobytes())
            f.write(b"\n")


def read_word2vec_binary(path: str) -> Tuple[List[str], np.ndarray]:
    """Inverse (WordVectorSerializer.readBinaryModel)."""
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").split()
        V, D = int(header[0]), int(header[1])
        words: List[str] = []
        vecs = np.zeros((V, D), np.float32)
        for i in range(V):
            chars = bytearray()
            while True:
                c = f.read(1)
                if c in (b" ", b""):
                    break
                chars.extend(c)
            words.append(chars.decode("utf-8"))
            vecs[i] = np.frombuffer(f.read(4 * D), dtype="<f4")
            f.read(1)  # trailing newline
    return words, vecs
