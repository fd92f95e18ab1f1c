"""The port's embeddings stack (deeplearning4j_torch/nlp/) against the JAX
package's, on the CPU.

Tolerances, each stated where it is used:
- an update function against the reference's from the same tables and one
  Zipfian batch with heavy duplicates: tables within atol 1e-6, rtol 1e-5,
  the loss within rtol 1e-5 (STEP_*);
- a whole fit from the same seed: tables and per-epoch losses within
  rtol 1e-4, atol 1e-5 (FIT_*): the host draws the same index streams, so
  only float summation differs;
- the lookups (``words_nearest``) from the same tables: the same
  neighbours, similarities within 1e-6;
- exact equality for everything the host computes: vocab order, Huffman
  codes and points, the unigram table, sampled pairs and windows, GloVe's
  COO, the bag-of-words and TF-IDF matrices, CnnSentenceIterator's batches,
  and the vectors files (byte for byte).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_torch import nlp as tnlp
from deeplearning4j_torch.nlp import glove as tglove
from deeplearning4j_torch.nlp import sequencevectors as tsv
from deeplearning4j_torch.nlp import vocab as tvocab
from deeplearning4j_tpu import nlp as jnlp
from deeplearning4j_tpu.nlp import glove as jglove
from deeplearning4j_tpu.nlp import sequencevectors as jsv
from deeplearning4j_tpu.nlp import vocab as jvocab

STEP_ATOL, STEP_RTOL = 1e-6, 1e-5
FIT_ATOL, FIT_RTOL = 1e-5, 1e-4

V, D, B, K, L = 200, 16, 512, 5, 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's small CPU ops on one torch thread. On a loaded machine
    the intra-op pool's barriers cost far more than the work: one
    skip-gram fit of these tests took 54 s on 8 threads beside 8 busy
    processes, 0.6 s on 1."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
TOPICS = 5


def _corpus(seed=0, n_sent=300, length=12):
    """Sentences over V words: each picks a topic and draws 70% of its
    tokens Zipf within the topic, 30% Zipf over all words."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(V)]
    p = 1.0 / np.arange(1, V + 1)
    p /= p.sum()
    sents = []
    for _ in range(n_sent):
        t = rng.integers(TOPICS)
        cand = np.arange(t, V, TOPICS)
        pc = 1.0 / np.arange(1, len(cand) + 1)
        pc /= pc.sum()
        toks = [words[rng.choice(V, p=p)] if rng.random() < 0.3
                else words[cand[rng.choice(len(cand), p=pc)]]
                for _ in range(length)]
        sents.append(" ".join(toks))
    return sents


SENTS = _corpus()


def _zipf(rng, shape):
    """Indices in [0, V) drawn Zipf(1): index 0 fills about a sixth of a
    batch, so every scatter sums many repeated rows."""
    p = 1.0 / np.arange(1, V + 1)
    return rng.choice(V, size=shape, p=p / p.sum()).astype(np.int64)


def _tables(seed=1):
    rng = np.random.default_rng(seed)
    syn0 = ((rng.random((V, D), dtype=np.float32) - 0.5) / D)
    syn1 = (rng.standard_normal((V, D)).astype(np.float32) * 0.1)
    return syn0, syn1


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


# --------------------------------------------------------------------------
# update functions, one step from the same tables
# --------------------------------------------------------------------------

class TestSteps:
    LR = 0.025

    def _check(self, got, want):
        tsyn0, tsyn1, tloss = got
        jsyn0, jsyn1, jloss = want
        # STEP tolerance: atol 1e-6, rtol 1e-5 on the tables, rtol 1e-5 loss
        _close(tsyn0, jsyn0, STEP_ATOL, STEP_RTOL)
        _close(tsyn1, jsyn1, STEP_ATOL, STEP_RTOL)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=STEP_RTOL)

    def test_row_scale_counts_are_f32_and_exact(self):
        rng = np.random.default_rng(0)
        a, b = _zipf(rng, (B,)), _zipf(rng, (B * K,))
        got = tsv._row_scale(V, _t(a), _t(b))
        want = jsv._row_scale(V, _j(a), _j(b))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_skipgram_ns(self):
        rng = np.random.default_rng(2)
        syn0, syn1 = _tables()
        c, x, n = _zipf(rng, (B,)), _zipf(rng, (B,)), _zipf(rng, (B, K))
        got = tsv._skipgram_ns_step(_t(syn0), _t(syn1), _t(c), _t(x), _t(n),
                                    self.LR)
        want = jsv._skipgram_ns_step(_j(syn0), _j(syn1), _j(c), _j(x), _j(n),
                                     self.LR)
        self._check(got, want)
        assert np.abs(got[1].numpy() - syn1).max() > 1e-4  # it moved

    def test_skipgram_hs(self):
        rng = np.random.default_rng(3)
        syn0, syn1 = _tables()
        cache = jvocab.VocabCache()
        counts = np.bincount(_zipf(rng, (20 * V,)), minlength=V) + 1
        for i in range(V):
            cache.add(jvocab.VocabWord(word=f"w{i}", count=int(counts[i])))
        jvocab.build_huffman(cache)
        codes, points, mask = jvocab.huffman_tensors(cache)
        c, x = _zipf(rng, (B,)), _zipf(rng, (B,))
        args = (c, codes[x], points[x], mask[x])
        got = tsv._skipgram_hs_step(_t(syn0), _t(syn1),
                                    *[_t(a) for a in args], self.LR)
        want = jsv._skipgram_hs_step(_j(syn0), _j(syn1),
                                     *[_j(a) for a in args], self.LR)
        self._check(got, want)

    def test_cbow_ns(self):
        rng = np.random.default_rng(4)
        syn0, syn1 = _tables()
        W = 10
        ctx = _zipf(rng, (B, W))
        msk = (rng.random((B, W)) < 0.7).astype(np.float32)
        msk[:3] = 0.0  # rows with an empty window
        tgt, neg = _zipf(rng, (B,)), _zipf(rng, (B, K))
        got = tsv._cbow_ns_step(_t(syn0), _t(syn1), _t(ctx), _t(msk), _t(tgt),
                                _t(neg), self.LR)
        want = jsv._cbow_ns_step(_j(syn0), _j(syn1), _j(ctx), _j(msk), _j(tgt),
                                 _j(neg), self.LR)
        self._check(got, want)

    def test_infer_step_matches_and_leaves_syn1(self):
        rng = np.random.default_rng(5)
        _, syn1 = _tables()
        vec = (rng.random((1, D), dtype=np.float32) - 0.5) / D
        ctx, neg = _zipf(rng, (40,)), _zipf(rng, (40, K))
        t_syn1 = _t(syn1)
        t_vec = _t(vec)
        got = tsv._skipgram_ns_infer_step(t_vec, t_syn1, _t(ctx), _t(neg),
                                          self.LR)
        want = jsv._skipgram_ns_infer_step(_j(vec), _j(syn1), _j(ctx), _j(neg),
                                           self.LR)
        _close(got, want, STEP_ATOL, STEP_RTOL)
        np.testing.assert_array_equal(t_syn1.numpy(), syn1)
        np.testing.assert_array_equal(t_vec.numpy(), vec)

    def test_glove_step(self):
        rng = np.random.default_rng(6)
        W0 = (rng.random((V, D), dtype=np.float32) - 0.5) / D
        Wt0 = (rng.random((V, D), dtype=np.float32) - 0.5) / D
        b0 = rng.standard_normal(V).astype(np.float32) * 0.1
        bt0 = rng.standard_normal(V).astype(np.float32) * 0.1
        g = [np.full((V, D), 1e-8, np.float32), np.full((V, D), 1e-8, np.float32),
             rng.random(V).astype(np.float32), rng.random(V).astype(np.float32)]
        rows, cols = _zipf(rng, (B,)), _zipf(rng, (B,))
        x = rng.random(B).astype(np.float32) * 50 + 0.5
        logx = np.log(x)
        fx = np.minimum((x / 100.0) ** 0.75, 1.0).astype(np.float32)
        state = [W0, Wt0, b0, bt0] + g
        got = tglove._glove_step(*[_t(a) for a in state], _t(rows), _t(cols),
                                 _t(logx), _t(fx), 0.05)
        want = jglove._glove_step(*[_j(a) for a in state], _j(rows), _j(cols),
                                  _j(logx), _j(fx), 0.05)
        for name, a, b in zip(tglove.TABLES, got[:-1], want[:-1]):
            _close(a, b, STEP_ATOL, STEP_RTOL)
        np.testing.assert_allclose(float(got[-1]), float(want[-1]),
                                   rtol=STEP_RTOL)


# --------------------------------------------------------------------------
# host streams: exact equality
# --------------------------------------------------------------------------

def _vocab_pair(min_freq=1, huffman=True, special=()):
    toks = [s.split() for s in SENTS]
    j = jnlp.VocabConstructor(min_freq, huffman).build(toks, special)
    t = tnlp.VocabConstructor(min_freq, huffman).build(toks, special)
    return j, t


class TestHostStreams:
    @pytest.mark.parametrize("min_freq", [1, 5])
    def test_vocab_order_and_huffman(self, min_freq):
        j, t = _vocab_pair(min_freq, special=("__label__a",))
        assert [(w.word, w.count, w.index, w.codes, w.points, w.is_label)
                for w in t.words] == \
               [(w.word, w.count, w.index, w.codes, w.points, w.is_label)
                for w in j.words]
        assert t.total_count == j.total_count
        for a, b in zip(tvocab.huffman_tensors(t), jvocab.huffman_tensors(j)):
            np.testing.assert_array_equal(a, b)

    def test_unigram_table(self):
        j, t = _vocab_pair()
        got, want = tvocab.unigram_table(t), jvocab.unigram_table(j)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)

    def test_vocab_from_counts_rebuilds_the_vocabulary(self):
        j, _ = _vocab_pair(special=("__label__a",))
        t = tvocab.vocab_from_counts([w.word for w in j.words],
                                     [w.count for w in j.words],
                                     build_huffman_tree=True,
                                     label_prefix="__label__")
        assert [(w.word, w.count, w.codes, w.points, w.is_label)
                for w in t.words] == \
               [(w.word, w.count, w.codes, w.points, w.is_label)
                for w in j.words]

    @pytest.mark.parametrize("sampling", [0.0, 1e-3])
    def test_sampled_pairs(self, sampling):
        j, t = _vocab_pair()
        seqs = [[j.index_of(w) for w in s.split()] for s in SENTS]
        js = jsv.SequenceVectors(j, layer_size=D, window=4, sampling=sampling)
        ts = tsv.SequenceVectors(t, layer_size=D, window=4, sampling=sampling,
                                 device="cpu")
        got = ts._sample_pairs(seqs, np.random.default_rng(7))
        want = js._sample_pairs(seqs, np.random.default_rng(7))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ts.syn0.numpy(), np.asarray(js.syn0))

    def test_sampled_windows(self):
        j, t = _vocab_pair()
        seqs = [[j.index_of(w) for w in s.split()] for s in SENTS]
        js = jsv.SequenceVectors(j, layer_size=D, window=3)
        ts = tsv.SequenceVectors(t, layer_size=D, window=3, device="cpu")
        got = ts._window_arrays(seqs, np.random.default_rng(8))
        want = js._window_arrays(seqs, np.random.default_rng(8))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

    def test_pad_batch(self):
        j, t = _vocab_pair()
        js = jsv.SequenceVectors(j, layer_size=D, batch_size=7)
        ts = tsv.SequenceVectors(t, layer_size=D, batch_size=7, device="cpu")
        a = np.arange(3 * 2).reshape(3, 2)
        np.testing.assert_array_equal(ts._pad_batch(a), js._pad_batch(a))

    def test_glove_coo(self):
        j, t = _vocab_pair(huffman=False)
        toks = [s.split() for s in SENTS]
        got = tnlp.CoOccurrences(t, window=6).fit(toks).coo()
        want = jnlp.CoOccurrences(j, window=6).fit(toks).coo()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("cls", ["BagOfWordsVectorizer", "TfidfVectorizer"])
    def test_vectorizers(self, cls):
        got = getattr(tnlp, cls)().fit(SENTS[:200]).transform(SENTS[200:])
        want = getattr(jnlp, cls)().fit(SENTS[:200]).transform(SENTS[200:])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    def test_tokenizers(self):
        text = "The Quick, brown (fox) jumps: 42 times!"
        got, want = (pkg.NGramTokenizerFactory(min_n=1, max_n=2)
                     .set_token_preprocessor(pkg.CommonPreprocessor())
                     .create(text).get_tokens() for pkg in (tnlp, jnlp))
        assert got == want and "quick_brown" in got

    def test_cnn_sentence_iterator(self):
        rng = np.random.default_rng(9)
        table = {f"w{i}": rng.standard_normal(D).astype(np.float32)
                 for i in range(0, V, 2)}

        class Vectors:
            def has_word(self, w):
                return w in table

            def get_word_vector(self, w):
                return table[w]

        batches = []
        for pkg in (tnlp, jnlp):
            docs = [pkg.LabelledDocument(s, [f"t{i % 3}"])
                    for i, s in enumerate(SENTS[:50])]
            batches.append(list(pkg.CnnSentenceIterator(
                docs, Vectors(), batch_size=16, max_length=8,
                shuffle_seed=3)))
        assert len(batches[0]) == len(batches[1]) == 4
        for got, want in zip(*batches):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# whole fits from the same seed
# --------------------------------------------------------------------------

W2V_CASES = {
    "skipgram_ns": dict(),
    "skipgram_ns_sampled": dict(sampling=1e-3),
    "skipgram_hs": dict(negative_sample=0),
    "cbow": dict(use_cbow=True),
}


def _same_nearest(got, want):
    """The same neighbours in the same order, similarities within 1e-6 (the
    port takes them with torch, the reference with numpy)."""
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=0, atol=1e-6)


def _fit_close(got, want):
    # FIT tolerance: rtol 1e-4, atol 1e-5
    _close(got, want, FIT_ATOL, FIT_RTOL)


class TestFits:
    @pytest.mark.parametrize("case", sorted(W2V_CASES))
    def test_word2vec(self, case):
        kw = dict(min_word_frequency=1, layer_size=D, window_size=3,
                  batch_size=64, epochs=3, **W2V_CASES[case])
        j = jnlp.Word2Vec(**kw)
        t = tnlp.Word2Vec(device="cpu", **kw)
        jl, tl = j.fit(SENTS), t.fit(SENTS)
        assert len(tl) == 3 and tl[-1] < tl[0]
        _fit_close(tl, jl)
        _fit_close(t.sv.syn0.numpy(), np.asarray(j.sv.syn0))
        _fit_close(t.sv.syn1.numpy(), np.asarray(j.sv.syn1))
        assert t.vocab_words() == j.vocab_words()
        np.testing.assert_allclose(t.similarity("w0", "w5"),
                                   j.similarity("w0", "w5"), atol=FIT_ATOL)

    @pytest.mark.parametrize("dm", [False, True], ids=["dbow", "dm"])
    def test_paragraph_vectors(self, dm):
        kw = dict(layer_size=D, window_size=3, batch_size=64, epochs=3, dm=dm)
        j = jnlp.ParagraphVectors(**kw)
        t = tnlp.ParagraphVectors(device="cpu", **kw)
        jl = j.fit([jnlp.LabelledDocument(s, [f"d{i % 20}"])
                    for i, s in enumerate(SENTS)])
        tl = t.fit([tnlp.LabelledDocument(s, [f"d{i % 20}"])
                    for i, s in enumerate(SENTS)])
        _fit_close(tl, jl)
        _fit_close(t.sv.syn0.numpy(), np.asarray(j.sv.syn0))
        _fit_close(t.sv.syn1.numpy(), np.asarray(j.sv.syn1))
        assert t.labels == j.labels
        _fit_close(t.infer_vector(SENTS[7]), j.infer_vector(SENTS[7]))
        assert [lab for lab, _ in t.nearest_labels(SENTS[7], 3)] == \
               [lab for lab, _ in j.nearest_labels(SENTS[7], 3)]

    def test_glove(self):
        kw = dict(layer_size=D, window_size=5, batch_size=256, epochs=3)
        j, t = jnlp.Glove(**kw), tnlp.Glove(device="cpu", **kw)
        jl, tl = j.fit(SENTS), t.fit(SENTS)
        assert tl[-1] < tl[0]
        _fit_close(tl, jl)
        _fit_close(t.W, j.W)
        assert sorted(t.tables) == sorted(tglove.TABLES)

    def test_glove_from_loaded_state(self):
        """``Glove.load_tables`` starts the fit from the given state: held
        against the reference's step driven by hand over the same COO and
        shuffle (FIT tolerance)."""
        rng = np.random.default_rng(10)
        j, _ = _vocab_pair(huffman=False)
        n = len(j)
        state = [(rng.random((n, D), dtype=np.float32) - 0.5) / D,
                 (rng.random((n, D), dtype=np.float32) - 0.5) / D,
                 rng.standard_normal(n).astype(np.float32) * 0.1,
                 rng.standard_normal(n).astype(np.float32) * 0.1,
                 np.full((n, D), 1e-3, np.float32),
                 np.full((n, D), 1e-3, np.float32),
                 np.full(n, 1e-3, np.float32), np.full(n, 1e-3, np.float32)]
        t = tnlp.Glove(layer_size=D, batch_size=256, epochs=2, seed=4,
                       device="cpu")
        t.load_tables(*state)
        tl = t.fit(SENTS)
        rows, cols, x = jnlp.CoOccurrences(j, window=5).fit(
            [s.split() for s in SENTS]).coo()
        logx = np.log(x)
        fx = np.minimum((x / 100.0) ** 0.75, 1.0).astype(np.float32)
        r = np.random.default_rng(4)
        r.random((n, D), dtype=np.float32), r.random((n, D), dtype=np.float32)
        js = [jnp.asarray(a) for a in state]
        jl = []
        for _ in range(2):
            order = r.permutation(len(x))
            ep = []
            for s in range(0, len(order) - 256 + 1, 256):
                sel = order[s:s + 256]
                *js, loss = jglove._glove_step(
                    *js, jnp.asarray(rows[sel]), jnp.asarray(cols[sel]),
                    jnp.asarray(logx[sel]), jnp.asarray(fx[sel]), 0.05)
                ep.append(float(loss))
            jl.append(sum(ep) / len(ep))
        _fit_close(tl, jl)
        for name, want in zip(tglove.TABLES, js):
            _fit_close(t.tables[name].numpy(), np.asarray(want))

    def test_word2vec_carried_tables(self):
        """The reference's trained tables and vocabulary loaded into the
        port answer the lookup API as the reference does: the vectors
        exactly, the nearest words the same (similarities within 1e-6)."""
        kw = dict(min_word_frequency=2, layer_size=D, window_size=3,
                  batch_size=64, epochs=2)
        j = jnlp.Word2Vec(**kw)
        j.fit(SENTS)
        t = tnlp.Word2Vec(device="cpu", **kw)
        t.load_tables(np.asarray(j.sv.syn0), np.asarray(j.sv.syn1),
                      words=j.vocab_words(),
                      counts=[w.count for w in j.vocab.words],
                      total_count=j.vocab.total_count)
        np.testing.assert_array_equal(t.vectors, np.asarray(j.sv.syn0))
        for w in ("w0", "w3", "w17"):
            _same_nearest(t.words_nearest(w, 5), j.words_nearest(w, 5))
        np.testing.assert_array_equal(t.sv.syn1.numpy(), np.asarray(j.sv.syn1))

    def test_sequence_vectors_carried_tables(self):
        j, t = _vocab_pair()
        syn0, syn1 = np.zeros((len(j), D), np.float32), np.ones((len(j), D),
                                                               np.float32)
        sv = tsv.SequenceVectors(t, layer_size=D, device="cpu")
        sv.load_tables(syn0, syn1)
        np.testing.assert_array_equal(sv.syn1.numpy(), syn1)
        syn1[0, 0] = 5.0  # a copy, not a view of the caller's array
        assert float(sv.syn1[0, 0]) == 1.0
        with pytest.raises(ValueError):
            sv.load_tables(syn0[:-1], syn1)
        with pytest.raises(RuntimeError):
            tnlp.Word2Vec(device="cpu").load_tables(syn0, syn1)

    def test_paragraph_vectors_carried_tables(self):
        kw = dict(layer_size=D, window_size=3, batch_size=64, epochs=2)
        j = jnlp.ParagraphVectors(**kw)
        j.fit([jnlp.LabelledDocument(s, [f"d{i % 7}"])
               for i, s in enumerate(SENTS)])
        t = tnlp.ParagraphVectors(device="cpu", **kw)
        t.load_tables(np.asarray(j.sv.syn0), np.asarray(j.sv.syn1),
                      words=[w.word for w in j.vocab.words],
                      counts=[w.count for w in j.vocab.words])
        assert t.labels == j.labels
        np.testing.assert_array_equal(t.get_label_vector("d3"),
                                      j.get_label_vector("d3"))
        _fit_close(t.infer_vector(SENTS[1]), j.infer_vector(SENTS[1]))


# --------------------------------------------------------------------------
# files, devices
# --------------------------------------------------------------------------

class TestSerializer:
    @pytest.mark.parametrize("fmt", ["text", "binary"])
    def test_files_cross_read_and_same_bytes(self, tmp_path, fmt):
        rng = np.random.default_rng(11)
        words = [f"w{i}" for i in range(30)] + ["émigré", "naïve"]
        vecs = rng.standard_normal((len(words), 7)).astype(np.float32)
        write, read = (("write_word_vectors", "read_word_vectors")
                       if fmt == "text" else
                       ("write_word2vec_binary", "read_word2vec_binary"))
        tp, jp = tmp_path / "port", tmp_path / "ref"
        getattr(tnlp, write)(str(tp), words, vecs)
        getattr(jnlp, write)(str(jp), words, vecs)
        assert tp.read_bytes() == jp.read_bytes()
        for reader, path in ((tnlp, jp), (jnlp, tp)):
            got_w, got_v = getattr(reader, read)(str(path))
            want_w, want_v = getattr(jnlp if reader is tnlp else tnlp,
                                     read)(str(path))
            assert got_w == want_w == words
            np.testing.assert_array_equal(got_v, want_v)
        if fmt == "binary":
            np.testing.assert_array_equal(getattr(tnlp, read)(str(jp))[1], vecs)


class TestDevice:
    @pytest.mark.parametrize("make", [
        lambda: tnlp.Word2Vec(), lambda: tnlp.ParagraphVectors(),
        lambda: tnlp.Glove(),
        lambda: tsv.SequenceVectors(tvocab.VocabConstructor().build([["a"]])),
    ], ids=["Word2Vec", "ParagraphVectors", "Glove", "SequenceVectors"])
    def test_no_card_no_device_raises(self, make, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()

    def test_tables_on_the_named_device(self):
        t = tnlp.Word2Vec(min_word_frequency=1, layer_size=D, device="cpu")
        t.fit(SENTS[:20])
        assert t.sv.syn0.device.type == t.sv.syn1.device.type == "cpu"
        v = t.get_word_vector("w0")
        t.sv.syn0.zero_()  # lookups are host copies
        assert np.abs(v).max() > 0
