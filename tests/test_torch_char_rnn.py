"""The char-RNN slice of the port held against the JAX package on the CPU
at small sizes: ``rmsprop``, truncated BPTT, the recurrent zoo models
(``GravesLSTMCharRNN`` at hidden 12, ``TextGenerationLSTM``) trained and
generating, and the continuous batcher's refusal of recurrent models.

Params are the reference's, carried across with ``params_from_numpy``;
inputs come from numpy seeds. Tolerances (f32 both sides unless said):

- rmsprop: updates and params within 1e-6 of the largest entry over 5
  steps (``rsqrt`` may differ by an ulp), its state leaf for leaf;
- loss trajectories (full BPTT and tBPTT, masked or not, 6 steps at
  rmsprop 0.1): within 1e-4 relative per loss, as the other slices'
  trajectory tests (rmsprop's first steps move every weight by about
  0.45, which magnifies the packages' ulp-level differences);
- a bf16 config's tBPTT trajectory equals its f32 config's bit for bit
  (the reference's chunks cast nothing: they train in f32);
- ``steps_per_execution=4`` on the CPU equals single steps bit for bit;
- zips resume in the other package with the next loss within 1e-5;
- greedy one-hot ``generate``: the same ids as the reference's (f32).

The graphed char-RNN step against eager steps needs the card
(``gpu``-marked here; chip_smoke's ``[rnn]`` phase runs it at full width).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_torch.data import ArrayIterator, char_rnn_corpus
from deeplearning4j_torch.models import (ZOO_REGISTRY, GravesLSTMCharRNN,
                                         TextGenerationLSTM)
from deeplearning4j_torch.nn import layers as TL
from deeplearning4j_torch.nn.generation import generate
from deeplearning4j_torch.nn.model import (GraphBuilder, NetConfig,
                                           Sequential)
from deeplearning4j_torch.ops import updaters
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.serve.continuous import ContinuousBatcher
from deeplearning4j_torch.train import (CollectScoresListener, Trainer,
                                        opt_state_from_numpy,
                                        params_from_numpy)
from deeplearning4j_tpu.data.datasets import \
    char_rnn_corpus as j_char_rnn_corpus
from deeplearning4j_tpu.data.iterators import ArrayIterator as JArrayIterator
from deeplearning4j_tpu.models import GravesLSTMCharRNN as JGravesLSTMCharRNN
from deeplearning4j_tpu.models import TextGenerationLSTM as JTextGenerationLSTM
from deeplearning4j_tpu.nn.generation import generate as j_generate
from deeplearning4j_tpu.ops import updaters as jupdaters
from deeplearning4j_tpu.train.listeners import \
    CollectScoresListener as JCollectScoresListener
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

T, V, HID, BATCH = 10, 20, 12, 8
TRAJ_RTOL = 1e-4
ZIP_RTOL = 1e-5


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _pair(kind="graves", tbptt=0, compute_dtype=None, T_=T, V_=V):
    """The zoo model at hidden HID (TextGenerationLSTM keeps its 256) in
    both packages, the reference's params carried across."""
    jcls, tcls = ((JGravesLSTMCharRNN, GravesLSTMCharRNN) if kind == "graves"
                  else (JTextGenerationLSTM, TextGenerationLSTM))
    jz = jcls(seed=0, input_shape=(T_, V_), num_classes=V_, tbptt=tbptt)
    tz = tcls(seed=0, input_shape=(T_, V_), num_classes=V_, tbptt=tbptt,
              device="cpu")
    if kind == "graves":
        jz.hidden = tz.hidden = HID
    jm, tm = jz.build(), tz.build()
    jm.config.compute_dtype = tm.config.compute_dtype = compute_dtype
    jm.init()
    tm.params = params_from_numpy(tm, jax.tree.map(np.asarray, jm.params))
    tm.state = {}
    return jm, tm


def _batches(n=2, T_=T, V_=V, seed=0):
    rng = np.random.RandomState(seed)
    eye = np.eye(V_, dtype=np.float32)
    x = eye[rng.randint(0, V_, (n * BATCH, T_))]
    y = eye[rng.randint(0, V_, (n * BATCH, T_))]
    return x, y


def _trajectories(jm, tm, x, y, epochs=3, fm=None, lm=None, spe=1):
    jrec, trec = JCollectScoresListener(), CollectScoresListener()
    JTrainer(jm).fit(JArrayIterator(x, y, batch_size=BATCH,
                                    features_mask=fm, labels_mask=lm),
                     epochs=epochs, listeners=[jrec], prefetch=False)
    tr = Trainer(tm)
    tr.fit(ArrayIterator(x, y, batch_size=BATCH, features_mask=fm,
                         labels_mask=lm), epochs=epochs, listeners=[trec],
           steps_per_execution=spe)
    return ([float(l) for _, l in jrec.scores],
            [l for _, l in trec.scores], tr)


# ---------------------------------------------------------------- rmsprop
def test_rmsprop_matches_optax_and_its_state_crosses():
    rng = np.random.RandomState(0)
    params = {"a": {"w": rng.randn(4, 5).astype(np.float32),
                    "b": rng.randn(5).astype(np.float32)},
              "c": {"w": rng.randn(3).astype(np.float32)}}
    cfg = {"type": "rmsprop", "learning_rate": 0.1}
    jt, tt = jupdaters.build(cfg), updaters.build(cfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jt.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in tree_leaves(params)]
    ts = tt.init(tp)
    for _ in range(5):
        g = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                         params)
        ju, js = jt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = tt.update([torch.from_numpy(a) for a in tree_leaves(g)],
                           ts, tp)
        for got, want in zip(tu, jax.tree_util.tree_leaves(ju)):
            assert _rel_to_max(got.numpy(), want) <= 1e-6
        torch._foreach_add_(tp, list(tu))
    for got, want in zip(tp, jax.tree_util.tree_leaves(jp)):
        assert _rel_to_max(got.numpy(), want) <= 1e-6
    jleaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(js)]
    tleaves = [a.numpy() for a in tree_leaves(ts)]
    assert [(a.shape, a.dtype) for a in jleaves] == \
        [(a.shape, a.dtype) for a in tleaves]
    assert int(tleaves[-1]) == 5  # the learning-rate schedule's count
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)
    carried = opt_state_from_numpy(ts, jleaves)
    for a, b in zip(jleaves, tree_leaves(carried)):
        np.testing.assert_array_equal(b.numpy(), a)


def test_rmsprop_state_from_the_reference_trainer_continues_its_run():
    """A reference trainer's rmsprop state and params, carried into the
    port after 2 steps, give the reference's next losses."""
    jm, tm = _pair()
    x, y = _batches(3)
    jt = JTrainer(jm)
    jt.fit(JArrayIterator(x[:2 * BATCH], y[:2 * BATCH], batch_size=BATCH),
           prefetch=False)
    tm.params = params_from_numpy(tm, jax.tree.map(np.asarray, jt.params))
    tr = Trainer(tm)
    tr.opt_state = opt_state_from_numpy(
        tr.opt_state, jax.tree_util.tree_leaves(jt.opt_state))
    jrec, trec = JCollectScoresListener(), CollectScoresListener()
    jt.fit(JArrayIterator(x[2 * BATCH:], y[2 * BATCH:], batch_size=BATCH),
           epochs=2, listeners=[jrec], prefetch=False)
    tr.fit(ArrayIterator(x[2 * BATCH:], y[2 * BATCH:], batch_size=BATCH),
           epochs=2, listeners=[trec])
    np.testing.assert_allclose([l for _, l in trec.scores],
                               [float(l) for _, l in jrec.scores],
                               rtol=TRAJ_RTOL)


# ------------------------------------------------------------------ fits
@pytest.mark.parametrize("kind", ["graves", "textgen"])
def test_full_bptt_fit_matches_reference(kind):
    jm, tm = _pair(kind)
    x, y = _batches()
    want, got, _ = _trajectories(jm, tm, x, y)
    assert len(got) == 6
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


@pytest.mark.parametrize("masks", ["none", "features", "labels"])
def test_tbptt_trajectory_matches_reference(masks):
    """tBPTT of 4 steps at T 10: chunks of 4, 4 and a tail of 2 padded to
    4 and masked; with a (B, T) feature mask (the tail's pad extends it
    with zeros) or a label mask."""
    jm, tm = _pair(tbptt=4)
    x, y = _batches()
    lens = np.random.RandomState(5).randint(1, T + 1, 2 * BATCH)
    m = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    kw = {"none": {}, "features": {"fm": m}, "labels": {"lm": m}}[masks]
    want, got, _ = _trajectories(jm, tm, x, y, **kw)
    assert len(got) == 6
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


def test_tbptt_chunks_update_once_each_and_detach_the_carries():
    """One batch of T 10 at tBPTT 4 is three updater calls (the schedule's
    count), and its loss the mean of the three chunk losses."""
    _, tm = _pair(tbptt=4)
    x, y = _batches(1)
    tr = Trainer(tm)
    calls = []
    step = tr.tbptt_step

    def spy(*a, **k):
        out = step(*a, **k)
        calls.append(out[-1])
        assert not any(t.requires_grad for t in tree_leaves(out[3]))
        return out

    tr.tbptt_step = spy
    rec = CollectScoresListener()
    tr.fit(ArrayIterator(x, y, batch_size=BATCH), listeners=[rec])
    assert len(calls) == 3 and int(tree_leaves(tr.opt_state)[-1]) == 3
    assert rec.scores[0][1] == pytest.approx(
        float(sum(calls) / 3), rel=1e-7)


def test_tbptt_under_bf16_config_trains_in_f32():
    """The reference's contract: ``score_with_carry`` casts nothing, so a
    bf16 config's tBPTT run is its f32 config's bit for bit, and the
    reference's bf16-config run within TRAJ_RTOL."""
    jm, tm = _pair(tbptt=4, compute_dtype="bfloat16")
    _, tm32 = _pair(tbptt=4)
    x, y = _batches()
    want, got, _ = _trajectories(jm, tm, x, y)
    _, got32, _ = _trajectories(_pair(tbptt=4)[0], tm32, x, y)
    assert got == got32
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


def test_tbptt_ignores_steps_per_execution():
    x, y = _batches()
    _, a = _pair(tbptt=4)
    _, b = _pair(tbptt=4)
    ra, rb = CollectScoresListener(), CollectScoresListener()
    Trainer(a).fit(ArrayIterator(x, y, batch_size=BATCH), epochs=2,
                   listeners=[ra])
    tb = Trainer(b)
    tb.fit(ArrayIterator(x, y, batch_size=BATCH), epochs=2, listeners=[rb],
           steps_per_execution=2)
    assert tb.windows == 0 and ra.scores == rb.scores


def test_tbptt_on_a_graph_is_refused_like_the_reference():
    g = (GraphBuilder(NetConfig(seed=0, tbptt_length=4), device="cpu")
         .add_input("in", (T, V))
         .add_layer("rnn", TL.LSTM(n_out=HID), "in")
         .add_layer("out", TL.RnnOutput(n_out=V, activation="softmax",
                                        loss="mcxent"), "rnn")
         .set_outputs("out").build())
    x, y = _batches(1)
    with pytest.raises(ValueError, match="tBPTT is not supported"):
        Trainer(g).fit(ArrayIterator(x, y, batch_size=BATCH))


def test_steps_per_execution_equals_single_steps_on_the_cpu():
    x, y = _batches(5)
    _, a = _pair()
    _, b = _pair()
    ra, rb = CollectScoresListener(), CollectScoresListener()
    ta, tb = Trainer(a), Trainer(b)
    ta.fit(ArrayIterator(x, y, batch_size=BATCH), listeners=[ra])
    tb.fit(ArrayIterator(x, y, batch_size=BATCH), listeners=[rb],
           steps_per_execution=4)
    assert tb.windows == 1 and ra.scores == rb.scores
    for p, q in zip(tree_leaves((ta.params, ta.opt_state)),
                    tree_leaves((tb.params, tb.opt_state))):
        assert torch.equal(p, q)


# ------------------------------------------------------------------- zips
def _next_loss_jax(trainer, x, y):
    step = trainer._make_step()
    trainer.params, trainer.opt_state, trainer.state, loss = step(
        trainer.params, trainer.opt_state, trainer.state, jnp.asarray(x),
        jnp.asarray(y), trainer.next_rng(), None)
    return float(loss)


def _next_loss_port(trainer, x, y):
    trainer.params, trainer.opt_state, trainer.state, loss = trainer.step(
        trainer.params, trainer.opt_state, trainer.state, x, y)
    return loss.item()


def test_reference_zip_resumes_in_port(tmp_path):
    jm, _ = _pair()
    x, y = _batches()
    jt = JTrainer(jm)
    jt.fit(JArrayIterator(x, y, batch_size=BATCH), prefetch=False)
    path = str(tmp_path / "ref.zip")
    jt.save(path)
    port = Trainer.load(path, device="cpu")
    assert isinstance(port.model.layers[0], TL.GravesLSTM)
    assert int(tree_leaves(port.opt_state)[-1]) == 2
    want = _next_loss_jax(jt, x[:BATCH], y[:BATCH])
    np.testing.assert_allclose(_next_loss_port(port, x[:BATCH], y[:BATCH]),
                               want, rtol=ZIP_RTOL)


def test_port_zip_resumes_in_reference(tmp_path):
    _, tm = _pair()
    x, y = _batches()
    port = Trainer(tm)
    port.fit(ArrayIterator(x, y, batch_size=BATCH))
    path = str(tmp_path / "port.zip")
    port.save(path)
    jt = JTrainer.load(path)
    want = _next_loss_port(port, x[:BATCH], y[:BATCH])
    np.testing.assert_allclose(_next_loss_jax(jt, x[:BATCH], y[:BATCH]),
                               want, rtol=ZIP_RTOL)


# ------------------------------------------------------------- generation
@pytest.mark.parametrize("kind", ["graves", "textgen"])
def test_greedy_one_hot_generate_matches_reference(kind):
    jm, tm = _pair(kind, T_=12, V_=30)
    ids = np.random.RandomState(1).randint(0, 30, (2, 8))
    prompt = np.eye(30, dtype=np.float32)[ids]
    want = j_generate(jm, prompt, 6, temperature=0.0)
    got = generate(tm, prompt, 6, temperature=0.0)
    assert got.shape == (2, 6) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_generate_equals_the_argmax_rollout_of_full_forwards():
    """The rnnTimeStep contract: each greedy character is the argmax of a
    full forward over prompt + the characters before it."""
    _, tm = _pair("graves", T_=12, V_=30)
    eye = np.eye(30, dtype=np.float32)
    x = eye[np.random.RandomState(1).randint(0, 30, (2, 8))]
    toks = generate(tm, x, 5, temperature=0.0)
    for _ in range(5):
        nxt = tm.output(x)[:, -1].argmax(-1).numpy()
        x = np.concatenate([x, eye[nxt][:, None]], axis=1)
    np.testing.assert_array_equal(toks, x[:, -5:].argmax(-1))


def test_bf16_decode_promotes_carries_like_reference():
    """Under a bf16 compute dtype the decode carries are f32 (the param
    dtype): the port's stepwise logits equal the reference's decode
    compiled without excess precision, within 1e-5 of the largest."""
    from deeplearning4j_torch.nn.generation import (decode_forward,
                                                    init_caches)
    from deeplearning4j_tpu.nn.generation import \
        decode_forward as j_decode_forward
    from deeplearning4j_tpu.nn.generation import init_caches as j_init_caches

    jm, tm = _pair("graves", compute_dtype="bfloat16", T_=12, V_=30)
    x = np.eye(30, dtype=np.float32)[np.random.RandomState(1).randint(
        0, 30, (2, 6))]
    caches = init_caches(tm, 2, 6, tm.dtype)
    assert all(t.dtype == torch.float32 for t in tree_leaves(caches))

    def run(p, x):
        c = j_init_caches(jm, 2, 6, jm.dtype)
        out = []
        for t in range(6):
            lg, c = j_decode_forward(jm, p, {}, x[:, t:t + 1], c, t)
            out.append(lg)
        return jnp.concatenate(out, axis=1)

    fn = jax.jit(run).lower(jm.params, jnp.asarray(x)).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(fn(jm.params, jnp.asarray(x)))
    got = []
    with torch.inference_mode():
        for t in range(6):
            lg, caches = decode_forward(tm, tm.params, {},
                                        torch.from_numpy(x[:, t:t + 1]),
                                        caches, t)
            got.append(lg)
    got = torch.cat(got, dim=1).numpy()
    assert _rel_to_max(got, want) <= 1e-5


def test_continuous_batcher_refuses_recurrent_models():
    m = Sequential(NetConfig(seed=0), [
        TL.EmbeddingSequence(n_in=30, n_out=8),
        TL.LSTM(n_out=8),
        TL.RnnOutput(n_out=30, activation="softmax", loss="mcxent")],
        (16,), device="cpu")
    m.init()
    with pytest.raises(ValueError, match="recurrent carries cannot survive "
                                         "a right-padded prefill"):
        ContinuousBatcher(m, slots=2, capacity=16, seed=0)
    one_hot = TextGenerationLSTM(seed=0, input_shape=(12, 30),
                                 num_classes=30, device="cpu").build()
    one_hot.init()
    with pytest.raises(ValueError, match="embedding-front"):
        ContinuousBatcher(one_hot, slots=2, capacity=16, seed=0)


# ------------------------------------------------------- zoo and corpus
@pytest.mark.parametrize("kind", ["graves", "textgen"])
def test_zoo_configs_equal_the_reference_at_full_width(kind):
    jcls, tcls = ((JGravesLSTMCharRNN, GravesLSTMCharRNN) if kind == "graves"
                  else (JTextGenerationLSTM, TextGenerationLSTM))
    jm, tm = jcls(seed=0).build(), tcls(seed=0, device="meta").build()
    assert tm.to_json() == jm.to_json()
    assert ZOO_REGISTRY[tcls.__name__.lower()] is tcls
    jp = jax.eval_shape(lambda: jm.init()[0])
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == tm.param_shapes()


def test_char_rnn_corpus_equals_reference():
    ids, vocab = char_rnn_corpus(5000, seed=3)
    jids, jvocab = j_char_rnn_corpus(5000, seed=3)
    np.testing.assert_array_equal(ids, jids)
    assert ids.dtype == np.int32 and vocab == jvocab


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's [rnn] phase runs "
                    "these checks at full width on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"],
                         ids=["f32", "bf16"])
def test_graphed_char_rnn_is_bit_equal_to_eager(cuda, compute_dtype):
    x, y = _batches(5)

    def run(spe):
        z = GravesLSTMCharRNN(seed=0, input_shape=(T, V), num_classes=V,
                              tbptt=0, device=cuda)
        z.hidden = HID
        m = z.build()
        m.config.compute_dtype = compute_dtype
        m.init(seed=0)
        tr = Trainer(m)
        rec = CollectScoresListener()
        tr.fit(ArrayIterator(x, y, batch_size=BATCH), listeners=[rec],
               steps_per_execution=spe)
        return tr, [l for _, l in rec.scores]

    a, la = run(1)
    b, lb = run(4)
    assert b.captures == 1 and b.windows == 1 and la == lb
    for p, q in zip(tree_leaves((a.params, a.opt_state)),
                    tree_leaves((b.params, b.opt_state))):
        assert torch.equal(p, q)


@pytest.mark.gpu
def test_tbptt_batch_on_the_card_matches_the_cpu(cuda):
    _, tm = _pair(tbptt=4)
    x, y = _batches(1)
    card = Sequential.from_json(tm.to_json(), device=cuda)
    card.params = params_from_numpy(card, {
        k: {n: t.numpy() for n, t in v.items()} for k, v in tm.params.items()})
    card.state = {}
    losses = []
    for m in (tm, card):
        rec = CollectScoresListener()
        Trainer(m).fit(ArrayIterator(x, y, batch_size=BATCH), listeners=[rec])
        losses.append(rec.scores[0][1])
    assert losses[1] == pytest.approx(losses[0], rel=1e-4)
