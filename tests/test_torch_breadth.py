"""The breadth configs of the port (``LeNet``, ``SimpleCNN``, ``VGG16``,
``VGG19`` and ``BertBase`` in ``deeplearning4j_torch/models``) held
against the JAX package at small sizes.

Params are the reference's, carried across with ``params_from_numpy``;
inputs come from numpy seeds. Tolerances (f32 both sides):

- configs: the layer JSON and the params tree's shapes equal the
  reference's, for every model at its full width;
- forward and loss, in eval mode and in training with every dropout at 0:
  within 1e-5 (relative to the largest output; the loss relative);
- first-step gradients: within 1e-4 of ``jax.value_and_grad`` relative to
  each param's largest entry;
- ``BertBase(small=True, flash=True)`` with a right-padded mask: the JAX
  side runs its Pallas kernel in interpret mode (as its own tests run it
  on the CPU), the port its plain versions, both on the lengths route;
- 5-step trajectories of the reference's updaters (adam for LeNet, adamw
  for BERT) within 1e-4 relative per loss, as
  ``test_loss_trajectory_matches_reference_trainer``;
- zips written by either package resume in the other with the next
  step's loss within 1e-5 relative.

The graphed megastep against eager steps on the card is in
``tests/test_torch_train.py`` (``gpu``-marked; chip_smoke runs the same
checks at full width).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.data import ArrayIterator
from deeplearning4j_torch.models import (VGG16, VGG19, BertBase, LeNet,
                                         SimpleCNN)
from deeplearning4j_torch.models.cnn import _vgg
from deeplearning4j_torch.nn.model import Sequential
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.train import (CollectScoresListener, Trainer,
                                        params_from_numpy, state_from_numpy)
from deeplearning4j_tpu.data.iterators import ArrayIterator as JArrayIterator
from deeplearning4j_tpu.models import VGG16 as JVGG16
from deeplearning4j_tpu.models import VGG19 as JVGG19
from deeplearning4j_tpu.models import BertBase as JBertBase
from deeplearning4j_tpu.models import LeNet as JLeNet
from deeplearning4j_tpu.models import SimpleCNN as JSimpleCNN
from deeplearning4j_tpu.models.cnn import _vgg as j_vgg
from deeplearning4j_tpu.nn.model import Sequential as JSequential
from deeplearning4j_tpu.train.listeners import \
    CollectScoresListener as JCollectScoresListener
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
TRAJ_RTOL = 1e-4
ZIP_RTOL = 1e-5
# a narrowed VGG: the reference's _vgg at 16x16x3 with two conv stages
VGG_CFG = [8, 8, "M", 16, "M", "M"]
VGG_SHAPE = (16, 16, 3)
BERT_T = 32
BERT_LENS = [32, 20, 7, 1]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _no_dropout(model):
    """The same Sequential with every layer's dropout config removed."""
    layers = [dataclasses.replace(l, dropout=None)
              if getattr(l, "dropout", None) is not None else l
              for l in model.layers]
    if isinstance(model, JSequential):
        return JSequential(model.config, layers, model.input_shape)
    return Sequential(model.config, layers, model.input_shape,
                      device=model.device)


def _carry(jm, tm):
    """The port model ``tm`` with ``jm``'s params and state."""
    tm.params = params_from_numpy(tm, _np_tree(jm.params))
    tm.state = state_from_numpy(_np_tree(jm.state), "cpu") if jm.state else {}
    return tm


# ------------------------------------------------------------- the models
def _lenet_pair():
    jm = JLeNet(num_classes=10, seed=0).build()
    jm.init()
    return jm, _carry(jm, LeNet(num_classes=10, seed=0, device="cpu").build())


def _vgg_pair(dropout=True):
    jm = j_vgg(0, VGG_SHAPE, 10, VGG_CFG)
    jm.init()
    tm = _carry(jm, _vgg(0, VGG_SHAPE, 10, VGG_CFG, device="cpu"))
    if not dropout:
        jm2, tm2 = _no_dropout(jm), _no_dropout(tm)
        jm2.params, jm2.state = jm.params, jm.state
        tm2.params, tm2.state = tm.params, tm.state
        return jm2, tm2
    return jm, tm


def _bert_pair():
    jm = JBertBase(small=True, flash=True, input_shape=(BERT_T,),
                   seed=0).build()
    jm.init()
    return jm, _carry(jm, BertBase(small=True, flash=True, seed=0,
                                   input_shape=(BERT_T,),
                                   device="cpu").build())


def _image_batch(shape, n=4, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + shape).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _bert_batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 1000, (n, BERT_T)).astype(np.int32)
    mask = (np.arange(BERT_T)[None, :]
            < np.array(BERT_LENS[:n])[:, None]).astype(np.float32)
    x = np.where(mask > 0, x, 0).astype(np.int32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    return x, y, mask


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("name", ["LeNet", "SimpleCNN", "VGG16", "VGG19",
                                  "BertBase", "BertBase_small"])
def test_zoo_config_and_param_tree_match_reference(name):
    small = name == "BertBase_small"
    port, ref = {"LeNet": (LeNet, JLeNet), "SimpleCNN": (SimpleCNN, JSimpleCNN),
                 "VGG16": (VGG16, JVGG16), "VGG19": (VGG19, JVGG19),
                 "BertBase": (BertBase, JBertBase),
                 "BertBase_small": (BertBase, JBertBase)}[name]
    kw = {"small": True, "flash": True} if small else {}
    jm = ref(seed=0, **kw).build()
    tm = port(seed=0, device="cpu", **kw).build()
    assert json.loads(tm.to_json()) == json.loads(jm.to_json())
    jshapes, jstate = jax.eval_shape(jm.init)
    assert tm.param_shapes() == jax.tree.map(lambda s: tuple(s.shape),
                                             jshapes)
    # the reference's JSON builds the same model in the port, and back
    again = Sequential.from_json(jm.to_json(), device="cpu")
    assert json.loads(again.to_json()) == json.loads(jm.to_json())
    assert json.loads(JSequential.from_json(tm.to_json()).to_json()) == \
        json.loads(jm.to_json())


# ------------------------------------------------------- forward and loss
def _forward_pair(jm, tm, x, mask=None, training=False):
    jy, _ = jm.forward(jm.params, jm.state, jnp.asarray(x), training=training,
                       mask=None if mask is None else jnp.asarray(mask),
                       rng=jax.random.PRNGKey(0) if training else None)
    ty, _ = tm.forward(tm.params, tm.state, torch.from_numpy(x),
                       training=training,
                       mask=None if mask is None else torch.from_numpy(mask),
                       rng=torch.Generator().manual_seed(0)
                       if training else None)
    return np.asarray(jy), ty.detach().numpy()


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("which", ["lenet", "vgg"])
def test_cnn_forward_matches_reference(which, training):
    jm, tm = _lenet_pair() if which == "lenet" else \
        _vgg_pair(dropout=not training)
    shape = (28, 28, 1) if which == "lenet" else VGG_SHAPE
    x, _ = _image_batch(shape)
    jy, ty = _forward_pair(jm, tm, x, training=training)
    assert _rel_to_max(ty, jy) <= FWD_RTOL


def test_simple_cnn_eval_forward_matches_reference():
    jm = JSimpleCNN(seed=0).build()
    jm.init()
    tm = _carry(jm, SimpleCNN(seed=0, device="cpu").build())
    x, _ = _image_batch((48, 48, 3), n=2)
    jy, ty = _forward_pair(jm, tm, x)
    assert _rel_to_max(ty, jy) <= FWD_RTOL


def _loss_and_grads(jm, tm, x, y, mask=None):
    def jloss(p):
        return jm.score(p, jm.state, jnp.asarray(x), jnp.asarray(y),
                        training=True, rng=jax.random.PRNGKey(0),
                        mask=None if mask is None else jnp.asarray(mask))[0]

    lj, gj = jax.value_and_grad(jloss)(jm.params)
    leaves = [p.detach().clone().requires_grad_() for p in
              tree_leaves(tm.params)]
    from deeplearning4j_torch.ops.updaters import tree_unflatten

    lt, _ = tm.score(tree_unflatten(tm.params, leaves), tm.state,
                     torch.from_numpy(x), torch.from_numpy(y), training=True,
                     rng=torch.Generator().manual_seed(0),
                     mask=None if mask is None else torch.from_numpy(mask))
    gt = torch.autograd.grad(lt, leaves)
    return float(lj), lt.item(), jax.tree_util.tree_leaves(gj), gt


@pytest.mark.parametrize("which", ["lenet", "vgg", "bert"])
def test_loss_and_first_step_gradients_match_reference(which):
    if which == "bert":
        jm, tm = _bert_pair()
        x, y, mask = _bert_batch()
    else:
        jm, tm = _lenet_pair() if which == "lenet" else _vgg_pair(False)
        x, y = _image_batch((28, 28, 1) if which == "lenet" else VGG_SHAPE)
        mask = None
    lj, lt, gj, gt = _loss_and_grads(jm, tm, x, y, mask)
    np.testing.assert_allclose(lt, lj, rtol=FWD_RTOL)
    assert len(gj) == len(gt)
    for want, got in zip(gj, gt):
        assert got.shape == want.shape
        assert _rel_to_max(got.numpy(), want) <= GRAD_RTOL


def test_bert_padded_forward_matches_reference_and_ignores_padding():
    jm, tm = _bert_pair()
    x, _, mask = _bert_batch()
    jy, ty = _forward_pair(jm, tm, x, mask=mask)
    assert _rel_to_max(ty, jy) <= FWD_RTOL
    # tokens past each row's length change nothing
    x2 = np.where(mask > 0, x, 999).astype(np.int32)
    _, ty2 = _forward_pair(jm, tm, x2, mask=mask)
    np.testing.assert_allclose(ty2, ty, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ trajectories
def _fit_losses(jm, tm, x, y, mask, steps, batch):
    rep = lambda a: None if a is None else np.concatenate([a] * steps)
    jrec, trec = JCollectScoresListener(), CollectScoresListener()
    jm.params = jax.tree.map(jnp.asarray, _np_tree(jm.params))
    JTrainer(jm).fit(JArrayIterator(rep(x), rep(y), batch_size=batch,
                                    features_mask=rep(mask)),
                     listeners=[jrec], prefetch=False)
    Trainer(tm).fit(ArrayIterator(rep(x), rep(y), batch_size=batch,
                                  features_mask=rep(mask)),
                    listeners=[trec])
    return (np.array([l for _, l in jrec.scores]),
            np.array([l for _, l in trec.scores]))


@pytest.mark.parametrize("which", ["lenet", "bert"])
def test_five_step_trajectory_matches_reference_trainer(which):
    if which == "bert":
        jm, tm = _bert_pair()
        x, y, mask = _bert_batch()
    else:
        jm, tm = _lenet_pair()
        (x, y), mask = _image_batch((28, 28, 1)), None
    want, got = _fit_losses(jm, tm, x, y, mask, 5, 4)
    assert len(got) == len(want) == 5
    assert float(np.max(np.abs(got - want) / np.abs(want))) <= TRAJ_RTOL


# -------------------------------------------------------------------- zips
def _next_loss_jax(trainer, x, y, mask):
    step = trainer._make_step()
    trainer.params, trainer.opt_state, trainer.state, loss = step(
        trainer.params, trainer.opt_state, trainer.state, jnp.asarray(x),
        jnp.asarray(y), trainer.next_rng(),
        None if mask is None else jnp.asarray(mask))
    return float(loss)


def _next_loss_port(trainer, x, y, mask):
    trainer.params, trainer.opt_state, trainer.state, loss = trainer.step(
        trainer.params, trainer.opt_state, trainer.state, x, y, mask=mask)
    return loss.item()


def _zip_case(which):
    if which == "bert":
        jm, tm = _bert_pair()
        return jm, tm, _bert_batch()
    jm, tm = _lenet_pair()
    return jm, tm, (*_image_batch((28, 28, 1)), None)


@pytest.mark.parametrize("which", ["lenet", "bert"])
def test_reference_zip_resumes_in_port(which, tmp_path):
    jm, _, (x, y, mask) = _zip_case(which)
    jt = JTrainer(jm)
    jt.fit(JArrayIterator(x, y, batch_size=4, features_mask=mask),
           prefetch=False)
    path = str(tmp_path / "ref.zip")
    jt.save(path)
    port = Trainer.load(path, device="cpu")
    assert isinstance(port.model, Sequential)
    assert int(tree_leaves(port.opt_state)[0]) == 1
    want = _next_loss_jax(jt, x, y, mask)
    np.testing.assert_allclose(_next_loss_port(port, x, y, mask), want,
                               rtol=ZIP_RTOL)


@pytest.mark.parametrize("which", ["lenet", "bert"])
def test_port_zip_resumes_in_reference(which, tmp_path):
    _, tm, (x, y, mask) = _zip_case(which)
    port = Trainer(tm)
    port.fit(ArrayIterator(x, y, batch_size=4, features_mask=mask))
    path = str(tmp_path / "port.zip")
    port.save(path)
    jt = JTrainer.load(path)
    assert isinstance(jt.model, JSequential)
    want = _next_loss_port(port, x, y, mask)
    np.testing.assert_allclose(_next_loss_jax(jt, x, y, mask), want,
                               rtol=ZIP_RTOL)


# ---------------------------------------------------------- VGG16 dropout
def test_vgg_dense_layers_drop_their_inputs_in_training_only():
    """VGG's two 4096-wide Dense layers carry dropout 0.5 on their inputs:
    two training forwards from one seed agree, from two seeds differ, and
    eval ignores the generator."""
    _, tm = _vgg_pair()
    dense = [l for l in tm.layers if getattr(l, "dropout", None)]
    assert len(dense) == 2 and all(l.dropout == 0.5 for l in dense)
    x, _ = _image_batch(VGG_SHAPE)

    def run(seed, training=True):
        y, _ = tm.forward(tm.params, tm.state, torch.from_numpy(x),
                          training=training,
                          rng=torch.Generator().manual_seed(seed))
        return y

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert torch.equal(run(1, False), run(2, False))
    with pytest.raises(ValueError, match="no rng"):
        tm.forward(tm.params, tm.state, torch.from_numpy(x), training=True)
