"""The port's CNN zoo (deeplearning4j_torch.models: AlexNet, Darknet19,
TinyYOLO, YOLO2, GoogLeNet, InceptionResNetV1, FaceNetNN4Small2,
``model_by_name`` and the pretrained checkpoints) held against the JAX
package on the CPU.

Each model is built at the reference's small test inputs
(``tests/test_zoo.py``) in both packages, the port's params drawn from
seed 0 and carried into the reference (the reference draws its own eagerly,
1 to 25 s a model on the CPU): the config JSON and the params tree must be
equal, and the port's forward within 1e-5 of the largest output of the
reference's (f32; the two sum convolutions in other orders). The slice as
a whole:

- TinyYOLO with 3 classes trained by ``Trainer.fit`` for 3 adam steps,
  losses within 1e-4 relative of the JAX trajectory; the JAX trainer's zip
  after its second step resumes in the port for the third;
- YOLO2 (80 classes, 64x64, batch 4): every param's gradient within 1e-4
  of its node's largest entry with BatchNorm on its running statistics;
  in training mode, each within twice the reference's own spread over
  other row orders of the batch; 3 adam steps within 1e-4 of the JAX
  trajectory;
- a JAX ``save_pretrained`` checkpoint loads through the port's
  ``init_pretrained`` and back, and a corrupt one is deleted and raises as
  the reference's does; ``ServeEngine`` answers YOLO2 requests with
  ``Graph.output``'s rows.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.data import ArrayIterator, yolo_labels
from deeplearning4j_torch.interop.pretrained import ChecksumMismatch
from deeplearning4j_torch.models import ZOO_REGISTRY, model_by_name
from deeplearning4j_torch.models import zoo as tzoo
from deeplearning4j_torch.nn.model import Graph, Sequential
from deeplearning4j_torch.ops.updaters import tree_leaves
from deeplearning4j_torch.serve import ServeEngine
from deeplearning4j_torch.train import (CollectScoresListener, Trainer,
                                        params_from_numpy, state_from_numpy)
from deeplearning4j_tpu.data import ArrayIterator as JArrayIterator
from deeplearning4j_tpu.interop.pretrained import \
    ChecksumMismatch as JChecksumMismatch
from deeplearning4j_tpu.models import ZOO_REGISTRY as JZOO_REGISTRY
from deeplearning4j_tpu.models import model_by_name as jmodel_by_name
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.train.listeners import \
    CollectScoresListener as JCollectScoresListener
from deeplearning4j_tpu.train.trainer import Trainer as JTrainer

# the reference's small inputs (tests/test_zoo.py) for the seven models
SMALL = {
    "alexnet": dict(num_classes=10, input_shape=(96, 96, 3)),
    "darknet19": dict(num_classes=10, input_shape=(64, 64, 3)),
    "googlenet": dict(num_classes=10, input_shape=(64, 64, 3)),
    "inceptionresnetv1": dict(num_classes=32, input_shape=(64, 64, 3)),
    "facenetnn4small2": dict(num_classes=32, input_shape=(64, 64, 3)),
    "tinyyolo": dict(input_shape=(64, 64, 3)),
    "yolo2": dict(input_shape=(64, 64, 3)),
}
MODEL_RTOL = 1e-5
TRAJ_RTOL = 1e-4
GRAD_RTOL = 1e-4        # a gradient's error over its node's largest entry
ADAM = {"type": "adam", "learning_rate": 1e-5}


def _np_tree(tree):
    """A tree of torch tensors or JAX arrays as numpy copies."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return np.array(tree, copy=True)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _first(y):
    return y[0] if isinstance(y, list) else y


def _pair(name, tree=None, **kw):
    """The reference's model and the port's with the same params and
    state: ``tree`` (numpy (params, state)), else the port's drawn from
    seed 0; the port's carried in with ``params_from_numpy``."""
    tm = model_by_name(name, seed=0, device="cpu", **kw).build()
    if tree is None:
        tree = tuple(_np_tree(t) for t in tm.init(seed=0))
    tm.params = params_from_numpy(tm, tree[0])
    tm.state = state_from_numpy(tree[1], "cpu")
    jm = jmodel_by_name(name, seed=0, **kw).build()
    jm.params, jm.state = (jax.tree.map(jnp.array, t) for t in tree)
    return jm, tm


def test_every_reference_zoo_model_is_in_the_port():
    assert set(ZOO_REGISTRY) == set(JZOO_REGISTRY)
    for name in SMALL:
        zm = model_by_name(name.upper(), seed=3)
        assert type(zm).__name__.lower() == name and zm.seed == 3
        assert zm.input_shape == jmodel_by_name(name).input_shape
        assert zm.num_classes == jmodel_by_name(name).num_classes
    assert ZOO_REGISTRY["yolo2"].anchors == JZOO_REGISTRY["yolo2"].anchors
    assert ZOO_REGISTRY["tinyyolo"].anchors == \
        JZOO_REGISTRY["tinyyolo"].anchors
    with pytest.raises(ValueError, match="Unknown zoo model"):
        model_by_name("nope")


def test_zoo_models_build_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the build lands on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_by_name("yolo2").build()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py's [zoo] phase runs "
                    "these checks on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["c1", "c14"])
def test_bn_kernels_match_plain_at_yolo2_shapes(cuda, name):
    """K4a (fused) and K4b on the card at YOLO2's narrowest (c1: 64·416²
    rows of 32 channels) and widest (c14: 64·13² rows of 1024) BatchNorm,
    bf16: the whole backward's dx bit for bit against the plain K4b on
    the fused coefficients, and dgamma, dbeta against the plain backward
    within 1e-2 of their largest entry."""
    from deeplearning4j_torch.ops.batch_norm import (bn_backward,
                                                     bn_backward_reference,
                                                     bn_dx_reference,
                                                     bn_reduce_coeffs)

    M, C = {"c1": (64 * 416 * 416, 32), "c14": (64 * 13 * 13, 1024)}[name]
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, dy = (torch.randn((M, C), generator=gen, device=cuda)
             .to(torch.bfloat16) for _ in range(2))
    gamma = (1 + 0.1 * torch.randn((C,), generator=gen, device=cuda)).to(
        torch.bfloat16)
    xf = x.float()
    mean = xf.mean(0)
    gap = (xf * xf).mean(0) - mean * mean
    var = gap.clamp_min(0.0)
    inv = torch.rsqrt(var + 1e-5)
    stats = (mean, var, inv, inv * gamma.float(), gap)
    coef, _, _ = bn_reduce_coeffs(x, dy, *stats, gamma, 1e-5)
    dx, dg, db = bn_backward(x, dy, gamma, *stats, 1e-5)
    assert torch.equal(dx, bn_dx_reference(x, dy, *coef))
    _, dg_ref, db_ref = bn_backward_reference(x, dy, gamma, *stats, 1e-5)
    for got, want in ((dg, dg_ref), (db, db_ref)):
        err = (got.float() - want.float()).abs().max()
        assert err <= 1e-2 * want.float().abs().max()


@pytest.mark.parametrize("name", sorted(SMALL))
def test_zoo_model_matches_reference(name):
    """Config JSON, topological order, the params tree of the reference's
    own init (traced, not run) and one forward at batch 2 (the
    reference's jitted)."""
    drawn = jax.eval_shape(jmodel_by_name(name, seed=0, **SMALL[name])
                           .build().init)[0]
    jm, tm = _pair(name, **SMALL[name])
    assert json.loads(tm.to_json()) == json.loads(jm.to_json())
    assert type(tm).__name__ == type(jm).__name__
    if isinstance(tm, Graph):
        assert tm.topo_order == jm.topo_order
    assert jax.tree.map(lambda a: tuple(a.shape), drawn) == tm.param_shapes()
    assert {str(a.dtype) for a in jax.tree_util.tree_leaves(drawn)} == \
        {"float32"} == {str(t.dtype)[6:] for t in tree_leaves(tm.params)}
    shape = SMALL[name]["input_shape"]
    x = np.random.default_rng(0).standard_normal((2,) + shape).astype(
        np.float32)
    yj = np.asarray(_first(jax.jit(lambda p, s, a: jm.forward(
        p, s, a, training=False)[0])(jm.params, jm.state, jnp.asarray(x))))
    yt = _first(tm.output(x)).numpy()
    assert yt.shape == yj.shape
    assert _rel(yt, yj) <= MODEL_RTOL


@pytest.mark.parametrize("name", ["inceptionresnetv1", "facenetnn4small2"])
def test_embedding_graph_outputs_l2_norm_and_has_no_loss(name):
    """Their output is an L2Norm vertex: ``output`` returns unit rows and
    ``score`` raises the reference's "no loss-bearing output layer"."""
    tm = model_by_name(name, seed=0, device="cpu", num_classes=8,
                       input_shape=(32, 32, 3)).init()
    x = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    (y,) = tm.output(x)
    torch.testing.assert_close(y.norm(dim=-1), torch.ones(3))
    with pytest.raises(ValueError, match="no loss-bearing output layer"):
        tm.score(tm.params, tm.state, torch.from_numpy(x),
                 torch.zeros(3, 8))


def _yolo_batch(name, size, batch, classes, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    y = yolo_labels(rng, batch, size // 32, ZOO_REGISTRY[name].anchors,
                    classes)
    return x, y


def _jax_fit(jt, x, y, steps, rec):
    jt.fit(JArrayIterator(np.concatenate([x] * steps),
                          np.concatenate([y] * steps), x.shape[0]),
           listeners=[rec], prefetch=False)


def _port_fit(tm, x, y, steps):
    rec = CollectScoresListener()
    Trainer(tm).fit(ArrayIterator(np.concatenate([x] * steps),
                                  np.concatenate([y] * steps), x.shape[0]),
                    listeners=[rec])
    return np.array([l for _, l in rec.scores])


@pytest.fixture(scope="module")
def tinyyolo_run(tmp_path_factory):
    """The reference's TinyYOLO (3 classes, 64x64, adam 1e-5) trained by
    its Trainer for 3 steps on one repeated batch of 4, its trainer zip
    written after the second: (the params and state it started from, x,
    y, its 3 losses, the zip's path)."""
    kw = dict(num_classes=3, input_shape=(64, 64, 3))
    jm, tm = _pair("tinyyolo", **kw)
    tree = tuple(_np_tree(t) for t in (tm.params, tm.state))
    x, y = _yolo_batch("tinyyolo", 64, 4, 3)
    jm.config.updater = ADAM
    jt, rec = JTrainer(jm), JCollectScoresListener()
    _jax_fit(jt, x, y, 2, rec)
    path = str(tmp_path_factory.mktemp("tinyyolo") / "tinyyolo.zip")
    jt.save(path)
    _jax_fit(jt, x, y, 1, rec)
    return tree, x, y, np.array([l for _, l in rec.scores]), path


def test_tinyyolo_trajectory_matches_reference(tinyyolo_run):
    """3 adam steps (lr 1e-5) of ``Trainer.fit`` (f32) on one repeated
    batch of 4 at 64x64 with the YOLOv2 loss: losses within 1e-4 relative
    of the reference's (measured 3.6e-5; the reference's own in two other
    row orders 1.5e-5), the port's falling. At lr 1e-4 these params
    overshoot (29.8, 57.0, 26.8) and the reference's own row orders part
    by 8e-3 at the third step. At 32x32 the grid is 1x1 and the late
    BatchNorms normalize over 4 rows, where the single-pass variance
    cancels: there the reference's own jitted and op-by-op gradients
    differ by 1.7e-4, so 64x64 it is."""
    tree, x, y, want, _ = tinyyolo_run
    _, tm = _pair("tinyyolo", tree, num_classes=3, input_shape=(64, 64, 3))
    tm.config.updater = ADAM
    got = _port_fit(tm, x, y, 3)
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    assert got[-1] < got[0]


def test_reference_yolo_zip_resumes_in_port(tinyyolo_run):
    """The reference's TinyYOLO trainer zip written after 2 steps loads in
    the port (config, params, running statistics, adam's state) and its
    next step's loss is the reference's third within 1e-5 relative."""
    _, x, y, want, path = tinyyolo_run
    port = Trainer.load(path, device="cpu")
    assert isinstance(port.model, Sequential)
    assert port.model.config.updater == ADAM
    *_, lt = port.step(port.params, port.opt_state, port.state, x, y)
    np.testing.assert_allclose(lt.item(), want[2], rtol=1e-5)


def _node_errors(got, want, names):
    """Each leaf's largest error over the largest entry of its node."""
    scale = {}
    for n, w in zip(names, want):
        scale[n] = max(scale.get(n, 0.0), float(np.abs(w).max()))
    return np.array([float(np.abs(g - w).max()) / scale[n]
                     for n, g, w in zip(names, got, want)])


@pytest.fixture(scope="module")
def yolo2_case():
    """YOLO2 at the reference's small size (64x64, its 80 classes, the
    zoo's five anchors): the port's params and state from seed 0 as numpy,
    and a batch of 4 images with their labels."""
    tm = model_by_name("yolo2", seed=0, device="cpu",
                       **SMALL["yolo2"]).build()
    tree = tuple(_np_tree(t) for t in tm.init(seed=0))
    return (tree,) + _yolo_batch("yolo2", 64, 4, 80)


def _yolo2_grads(yolo2_case, training, perms=()):
    """Loss and gradients of YOLO2 on the case's batch: the reference's
    (jitted), the port's, and the reference's on the batch in each row
    order of ``perms``; with the leaves' node names."""
    tree, x, y = yolo2_case
    jm, tm = _pair("yolo2", tree, **SMALL["yolo2"])
    state = jm.state
    grad = jax.jit(jax.value_and_grad(lambda p, a, b: jm.score(
        p, state, a, b, training=training)[0]))
    lj, gj = grad(jm.params, jnp.asarray(x), jnp.asarray(y))
    leaves = [p.requires_grad_() for p in tree_leaves(tm.params)]
    lt, _ = tm.score(tm.params, tm.state, torch.from_numpy(x),
                     torch.from_numpy(y), training=training)
    gt = [g.numpy() for g in torch.autograd.grad(lt, leaves)]
    others = [[np.asarray(g) for g in jax.tree_util.tree_leaves(
        grad(jm.params, jnp.asarray(x[p]), jnp.asarray(y[p]))[1])]
        for p in perms]
    names = [k for k in sorted(jm.params) for _ in jm.params[k]]
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(gj)]
    return float(lj), lt.item(), want, gt, others, names


def test_yolo2_inference_gradients_match_reference(yolo2_case):
    """With BatchNorm on its running statistics (``training=False``), which
    couples no rows: the loss within 1e-5 relative and every param's
    gradient within 1e-4 of its node's largest entry (measured 9.6e-6):
    the backward of every conv, leaky ReLU and pool, the SpaceToDepth
    passthrough and its merge, and the 80-class YOLOv2 loss."""
    lj, lt, want, gt, _, names = _yolo2_grads(yolo2_case, False)
    assert abs(lt - lj) <= MODEL_RTOL * abs(lj)
    errs = _node_errors(gt, want, names)
    assert errs.max() <= GRAD_RTOL, dict(zip(names, errs))


def test_yolo2_gradients_as_accurate_as_the_reference(yolo2_case):
    """Training mode (batch statistics): the loss within 1e-5 relative, and
    each param's gradient no further from the reference's than twice the
    reference's own on the same batch in three other row orders (the same
    function, summed in other orders), plus 1e-5, each relative to the
    largest entry of its node. A random YOLO2's training-mode gradients
    are ill-conditioned at every size tried: the reference's own differ
    between row orders by up to 55% of a node's scale here (the early
    nodes most; 20-31% at 128x128 with batches of 4 and 16), and the
    port's by at most 1.0x that, node by node. The inference-mode test
    above holds every layer's backward to 1e-4; the BatchNorm's
    batch-statistics backward is held tightly in
    ``tests/test_torch_batchnorm.py``."""
    perms = [np.random.default_rng(100 + i).permutation(4) for i in range(3)]
    lj, lt, want, gt, others, names = _yolo2_grads(yolo2_case, True, perms)
    assert abs(lt - lj) <= MODEL_RTOL * abs(lj)
    spread = np.max([_node_errors(o, want, names) for o in others], axis=0)
    errs = _node_errors(gt, want, names)
    bad = {n: (e, s) for n, e, s in zip(names, errs, spread)
           if e > 2 * s + 1e-5}
    assert not bad, bad


def test_yolo2_trajectory_matches_reference(yolo2_case):
    """3 adam steps of ``Trainer.fit`` (f32) at lr 1e-6 on the repeated
    batch: losses within 1e-4 relative of the reference's (measured
    9.3e-6), the port's falling. A random YOLO2's loss is steep enough
    that one adam step of 1e-6 per param takes it from 38.8 to 31.6; the
    reference's own trajectory in another row order moves by 1.9e-4 at
    the third step at this rate and by 7.4e-3 at 1e-5, so no larger rate
    is compared."""
    tree, x, y = yolo2_case
    jm, tm = _pair("yolo2", tree, **SMALL["yolo2"])
    jm.config.updater = tm.config.updater = {"type": "adam",
                                             "learning_rate": 1e-6}
    rec = JCollectScoresListener()
    _jax_fit(JTrainer(jm), x, y, 3, rec)
    want = np.array([l for _, l in rec.scores])
    got = _port_fit(tm, x, y, 3)
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    assert got[-1] < got[0]


def test_pretrained_zips_cross_both_ways(tmp_path, monkeypatch):
    """The JAX package's ``save_pretrained`` checkpoint of an
    InceptionResNetV1 (a graph; params and running statistics carried
    from the port's draw, the statistics moved off their initial values)
    loads through the port's ``init_pretrained`` (same cache path, same
    sha256 sidecar) with the reference's config, params and statistics,
    and answers bit for bit as the model it was written from; the port's
    checkpoint loads through the reference's."""
    monkeypatch.setattr(jzoo, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(tzoo, "CACHE_DIR", tmp_path)
    name, kw = "inceptionresnetv1", SMALL["inceptionresnetv1"]
    tz = model_by_name(name, seed=0, device="cpu", **kw)
    params, state = (_np_tree(t) for t in tz.build().init(seed=0))
    state = jax.tree.map(lambda a: a * 1.25 + 0.1, state)
    jm, src = _pair(name, (params, state), **kw)
    jz = jmodel_by_name(name, seed=0, **kw)
    path = jz.save_pretrained(jm, "cifar10")
    assert tz.pretrained_path("cifar10") == path
    tm = tz.init_pretrained("cifar10")
    assert isinstance(tm, Graph)
    assert json.loads(tm.to_json()) == json.loads(jm.to_json())
    for got, want in ((tm.params, params), (tm.state, state)):
        for k, v in want.items():
            for n, a in v.items():
                np.testing.assert_array_equal(got[k][n].numpy(), a)
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    assert torch.equal(tm.output(x)[0], src.output(x)[0])
    tm.params = {k: {n: a + 1 for n, a in v.items()}
                 for k, v in tm.params.items()}
    tz.save_pretrained(tm, "mnist")
    back = jz.init_pretrained("mnist")
    for k, v in tm.params.items():
        for n, a in v.items():
            np.testing.assert_array_equal(np.asarray(back.params[k][n]),
                                          a.numpy())


@pytest.mark.parametrize("package", ["port", "reference"])
def test_corrupt_pretrained_zip_is_deleted_and_raises(tmp_path, monkeypatch,
                                                      package):
    """A checkpoint whose bytes no longer match its sidecar is deleted with
    the sidecar, and the load fails, in the port as in the reference."""
    monkeypatch.setattr(jzoo, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(tzoo, "CACHE_DIR", tmp_path)
    jm, _ = _pair("lenet")
    jz = jmodel_by_name("lenet", seed=0)
    path = jz.save_pretrained(jm, "cifar10")
    with open(path, "ab") as f:
        f.write(b"x")
    tz = model_by_name("lenet", seed=0, device="cpu")
    loader = tz if package == "port" else jz
    with pytest.raises(FileNotFoundError, match="No cached pretrained"):
        loader.init_pretrained("cifar10")
    assert not path.exists() and not path.with_name(
        path.name + ".sha256").exists()
    # the checksum check itself raises the typed error in both packages
    path = jz.save_pretrained(jm, "cifar10")
    with open(path, "ab") as f:
        f.write(b"x")
    from deeplearning4j_torch.interop.pretrained import verify_checksum
    from deeplearning4j_tpu.interop.pretrained import \
        verify_checksum as jverify
    with pytest.raises(ChecksumMismatch):
        verify_checksum(path)
    with pytest.raises(JChecksumMismatch):
        jverify(path)


def test_keras_auto_convert_is_not_ported(tmp_path, monkeypatch):
    monkeypatch.setattr(tzoo, "CACHE_DIR", tmp_path)
    with pytest.raises(NotImplementedError, match="item 16"):
        model_by_name("vgg16", device="cpu").init_pretrained()


def test_serve_engine_answers_yolo2_requests_as_output():
    """A CPU ``ServeEngine`` over a YOLO2 graph (batch buckets 1, 4,
    ``length_buckets=None``): each answer equals the rows of
    ``Graph.output`` on the same images within 1e-5."""
    tm = model_by_name("yolo2", seed=0, device="cpu", num_classes=3,
                       input_shape=(64, 64, 3)).init()
    rng = np.random.default_rng(9)
    reqs = [rng.standard_normal((n, 64, 64, 3)).astype(np.float32)
            for n in (1, 3, 2)]
    eng = ServeEngine(tm, batch_buckets=(1, 4), length_buckets=None)
    try:
        for x in reqs:
            got = eng.predict(x)
            (want,) = tm.output(x)
            assert got.shape == (x.shape[0], 2, 2, 40)
            assert _rel(got, want.numpy()) <= 1e-5
    finally:
        eng.shutdown()
