"""The port's activations, losses, layers, vertices and ``Yolo2Output``
(deeplearning4j_torch: the rest of ``ops/activations``, ``ops/losses``,
``nn/layers/{core,conv,norm,pooling}``, ``nn/vertices`` and
``nn/layers/special.Yolo2Output``) held against the JAX package on the CPU.

Inputs come from numpy seeds; params are the reference's, carried across.
Tolerances, relative to the largest entry of the reference's array:

- f32 forward and gradients: 1e-6 where both packages run the same
  elementwise ops (measured 0 to 4e-7); 4e-6 where an ``exp``, ``log``,
  ``tanh`` or ``sin`` is on the path, whose f32 implementations in XLA and
  torch differ by an ulp or two (mish's gradient chains four of them:
  measured 3.3e-6); 1e-5 through a convolution or a product, which sum in
  another order (measured 1.2e-6 at most);
- bf16: every activation forward bit for bit, and its gradient but for
  gelu's, softmax's and softsign's (a division's gradient rounds in
  another order: within 2% of the largest entry); layers that
  round op for op (space-to-depth, LRN, RMSNorm,
  ``Yolo2Output``, the vertices) within the ulps each test states;
- layouts, masks, output shapes, JSON and index-only layers exactly.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.nn import api as TAPI
from deeplearning4j_torch.nn import layers as TL
from deeplearning4j_torch.nn import vertices as TV
from deeplearning4j_torch.ops import activations as TA
from deeplearning4j_torch.ops import losses as TLoss
from deeplearning4j_tpu.nn import api as JAPI
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import vertices as JV
from deeplearning4j_tpu.ops import activations as JA
from deeplearning4j_tpu.ops import losses as JLoss

ULP = 2.0 ** -8


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(np.asarray(b, np.float32), np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _no_excess(fn, *args):
    """``fn`` compiled without XLA's excess precision: every bf16 op
    rounds, as the reference's code is written (by default XLA keeps some
    intermediates of a fusion in f32, which no op-by-op port follows)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ------------------------------------------------------------ activations
GRID = np.linspace(-12, 12, 4001).astype(np.float32)
GRID[2000] = 0.0
# exp/log/tanh/sin on the path: the two packages' f32 versions differ by
# an ulp or two
TRANSCENDENTAL = {"elu", "exp", "mish", "rational_tanh", "rectified_tanh",
                  "selu", "sigmoid", "silu", "swish", "sin", "softplus",
                  "tanh", "gelu", "softmax"}


def test_activation_registry_is_the_references():
    assert TA.names() == JA.names()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", JA.names())
def test_activation_matches_reference(name, dtype):
    """Forward and VJP on a grid over [-12, 12] with 0 on it; softmax over
    rows of 7."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = GRID[:4000].reshape(-1, 8)
    g = np.cos(np.arange(x.size)).reshape(x.shape).astype(np.float32)
    yj, vjp = jax.vjp(JA.get(name), jnp.asarray(x, jdt))
    (gj,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    yt = TA.get(name)(xt)
    (gt,) = torch.autograd.grad(yt, xt, torch.from_numpy(g).to(tdt))
    assert yt.dtype == tdt and gt.dtype == tdt
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(yt), _np(yj))
        if name not in ("gelu", "softmax", "softsign"):
            np.testing.assert_array_equal(_np(gt), _np(gj))
            return
    # gelu's, softmax's and softsign's bf16 gradients are torch's autograd
    # of the op-for-op forward, which rounds a division's gradient
    # (-g·s/w²) in another order than JAX's jitted autodiff (g·w⁻²·s)
    tol = {"bfloat16": 2 * ULP}.get(dtype, 4e-6 if name in TRANSCENDENTAL
                                    else 1e-6)
    assert _rel(_np(yt), yj) <= tol
    assert _rel(_np(gt), gj) <= (0.02 if dtype == "bfloat16" else tol)


def test_leaky_relu_gradient_at_zero_is_one():
    """``where(x >= 0, x, αx)``: the gradient at exactly 0 is 1, as
    JAX's (``F.leaky_relu``'s is α)."""
    x = torch.zeros(3, dtype=torch.bfloat16, requires_grad=True)
    (g,) = torch.autograd.grad(TA.get("leakyrelu")(x).sum(), x)
    assert g.tolist() == [1.0, 1.0, 1.0]
    gj = jax.grad(lambda a: jnp.sum(JA.get("leakyrelu")(a)))(
        jnp.zeros(3, jnp.bfloat16))
    assert np.asarray(gj, np.float32).tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("name", ["relu6", "hardtanh", "rectified_tanh",
                                  "thresholdedrelu"])
def test_activation_gradient_at_the_kinks(name):
    """At each kink (ties of maximum/minimum split in half; relu6 zero at 0
    and 6), the gradient is the reference's exactly."""
    x = np.array([-1.0, 0.0, 1.0, 6.0], np.float32)
    gj = jax.grad(lambda a: jnp.sum(JA.get(name)(a)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (gt,) = torch.autograd.grad(TA.get(name)(xt).sum(), xt)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-6)


# ------------------------------------------------------------ losses
LOSS_NAMES = [n for n in JLoss.names()]


def _loss_inputs(name, rng, shape):
    p = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32)
    if name in ("mcxent", "negativeloglikelihood", "xent",
                "binary_crossentropy", "kl_divergence",
                "reconstruction_crossentropy", "poisson"):
        p = 1 / (1 + np.exp(-p))
        y = (rng.random(shape) < 0.4).astype(np.float32)
    if name in ("mcxent", "negativeloglikelihood"):
        p = p / p.sum(-1, keepdims=True)
    if name in ("hinge", "squared_hinge", "xent_logits",
                "sigmoid_cross_entropy_logits", "mcxent_logits",
                "softmax_cross_entropy_logits"):
        y = (rng.random(shape) < 0.5).astype(np.float32)
    if name in ("mean_squared_logarithmic_error", "msle"):
        p, y = np.abs(p), np.abs(y)
    return p.astype(np.float32), y.astype(np.float32)


def test_loss_registry_is_the_references():
    assert TLoss.names() == JLoss.names()


# losses whose summed term spans the feature axis: a term per example
ROW_TERM_LOSSES = ("cosine_proximity", "mcxent_logits",
                   "softmax_cross_entropy_logits")


def _term_scale(jfn, name, p, y, mask, weights):
    """Mean |term| over the terms a loss's reduction sums, the scale of
    its f32 rounding when torch and XLA sum them in another order: each
    unit's loss alone (its element-wise term, weighted), or each example's
    for a loss whose term spans the feature axis. Masked-out units are
    left out."""
    f = p.shape[-1]
    keep = np.ones(p.shape[:-1], bool) if mask is None else mask > 0
    w = np.ones(f, np.float32) if weights is None else weights
    pk, yk = p[keep], y[keep]
    wk = np.broadcast_to(w, pk.shape)
    if name in ROW_TERM_LOSSES:
        pk, yk, wk = pk[:, None], yk[:, None], wk
    else:
        pk, yk, wk = (a.reshape(-1, 1, 1) for a in (pk, yk, wk))
        wk = wk[:, 0]
    vals = jax.vmap(lambda a, b, c: jfn(a, b, weights=c))(
        jnp.asarray(pk), jnp.asarray(yk), jnp.asarray(wk))
    return float(np.mean(np.abs(np.asarray(vals))))


@pytest.mark.parametrize("variant", ["plain", "mask_weights_3d"])
@pytest.mark.parametrize("name", LOSS_NAMES)
def test_loss_matches_reference(name, variant):
    """Loss and its gradient in the predictions, f32; with a (B, T) mask
    and per-unit weights over (B, T, F) in the second variant. Inputs are
    drawn from a seed that is the same in every process (crc32 of the
    name). The loss value is held to 4e-6 of the larger of its own size and
    the mean size of the terms it sums: a loss that cancels towards zero
    keeps the rounding of its terms."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    shape = (4, 6) if variant == "plain" else (3, 5, 4)
    p, y = _loss_inputs(name, rng, shape)
    mask = weights = None
    if variant != "plain":
        mask = (rng.random(shape[:2]) < 0.7).astype(np.float32)
        weights = rng.random(shape[-1]).astype(np.float32) + 0.5
    jfn, tfn = JLoss.get(name), TLoss.get(name)

    def jl(pp):
        return jfn(pp, jnp.asarray(y),
                   mask=None if mask is None else jnp.asarray(mask),
                   weights=None if weights is None else jnp.asarray(weights))

    lj, gj = jax.value_and_grad(jl)(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_()
    lt = tfn(pt, torch.from_numpy(y),
             mask=None if mask is None else torch.from_numpy(mask),
             weights=None if weights is None else torch.from_numpy(weights))
    (gt,) = torch.autograd.grad(lt, pt)
    scale = max(abs(float(lj)), _term_scale(jfn, name, p, y, mask, weights))
    assert abs(float(lt) - float(lj)) <= 4e-6 * scale
    assert _rel(gt.numpy(), gj) <= 4e-6


def test_center_loss_matches_reference():
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((6, 4)).astype(np.float32)
    idx = np.array([0, 2, 2, 1, 0, 2])
    centers = rng.standard_normal((4, 4)).astype(np.float32)  # class 3 unseen
    lj, cj = JLoss.center_loss(jnp.asarray(feats), jnp.asarray(idx),
                               jnp.asarray(centers), 0.3)
    lt, ct = TLoss.center_loss(torch.from_numpy(feats), torch.from_numpy(idx),
                               torch.from_numpy(centers), 0.3)
    assert _rel(lt.numpy(), lj) <= 1e-6
    assert _rel(ct.numpy(), cj) <= 1e-6
    np.testing.assert_array_equal(ct[3].numpy(), centers[3])


# ------------------------------------------------------------ layers
def _apply_both(jl, tl, params, x, dy, mask=None):
    """Forward and the VJP of ``dy`` in both packages (f32): returns
    (got, want) dicts of y, the input's gradient, each param's gradient,
    and the output masks."""
    jparams = jax.tree.map(jnp.asarray, params)
    jm = None if mask is None else jnp.asarray(mask)
    names = sorted(params)
    floating = np.issubdtype(np.asarray(x).dtype, np.floating)

    @jax.jit
    def reference(p, xx, dyy):
        # one compiled program: eager dispatch compiles each op apart
        y, _, m = jl.apply(p, {}, xx, mask=jm)
        if dyy is None or not floating:
            return y, m, None
        _, vjp = jax.vjp(lambda pp, xi: jl.apply(pp, {}, xi, mask=jm)[0],
                         p, xx)
        return y, m, vjp(dyy)

    yj, mj, grads = reference(jparams, jnp.asarray(x),
                              None if dy is None else jnp.asarray(dy))
    want = {"y": np.asarray(yj), "mask": None if mj is None
            else np.asarray(mj)}
    if grads is not None:
        gp, gx = grads
        want.update({"x": np.asarray(gx),
                     **{k: np.asarray(gp[k]) for k in names}})
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=floating)
    yt, _, mt = tl.apply(tp, {}, tx, mask=None if mask is None
                         else torch.tensor(mask))
    got = {"y": yt.detach().numpy(), "mask": None if mt is None
           else mt.numpy()}
    if dy is not None and floating:
        g = torch.autograd.grad((yt * torch.tensor(dy)).sum(),
                                [tx] + [tp[k] for k in names])
        got.update({"x": g[0].numpy(),
                    **{k: v.numpy() for k, v in zip(names, g[1:])}})
    return got, want


# name: (layer kwargs, feature shape, mask on the time axis, f32 tolerance)
LAYER_CASES = {
    # conv family: sums in another order
    "Conv1D/k3_same": ("Conv1D", dict(n_out=5, kernel=3), (9, 4), True, 1e-5),
    "Conv1D/k3_s2_valid_mask": ("Conv1D", dict(n_out=5, kernel=3, stride=2,
                                               padding="valid"), (11, 4), True,
                                1e-5),
    "Conv1D/k2_s2_same": ("Conv1D", dict(n_out=3, kernel=2, stride=2,
                                         activation="relu"), (9, 3), True,
                          1e-5),
    "Conv1D/explicit_dilated": ("Conv1D", dict(n_out=3, kernel=3, padding=2,
                                               dilation=2), (10, 3), True,
                                1e-5),
    "Deconv2D/k2_s2_valid": ("Deconv2D", dict(n_out=4), (4, 5, 3), False,
                             1e-5),
    "Deconv2D/k3_s2_same": ("Deconv2D", dict(n_out=4, kernel=(3, 3),
                                             stride=(2, 2), padding="same"),
                            (4, 5, 3), False, 1e-5),
    "Deconv2D/k3_s1_same": ("Deconv2D", dict(n_out=4, kernel=(3, 3),
                                             stride=(1, 1), padding="same"),
                            (4, 5, 3), False, 1e-5),
    "Deconv2D/k4_s2_same": ("Deconv2D", dict(n_out=2, kernel=(4, 4),
                                             stride=(2, 2), padding="same",
                                             use_bias=False), (3, 4, 3),
                            False, 1e-5),
    "Deconv2D/k3_s3_valid": ("Deconv2D", dict(n_out=2, kernel=(3, 2),
                                              stride=(3, 2)), (3, 4, 3),
                             False, 1e-5),
    "Deconv2D/explicit": ("Deconv2D", dict(n_out=3, kernel=(3, 3),
                                           stride=(2, 2), padding=(1, 0)),
                          (4, 4, 2), False, 1e-5),
    "DepthwiseConv2D/same": ("DepthwiseConv2D", dict(depth_multiplier=2),
                             (6, 7, 3), False, 1e-5),
    "DepthwiseConv2D/s2_valid": ("DepthwiseConv2D", dict(
        kernel=(3, 2), stride=(2, 2), padding="valid"), (7, 7, 4), False,
        1e-5),
    "SeparableConv2D/same": ("SeparableConv2D", dict(n_out=5), (6, 6, 3),
                             False, 1e-5),
    "SeparableConv2D/s2_dm2": ("SeparableConv2D", dict(
        n_out=4, stride=(2, 2), depth_multiplier=2, activation="tanh"),
        (7, 6, 3), False, 1e-5),
    # index and window layers: the same elementwise ops
    "Subsampling1D/max": ("Subsampling1D", dict(), (9, 3), True, 1e-6),
    "Subsampling1D/avg_same_s1": ("Subsampling1D", dict(
        kernel=3, stride=1, padding="same", mode="avg"), (8, 3), True, 1e-6),
    "Subsampling1D/sum_explicit": ("Subsampling1D", dict(
        kernel=3, stride=2, padding=1, mode="sum"), (9, 3), True, 1e-6),
    "Subsampling1D/pnorm_is_sum": ("Subsampling1D", dict(mode="pnorm"),
                                   (8, 3), True, 1e-6),
    "Upsampling2D": ("Upsampling2D", dict(size=(2, 3)), (3, 4, 2), False,
                     1e-6),
    "Upsampling1D": ("Upsampling1D", dict(size=3), (4, 2), True, 1e-6),
    "ZeroPadding2D/4": ("ZeroPadding2D", dict(padding=(1, 2, 0, 3)),
                        (3, 4, 2), False, 1e-6),
    "ZeroPadding2D/pair": ("ZeroPadding2D", dict(padding=(2, 1)), (3, 4, 2),
                           False, 1e-6),
    "ZeroPadding2D/scalar": ("ZeroPadding2D", dict(padding=1), (3, 4, 2),
                             False, 1e-6),
    "ZeroPadding1D": ("ZeroPadding1D", dict(padding=(2, 1)), (5, 3), True,
                      1e-6),
    "ZeroPadding1D/scalar": ("ZeroPadding1D", dict(padding=2), (5, 3), True,
                             1e-6),
    "Cropping2D": ("Cropping2D", dict(cropping=(1, 0, 2, 1)), (5, 6, 2),
                   False, 1e-6),
    "Cropping1D": ("Cropping1D", dict(cropping=(1, 2)), (7, 3), True, 1e-6),
    "SpaceToDepth": ("SpaceToDepth", dict(), (4, 6, 3), False, 1e-6),
    "SpaceToDepth/b3": ("SpaceToDepth", dict(block_size=3), (6, 3, 2), False,
                        1e-6),
    "SpaceToBatch": ("SpaceToBatch", dict(), (4, 6, 3), False, 1e-6),
    "LRN": ("LRN", dict(), (3, 3, 9), False, 4e-6),
    "LRN/n3": ("LRN", dict(n=3, k=1.0, alpha=0.5, beta=0.5), (2, 3, 4),
               False, 4e-6),
    "RMSNorm": ("RMSNorm", dict(), (5, 8), False, 1e-6),
    "Reshape": ("Reshape", dict(shape=(3, 8)), (4, 6), False, 1e-6),
    "ElementWiseMultiplication": ("ElementWiseMultiplication", dict(
        activation="tanh"), (5, 4), False, 4e-6),
    "PReLU": ("PReLU", dict(), (5, 4), False, 1e-6),
    "LossLayer": ("LossLayer", dict(activation="softmax"), (5, 4), False,
                  4e-6),
    "Yolo2Output": ("Yolo2Output", dict(anchors=((1.0, 2.0), (0.5, 0.7))),
                    (3, 2, 2 * 8), False, 4e-6),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_reference(case):
    """JSON, output shape, forward, gradients (input and params) and the
    propagated mask, in f32."""
    kind, kw, shape, masked, tol = LAYER_CASES[case]
    jl, tl = getattr(JL, kind)(**kw), getattr(TL, kind)(**kw)
    assert tl.to_dict() == jl.to_dict()
    assert TAPI.layer_from_dict(jl.to_dict()).to_dict() == jl.to_dict()
    assert JAPI.layer_from_dict(tl.to_dict()).to_dict() == tl.to_dict()
    rng = np.random.default_rng(sum(map(ord, case)))
    pj, _ = jax.jit(jl.init, static_argnums=1)(jax.random.PRNGKey(1), shape)
    params = {k: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(
        np.float32) for k, v in pj.items()}
    x = rng.standard_normal((2,) + shape).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, shape[0]), np.float32)
        mask[0, shape[0] // 2:] = 0
    y_shape = jax.eval_shape(lambda p, xx: jl.apply(p, {}, xx)[0],
                             params, x).shape
    dy = rng.standard_normal(y_shape).astype(np.float32)
    got, want = _apply_both(jl, tl, params, x, dy, mask)
    assert got["y"].shape == want["y"].shape
    if kind not in ("Reshape", "SpaceToBatch"):
        assert tuple(tl.output_shape(shape)) == tuple(jl.output_shape(shape))
    if kind == "Deconv2D" and not isinstance(kw.get("padding"), tuple):
        assert got["y"].shape[1:] == tuple(tl.output_shape(shape))
    for k in want:
        if k == "mask":
            if want[k] is None:
                assert got[k] is None
            else:
                np.testing.assert_array_equal(got[k], want[k])
        else:
            assert _rel(got[k], want[k]) <= tol, k


def test_embedding_matches_reference():
    for kw in (dict(n_in=7, n_out=4), dict(n_in=7, n_out=4, use_bias=True,
                                           activation="tanh",
                                           one_hot_matmul=True)):
        jl, tl = JL.Embedding(**kw), TL.Embedding(**kw)
        assert tl.to_dict() == jl.to_dict()
        assert tl.output_shape((1,)) == jl.output_shape((1,))
        pj, _ = jl.init(jax.random.PRNGKey(0), (1,))
        rng = np.random.default_rng(4)
        params = {k: np.asarray(v) + rng.standard_normal(v.shape).astype(
            np.float32) for k, v in pj.items()}
        for ids in (np.array([0, 3, 6, 3]), np.array([[1], [5], [2]])):
            dy = rng.standard_normal((ids.shape[0], 4)).astype(np.float32)
            yj, vjp = jax.vjp(lambda p: jl.apply(p, {}, jnp.asarray(ids))[0],
                              jax.tree.map(jnp.asarray, params))
            (gj,) = vjp(jnp.asarray(dy))
            tp = {k: torch.tensor(v, requires_grad=True)
                  for k, v in params.items()}
            yt, _, _ = tl.apply(tp, {}, torch.from_numpy(ids))
            gt = torch.autograd.grad((yt * torch.from_numpy(dy)).sum(),
                                     [tp[k] for k in sorted(tp)])
            assert _rel(yt.detach().numpy(), yj) <= 4e-6
            for k, g in zip(sorted(tp), gt):
                assert _rel(g.numpy(), gj[k]) <= 1e-6


@pytest.mark.parametrize("kind,kw,shape,ulps", [
    ("SpaceToDepth", dict(), (4, 6, 8), 0),
    ("SpaceToBatch", dict(), (4, 6, 8), 0),
    ("LRN", dict(), (3, 3, 16), 0),
    ("RMSNorm", dict(), (4, 32), 0),
    ("Subsampling1D", dict(kernel=3, stride=2, mode="avg"), (9, 4), 0),
    ("Deconv2D", dict(n_out=4, kernel=(3, 3), padding="same"), (4, 4, 3), 2),
    ("Conv1D", dict(n_out=4, kernel=3), (9, 4), 2),
])
def test_layer_bf16_forward_matches_reference(kind, kw, shape, ulps):
    """bf16 forwards with the reference's params: the op-for-op layers bit
    for bit (``ulps`` 0), the convolutions within ``ulps`` bf16 ulps of
    the largest output (the two backends sum products in another
    order)."""
    jl, tl = getattr(JL, kind)(**kw), getattr(TL, kind)(**kw)
    pj, _ = jl.init(jax.random.PRNGKey(2), shape)
    rng = np.random.default_rng(5)
    params = {k: np.asarray(v) + 0.2 * rng.standard_normal(v.shape).astype(
        np.float32) for k, v in pj.items()}
    x = (2 * rng.standard_normal((2,) + shape)).astype(np.float32)
    yj, _, _ = jl.apply({k: jnp.asarray(v, jnp.bfloat16)
                         for k, v in params.items()}, {},
                        jnp.asarray(x, jnp.bfloat16))
    yt, _, _ = tl.apply({k: torch.from_numpy(v).to(torch.bfloat16)
                         for k, v in params.items()}, {},
                        torch.from_numpy(x).to(torch.bfloat16))
    assert yt.dtype == torch.bfloat16
    if ulps == 0:
        np.testing.assert_array_equal(_np(yt), _np(yj))
    else:
        assert _rel(_np(yt), _np(yj)) <= ulps * ULP


def test_space_to_depth_channel_order():
    """(row in block, column in block, C): the channel at index
    (i * b + j) * C + c of output pixel (h, w) is input pixel
    (h * b + i, w * b + j), channel c."""
    x = torch.arange(2 * 4 * 6 * 3, dtype=torch.float32).reshape(2, 4, 6, 3)
    y, _, _ = TL.SpaceToDepth().apply({}, {}, x)
    for i in range(2):
        for j in range(2):
            for c in range(3):
                torch.testing.assert_close(
                    y[:, :, :, (i * 2 + j) * 3 + c], x[:, i::2, j::2, c],
                    rtol=0, atol=0)


# ------------------------------------------------------------ JSON contract
LAYER_MODULES = ("core", "conv", "norm", "pooling")


def _reference_layer_types():
    out = []
    for name, cls in sorted(JAPI.LAYER_REGISTRY.items()):
        mod = cls.__module__.rsplit(".", 1)[-1]
        if mod in LAYER_MODULES or name == "Yolo2Output":
            out.append(name)
    return out


@pytest.mark.parametrize("kind", _reference_layer_types())
def test_every_reference_layer_type_loads_both_ways(kind):
    """Every layer type of the reference's core, conv, norm and pooling
    modules, and Yolo2Output, reads from the JSON the JAX package writes
    and writes JSON the JAX package reads, with a non-default field."""
    jcls = JAPI.LAYER_REGISTRY[kind]
    j = jcls(name=f"my_{kind.lower()}")
    t = TAPI.layer_from_dict(j.to_dict())
    assert type(t).__name__ == kind
    assert t.to_dict() == j.to_dict()
    assert JAPI.layer_from_dict(t.to_dict()).to_dict() == j.to_dict()


# ------------------------------------------------------------ vertices
VERTEX_CASES = {
    "L2Norm": (dict(), [(3, 5)], 4e-6),
    "L2Norm/eps": (dict(eps=10.0), [(3, 5)], 4e-6),
    "L2Distance": (dict(), [(3, 5), (3, 5)], 4e-6),
    "Scale": (dict(factor=0.17), [(3, 4, 2)], 1e-6),
    "Shift": (dict(amount=-0.3), [(3, 4)], 1e-6),
    "Stack": (dict(), [(2, 4), (3, 4)], 1e-6),
    "Unstack": (dict(index=1, num=3), [(6, 4)], 1e-6),
    "Subset": (dict(low=1, high=3), [(3, 5)], 1e-6),
    "ReshapeVertex": (dict(shape=(2, 6)), [(4, 3, 4)], 1e-6),
    "PoolHelper": (dict(), [(2, 5, 4, 3)], 1e-6),
    "LastTimeStepVertex": (dict(), [(3, 6, 4)], 1e-6),
    "DuplicateToTimeSeries": (dict(), [(3, 4), (3, 5, 2)], 1e-6),
    "ReverseTimeSeries": (dict(), [(3, 6, 2)], 1e-6),
    "Merge": (dict(), [(3, 2), (3, 4)], 1e-6),
    "ElementWise": (dict(op="average"), [(3, 2), (3, 2), (3, 2)], 1e-6),
}


def test_every_reference_vertex_type_is_ported():
    assert set(TV.VERTEX_REGISTRY) == set(JV.VERTEX_REGISTRY)
    assert {c.split("/")[0] for c in VERTEX_CASES} == set(JV.VERTEX_REGISTRY)


@pytest.mark.parametrize("case", sorted(VERTEX_CASES))
def test_vertex_matches_reference(case):
    """JSON both ways, output shape, forward and the gradients of every
    input in f32; the forward in bf16 bit for bit against the reference
    compiled without excess precision."""
    kw, shapes, tol = VERTEX_CASES[case]
    kind = case.split("/")[0]
    jv, tv = getattr(JV, kind)(**kw), getattr(TV, kind)(**kw)
    assert tv.to_dict() == jv.to_dict()
    assert TV.vertex_from_dict(jv.to_dict()).to_dict() == jv.to_dict()
    assert JV.vertex_from_dict(tv.to_dict()).to_dict() == tv.to_dict()
    feat = [s[1:] for s in shapes]
    assert tuple(tv.output_shape(feat)) == tuple(jv.output_shape(feat))
    rng = np.random.default_rng(sum(map(ord, case)))
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    yj, vjp = jax.vjp(lambda *a: jv.apply(list(a)), *map(jnp.asarray, xs))
    dy = rng.standard_normal(yj.shape).astype(np.float32)
    gj = vjp(jnp.asarray(dy))
    txs = [torch.tensor(a, requires_grad=True) for a in xs]
    yt = tv.apply(txs)
    assert _rel(yt.detach().numpy(), yj) <= tol
    used = [t for t in txs]
    gt = torch.autograd.grad((yt * torch.from_numpy(dy)).sum(), used,
                             allow_unused=True)
    for a, b in zip(gt, gj):
        want = np.asarray(b)
        got = np.zeros_like(want) if a is None else a.numpy()
        assert _rel(got, want) <= tol
    ybj = _no_excess(lambda *a: jv.apply(list(a)),
                     *[jnp.asarray(a, jnp.bfloat16) for a in xs])
    ybt = tv.apply([torch.from_numpy(a).to(torch.bfloat16) for a in xs])
    assert ybt.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(ybt), _np(ybj))


# ------------------------------------------------------------ Yolo2Output
YOLO_ANCHORS = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434))


def _yolo_labels(rng, B, H, W, A, C):
    lab = np.zeros((B, H, W, A, 5 + C), np.float32)
    for b in range(B):
        for _ in range(3):
            i, j, a = rng.integers(H), rng.integers(W), rng.integers(A)
            lab[b, i, j, a, :5] = [j + rng.random(), i + rng.random(),
                                   rng.random() * 4, rng.random() * 4, 1.0]
            lab[b, i, j, a, 5 + rng.integers(C)] = 1.0
    return lab


@pytest.mark.parametrize("flat_labels", [False, True],
                         ids=["labels_5d", "labels_flat"])
def test_yolo2_output_score_and_gradient_f32(flat_labels):
    B, H, W, A, C = 2, 3, 4, 3, 4
    jl = JL.Yolo2Output(anchors=YOLO_ANCHORS)
    tl = TL.Yolo2Output(anchors=YOLO_ANCHORS)
    rng = np.random.default_rng(11)
    x = (2 * rng.standard_normal((B, H, W, A * (5 + C)))).astype(np.float32)
    x[0, 0, 0, 2] = 12.0   # a box size past the clip
    lab = _yolo_labels(rng, B, H, W, A, C)
    if flat_labels:
        lab = lab.reshape(B, H, W, -1)
    lj, gj = jax.value_and_grad(lambda xx: jl.score({}, {}, xx, jnp.asarray(
        lab)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    lt = tl.score({}, {}, xt, torch.from_numpy(lab))
    (gt,) = torch.autograd.grad(lt, xt)
    assert lt.dtype == torch.float32
    assert abs(float(lt) - float(lj)) <= 1e-6 * abs(float(lj))
    assert _rel(gt.numpy(), gj) <= 4e-6
    assert float(gt[0, 0, 0, 2]) == 0.0  # clipped: no gradient


def test_yolo2_output_bf16():
    """Under bf16 compute: the decoded boxes bit for bit, the loss (f32
    against f32 labels, as in JAX) within 1e-5 relative, the gradient in
    bf16 within 2 ulps of its largest entry."""
    B, H, W, A, C = 2, 3, 3, 3, 5
    anchors = YOLO_ANCHORS
    jl, tl = JL.Yolo2Output(anchors=anchors), TL.Yolo2Output(anchors=anchors)
    rng = np.random.default_rng(12)
    x = (2 * rng.standard_normal((B, H, W, A * (5 + C)))).astype(np.float32)
    lab = _yolo_labels(rng, B, H, W, A, C)
    xb = jnp.asarray(x, jnp.bfloat16)
    yj, _, _ = jl.apply({}, {}, xb)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    yt, _, _ = tl.apply({}, {}, xt)
    np.testing.assert_array_equal(_np(yt), _np(yj))
    lj, gj = jax.value_and_grad(lambda xx: jl.score({}, {}, xx, jnp.asarray(
        lab)))(xb)
    lt = tl.score({}, {}, xt, torch.from_numpy(lab))
    (gt,) = torch.autograd.grad(lt, xt)
    assert lt.dtype == torch.float32 and lj.dtype == jnp.float32
    assert abs(float(lt) - float(lj)) <= 1e-5 * abs(float(lj))
    assert gt.dtype == torch.bfloat16
    assert _rel(_np(gt), _np(gj)) <= 2 * ULP


def test_yolo2_output_trains_after_a_served_forward():
    """The anchors the layer makes once are usable by autograd after a
    forward under ``torch.inference_mode`` (a served answer)."""
    layer = TL.Yolo2Output(anchors=((0.25, 0.5), (2.0, 3.0)))
    x = torch.randn(2, 2, 2, 2 * 7, dtype=torch.float64)
    with torch.inference_mode():
        layer.apply({}, {}, x)
    xt = x.clone().requires_grad_()
    loss = layer.score({}, {}, xt, torch.zeros(2, 2, 2, 2, 7,
                                               dtype=torch.float64))
    (g,) = torch.autograd.grad(loss, xt)
    assert torch.isfinite(g).all() and g.abs().max() > 0


# ------------------------------------------------------------ loss layers
@pytest.mark.parametrize("kind,act,loss,shape,masked", [
    ("LossLayer", "identity", "mse", (5,), False),
    ("LossLayer", "sigmoid", "xent", (5,), False),
    ("LossLayer", "softmax", "mcxent", (5,), False),
    ("CnnLossLayer", "sigmoid", "xent", (3, 4, 2), False),
    ("RnnLossLayer", "softmax", "mcxent", (6, 4), True),
    ("RnnLossLayer", "identity", "l1", (6, 4), True),
])
def test_loss_layer_scores_match_reference(kind, act, loss, shape, masked):
    """score (the fused ``*_logits`` forms for softmax + mcxent and
    sigmoid + xent) and its input gradient, f32; masked over time."""
    jl = getattr(JL, kind)(activation=act, loss=loss)
    tl = getattr(TL, kind)(activation=act, loss=loss)
    assert tl.to_dict() == jl.to_dict()
    rng = np.random.default_rng(len(shape) + masked)
    x = rng.standard_normal((3,) + shape).astype(np.float32)
    y = (rng.random((3,) + shape) < 0.4).astype(np.float32)
    if act == "softmax":
        y = np.eye(shape[-1], dtype=np.float32)[rng.integers(
            0, shape[-1], (3,) + shape[:-1])]
    mask = None
    if masked:
        mask = np.ones((3, shape[0]), np.float32)
        mask[1, 2:] = 0
    lj, gj = jax.value_and_grad(lambda xx: jl.score(
        {}, {}, xx, jnp.asarray(y), mask=None if mask is None
        else jnp.asarray(mask)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    lt = tl.score({}, {}, xt, torch.from_numpy(y),
                  mask=None if mask is None else torch.from_numpy(mask))
    (gt,) = torch.autograd.grad(lt, xt)
    assert abs(float(lt) - float(lj)) <= 4e-6 * abs(float(lj))
    assert _rel(gt.numpy(), gj) <= 4e-6


def test_center_loss_output_matches_reference():
    jl = JL.CenterLossOutput(n_out=4, alpha=0.3, lambda_=0.5)
    tl = TL.CenterLossOutput(n_out=4, alpha=0.3, lambda_=0.5)
    assert tl.to_dict() == jl.to_dict()
    pj, sj = jl.init(jax.random.PRNGKey(0), (6,))
    rng = np.random.default_rng(13)
    params = {k: np.asarray(v) for k, v in pj.items()}
    state = {"centers": rng.standard_normal((4, 6)).astype(np.float32)}
    assert np.asarray(sj["centers"]).shape == (4, 6)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[[0, 1, 1, 3, 0]]
    (lj, gj) = jax.value_and_grad(lambda p, xx: jl.score(
        p, jax.tree.map(jnp.asarray, state), xx, jnp.asarray(y)),
        argnums=(0, 1))(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    ts = {"centers": torch.from_numpy(state["centers"])}
    lt = tl.score(tp, ts, xt, torch.from_numpy(y))
    g = torch.autograd.grad(lt, [xt, tp["b"], tp["w"]])
    assert abs(float(lt) - float(lj)) <= 4e-6 * abs(float(lj))
    for a, b in zip(g, (gj[1], gj[0]["b"], gj[0]["w"])):
        assert _rel(a.numpy(), b) <= 4e-6
    nj = jl.update_centers(jax.tree.map(jnp.asarray, state), jnp.asarray(x),
                           jnp.asarray(y))
    nt = tl.update_centers(ts, torch.from_numpy(x), torch.from_numpy(y))
    assert _rel(nt["centers"].numpy(), nj["centers"]) <= 1e-6
    np.testing.assert_array_equal(nt["centers"][2].numpy(),
                                  state["centers"][2])  # class 2 unseen
