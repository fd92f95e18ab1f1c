"""The port's weight initializers (deeplearning4j_torch/ops/initializers.py)
held against the JAX package's.

JAX's random bits cannot be reproduced in torch, so each random scheme is
checked by its distribution: both packages draw the same shape, with fans
from each package's ``compute_fans`` (which must agree), and each draw's
mean, variance and bounds are held to the reference's formula. Tolerances:
the sample mean within 5 standard errors of 0, the sample variance within
5 standard errors of the formula's (the error of a variance estimate from
the distribution's fourth moment: 2/n for a normal, 0.8/n for a uniform,
relative), a uniform's draws inside [-a, a] and reaching past 0.99 a. The
deterministic schemes (zero, zeros, ones, identity, a constant) are held
bit for bit against the reference's arrays. Draws run in f32 on the CPU
from fixed seeds.
"""

import math

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_torch.nn.model import Sequential
from deeplearning4j_torch.ops import initializers as T
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.model import NetConfig as JNetConfig
from deeplearning4j_tpu.nn.model import Sequential as JSequential
from deeplearning4j_tpu.ops import initializers as J

SIGMAS = 5.0
SHAPES = {"dense": (384, 256), "conv": (3, 3, 32, 48)}

# scheme -> (distribution, variance or half-width from (fan_in, fan_out))
FORMULA = {
    "normal": ("normal", lambda i, o: 1.0 / i),
    "uniform": ("uniform", lambda i, o: math.sqrt(3.0 / i)),
    "xavier": ("normal", lambda i, o: 2.0 / (i + o)),
    "xavier_uniform": ("uniform", lambda i, o: math.sqrt(6.0 / (i + o))),
    "xavier_fan_in": ("normal", lambda i, o: 1.0 / i),
    "xavier_legacy": ("normal", lambda i, o: 1.0 / (i + o)),
    "relu": ("normal", lambda i, o: 2.0 / i),
    "relu_uniform": ("uniform", lambda i, o: math.sqrt(6.0 / i)),
    "lecun_normal": ("normal", lambda i, o: 1.0 / i),
    "lecun_uniform": ("uniform", lambda i, o: math.sqrt(3.0 / i)),
    "sigmoid_uniform": ("uniform",
                        lambda i, o: 4.0 * math.sqrt(6.0 / (i + o))),
}
for _mode, _n in (("fan_in", lambda i, o: i), ("fan_out", lambda i, o: o),
                  ("fan_avg", lambda i, o: (i + o) / 2.0)):
    FORMULA[f"var_scaling_{_mode}_normal"] = (
        "normal", lambda i, o, n=_n: 1.0 / n(i, o))
    FORMULA[f"var_scaling_{_mode}_uniform"] = (
        "uniform", lambda i, o, n=_n: math.sqrt(3.0 / n(i, o)))
EXACT = ("zero", "zeros", "ones", "identity")


def _port(scheme, shape, seed=0, kind="dense"):
    gen = torch.Generator().manual_seed(seed)
    return T.init_param(gen, scheme, shape, kind=kind).numpy()


def _ref(scheme, shape, seed=0, kind="dense"):
    return np.asarray(J.init_param(jax.random.PRNGKey(seed), scheme, shape,
                                   kind=kind))


def _check_moments(w, dist, param, what):
    n = w.size
    if dist == "normal":
        var, rel = param, math.sqrt(2.0 / n)
    else:
        var, rel = param * param / 3.0, math.sqrt(0.8 / n)
        assert np.abs(w).max() <= param * (1 + 1e-6), what
        assert np.abs(w).max() > 0.99 * param, what
    mean_se = math.sqrt(var / n)
    assert abs(w.mean()) < SIGMAS * mean_se, (what, w.mean(), mean_se)
    assert abs(w.var() - var) < SIGMAS * rel * var, (what, w.var(), var)


def test_names_equal_the_reference():
    assert set(T.names()) == set(J.names())
    assert len(T.names()) == 21


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_fans_equal_the_reference(kind):
    assert T.compute_fans(SHAPES[kind], kind) == J.compute_fans(SHAPES[kind],
                                                                kind)


@pytest.mark.parametrize("scheme", sorted(FORMULA))
def test_scheme_moments_match_the_formula(scheme):
    """The port at both layouts; the reference at the dense one (its draws
    compile once a shape)."""
    dist, f = FORMULA[scheme]
    for kind, shape in SHAPES.items():
        fi, fo = J.compute_fans(shape, kind)
        param = f(fi, fo)
        _check_moments(_port(scheme, shape, kind=kind), dist, param,
                       f"port {scheme} {kind}")
        if kind == "dense":
            _check_moments(_ref(scheme, shape, kind=kind), dist, param,
                           f"reference {scheme} {kind}")


@pytest.mark.parametrize("scheme", sorted(FORMULA))
def test_scheme_is_seeded(scheme):
    a, b = _port(scheme, (64, 32), seed=4), _port(scheme, (64, 32), seed=4)
    c = _port(scheme, (64, 32), seed=5)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("scheme", EXACT)
def test_deterministic_schemes_are_exact(scheme):
    for shape in ((16, 16), (3, 3, 8, 8)):
        np.testing.assert_array_equal(_port(scheme, shape),
                                      _ref(scheme, shape))


def test_identity_refuses_non_square():
    for pkg, call in ((T, lambda: _port("identity", (4, 5))),
                      (J, lambda: _ref("identity", (4, 5)))):
        with pytest.raises(ValueError, match="square"):
            call()


def test_schemes_keep_dtype_and_device():
    gen = torch.Generator().manual_seed(0)
    for scheme in T.names():
        shape = (8, 8)
        w = T.init_param(gen, scheme, shape, dtype=torch.bfloat16)
        assert w.dtype == torch.bfloat16 and w.shape == shape, scheme
        m = T.init_param(None, scheme, shape, device="meta")
        assert m.is_meta and m.shape == shape, scheme


DISTS = {
    "normal": dict(mean=0.5, std=2.0),
    "gaussian": dict(mean=-1.0, std=0.5),
    "uniform": dict(lower=-0.25, upper=0.75),
    "truncated_normal": dict(mean=0.25, std=0.5),
    "binomial": dict(p=0.3),
}


@pytest.mark.parametrize("name", sorted(DISTS))
def test_distribution_moments_match_the_reference(name):
    """Each draw's mean and variance, port and reference, against the
    distribution's own (a truncated normal at 2 std has variance
    1 - 4 phi(2) / (2 Phi(2) - 1) of std^2)."""
    kw = DISTS[name]
    shape = (256, 256)
    n = 256 * 256
    if name in ("normal", "gaussian"):
        mean, var, kurt = kw["mean"], kw["std"] ** 2, 2.0
    elif name == "uniform":
        mean = (kw["lower"] + kw["upper"]) / 2
        var, kurt = (kw["upper"] - kw["lower"]) ** 2 / 12.0, 0.8
    elif name == "truncated_normal":
        phi2 = math.exp(-2.0) / math.sqrt(2 * math.pi)
        z = math.erf(2 / math.sqrt(2))
        mean, var, kurt = kw["mean"], (1 - 4 * phi2 / z) * kw["std"] ** 2, 1.0
    else:
        p = kw["p"]
        mean, var, kurt = p, p * (1 - p), 1.0
    port = T.init_param(torch.Generator().manual_seed(1),
                        T.distribution(name, **kw), shape).numpy()
    ref = np.asarray(J.init_param(jax.random.PRNGKey(1),
                                  J.distribution(name, **kw), shape))
    for what, w in (("port", port), ("reference", ref)):
        assert abs(w.mean() - mean) < SIGMAS * math.sqrt(var / n), what
        assert abs(w.var() - var) < SIGMAS * math.sqrt(kurt / n) * var, what
    if name == "uniform":
        assert port.min() >= kw["lower"] and port.max() < kw["upper"]
    if name == "truncated_normal":
        assert np.abs(port - kw["mean"]).max() <= 2 * kw["std"] + 1e-6
    if name == "binomial":
        assert set(np.unique(port)) <= {0.0, 1.0}


def test_constant_distribution_is_exact():
    f = dict(value=0.75)
    np.testing.assert_array_equal(
        T.init_param(None, T.distribution("constant", **f), (5, 7)).numpy(),
        np.asarray(J.init_param(jax.random.PRNGKey(0),
                                J.distribution("constant", **f), (5, 7))))


@pytest.mark.parametrize("shape", [(32, 12), (12, 32), (3, 3, 4, 16)])
def test_orthogonal_distribution_is_orthogonal(shape):
    """The (prod(shape[:-1]), shape[-1]) matrix has orthonormal columns
    (rows when wide) times the gain: the reference's layout
    (``jax.nn.initializers.orthogonal`` with ``column_axis=-1``)."""
    gain = 1.5
    w = T.init_param(torch.Generator().manual_seed(2),
                     T.distribution("orthogonal", gain=gain), shape).numpy()
    assert w.shape == shape
    m = w.reshape(-1, shape[-1]).astype(np.float64)
    g = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
    np.testing.assert_allclose(g, gain ** 2 * np.eye(g.shape[0]), atol=1e-5)


def test_unknown_distribution_raises():
    for pkg in (T, J):
        with pytest.raises(ValueError, match="Unknown distribution"):
            pkg.distribution("cauchy")(None, (2, 2), 2, 2)


def test_reference_config_with_new_inits_builds_in_the_port():
    """A reference config naming the schemes the port lacked before
    (lecun_normal, identity, uniform) loads through the shared JSON and
    initializes, with the reference's shapes and the identity layer's
    exact weights."""
    layers = [JL.Dense(n_out=32, activation="relu",
                       weight_init="lecun_normal"),
              JL.Dense(n_out=32, activation="tanh", weight_init="identity"),
              JL.Output(n_out=4, loss="mcxent", activation="softmax",
                        weight_init="uniform")]
    ref = JSequential(JNetConfig(seed=3), layers, (20,))
    ref.init()
    port = Sequential.from_json(ref.to_json(), device="cpu")
    params, _ = port.init()
    for k, p in ref.params.items():
        for name, a in p.items():
            assert tuple(params[k][name].shape) == tuple(a.shape), (k, name)
    np.testing.assert_array_equal(params["layer_1"]["w"].numpy(),
                                  np.asarray(ref.params["layer_1"]["w"]))
    a = math.sqrt(3.0 / 32)
    assert float(params["layer_2"]["w"].abs().max()) <= a
