"""The port's BatchNorm and its backward kernels' plain versions
(deeplearning4j_torch.ops.batch_norm, nn.layers.norm.BatchNorm) held
against the JAX package.

Inputs come from numpy seeds. Tolerances, each relative to the largest
entry of the reference's array (one bf16 ulp of it is 2**-8):

- plain K4a/K4b (``bn_bwd``) against ``scripts/bn_reduce_bench.py`` at
  M = 16384, C = 8 and 24: f32 within 1e-6 of both ``bn_bwd_xla`` and the
  Pallas kernels (measured 7.7e-8); bf16 bit-equal to the Pallas kernels
  run in interpret mode (they round where K4b rounds) and within one ulp
  of ``bn_bwd_xla``, which rounds each dy·x to bf16 before summing
  (measured 2.5e-3, 0.64 ulp);
- BatchNorm forward, new state and gradients in f32: within 1e-5
  (measured 4.8e-7 at most); in bf16 the forward equals the reference's
  bit for bit, the state within 1e-5, dx within 2 ulps and dγ, dβ within
  16 ulps of the reference (measured 1.6 and 8.0): the reference's CPU
  backend sums the bf16 cotangents of a and b with a bf16 rounding after
  every add (its HLO's reducer converts to bf16), where the port sums in
  f32 and rounds once, as K4a does;
- a constant channel: msq − mean² is a rounding residue there, dγ is a
  cancellation amplified by 1/sqrt(eps), and the two packages' residues
  differ; that channel's dγ and dx are held to the f32 gradient within
  r·inv·|S2| with S2 = Σdy·x there, inv = 1/sqrt(eps) and r = 1e-5 in f32,
  2**-7 in bf16 (about one rounding of S1 and S2 after the 1/sqrt(eps)
  gain; in bf16 dx also two ulps of its own size), the other channels to
  the tolerances above.

Tests of the CUDA kernels against their plain versions carry the ``gpu``
marker and skip without a card; chip_smoke.py runs the same comparisons
on the card.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.nn.layers import BatchNorm
from deeplearning4j_torch.ops import batch_norm as B
from deeplearning4j_tpu.nn.layers import BatchNorm as JBatchNorm

ULP = 2.0 ** -8
SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "scripts" / \
    "bn_reduce_bench.py"


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("bn_reduce_bench", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(np.asarray(b, np.float32), np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ------------------------------------------------ the script's kernels
@pytest.mark.parametrize("C", [8, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bn_bwd_matches_the_script(bench, monkeypatch, dtype, C):
    M = 16384  # a multiple of the script's TM = 8192
    monkeypatch.setattr(bench, "M", M)
    monkeypatch.setattr(bench, "C", C)
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))
    jdt = jnp.dtype(dtype)
    rng = np.random.RandomState(0)
    x, dy = (jnp.asarray(rng.randn(M, C).astype(np.float32)).astype(jdt)
             for _ in range(2))
    a = jnp.asarray(rng.randn(C).astype(np.float32)).astype(jdt)
    want_xla = np.asarray(bench.bn_bwd_xla(x, dy, a), np.float32)
    want_pallas = np.asarray(bench.bn_bwd_pallas(x, dy, a), np.float32)
    tdt = getattr(torch, dtype)
    tx, tdy, ta = (torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(tdt)
                   for v in (x, dy, a))
    got = B.bn_bwd(tx, tdy, ta)
    assert got.dtype == tdt and got.shape == (M, C)
    got = got.float().numpy()
    np.testing.assert_array_equal(got, B.bn_bwd_reference(tx, tdy, ta)
                                  .float().numpy())
    if dtype == "float32":
        assert _rel(got, want_xla) <= 1e-6
        assert _rel(got, want_pallas) <= 1e-6
    else:
        np.testing.assert_array_equal(got, want_pallas)
        assert _rel(got, want_xla) <= ULP


def test_plain_reduce_and_dx_match_the_script_sums(bench):
    rng = np.random.RandomState(1)
    x, dy = (rng.randn(1000, 5).astype(np.float32) for _ in range(2))
    s_dy, s_dyx = B.bn_reduce(torch.from_numpy(x), torch.from_numpy(dy))
    assert s_dy.dtype == s_dyx.dtype == torch.float32
    np.testing.assert_allclose(s_dy.numpy(), dy.astype(np.float64).sum(0),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s_dyx.numpy(),
                               (dy.astype(np.float64) * x).sum(0),
                               rtol=1e-5, atol=1e-4)
    a, c1, c2 = (torch.from_numpy(rng.randn(5).astype(np.float32))
                 for _ in range(3))
    dx = B.bn_dx(torch.from_numpy(x), torch.from_numpy(dy), a, c1, c2)
    np.testing.assert_allclose(
        dx.numpy(), dy * a.numpy() + c1.numpy() + x * c2.numpy(), rtol=1e-6,
        atol=1e-6)


def test_kernel_operand_checks():
    x = torch.zeros((6, 4))
    with pytest.raises(ValueError, match="contiguous"):
        B._rows(x.t().contiguous().t(), x, "bn_reduce")
    with pytest.raises(ValueError, match=r"\(M, C\)"):
        B._rows(x.view(2, 3, 4), x.view(2, 3, 4), "bn_reduce")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        B._rows(x.half(), x.half(), "bn_reduce")
    with pytest.raises(ValueError, match="one device"):
        B._on_cpu(x, torch.zeros((6, 4), device="meta"))


# ------------------------------------------------ BatchNorm against JAX
def _bn_case(shape, seed=0, const=False):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    if const:
        x[..., 1] = 0.75
    C = shape[-1]
    params = {"gamma": (1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
              "beta": (0.1 * rng.standard_normal(C)).astype(np.float32)}
    state = {"mean": rng.standard_normal(C).astype(np.float32),
             "var": (0.5 + rng.random(C)).astype(np.float32)}
    dy = rng.standard_normal(shape).astype(np.float32)
    # x as bf16 values, so the f32 and bf16 runs see the same inputs
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32)
    return x, params, state, dy


def _jax_bn(layer, x, params, state, dy, dtype, training):
    jdt = jnp.dtype(dtype)

    def f(p, xx):
        pc = jax.tree.map(lambda a: a.astype(jdt), p)
        y, ns, _ = layer.apply(pc, jax.tree.map(jnp.asarray, state),
                               xx.astype(jdt), training=training)
        return jnp.sum(y.astype(jnp.float32) * dy), (y, ns)

    p = {} if layer.lock_gamma_beta else jax.tree.map(jnp.asarray, params)
    (_, (y, ns)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    f32 = functools.partial(np.asarray, dtype=np.float32)
    return (f32(y), jax.tree.map(f32, ns), f32(gx),
            {k: f32(v) for k, v in gp.items()})


def _port_bn(layer, x, params, state, dy, dtype, training):
    tdt = getattr(torch, dtype)
    tp = ({} if layer.lock_gamma_beta else
          {k: torch.tensor(v, requires_grad=True) for k, v in params.items()})
    tx = torch.tensor(x, requires_grad=True)
    y, ns, _ = layer.apply({k: v.to(tdt) for k, v in tp.items()},
                           {k: torch.tensor(v) for k, v in state.items()},
                           tx.to(tdt), training=training)
    names = sorted(tp)
    grads = torch.autograd.grad((y.float() * torch.tensor(dy)).sum(),
                                [tx] + [tp[k] for k in names])
    return (y.float().detach().numpy(), {k: v.numpy() for k, v in ns.items()},
            grads[0].numpy(), {k: g.numpy() for k, g in zip(names, grads[1:])})


BN_CASES = [
    ((4, 6, 6, 8), False, "relu"),
    ((4, 6, 6, 8), True, "relu"),
    ((4, 6, 6, 8), False, "identity"),
    ((8, 8, 8, 16), False, "relu"),
    ((16, 5), False, "identity"),
    ((16, 5), True, "relu"),
]
BN_IDS = [f"{'x'.join(map(str, s))}-{'lock' if l else 'affine'}-{a}"
          for s, l, a in BN_CASES]


@pytest.mark.parametrize("shape,lock,act", BN_CASES, ids=BN_IDS)
@pytest.mark.parametrize("training", [True, False], ids=["train", "infer"])
def test_batchnorm_f32_matches_reference(shape, lock, act, training):
    x, params, state, dy = _bn_case(shape)
    kw = dict(lock_gamma_beta=lock, activation=act)
    want = _jax_bn(JBatchNorm(**kw), x, params, state, dy, "float32", training)
    got = _port_bn(BatchNorm(**kw), x, params, state, dy, "float32", training)
    assert _rel(got[0], want[0]) <= 1e-5
    for k in ("mean", "var"):
        assert _rel(got[1][k], want[1][k]) <= 1e-5
    if not training:
        for k in ("mean", "var"):
            np.testing.assert_array_equal(got[1][k], state[k])
    assert _rel(got[2], want[2]) <= 1e-5
    assert sorted(got[3]) == sorted(want[3])
    for k in want[3]:
        assert _rel(got[3][k], want[3][k]) <= 1e-5, k


@pytest.mark.parametrize("shape,lock,act", BN_CASES, ids=BN_IDS)
def test_batchnorm_bf16_matches_reference(shape, lock, act):
    x, params, state, dy = _bn_case(shape)
    kw = dict(lock_gamma_beta=lock, activation=act)
    want = _jax_bn(JBatchNorm(**kw), x, params, state, dy, "bfloat16", True)
    got = _port_bn(BatchNorm(**kw), x, params, state, dy, "bfloat16", True)
    np.testing.assert_array_equal(got[0], want[0])
    for k in ("mean", "var"):
        assert _rel(got[1][k], want[1][k]) <= 1e-5
    assert _rel(got[2], want[2]) <= 2 * ULP
    for k in want[3]:
        assert _rel(got[3][k], want[3][k]) <= 16 * ULP, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_constant_channel(dtype):
    x, params, state, dy = _bn_case((4, 6, 6, 8), seed=3, const=True)
    layer, jlayer = BatchNorm(), JBatchNorm()
    want = _jax_bn(jlayer, x, params, state, dy, dtype, True)
    got = _port_bn(layer, x, params, state, dy, dtype, True)
    truth = _jax_bn(jlayer, x, params, state, dy, "float32", True)
    tol = 1e-5 if dtype == "float32" else 2 * ULP
    keep = [c for c in range(8) if c != 1]
    assert _rel(got[2][..., keep], want[2][..., keep]) <= tol
    assert _rel(got[3]["gamma"][keep], want[3]["gamma"][keep]) <= (
        tol if dtype == "float32" else 16 * ULP)
    assert _rel(got[3]["beta"], want[3]["beta"]) <= (
        tol if dtype == "float32" else 16 * ULP)
    # the constant channel: a rounding of S1 and S2, times 1/sqrt(eps)
    s2 = abs(float((dy.astype(np.float64) * x)[..., 1].sum()))
    band = (1e-5 if dtype == "float32" else 2 * ULP) * s2 / np.sqrt(1e-5)
    assert abs(got[3]["gamma"][1] - truth[3]["gamma"][1]) <= band
    assert np.isfinite(got[2]).all() and np.isfinite(got[3]["gamma"]).all()
    dx_round = 0.0 if dtype == "float32" else 2 * ULP * np.abs(
        truth[2][..., 1]).max()  # dx itself in bf16
    assert np.abs(got[2][..., 1] - truth[2][..., 1]).max() <= band + dx_round


def test_running_stats_follow_the_reference_over_steps():
    """Five training-mode applications with the state threaded: the EMA
    (decay 0.9, f32 state) matches the reference's within 1e-6."""
    x, params, state, _ = _bn_case((4, 6, 6, 8))
    jl, tl = JBatchNorm(), BatchNorm()
    js = jax.tree.map(jnp.asarray, state)
    ts = {k: torch.tensor(v) for k, v in state.items()}
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    for i in range(5):
        xi = x * (1 + 0.1 * i) + 0.2 * i
        _, js, _ = jl.apply(jp, js, jnp.asarray(xi), training=True)
        _, ts, _ = tl.apply(tp, ts, torch.tensor(xi), training=True)
    for k in ("mean", "var"):
        assert ts[k].dtype == torch.float32
        assert _rel(ts[k].numpy(), js[k]) <= 1e-6


def test_batchnorm_saves_x_and_channel_stats_only():
    x = torch.randn((64, 8), requires_grad=True)
    g = torch.ones(8, requires_grad=True)
    b = torch.zeros(8, requires_grad=True)
    y, mean, var = B.batch_norm_train(x, g, b, 1e-5)
    saved = y.grad_fn.saved_tensors
    assert any(t is x or t.data_ptr() == x.data_ptr() for t in saved)
    assert sum(t.numel() for t in saved if t is not None) \
        <= x.numel() + 6 * 8
    assert not mean.requires_grad and not var.requires_grad


# ------------------------------------------------ the kernels (card only)
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these checks on "
                    "the H100)")
    return torch.device("cuda")


GPU_CASES = [(torch.float32, 1000, 64), (torch.float32, 777, 5),
             (torch.bfloat16, 4099, 256), (torch.bfloat16, 301, 2048),
             (torch.bfloat16, 1000, 12)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(GPU_CASES)))
def test_kernels_match_plain(cuda, case):
    dt, M, C = GPU_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(case)
    x, dy = (torch.randn((M, C), generator=gen, device=cuda).to(dt)
             for _ in range(2))
    a, c1, c2 = (torch.randn((C,), generator=gen, device=cuda)
                 for _ in range(3))
    before = (B.bn_reduce.launches, B.bn_dx.launches)
    s = B.bn_reduce(x, dy)
    dx = B.bn_dx(x, dy, a, c1, c2)
    torch.cuda.synchronize()
    assert (B.bn_reduce.launches, B.bn_dx.launches) == (before[0] + 1,
                                                        before[1] + 1)
    ref = B.bn_reduce_reference(x, dy)
    for got, want, terms in zip(s, ref, (dy.float(), dy.float() * x.float())):
        scale = terms.abs().sum(0)
        assert bool(((got - want).abs() <= 2e-5 * scale + 1e-6).all())
    torch.testing.assert_close(dx, B.bn_dx_reference(x, dy, a, c1, c2),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="contiguous"):
        B.bn_reduce(x.t(), dy.t())
