"""The port's recurrent layers (``deeplearning4j_torch/nn/layers/
recurrent.py``) and their activations held against the JAX package at
small sizes (B 3, T 7, F 5, H 8).

Each case builds the layer from the reference's config dict in both
packages, perturbs the reference's init with numpy noise (so GravesLSTM's
peepholes, zero at init, are non-zero, and every bias is too) and carries
the params across. Forward and the vector-Jacobian product (params and x,
one random cotangent) are compared relative to each output's largest
entry:

- f32 within 1e-5: the two packages' ``exp`` and ``tanh`` differ by an ulp
  or two on some inputs (``ops/activations.py``), and a recurrence carries
  that through T steps;
- bf16, with the reference compiled without XLA's excess precision (by
  default XLA drops bf16 roundings inside its fusions; the port rounds
  every op, as the reference's code is written): the forward bit for
  bit; the gradients within 2^-5 of the largest entry (3.1%; measured at
  most 1.6%). A backward sums several bf16 cotangents into one tensor
  (a carry's, a weight's over T steps) and the two packages add them in
  different orders, each add rounding; a recurrence then carries the
  ulp back through the earlier steps.

``sigmoid`` and ``tanh`` are bit-equal to ``jax.nn`` in bf16, forward and
gradient, over 20,001 points in [-8, 8].
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_torch.nn.layers as TL
from deeplearning4j_torch.nn.api import layer_from_dict
from deeplearning4j_torch.nn.model import NetConfig, Sequential
from deeplearning4j_torch.ops import activations
from deeplearning4j_torch.ops.updaters import tree_leaves, tree_unflatten
from deeplearning4j_torch.train import params_from_numpy
import deeplearning4j_tpu.nn.layers as JL
from deeplearning4j_tpu.nn.api import layer_from_dict as j_layer_from_dict
from deeplearning4j_tpu.nn.model import NetConfig as JNetConfig
from deeplearning4j_tpu.nn.model import Sequential as JSequential

B, T, F, H = 3, 7, 5, 8
LENS = [7, 4, 1]
F32_RTOL = 1e-5
BF16_GRAD_RTOL = 2 ** -5
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

CASES = {
    "lstm": JL.LSTM(n_out=H),
    "graves": JL.GravesLSTM(n_out=H),
    "gru": JL.GRU(n_out=H),
    "gru_reset_after": JL.GRU(n_out=H, reset_after=True),
    "simple_rnn": JL.SimpleRnn(n_out=H),
    "bidi_concat": JL.Bidirectional(fwd=JL.GravesLSTM(n_out=H).to_dict()),
    "bidi_add": JL.Bidirectional(fwd=JL.LSTM(n_out=H).to_dict(), mode="add"),
    "bidi_mul": JL.Bidirectional(fwd=JL.GRU(n_out=H).to_dict(), mode="mul"),
    "bidi_average": JL.Bidirectional(fwd=JL.SimpleRnn(n_out=H).to_dict(),
                                     mode="average"),
    "last_lstm": JL.LastTimeStep(fwd=JL.LSTM(n_out=H).to_dict()),
    "last_graves": JL.LastTimeStep(fwd=JL.GravesLSTM(n_out=H).to_dict()),
}


def _rel_to_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _params(jl, seed=0):
    """The reference's init of ``jl`` plus N(0, 0.2) noise, as f32
    numpy."""
    p, _ = jl.init(jax.random.PRNGKey(seed), (T, F))
    rng = np.random.RandomState(seed + 1)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.2 * rng.randn(*a.shape)).astype(
            np.float32), p)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, F).astype(np.float32)
    mask = (np.arange(T)[None] < np.array(LENS)[:, None]).astype(np.float32)
    return x, mask


def _jax_vjp(jl, p, x, mask, ct, jdt):
    """The reference's forward and its VJP (params, x), compiled without
    excess precision."""
    def run(p, x, ct):
        def f(p, x):
            y, _, _ = jl.apply(p, {}, x, mask=mask)
            return y
        y, vjp = jax.vjp(f, p, x)
        return y, vjp(ct)

    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), t)
    args = (cast(p), cast(x), cast(ct))
    fn = jax.jit(run).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    y, (gp, gx) = fn(*args)
    return _f32(y), jax.tree.map(_f32, gp), _f32(gx)


def _port_vjp(tl, p, x, mask, ct, tdt):
    tp = tree_unflatten(p, [torch.from_numpy(np.array(a)).to(tdt)
                            .requires_grad_() for a in
                            tree_leaves(jax.tree.map(np.asarray, p))])
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tm = None if mask is None else torch.from_numpy(np.asarray(mask))
    y, _, _ = tl.apply(tp, {}, tx, mask=tm)
    leaves = tree_leaves(tp)
    grads = torch.autograd.grad(y, leaves + [tx],
                                torch.from_numpy(ct).to(tdt))
    return (y.detach().float().numpy(),
            [g.float().numpy() for g in grads[:-1]], grads[-1].float().numpy())


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_reference(case, dtype, masked):
    jl = CASES[case]
    tl = layer_from_dict(jl.to_dict())
    jdt, tdt = DTYPES[dtype]
    p = _params(jl)
    x, mask = _inputs()
    mask = mask if masked else None
    out_shape = (B,) + tuple(jl.output_shape((T, F)))
    ct = np.random.RandomState(7).randn(*out_shape).astype(np.float32)
    jy, jgp, jgx = _jax_vjp(jl, p, x, None if mask is None
                            else jnp.asarray(mask), ct, jdt)
    ty, tgp, tgx = _port_vjp(tl, p, x, mask, ct, tdt)
    assert ty.shape == jy.shape
    if dtype == "f32":
        tol = F32_RTOL
        assert _rel_to_max(ty, jy) <= tol
    else:
        tol = BF16_GRAD_RTOL
        np.testing.assert_array_equal(ty, jy)
    assert _rel_to_max(tgx, jgx) <= tol
    for got, want in zip(tgp, tree_leaves(jgp)):
        assert _rel_to_max(got, want) <= tol


# ------------------------------------------------------------ activations
_GRID = np.linspace(-8, 8, 20001).astype(np.float32)


def _act_pair(name, jfn, dtype):
    jdt, tdt = DTYPES[dtype]
    ct = np.random.RandomState(0).randn(_GRID.size).astype(np.float32)
    jy, vjp = jax.vjp(jfn, jnp.asarray(_GRID).astype(jdt))
    (jg,) = vjp(jnp.asarray(ct).astype(jdt))
    tx = torch.from_numpy(_GRID).to(tdt).requires_grad_()
    ty = activations.get(name)(tx)
    (tg,) = torch.autograd.grad(ty, tx, torch.from_numpy(ct).to(tdt))
    return ((ty.detach().float().numpy(), _f32(jy)),
            (tg.float().numpy(), _f32(jg)))


@pytest.mark.parametrize("name,jfn", [("sigmoid", jax.nn.sigmoid),
                                      ("tanh", jnp.tanh),
                                      ("hardsigmoid", jax.nn.hard_sigmoid)],
                         ids=["sigmoid", "tanh", "hardsigmoid"])
def test_bf16_activations_are_bit_equal_to_jax(name, jfn):
    """Forward and gradient bit for bit."""
    (y, jy), (g, jg) = _act_pair(name, jfn, "bf16")
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(g, jg)


@pytest.mark.parametrize("name,jfn,rtol", [("sigmoid", jax.nn.sigmoid, 2e-7),
                                           ("tanh", jnp.tanh, 3e-7),
                                           ("hardsigmoid",
                                            jax.nn.hard_sigmoid, 0.0)],
                         ids=["sigmoid", "tanh", "hardsigmoid"])
def test_f32_activations_within_ulps_of_jax(name, jfn, rtol):
    """f32: the two packages' exp and tanh differ by an ulp or two
    (torch.sigmoid on 90 points, by 1.6e-7 of the value at most; tanh on
    12,072, by 2.4e-7); the gradients by what that carries (within 1e-6
    of the largest). hardsigmoid is exact."""
    (y, jy), (g, jg) = _act_pair(name, jfn, "f32")
    assert (np.abs(y - jy) <= rtol * np.abs(jy)).all()
    assert _rel_to_max(g, jg) <= (1e-6 if rtol else 0.0)


# --------------------------------------------------------------- step API
@pytest.mark.parametrize("case", ["lstm", "graves", "gru", "gru_reset_after",
                                  "simple_rnn"])
def test_step_equals_apply_sequence_and_reference_step(case):
    """rnnTimeStep: T single steps from a carry equal one apply_sequence
    from it, and the reference's steps (f32, 1e-5 of the largest
    entry)."""
    jl = CASES[case]
    tl = layer_from_dict(jl.to_dict())
    p = _params(jl)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    x, _ = _inputs()
    rng = np.random.RandomState(3)
    jc = jax.tree.map(lambda a: jnp.asarray(rng.randn(*a.shape), jnp.float32),
                      jl.init_carry(B, (T, F)))
    tc = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jc)
    whole, whole_c = tl.apply_sequence(tp, torch.from_numpy(x), tc)
    c, jcs, steps, jsteps = tc, jc, [], []
    for t in range(T):
        y, c = tl.step(tp, torch.from_numpy(x[:, t]), c)
        jy, jcs = jl.step(p, jnp.asarray(x[:, t]), jcs)
        steps.append(y.numpy())
        jsteps.append(np.asarray(jy))
    steps = np.stack(steps, 1)
    assert _rel_to_max(steps, whole.numpy()) <= 1e-6
    assert _rel_to_max(steps, np.stack(jsteps, 1)) <= F32_RTOL
    for a, b, j in zip(tree_leaves(c), tree_leaves(whole_c),
                       jax.tree_util.tree_leaves(jcs)):
        assert _rel_to_max(a.numpy(), b.numpy()) <= 1e-6
        assert _rel_to_max(a.numpy(), np.asarray(j)) <= F32_RTOL


def test_masked_step_holds_the_carry_and_emits_it():
    """A masked step holds h and c and emits the held h (the reference's
    _mask_carry); LastTimeStep picks sum(mask) - 1, clamped at 0."""
    jl = CASES["graves"]
    tl = layer_from_dict(jl.to_dict())
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), _params(jl))
    x, mask = _inputs()
    mask[2] = 0.0  # a row with no live step
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    y, (h, c) = tl.apply_sequence(tp, tx, tl.init_carry(B, (T, F)), mask=tm)
    for b, n in enumerate([7, 4, 0]):
        if n:
            assert torch.equal(y[b, n:], y[b, n - 1:n].expand(T - n, H))
            assert torch.equal(h[b], y[b, n - 1])
        else:
            assert not y[b].any() and not h[b].any() and not c[b].any()
    last = layer_from_dict(CASES["last_graves"].to_dict())
    out, _, out_mask = last.apply(tp, {}, tx, mask=tm)
    assert out_mask is None
    assert torch.equal(out, y[[0, 1, 2], [6, 3, 0]])


# ------------------------------------------------------- configs and init
@pytest.mark.parametrize("case", sorted(CASES))
def test_config_and_param_shapes_cross_between_packages(case):
    jl = CASES[case]
    tl = layer_from_dict(jl.to_dict())
    assert tl.to_dict() == jl.to_dict()
    assert j_layer_from_dict(tl.to_dict()) == jl
    jp, _ = jl.init(jax.random.PRNGKey(0), (T, F))
    tp, _ = tl.init(torch.Generator().manual_seed(0), (T, F))
    assert jax.tree.map(np.shape, jp) == jax.tree.map(
        lambda a: tuple(a.shape), tp)
    assert tuple(tl.output_shape((T, F))) == tuple(jl.output_shape((T, F)))


def test_init_matches_reference_constants():
    """Forget-gate bias 1.0 (the [H:2H] block), other biases and the
    peepholes 0, weights drawn with xavier's variance."""
    tl = TL.GravesLSTM(n_out=64)
    p, _ = tl.init(torch.Generator().manual_seed(0), (T, 48))
    b = p["b"].numpy()
    np.testing.assert_array_equal(b[64:128], 1.0)
    assert not b[:64].any() and not b[128:].any()
    for k in ("w_ci", "w_cf", "w_co"):
        assert not p[k].any()
    std = float(p["w_hh"].std())
    assert abs(std - (2.0 / (64 + 256)) ** 0.5) < 0.01


def test_bidirectional_refuses_a_non_recurrent_layer():
    with pytest.raises(ValueError, match="not a recurrent layer"):
        TL.Bidirectional(fwd=TL.Dense(n_out=4).to_dict()).output_shape((T, F))


def _seq_pair(compute_dtype=None, bidirectional=True):
    layers = [JL.GravesLSTM(n_out=H),
              JL.Bidirectional(fwd=JL.GRU(n_out=H).to_dict(), mode="add"),
              JL.RnnOutput(n_out=6, activation="softmax", loss="mcxent")]
    if not bidirectional:
        layers = [layers[0], JL.LSTM(n_out=H), layers[2]]
    jm = JSequential(JNetConfig(seed=0, compute_dtype=compute_dtype),
                     layers, (T, F))
    jm.init()
    jm.params = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.2 * np.random.RandomState(
            a.size).randn(*a.shape).astype(np.float32)), jm.params)
    tm = Sequential.from_json(jm.to_json(), device="cpu")
    tm.params = params_from_numpy(tm, jax.tree.map(np.asarray, jm.params))
    tm.state = {}
    return jm, tm


def test_sequential_json_round_trips_through_both_packages():
    jm, tm = _seq_pair()
    assert json.loads(tm.to_json()) == json.loads(jm.to_json())
    back = JSequential.from_json(tm.to_json())
    assert [l.to_dict() for l in back.layers] == \
        [l.to_dict() for l in jm.layers]


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"],
                         ids=["f32", "bf16"])
def test_sequential_forward_matches_reference(compute_dtype):
    """The whole stack, masked: f32 within F32_RTOL; under a bf16 compute
    dtype (h and c in bf16, the carries built in x's dtype) bit for bit
    with the reference compiled without excess precision."""
    jm, tm = _seq_pair(compute_dtype)
    x, mask = _inputs()
    fn = jax.jit(lambda p, x, m: jm.forward(p, {}, x, mask=m)[0]).lower(
        jm.params, jnp.asarray(x), jnp.asarray(mask)).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(fn(jm.params, jnp.asarray(x), jnp.asarray(mask)))
    got, _ = tm.forward(tm.params, {}, torch.from_numpy(x),
                        mask=torch.from_numpy(mask))
    if compute_dtype is None:
        assert _rel_to_max(got.numpy(), want) <= F32_RTOL
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_carries_take_the_param_dtype_and_score_with_carry_ignores_compute_dtype():
    """The reference's contract: ``init_carries`` is in the param dtype
    (f32) under a bf16 compute dtype, and ``score_with_carry`` casts
    neither x nor the params, so a bf16 config's chunk loss is its f32
    config's bit for bit, and the reference's within F32_RTOL."""
    jm, tm = _seq_pair("bfloat16")
    _, tm32 = _seq_pair(None)
    carries = tm.init_carries(B)
    assert [t.dtype for t in tree_leaves(carries)] == [torch.float32] * 2
    assert [k for k, _ in tm.rnn_layers()] == ["layer_0"]
    x, mask = _inputs()
    y = np.eye(6, dtype=np.float32)[np.random.RandomState(2).randint(
        0, 6, (B, T))]
    args = (torch.from_numpy(x), torch.from_numpy(y))
    loss, _, new = tm.score_with_carry(tm.params, {}, *args, carries,
                                       mask=torch.from_numpy(mask))
    loss32, _, _ = tm32.score_with_carry(tm32.params, {}, *args,
                                         tm32.init_carries(B),
                                         mask=torch.from_numpy(mask))
    assert loss.dtype == torch.float32 and torch.equal(loss, loss32)
    assert [t.dtype for t in tree_leaves(new)] == [torch.float32] * 2
    jloss, _, jnew = jm.score_with_carry(
        jm.params, {}, jnp.asarray(x), jnp.asarray(y), jm.init_carries(B),
        mask=jnp.asarray(mask))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=F32_RTOL)
    for a, b in zip(tree_leaves(new), jax.tree_util.tree_leaves(jnew)):
        assert _rel_to_max(a.detach().numpy(), np.asarray(b)) <= F32_RTOL


def test_forward_with_carry_continues_a_sequence():
    """Two halves through ``forward_with_carry`` equal the whole sequence,
    and the reference's halves (f32)."""
    jm, tm = _seq_pair(bidirectional=False)
    x, _ = _inputs()
    tx = torch.from_numpy(x)
    whole, _ = tm.forward(tm.params, {}, tx)
    c = tm.init_carries(B)
    y1, _, c = tm.forward_with_carry(tm.params, {}, tx[:, :3], c)
    y2, _, c = tm.forward_with_carry(tm.params, {}, tx[:, 3:], c)
    halves = torch.cat([y1, y2], dim=1).numpy()
    assert _rel_to_max(halves, whole.numpy()) <= 1e-6
    jc = jm.init_carries(B)
    j1, _, jc = jm.forward_with_carry(jm.params, {}, jnp.asarray(x[:, :3]), jc)
    j2, _, jc = jm.forward_with_carry(jm.params, {}, jnp.asarray(x[:, 3:]), jc)
    assert _rel_to_max(halves, np.concatenate([j1, j2], 1)) <= F32_RTOL
