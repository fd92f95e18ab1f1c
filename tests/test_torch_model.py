"""The port's model stack (deeplearning4j_torch) held against the JAX
package: activations, init, layers, the Sequential container and its JSON,
the CausalLM, and weights crossing through ``params_from_numpy`` and through
model zips written by either package.

Inputs and params come from numpy (the reference's params, made from its
seed). Tolerances: f32 1e-5; bf16 compute one bf16 ulp relative (2**-7),
since the port rounds each op where the reference does (measured gap at
this size: 0), while a port that ran in f32 misses the reference's bf16
answer by about 4% relative. Also here: the import hygiene of the port (no
JAX, nothing of the JAX package) and its refusal to pick the CPU on its
own."""

import ast
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.models import CausalLM
from deeplearning4j_torch.nn import layers as TL
from deeplearning4j_torch.nn.model import NetConfig, Sequential
from deeplearning4j_torch.ops import activations, initializers
from deeplearning4j_torch.train import load_model, params_from_numpy, save_model
from deeplearning4j_tpu.models import CausalLM as JCausalLM
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.ops import activations as jactivations
from deeplearning4j_tpu.train.serialization import load_model as jload_model
from deeplearning4j_tpu.train.serialization import save_model as jsave_model

F32_TOL = 1e-5
BF16_RTOL = 2.0 ** -7  # one bf16 ulp
REPO = pathlib.Path(__file__).resolve().parent.parent
LM = dict(seed=0, input_shape=(48,), num_layers=2, d_model=64, num_heads=4,
          vocab=97)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def reference_lms():
    """The reference's 2-layer CausalLMs (flash and dense), initialized."""
    out = {}
    for flash in (True, False):
        m = JCausalLM(flash=flash, **LM).build()
        m.init()
        out[flash] = m
    return out


@pytest.fixture(scope="module")
def ids():
    return np.random.RandomState(0).randint(0, LM["vocab"], (2, 48)).astype(
        np.int32)


def _port_lm(flash, jmodel, compute_dtype=None):
    m = CausalLM(flash=flash, device="cpu", **LM).build()
    m.config.compute_dtype = compute_dtype
    m.params = params_from_numpy(m, _np_tree(jmodel.params))
    m.state = {}
    return m


def _reference_bf16_output(jmodel, ids):
    jmodel.config.compute_dtype = "bfloat16"
    try:
        return np.asarray(jmodel.output(jnp.asarray(ids)))
    finally:
        jmodel.config.compute_dtype = None


class TestCausalLM:
    @pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
    def test_output_matches_reference_f32(self, reference_lms, ids, flash):
        jm = reference_lms[flash]
        want = np.asarray(jm.output(jnp.asarray(ids)))
        got = _port_lm(flash, jm).output(ids).numpy()
        assert got.shape == (2, 48, LM["vocab"])
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)

    @pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
    def test_output_matches_reference_bf16_compute(self, reference_lms, ids,
                                                   flash):
        want = _reference_bf16_output(reference_lms[flash], ids)
        got = _port_lm(flash, reference_lms[flash], "bfloat16").output(ids)
        assert got.dtype == torch.float32  # cast back to the model dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=BF16_RTOL, atol=0)

    @pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
    def test_bf16_limit_rejects_f32_compute(self, reference_lms, ids, flash):
        """The control of the test above: the port computing in f32 misses
        the reference's bf16 answer by far more than the limit."""
        want = _reference_bf16_output(reference_lms[flash], ids)
        got = _port_lm(flash, reference_lms[flash]).output(ids).numpy()
        assert np.max(np.abs(got - want) / want) > 4 * BF16_RTOL

    def test_reference_zip_loads_in_port(self, reference_lms, ids, tmp_path):
        jm = reference_lms[True]
        path = str(tmp_path / "lm.zip")
        jsave_model(path, jm)
        model, params, state = load_model(path, device="cpu")
        assert model.params is params and model.device.type == "cpu"
        assert [type(l).__name__ for l in model.layers] == \
            [type(l).__name__ for l in jm.layers]
        np.testing.assert_allclose(model.output(ids).numpy(),
                                   np.asarray(jm.output(jnp.asarray(ids))),
                                   rtol=F32_TOL, atol=F32_TOL)

    def test_port_zip_loads_in_reference(self, reference_lms, ids, tmp_path):
        port = _port_lm(True, reference_lms[True])
        path = str(tmp_path / "lm.zip")
        save_model(path, port)
        jm, *_ = jload_model(path)
        np.testing.assert_allclose(np.asarray(jm.output(jnp.asarray(ids))),
                                   port.output(ids).numpy(),
                                   rtol=F32_TOL, atol=F32_TOL)

    def test_config_json_is_the_reference_json(self, reference_lms):
        jm = reference_lms[True]
        port = CausalLM(flash=True, device="cpu", **LM).build()
        assert json.loads(port.to_json()) == json.loads(jm.to_json())
        again = Sequential.from_json(jm.to_json(), device="cpu")
        assert again.layers == port.layers
        assert again.output_shape == tuple(jm.output_shape)

    def test_param_shapes_and_count_match_reference(self, reference_lms):
        jm = reference_lms[True]
        port = CausalLM(flash=True, device="cpu", **LM).build()
        port.init(seed=3)
        assert port.param_shapes() == jax.tree.map(lambda a: tuple(a.shape),
                                                   jm.params)
        assert port.param_count() == jm.param_count()

    def test_params_from_numpy_rejects_foreign_tree(self, reference_lms):
        tree = _np_tree(reference_lms[True].params)
        tree["layer_2"]["w_up"] = tree["layer_2"]["w_up"].T
        port = CausalLM(flash=True, device="cpu", **LM).build()
        with pytest.raises(ValueError, match="does not match"):
            params_from_numpy(port, tree)

    def test_init_is_seeded_and_finite(self):
        m = CausalLM(flash=True, device="cpu", **LM).build()
        a, _ = m.init(seed=7)
        b, _ = CausalLM(flash=True, device="cpu", **LM).build().init(seed=7)
        c, _ = CausalLM(flash=True, device="cpu", **LM).build().init(seed=8)
        w = a["layer_2"]["attn"]["w_qkv"]
        assert torch.equal(w, b["layer_2"]["attn"]["w_qkv"])
        assert not torch.equal(w, c["layer_2"]["attn"]["w_qkv"])
        probs = m.output(np.zeros((1, 48), np.int32))
        assert torch.isfinite(probs).all()
        torch.testing.assert_close(probs.sum(-1), torch.ones(1, 48))


ACTIVATIONS = ["identity", "softmax", "gelu"]


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_matches_reference(name):
    x = np.random.default_rng(1).standard_normal((3, 17)).astype(np.float32) * 3
    want = np.asarray(jactivations.get(name)(jnp.asarray(x)))
    got = activations.get(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


BF16_OPS = {
    "gelu": (lambda x: jactivations.get("gelu")(x),
             lambda x: activations.get("gelu")(x)),
    "softmax": (lambda x: jactivations.get("softmax")(x),
                lambda x: activations.get("softmax")(x)),
    "layer_norm": (
        lambda x: JL.TransformerEncoderBlock._ln(
            x, jnp.asarray(1.5, jnp.bfloat16), jnp.asarray(0.25, jnp.bfloat16)),
        lambda x: TL.norm.layer_norm(x, torch.tensor(1.5, dtype=torch.bfloat16),
                                     torch.tensor(0.25, dtype=torch.bfloat16))),
}


@pytest.mark.parametrize("name", sorted(BF16_OPS))
def test_bf16_op_rounds_where_reference_rounds(name):
    """In bf16 the port's op gives the reference's bits: it rounds after
    each step as JAX does, not once as a fused torch op would."""
    x = (np.random.default_rng(4).standard_normal((64, 96)) * 2).astype(
        np.float32)
    jfn, tfn = BF16_OPS[name]
    want = np.asarray(jfn(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = tfn(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="Unknown activation"):
        activations.get("nope")


@pytest.mark.parametrize("shape", [(256, 512), (2048, 96), (96, 2048)])
def test_xavier_distribution(shape):
    """JAX's bits cannot be reproduced: xavier is held to its distribution
    (zero mean, std sqrt(2 / (fan_in + fan_out)) within 3% on >131k
    draws)."""
    gen = torch.Generator().manual_seed(0)
    w = initializers.init_param(gen, "xavier", shape)
    std = (2.0 / sum(shape)) ** 0.5
    assert abs(w.mean().item()) < 0.02 * std
    assert abs(w.std().item() / std - 1) < 0.03


def test_unknown_init_raises():
    with pytest.raises(ValueError, match="Unknown weight init"):
        initializers.init_param(None, "orthogonal", (2, 2))


LAYER_CASES = {
    "dense_gelu": (lambda m: m.Dense(n_out=6, activation="gelu"), (5, 4)),
    "output_softmax": (lambda m: m.Output(n_out=3, activation="softmax"),
                       (5, 4)),
    "rnn_output": (lambda m: m.RnnOutput(n_out=7), (2, 5, 4)),
    "layer_norm": (lambda m: m.LayerNorm(), (2, 5, 16)),
    "block_gelu_causal": (lambda m: m.TransformerEncoderBlock(
        num_heads=2, causal=True, flash=True), (2, 12, 16)),
    "positional": (lambda m: m.PositionalEmbedding(max_len=16), (2, 12, 16)),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_reference(case):
    make, shape = LAYER_CASES[case]
    jl, tl = make(JL), make(TL)
    assert jl.to_dict() == tl.to_dict()
    pj, _ = jl.init(jax.random.PRNGKey(2), shape[1:])
    rng = np.random.default_rng(3)
    # perturb the constant-initialized params (LayerNorm's ones/zeros) so
    # the comparison sees them
    pj = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        a.shape).astype(np.float32), pj)
    pt = jax.tree.map(torch.from_numpy, pj)
    x = rng.standard_normal(shape).astype(np.float32)
    yj, _, _ = jl.apply(pj, {}, jnp.asarray(x))
    yt, _, _ = tl.apply(pt, {}, torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=F32_TOL,
                               atol=F32_TOL)


def test_embedding_sequence_matches_reference():
    jl, tl = JL.EmbeddingSequence(n_in=11, n_out=5, mask_zero=True), \
        TL.EmbeddingSequence(n_in=11, n_out=5, mask_zero=True)
    pj, _ = jl.init(jax.random.PRNGKey(0), (6,))
    ids = np.array([[0, 3, 10, 1, 0, 2]], np.int32)
    yj, _, mj = jl.apply(pj, {}, jnp.asarray(ids))
    yt, _, mt = tl.apply({"w": torch.from_numpy(np.asarray(pj["w"]))}, {},
                         torch.from_numpy(ids))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


@pytest.mark.parametrize("layer", [
    TL.Dense(n_out=2, dropout=0.5),
    TL.MultiHeadAttention(num_heads=2, attn_dropout=0.1),
    TL.TransformerEncoderBlock(num_heads=2, dropout_rate=0.1),
], ids=["input_dropout", "attn_dropout", "block_dropout"])
def test_training_time_dropout_is_refused(layer):
    """Forward only: training-time dropout is never silently skipped. With
    a generator the training forward drops (its output differs from
    inference's); an input dropout with no generator is refused, as the
    reference refuses it (attention and block dropout then drop nothing,
    as the reference's do); inference runs."""
    params, _ = layer.init(torch.Generator().manual_seed(0), (4, 8))
    x = torch.linspace(-1.0, 1.0, 32).reshape(1, 4, 8)
    y, _, _ = layer.apply(params, {}, x)
    assert torch.isfinite(y).all()
    y_train, _, _ = layer.apply(params, {}, x, training=True,
                                rng=torch.Generator().manual_seed(1))
    assert torch.isfinite(y_train).all() and not torch.equal(y_train, y)
    if layer.dropout is not None:
        with pytest.raises(ValueError, match="dropout but no rng"):
            layer.apply(params, {}, x, training=True)
    else:
        y_none, _, _ = layer.apply(params, {}, x, training=True)
        assert torch.equal(y_none, y)


class TestDevice:
    def test_no_device_without_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CausalLM(**LM).build()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Sequential(NetConfig(), [TL.Dense(n_out=2)], (3,))

    def test_load_model_without_cuda_raises(self, monkeypatch, tmp_path):
        m = Sequential(NetConfig(), [TL.Dense(n_out=2)], (3,), device="cpu")
        m.init()
        path = str(tmp_path / "m.zip")
        save_model(path, m)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_model(path)
        model, _, _ = load_model(path, device="cpu")
        assert model.device.type == "cpu"


FORBIDDEN_ROOTS = {"jax", "jaxlib", "deeplearning4j_tpu", "flax", "optax"}


def _port_sources():
    files = sorted((REPO / "deeplearning4j_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN_ROOTS, \
                f"{path.name}:{node.lineno} imports {name}"


def test_importing_the_port_loads_no_jax():
    """Importing the port (``parallel`` too) loads no JAX module, and
    neither does a spawned gloo rank of ``parallel.RankGroup`` (its cases
    come from ``tests/torch_parallel_ranks.py``)."""
    code = ("import sys, deeplearning4j_torch.serve, deeplearning4j_torch.models,"
            " deeplearning4j_torch.train, deeplearning4j_torch.kernels._build,"
            " deeplearning4j_torch.parallel;"
            " bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN_ROOTS)!r}); sys.exit(str(bad) if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    code = ("import sys; sys.path.insert(0, 'tests');"
            " import torch_parallel_ranks as R;"
            " from deeplearning4j_torch.parallel import run_ranks;"
            " info = run_ranks(R.rank_info, 2);"
            " bad = info['jax'] + R.jax_modules();"
            " sys.exit(str(bad) if bad or info['backend'] != 'gloo' else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
