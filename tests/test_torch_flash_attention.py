"""The port's flash attention (deeplearning4j_torch/ops/flash_attention.py),
forward and backward, held against the JAX package's.

On the CPU the port runs its plain PyTorch versions; the reference runs its
Pallas kernels in interpret mode, as tests/test_flash_attention.py runs
them (the backward through ``backward="pallas"`` or ``_flash_bwd_pallas``:
K2 and K3). Inputs are made with numpy from a seed and handed to both.
Tolerances: f32 1e-5 (abs and rel; the two sum in different orders); bf16
against the reference one bf16 ulp relative (2**-7: both round P to bf16
before P.V, and ds and p where K2/K3 round them; the measured forward gap
is 0, and in the backward an f32 summation-order difference can flip one
ds rounding, measured 1.4e-7 abs on an entry near 0, hence 1e-6 abs
beside it). The CUDA kernels against the plain versions, bf16: 8e-3 abs +
1e-2 rel for o (K1 rounds P relative to running maxima, the plain version
relative to the row's maximum), 1e-2 abs + 1e-2 rel for dq, dk, dv (max
seen 3.9e-3). Tests of the CUDA kernels themselves carry the ``gpu`` marker
and skip without a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.kernels import _build
from deeplearning4j_torch.nn.layers import MultiHeadAttention as TMHA
from deeplearning4j_torch.ops.flash_attention import (
    _bwd_route, _fwd_route, column_broadcast_cuda, flash_attention,
    flash_attention_backward_reference, flash_attention_reference,
    flash_bwd_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_fwd_cuda)
from deeplearning4j_tpu.nn.layers import MultiHeadAttention as JMHA
from deeplearning4j_tpu.ops import flash_attention as jfa

F32_TOL = 1e-5
BF16_RTOL = 2.0 ** -7  # one bf16 ulp
BF16_BWD_ATOL = 1e-6
KERNEL_BF16_ATOL, KERNEL_BF16_RTOL = 8e-3, 1e-2
KERNEL_BWD_BF16_ATOL, KERNEL_BWD_BF16_RTOL = 1e-2, 1e-2


def _qkv(B=2, T=48, H=3, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, T, H, D)).astype(np.float32)
                 for _ in range(3))


def _gappy_mask(B, T, seed):
    rng = np.random.default_rng(seed)
    m = rng.random((B, T)) > 0.35
    m[0] = np.r_[np.zeros(T // 2), np.ones(T - T // 2)]  # left-padded
    m[:, 0] = True
    return m


def _both(q, k, v, **kw):
    """(port o, reference o) as numpy f32 for the same numpy inputs."""
    jkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    tkw = {n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               **jkw)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **tkw)
    return got.numpy(), np.asarray(want)


FORWARD_CASES = {
    "dense": (dict(), dict()),
    "causal": (dict(), dict(causal=True)),
    "ragged_T": (dict(T=37), dict(causal=True)),
    "custom_scale": (dict(T=32), dict(scale=0.5)),
    "lengths": (dict(B=3, seed=11),
                dict(lengths=np.array([48, 17, 33], np.int32))),
    "lengths_causal": (dict(B=3, seed=11),
                       dict(causal=True,
                            lengths=np.array([48, 17, 33], np.int32))),
    "zero_length": (dict(T=32, seed=15),
                    dict(causal=True, lengths=np.array([32, 0], np.int32))),
    "key_mask": (dict(B=3, seed=21), dict(key_mask=_gappy_mask(3, 48, 22))),
    "key_mask_causal": (dict(B=3, seed=21),
                        dict(causal=True, key_mask=_gappy_mask(3, 48, 22))),
    "window7": (dict(seed=31), dict(causal=True, window=7)),
    "window16": (dict(seed=31), dict(causal=True, window=16)),
    "window33": (dict(seed=31), dict(causal=True, window=33)),
    "window_lengths": (dict(seed=33),
                       dict(causal=True, window=9,
                            lengths=np.array([48, 20], np.int32))),
    "window_ge_T": (dict(T=32, seed=35), dict(causal=True, window=999)),
}


class TestForward:
    @pytest.mark.parametrize("case", sorted(FORWARD_CASES))
    def test_matches_reference(self, case):
        shape, kw = FORWARD_CASES[case]
        got, want = _both(*_qkv(**shape), **kw)
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)

    def test_zero_length_row_is_zero(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(T=32, seed=15))
        o = flash_attention(q, k, v, causal=True,
                            lengths=torch.tensor([32, 0]))
        assert torch.all(o[1] == 0)

    def test_bf16_inputs(self):
        q, k, v = _qkv()
        want = jfa.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                     for a in (q, k, v)), causal=True)
        got = flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                for a in (q, k, v)), causal=True)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=BF16_RTOL, atol=0)


LSE_CASES = {
    "dense": dict(causal=False),
    "causal": dict(causal=True),
    "lengths": dict(causal=True, lens=[40, 0, 17]),
    "key_mask": dict(causal=False, kmask=True),
    "window": dict(causal=True, window=11),
}


@pytest.mark.parametrize("case", sorted(LSE_CASES))
def test_lse_matches_reference_kernel(case):
    """(o, lse) of the plain version against the reference's forward
    kernel, _flash_fwd in interpret mode."""
    kw = LSE_CASES[case]
    rng = np.random.default_rng(5)
    BH, T, D = 3, 40, 16
    q, k, v = (rng.standard_normal((BH, T, D)).astype(np.float32)
               for _ in range(3))
    lens = None if "lens" not in kw else np.array(kw["lens"], np.int32)
    kmask = (_gappy_mask(BH, T, 6).astype(np.int8) if kw.get("kmask")
             else None)
    window = kw.get("window", 0)
    scale = 0.25
    o_j, lse_j = jfa._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if lens is None else jnp.asarray(lens),
        None if kmask is None else jnp.asarray(kmask), scale, kw["causal"],
        16, 16, True, lens is not None, kmask is not None, window)
    o_t, lse_t = flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if lens is None else torch.from_numpy(lens),
        None if kmask is None else torch.from_numpy(kmask), scale=scale,
        causal=kw["causal"], window=window)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               rtol=F32_TOL, atol=F32_TOL)


def _stat_inputs(kw, dtype, BH=3, T=40, D=16, seed=5):
    """numpy q, k, v, do, lens, kmask for LSE_CASES entry ``kw``; q, k, v,
    do already rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (np.asarray(jnp.asarray(
        rng.standard_normal((BH, T, D)).astype(np.float32), dtype)
        .astype(jnp.float32)) for _ in range(4))
    lens = None if "lens" not in kw else np.array(kw["lens"], np.int32)
    kmask = (_gappy_mask(BH, T, 6).astype(np.int8) if kw.get("kmask")
             else None)
    return q, k, v, do, lens, kmask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(LSE_CASES))
def test_backward_matches_reference_kernels(case, dtype):
    """(dq, dk, dv) of the plain backward against the reference's backward
    kernels K2 and K3, _flash_bwd_pallas in interpret mode, from the same
    forward statistics."""
    kw = LSE_CASES[case]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    q, k, v, do, lens, kmask = _stat_inputs(kw, jdt)
    window, scale = kw.get("window", 0), 0.25
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jl = None if lens is None else jnp.asarray(lens)
    jm = None if kmask is None else jnp.asarray(kmask)
    o, lse = jfa._flash_fwd(jq, jk, jv, jl, jm, scale, kw["causal"], 16, 16,
                            True, lens is not None, kmask is not None, window)
    want = jfa._flash_bwd_pallas(jq, jk, jv, jl, jm, o, lse, jdo, scale,
                                 kw["causal"], 16, 16, True, window)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    to = torch.from_numpy(np.asarray(o.astype(jnp.float32))).to(tdt)
    delta = (tdo.float() * to.float()).sum(-1)
    got = flash_attention_backward_reference(
        tq, tk, tv, tdo, torch.from_numpy(np.asarray(lse)), delta,
        None if lens is None else torch.from_numpy(lens),
        None if kmask is None else torch.from_numpy(kmask), scale=scale,
        causal=kw["causal"], window=window)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == tdt
        b = np.asarray(b.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a.numpy(), b, rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=f"d{name}")
        else:
            np.testing.assert_allclose(a.float().numpy(), b, rtol=BF16_RTOL,
                                       atol=BF16_BWD_ATOL, err_msg=f"d{name}")


def _grads_both(q, k, v, w, **kw):
    """d(sum(o * w))/d(q, k, v) through the port's flash_attention and
    through the reference's with its Pallas backward (K2, K3)."""
    jkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    tkw = {n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, backward="pallas",
                                           block_q=16, block_k=16, **jkw) * w)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (flash_attention(tq, tk, tv, **tkw) * torch.from_numpy(w)).sum().backward()
    return (tq.grad, tk.grad, tv.grad), want


class TestBackward:
    @pytest.mark.parametrize("case", sorted(FORWARD_CASES))
    def test_grads_match_reference(self, case):
        shape, kw = FORWARD_CASES[case]
        q, k, v = _qkv(**shape)
        w = np.random.default_rng(99).standard_normal(q.shape).astype(
            np.float32)
        got, want = _grads_both(q, k, v, w, **kw)
        for name, a, b in zip("qkv", got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=f"d{name}")

    def test_zero_length_row_and_padded_keys_get_zero_grads(self):
        q, k, v = (torch.from_numpy(a).requires_grad_()
                   for a in _qkv(B=3, T=32, seed=15))
        o = flash_attention(q, k, v, causal=True,
                            lengths=torch.tensor([32, 0, 9]))
        (o ** 2).sum().backward()
        for g in (q.grad, k.grad, v.grad):
            assert torch.all(g[1] == 0)
        assert torch.all(k.grad[2, 9:] == 0) and torch.all(v.grad[2, 9:] == 0)
        assert torch.all(torch.isfinite(q.grad))

    def test_lse_output_is_not_differentiable(self):
        from deeplearning4j_torch.ops.flash_attention import _FlashAttention

        q = torch.randn((2, 8, 16), requires_grad=True)
        o, lse = _FlashAttention.apply(q, q, q, None, None, 0.25, True, 0)
        assert o.requires_grad and not lse.requires_grad


REJECTED = {
    "shape_mismatch": (lambda q: dict(k=q[:, :10]), "shapes must match"),
    "lengths_and_key_mask": (
        lambda q: dict(lengths=np.array([5, 6], np.int32),
                       key_mask=np.ones((2, 48), bool)), "not both"),
    "bad_lengths_shape": (lambda q: dict(lengths=np.array([5], np.int32)),
                          "lengths"),
    "window_not_causal": (lambda q: dict(window=4), "causal"),
    "window_zero": (lambda q: dict(causal=True, window=0), ">= 1"),
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_rejected_like_reference(case):
    q, k, v = _qkv()
    make, match = REJECTED[case]
    kw = dict(k=k, v=v)
    kw.update(make(q))
    k_, v_ = kw.pop("k"), kw.pop("v")
    jkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    tkw = {n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    with pytest.raises(ValueError, match=match):
        jfa.flash_attention(jnp.asarray(q), jnp.asarray(k_), jnp.asarray(v_),
                            **jkw)
    with pytest.raises(ValueError, match=match):
        flash_attention(torch.from_numpy(q), torch.from_numpy(k_),
                        torch.from_numpy(v_), **tkw)


def _layer_params(layer, seed, shape):
    import jax

    p, _ = layer.init(jax.random.PRNGKey(seed), shape)
    return ({n: np.asarray(a) for n, a in p.items()},
            {n: torch.from_numpy(np.asarray(a)) for n, a in p.items()})


LAYER_CASES = {
    # name: (layer kwargs, B, T, d, mask rows or None)
    "gqa_causal": (dict(num_heads=4, num_kv_heads=2, causal=True), 2, 24, 16,
                   None),
    "gqa_rope": (dict(num_heads=4, num_kv_heads=2, causal=True, rope=True),
                 2, 24, 16, None),
    "key_mask": (dict(num_heads=2), 2, 16, 8,
                 [[1] * 10 + [0] * 6, [1] * 16]),
    "left_padded": (dict(num_heads=2), 1, 8, 8, [[0, 0, 0, 1, 1, 1, 1, 1]]),
    "ragged": (dict(num_heads=2, ragged=True), 2, 16, 8,
               [[1] * 10 + [0] * 6, [1] * 16]),
    "window": (dict(num_heads=2, causal=True, window=5), 2, 32, 16, None),
}


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_reference(case, flash):
    """MultiHeadAttention of the port against the reference's on the same
    params: the fused-QKV split, the GQA repeat and the mask routing."""
    kw, B, T, d, mask = LAYER_CASES[case]
    jl, tl = JMHA(flash=flash, **kw), TMHA(flash=flash, **kw)
    pj, pt = _layer_params(jl, 1, (T, d))
    x = np.random.default_rng(30).standard_normal((B, T, d)).astype(np.float32)
    m = None if mask is None else np.asarray(mask, np.float32)
    yj, _, _ = jl.apply(pj, {}, jnp.asarray(x),
                        mask=None if m is None else jnp.asarray(m))
    yt, _, _ = tl.apply(pt, {}, torch.from_numpy(x),
                        mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj),
                               rtol=F32_TOL, atol=F32_TOL)


def test_unknown_device_is_refused_not_computed():
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention(q, q, q)


# ptxas's -Xptxas -v report for flash_fwd_sm90.cu on sm_90a, as nvcc
# 12 printed it for the two instantiations (the anonymous namespace's
# name carries a hash of the file)
_SM90_FN = ("_ZN50_GLOBAL__N__f84803df_17_flash_fwd_sm90_cu_a2c8b2f321"
           "flash_fwd_sm90_kernelILi{}EEEv14CUtensorMap_stS1_S1_PKiPKaP13"
           "__nv_bfloat16Pfiifii")
_SM90_LOG = "\n".join(
    [f"ptxas info    : Compiling entry function '{_SM90_FN.format(d)}' for "
     f"'sm_90a'\n"
     f"ptxas info    : Function properties for {_SM90_FN.format(d)}\n"
     "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
     "ptxas info    : Used 168 registers, used 1 barriers\n"
     f"ptxas info    : Compile time = {ms} ms" for d, ms in (
         (128, "217.520"), (64, "271.990"))])

# ptxas's -Xptxas -v report for flash_bwd_sm90.cu on sm_90a, as nvcc 12
# printed it for its two kernels (named in a named namespace, so the names
# do not change from build to build)
_SM90_BWD_FN = {
    "flash_bwd_dkv_sm90_kernel":
        "_ZN19dl4j_flash_bwd_sm9025flash_bwd_dkv_sm90_kernelILi64EEEv14"
        "CUtensorMap_stS1_S1_S1_PKfS3_PKiPKaP13__nv_bfloat16S9_iiffii",
    "flash_bwd_dq_sm90_kernel":
        "_ZN19dl4j_flash_bwd_sm9024flash_bwd_dq_sm90_kernelILi64EEEv14"
        "CUtensorMap_stS1_S1_S1_PKfS3_PKiPKaP13__nv_bfloat16iiiffii",
}
_SM90_BWD_LOG = "\n".join(
    [f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
     f"ptxas info    : Function properties for {fn}\n"
     "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
     "ptxas info    : Used 168 registers, used 1 barriers\n"
     f"ptxas info    : Compile time = {ms} ms" for fn, ms in (
         (_SM90_BWD_FN["flash_bwd_dkv_sm90_kernel"], "92.674"),
         (_SM90_BWD_FN["flash_bwd_dq_sm90_kernel"], "73.710"))])


class TestBuild:
    def test_targets_hopper_sm90a(self):
        flags = " ".join(_build.NVCC_FLAGS)
        assert "arch=compute_90a,code=sm_90a" in flags
        assert "-shared" in flags and "-fPIC" in flags
        assert _build.library_path("flash_fwd").parent == _build.BUILD_DIR

    def test_every_source_is_a_kernel_and_hashed_apart(self):
        assert set(_build.KERNELS) == {p.stem for p in
                                       _build.CSRC.glob("*.cu")}
        paths = {_build.library_path(n) for n in _build.KERNELS}
        assert len(paths) == len(_build.KERNELS)

    def test_build_all_compiles_side_by_side(self, monkeypatch):
        """build_all starts one build per source at once (a build waits
        until every other one has started) and returns them in order."""
        import threading

        started = threading.Barrier(len(_build.KERNELS), timeout=10)

        def fake_build(name):
            started.wait()
            return name

        monkeypatch.setattr(_build, "build", fake_build)
        assert _build.build_all() == list(_build.KERNELS)

    def test_hopper_forward_source_is_listed_and_hashed_apart(self):
        """K1's Hopper source (TMA, wgmma) is a kernel of its own beside
        v2's: listed, built to its own library, hashed apart."""
        assert "flash_fwd_sm90" in _build.KERNELS
        assert (_build.CSRC / "flash_fwd_sm90.cu").is_file()
        sm90 = _build.library_path("flash_fwd_sm90")
        assert sm90.name.startswith("libflash_fwd_sm90-")
        assert sm90 != _build.library_path("flash_fwd")

    @pytest.mark.parametrize("spilling, d, want", [
        (False, 64, "0 bytes spill stores, 0 bytes spill loads"),
        (False, 128, "0 bytes spill stores, 0 bytes spill loads"),
        (False, 32, ""),
        (True, 64, "16 bytes spill stores, 40 bytes spill loads")])
    def test_chip_smoke_reads_the_hopper_kernel_spills(self, spilling, d,
                                                       want):
        """chip_smoke gates the Hopper K1's D 64 spills on ptxas's report:
        the spill line that follows each kernel's properties line. The
        spilling case replaces D 64's real line with a made-up one."""
        import chip_smoke

        log = _SM90_LOG
        if spilling:
            head, tail = log.split(
                f"Function properties for {_SM90_FN.format(64)}\n")
            tail = tail.replace(
                "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                "loads", "16 bytes stack frame, 16 bytes spill stores, 40 "
                "bytes spill loads", 1)
            log = (f"{head}Function properties for "
                   f"{_SM90_FN.format(64)}\n{tail}")
        assert chip_smoke.sm90_spills(log, d) == want

    def test_hopper_backward_source_is_listed_and_hashed_apart(self):
        """K2/K3's Hopper source is a kernel of its own beside v2's, and
        its hash covers the header it shares with K1's Hopper source."""
        assert "flash_bwd_sm90" in _build.KERNELS
        assert (_build.CSRC / "flash_bwd_sm90.cu").is_file()
        sm90 = _build.library_path("flash_bwd_sm90")
        assert sm90.name.startswith("libflash_bwd_sm90-")
        assert sm90 != _build.library_path("flash_bwd")
        header = _build.CSRC / "sm90_common.cuh"
        for name in ("flash_fwd_sm90", "flash_bwd_sm90"):
            assert _build.sources(name) == [_build.CSRC / f"{name}.cu", header]
        assert _build.sources("flash_bwd") == [_build.CSRC / "flash_bwd.cu"]

    @pytest.mark.parametrize("edited", ["flash_bwd_sm90.cu", "sm90_common.cuh",
                                        "flash_bwd.cu"])
    def test_an_edited_source_or_header_changes_the_hash(self, monkeypatch,
                                                         tmp_path, edited):
        """An edit to a shared header rebuilds every source that includes
        it, and only those; an edit to a source rebuilds that source."""
        import shutil

        for f in _build.CSRC.iterdir():
            shutil.copy(f, tmp_path / f.name)
        monkeypatch.setattr(_build, "CSRC", tmp_path)
        before = {n: _build.library_path(n) for n in _build.KERNELS}
        with open(tmp_path / edited, "a") as f:
            f.write("\n// edited\n")
        after = {n: _build.library_path(n) for n in _build.KERNELS}
        changed = {n for n in _build.KERNELS if before[n] != after[n]}
        want = ({"flash_fwd_sm90", "flash_bwd_sm90", "bn_bwd"}
                if edited == "sm90_common.cuh" else {edited[:-3]})
        assert changed == want

    @pytest.mark.parametrize("kernel, spilling", [
        ("flash_bwd_dq_sm90_kernel", False), ("flash_bwd_dkv_sm90_kernel", False),
        ("flash_bwd_dq_sm90_kernel", True), ("flash_bwd_dkv_sm90_kernel", True)])
    def test_chip_smoke_reads_the_hopper_backward_spills(self, kernel,
                                                         spilling):
        """chip_smoke gates K2's and K3's Hopper kernels at D 64 on ptxas's
        report, each by its own name; the spilling cases replace one
        kernel's real line with a made-up one, which must not leak into the
        other's reading."""
        import chip_smoke

        log = _SM90_BWD_LOG
        if spilling:
            name = _SM90_BWD_FN[kernel]
            head, tail = log.split(f"Function properties for {name}\n")
            tail = tail.replace(
                "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                "loads", "8 bytes stack frame, 8 bytes spill stores, 8 bytes "
                "spill loads", 1)
            log = f"{head}Function properties for {name}\n{tail}"
        for other in _SM90_BWD_FN:
            want = ("8 bytes spill stores, 8 bytes spill loads"
                    if spilling and other == kernel
                    else "0 bytes spill stores, 0 bytes spill loads")
            assert chip_smoke.sm90_spills(log, 64, other) == want
        assert chip_smoke.sm90_spills(log, 128, kernel) == ""
        assert ("flash_bwd_sm90", kernel) in chip_smoke.SM90_GATED

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        if _build.library_path("flash_fwd").exists():
            pytest.skip("a built library is present; nothing to compile")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build("flash_fwd")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_fwd_route(dtype, D):
    """bf16 at head dims 64 and 128 goes to the Hopper kernel; f32 at every
    head dim and bf16 at 16 and 32 stay on flash_fwd.cu."""
    want = ("flash_fwd_sm90" if dtype == torch.bfloat16 and D in (64, 128)
            else "flash_fwd")
    assert _fwd_route(dtype, D) == want


@pytest.mark.parametrize("dtype, D, match", [
    (torch.bfloat16, 48, "head dim"), (torch.bfloat16, 256, "head dim"),
    (torch.float32, 8, "head dim"), (torch.float16, 64, "float32 or bfloat16"),
])
def test_fwd_route_refuses(dtype, D, match):
    with pytest.raises(ValueError, match=match):
        _fwd_route(dtype, D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_bwd_route(dtype, D):
    """bf16 at head dim 64 goes to the Hopper backward kernels; f32 at
    every head dim and bf16 at 16, 32 and 128 stay on flash_bwd.cu (the
    Hopper dK/dV kernel spilled at 128)."""
    want = ("flash_bwd_sm90" if dtype == torch.bfloat16 and D == 64
            else "flash_bwd")
    assert _bwd_route(dtype, D) == want


@pytest.mark.parametrize("dtype, D, match", [
    (torch.bfloat16, 48, "head dim"), (torch.bfloat16, 256, "head dim"),
    (torch.float32, 8, "head dim"), (torch.float16, 64, "float32 or bfloat16"),
])
def test_bwd_route_refuses(dtype, D, match):
    with pytest.raises(ValueError, match=match):
        _bwd_route(dtype, D)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


KERNEL_CASES = [
    # (dtype, BH, T, D, causal, window, lengths, hole)
    (torch.float32, 4, 100, 16, False, 0, None, False),
    (torch.float32, 4, 130, 64, True, 37, None, False),
    (torch.float32, 3, 90, 32, True, 0, [90, 0, 45], False),
    (torch.float32, 2, 70, 128, False, 0, None, True),
    (torch.bfloat16, 4, 200, 64, True, 0, None, False),
    (torch.bfloat16, 4, 150, 128, True, 20, [150, 0, 64, 1], True),
]
# K1's edges, forward only: the Hopper kernel (bf16, D 64 and 128; 128 query
# rows a CTA, 128 keys a tile at D 64 and 64 at D 128) at T below a tile and
# T = 1, T off the tile grid, BH 1, lengths either side of a tile edge, a
# key-mask hole, windows of 1, 64 and 200, causal and not; bf16 at D 32 stays
# on flash_fwd.cu
FWD_CASES = KERNEL_CASES + [
    (torch.bfloat16, 3, 1, 64, True, 0, None, False),
    (torch.bfloat16, 2, 1, 128, False, 0, None, False),
    (torch.bfloat16, 3, 100, 64, True, 0, None, False),
    (torch.bfloat16, 2, 333, 64, True, 0, None, False),
    (torch.bfloat16, 2, 1000, 128, True, 0, None, False),
    (torch.bfloat16, 1, 257, 64, False, 0, None, False),
    (torch.bfloat16, 5, 300, 64, True, 0, [0, 1, 127, 128, 129], False),
    (torch.bfloat16, 5, 300, 128, False, 0, [0, 1, 63, 64, 65], False),
    (torch.bfloat16, 3, 300, 64, True, 0, None, True),
    (torch.bfloat16, 3, 400, 64, True, 1, None, False),
    (torch.bfloat16, 3, 400, 64, True, 64, None, False),
    (torch.bfloat16, 3, 400, 128, True, 200, [400, 130, 7], False),
    (torch.bfloat16, 4, 200, 32, True, 0, [200, 0, 99, 150], False),
]
# K2 and K3's edges: their Hopper kernels (bf16 at D 64; dK/dV 128 keys a
# CTA and query tiles of 64; dQ 128 queries a CTA and key tiles of 64) at
# T = 1 and below a tile, T off the tile grid, BH 1, lengths 0, 1 and
# either side of 64 and 128, a key-mask hole, windows of 1, 64 and 200,
# causal and not; bf16 at D 32 and 128 stays on flash_bwd.cu
BWD_CASES = KERNEL_CASES + [
    (torch.bfloat16, 3, 1, 64, True, 0, None, False),
    (torch.bfloat16, 2, 1, 128, False, 0, None, False),
    (torch.bfloat16, 3, 100, 64, False, 0, None, False),
    (torch.bfloat16, 2, 333, 64, True, 0, None, False),
    (torch.bfloat16, 1, 257, 128, True, 0, None, False),
    (torch.bfloat16, 8, 300, 64, True, 0, [0, 1, 63, 64, 65, 127, 128, 129],
     False),
    (torch.bfloat16, 8, 300, 128, False, 0, [0, 1, 63, 64, 65, 127, 128, 129],
     False),
    (torch.bfloat16, 3, 300, 64, True, 0, None, True),
    (torch.bfloat16, 3, 400, 64, True, 1, None, False),
    (torch.bfloat16, 3, 400, 64, True, 64, None, False),
    (torch.bfloat16, 3, 400, 128, True, 200, [400, 130, 7], False),
    (torch.bfloat16, 4, 200, 32, True, 0, [200, 0, 99, 150], False),
]


def _bwd_inputs(device, case, seed, scale=None):
    """q, k, v, do, lse, delta, lens, kmask and the keyword arguments of
    backward case ``case``, with lse and delta from the plain forward."""
    dt, BH, T, D, causal, window, lens, hole = case
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn((BH, T, D), generator=gen,
                               device=device).to(dt) for _ in range(4))
    lens_t = None if lens is None else torch.tensor(lens, device=device)
    kmask = None
    if hole:
        kmask = torch.ones((BH, T), dtype=torch.int8, device=device)
        kmask[:, T // 3:T // 2] = 0
    kw = dict(scale=D ** -0.5 if scale is None else scale, causal=causal,
              window=window)
    o, lse = flash_attention_reference(q, k, v, lens_t, kmask, **kw)
    delta = (do.float() * o.float()).sum(-1)
    return (q, k, v, do, lse, delta, lens_t, kmask), kw


@pytest.mark.gpu
class TestKernelOnCard:
    @pytest.mark.parametrize("case", range(len(FWD_CASES)))
    def test_kernel_matches_plain(self, cuda, case):
        dt, BH, T, D, causal, window, lens, hole = FWD_CASES[case]
        gen = torch.Generator(device=cuda).manual_seed(case)
        q, k, v = (torch.randn((BH, T, D), generator=gen, device=cuda).to(dt)
                   for _ in range(3))
        lens_t = None if lens is None else torch.tensor(lens, device=cuda)
        kmask = None
        if hole:
            kmask = torch.ones((BH, T), dtype=torch.int8, device=cuda)
            kmask[:, T // 3:T // 2] = 0
        before = flash_fwd_cuda.launches
        o, lse = flash_fwd_cuda(q, k, v, lens_t, kmask, scale=D ** -0.5,
                                causal=causal, window=window)
        assert flash_fwd_cuda.launches == before + 1
        o_ref, lse_ref = flash_attention_reference(
            q, k, v, lens_t, kmask, scale=D ** -0.5, causal=causal,
            window=window)
        atol, rtol = ((F32_TOL, F32_TOL) if dt == torch.float32
                      else (KERNEL_BF16_ATOL, KERNEL_BF16_RTOL))
        torch.testing.assert_close(o.float(), o_ref.float(), rtol=rtol,
                                   atol=atol)
        live = lse_ref > -1e29
        torch.testing.assert_close(lse[live], lse_ref[live], rtol=F32_TOL,
                                   atol=1e-4)

    @pytest.mark.parametrize("scale", [-0.125, 0.0])
    def test_kernel_takes_any_scale(self, cuda, scale):
        """A scale <= 0 sends every key tile of the Hopper kernel down its
        masked path (interior tiles fold a positive scale into exp2)."""
        gen = torch.Generator(device=cuda).manual_seed(7)
        q, k, v = (torch.randn((2, 300, 64), generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(3))
        o, lse = flash_fwd_cuda(q, k, v, scale=scale, causal=True)
        o_ref, lse_ref = flash_attention_reference(q, k, v, scale=scale,
                                                   causal=True)
        torch.testing.assert_close(o.float(), o_ref.float(),
                                   rtol=KERNEL_BF16_RTOL,
                                   atol=KERNEL_BF16_ATOL)
        torch.testing.assert_close(lse, lse_ref, rtol=F32_TOL, atol=1e-4)

    @pytest.mark.parametrize("case", range(len(BWD_CASES)))
    def test_backward_kernels_match_plain(self, cuda, case):
        dt, lens = BWD_CASES[case][0], BWD_CASES[case][6]
        args, kw = _bwd_inputs(cuda, BWD_CASES[case], 100 + case)
        before = (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
        got = flash_bwd_cuda(*args, **kw)
        assert (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches) == \
            (before[0] + 1, before[1] + 1)
        want = flash_attention_backward_reference(*args, **kw)
        atol, rtol = ((F32_TOL, F32_TOL) if dt == torch.float32
                      else (KERNEL_BWD_BF16_ATOL, KERNEL_BWD_BF16_RTOL))
        for a, b in zip(got, want):
            assert a.dtype == dt
            torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                       atol=atol)
        for b, n in enumerate(lens or []):
            assert torch.all(got[1][b, n:] == 0) and torch.all(got[2][b, n:] == 0)

    @pytest.mark.parametrize("scale", [-0.125, 0.0])
    def test_backward_kernels_take_any_scale(self, cuda, scale):
        """A scale <= 0 sends every tile of the Hopper backward kernels down
        their masked path, as it does K1's."""
        args, kw = _bwd_inputs(cuda, (torch.bfloat16, 2, 300, 64, True, 0,
                                      None, False), 7, scale)
        for a, b in zip(flash_bwd_cuda(*args, **kw),
                        flash_attention_backward_reference(*args, **kw)):
            torch.testing.assert_close(a.float(), b.float(),
                                       rtol=KERNEL_BWD_BF16_RTOL,
                                       atol=KERNEL_BWD_BF16_ATOL)

    @pytest.mark.parametrize("case", [4, 11, 16])
    def test_backward_kernels_are_deterministic(self, cuda, case):
        """No float atomics: two launches give the same bits."""
        args, kw = _bwd_inputs(cuda, BWD_CASES[case], 300 + case)
        for a, b in zip(flash_bwd_cuda(*args, **kw), flash_bwd_cuda(*args, **kw)):
            assert torch.equal(a, b)

    def test_gradient_runs_the_backward_kernels(self, cuda):
        q = torch.randn((2, 64, 2, 16), device=cuda, requires_grad=True)
        before = (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
                  flash_bwd_dkv_cuda.launches)
        flash_attention(q, q, q, causal=True).sum().backward()
        assert (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
                flash_bwd_dkv_cuda.launches) == tuple(b + 1 for b in before)
        assert torch.isfinite(q.grad).all()

    def test_column_broadcast_is_bit_equal(self, cuda):
        x = torch.randn((1, 512, 1), device=cuda)
        torch.testing.assert_close(column_broadcast_cuda(x, 128),
                                   x.expand(1, 512, 128), rtol=0, atol=0)

    def test_unsupported_head_dim_raises(self, cuda):
        q = torch.randn((1, 16, 1, 24), device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(q, q, q)
