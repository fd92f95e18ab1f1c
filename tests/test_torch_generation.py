"""The port's KV-cache decode and sampling (deeplearning4j_torch/nn/
generation.py) — counterparts of tests/test_generation.py (all but its
recurrent-model cases, whose layers the port does not have yet), each held
against the JAX package on the same params on the CPU: decode logits
within 1e-5 abs of JAX's ``decode_forward`` (learned positions, rope, GQA,
a sliding window; dense and paged caches) at f32 and under the served
bf16 compute dtype, ``cache_append`` / ``cache_read`` bit-equal to JAX's,
greedy ``generate`` ids equal to JAX's at both precisions.

Under bf16 compute with f32 params the reference keeps its caches in f32
and promotes to f32 from the first block's output projection on; a
control run with everything in bf16 (no promotion) lands about 2e-2 from
JAX, so the 1e-5 tolerance tells the two apart. The bf16 logits are held
against JAX's ``decode_forward`` compiled without XLA's excess precision
(see ``_jax_schedule``); the greedy ids against JAX's ``generate`` as is.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_torch.models import CausalLM
from deeplearning4j_torch.nn import generation as tg
from deeplearning4j_torch.nn.layers import (EmbeddingSequence,
                                            GlobalPooling, Output,
                                            PositionalEmbedding,
                                            TransformerEncoderBlock)
from deeplearning4j_torch.nn.model import NetConfig, Sequential
from deeplearning4j_torch.train import params_from_numpy
from deeplearning4j_tpu.models import CausalLM as JCausalLM
from deeplearning4j_tpu.nn import generation as jg

ATOL = 1e-5
SMALL = dict(seed=0, input_shape=(16,), num_layers=2, d_model=32,
             num_heads=4, vocab=50)
CONFIGS = {"learned": {}, "rope": {"pos": "rope"},
           "gqa1": {"pos": "rope", "num_kv_heads": 1},
           "gqa2": {"num_kv_heads": 2},
           "window": {"pos": "rope", "window": 5}}


@functools.lru_cache(maxsize=None)
def _pair(name, cdt=None):
    """(JAX model, port model) of one config under compute dtype ``cdt``
    (None: the params' f32), the port carrying the JAX model's params."""
    kw = CONFIGS[name]
    jm = JCausalLM(**SMALL, **kw).build()
    jm.init()
    tm = CausalLM(**SMALL, **kw, device="cpu").build()
    tm.params = params_from_numpy(tm, jax.tree.map(np.asarray, jm.params))
    tm.state = {}
    jm.config.compute_dtype = tm.config.compute_dtype = cdt
    return jm, tm


def _tree_to(tree, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _caches(tm, layout, B=2, capacity=16, bs=4):
    """Zeroed caches of ``layout``; paged rows own blocks in scrambled
    order, so the table mapping is exercised."""
    if layout == "dense":
        return tg.init_caches(tm, B, capacity, torch.float32)
    maxb = capacity // bs
    rng = np.random.RandomState(0)
    tables = torch.from_numpy(
        1 + rng.permutation(B * maxb).reshape(B, maxb).astype(np.int32))
    out = {}
    for lk, hkv, hd in tg.cache_spec(tm):
        n = 1 + B * maxb
        out[lk] = {"k_pool": torch.zeros((n, bs, hkv, hd)),
                   "v_pool": torch.zeros((n, bs, hkv, hd)),
                   "tables": tables}
    return out


def _schedule(decode, prompt, n_pre):
    """Prefill ``n_pre`` tokens at offset 0 (a scalar), then one token a
    step at per-row offsets (a vector); the logits of every stage."""
    outs, c = [], None
    lg, c = decode(prompt[:, :n_pre], 0, None)
    outs.append(lg)
    for t in range(n_pre, prompt.shape[1]):
        lg, c = decode(prompt[:, t:t + 1], np.full(prompt.shape[0], t,
                                                   np.int32), c)
        outs.append(lg)
    return np.concatenate(outs, axis=1)


@functools.lru_cache(maxsize=None)
def _jax_schedule(name, cdt=None, n_pre=6, T=10):
    """JAX's logits over the schedule of :func:`_schedule` (dense caches:
    the paged layout reads the same, which the contract tests below hold
    bit for bit), on one fixed prompt."""
    jm, _ = _pair(name, cdt)
    prompt = np.random.RandomState(3).randint(0, 50, (2, T)).astype(np.int32)

    def run(params, caches, prompt):
        lg, c = jg.decode_forward(jm, params, {}, prompt[:, :n_pre], caches,
                                  0)
        outs = [lg]
        for t in range(n_pre, T):
            pos = jnp.full((prompt.shape[0],), t, jnp.int32)
            lg, c = jg.decode_forward(jm, params, {}, prompt[:, t:t + 1], c,
                                      pos)
            outs.append(lg)
        return jnp.concatenate(outs, axis=1)

    caches = jg.init_caches(jm, 2, 16, jm.dtype)
    args = (jm.params, caches, jnp.asarray(prompt))
    # XLA's default excess precision drops some bf16 roundings inside
    # fusions (up to 8e-3 on these bf16 logits on the CPU); the port rounds
    # every op to its dtype, as the reference's code is written and as JAX
    # runs it op by op, so the reference is compiled without it
    fn = jax.jit(run).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return prompt, np.asarray(fn(*args))


def _port_schedule(tm, prompt, caches):
    """The port's logits over the schedule of :func:`_schedule`."""
    box = {"c": caches}

    def decode(x, pos, _):
        pos = pos if isinstance(pos, int) else torch.from_numpy(pos)
        with torch.inference_mode():
            lg, box["c"] = tg.decode_forward(
                tm, tm.params, {}, torch.from_numpy(x), box["c"], pos)
        return lg.numpy(), None

    return _schedule(decode, prompt, 6)


class TestDecodeForwardParity:
    @pytest.mark.parametrize("layout", ["dense", "paged"])
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_decode_logits_match_jax(self, name, layout):
        _, tm = _pair(name)
        prompt, want = _jax_schedule(name)
        got = _port_schedule(tm, prompt, _caches(tm, layout))
        assert got.shape == (2, 10, 50)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    @pytest.mark.parametrize("layout", ["dense", "paged"])
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_bf16_decode_logits_match_jax(self, name, layout):
        """The served precision: bf16 compute over f32 params, f32 caches
        (the params' dtype), promoted where JAX promotes."""
        _, tm = _pair(name, "bfloat16")
        prompt, want = _jax_schedule(name, "bfloat16")
        got = _port_schedule(tm, prompt, _caches(tm, layout))
        assert got.shape == (2, 10, 50)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_bf16_without_promotion_misses_the_tolerance(self, name):
        """Control: the same decode with params and caches all in bf16 (so
        no op promotes to f32) is far outside ATOL of JAX's bf16 logits,
        so the test above would catch a port that rounds that way."""
        _, tm = _pair(name, "bfloat16")
        prompt, want = _jax_schedule(name, "bfloat16")
        m = CausalLM(**SMALL, **CONFIGS[name], device="cpu").build()
        m.params, m.state = _tree_to(tm.params, torch.bfloat16), {}
        m.config.compute_dtype = "bfloat16"
        got = _port_schedule(m, prompt,
                             tg.init_caches(m, 2, 16, torch.bfloat16))
        assert np.abs(got - want).max() > 100 * ATOL

    def test_cast_memo_gives_the_same_bits(self):
        """bf16 compute: a decode whose param casts are memoized across
        calls equals one that casts every call, bit for bit."""
        _, tm0 = _pair("gqa2")
        tm = CausalLM(**SMALL, **CONFIGS["gqa2"], device="cpu").build()
        tm.params, tm.state = tm0.params, {}
        tm.config.compute_dtype = "bfloat16"
        x = torch.from_numpy(np.random.RandomState(4).randint(
            0, 50, (2, 7)).astype(np.int32))
        casts = {}
        outs = []
        for memo in (None, casts, casts):
            c = tg.init_caches(tm, 2, 16, tm.dtype)
            with torch.inference_mode():
                lg, _ = tg.decode_forward(tm, tm.params, {}, x, c, 0,
                                          casts=memo)
            outs.append(lg)
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1],
                                                              outs[2])
        assert tg.cast_bytes(casts) > 0


class TestCausalLMDecode:
    def setup_method(self):
        self.jm, self.model = _pair("learned")
        rng = np.random.RandomState(0)
        self.prompt = rng.randint(0, 50, (2, 10)).astype(np.int32)

    def _full_logprobs(self, ids):
        return np.log(self.model.output(ids).numpy() + 1e-20)

    def test_prefill_matches_full_forward(self):
        caches = tg.init_caches(self.model, 2, 16, self.model.dtype)
        with torch.inference_mode():
            lg, _ = tg.decode_forward(self.model, self.model.params, {},
                                      torch.from_numpy(self.prompt), caches,
                                      0)
        got = torch.log_softmax(lg, dim=-1).numpy()
        np.testing.assert_allclose(got, self._full_logprobs(self.prompt),
                                   atol=1e-4)

    def test_greedy_generate_matches_jax_and_argmax_rollout(self):
        n_new = 5
        toks = tg.generate(self.model, self.prompt, n_new, temperature=0.0)
        assert toks.shape == (2, n_new)
        want = jg.generate(self.jm, self.prompt, n_new, temperature=0.0)
        np.testing.assert_array_equal(toks, want)
        # oracle: repeated FULL forward + argmax (no caches involved)
        ids = self.prompt.copy()
        for _ in range(n_new):
            probs = self.model.output(ids).numpy()
            nxt = probs[:, -1].argmax(-1).astype(np.int32)
            ids = np.concatenate([ids, nxt[:, None]], axis=1)
        np.testing.assert_array_equal(toks, ids[:, -n_new:])

    @pytest.mark.parametrize("name", ["rope", "gqa1", "window"])
    def test_greedy_generate_matches_jax_other_configs(self, name):
        jm, tm = _pair(name)
        prompt = np.random.RandomState(1).randint(0, 50, (2, 9)) \
            .astype(np.int32)
        np.testing.assert_array_equal(
            tg.generate(tm, prompt, 4, temperature=0.0),
            jg.generate(jm, prompt, 4, temperature=0.0))

    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_bf16_greedy_generate_matches_jax(self, name):
        jm, tm = _pair(name, "bfloat16")
        prompt = np.random.RandomState(1).randint(0, 50, (2, 9)) \
            .astype(np.int32)
        np.testing.assert_array_equal(
            tg.generate(tm, prompt, 6, temperature=0.0),
            jg.generate(jm, prompt, 6, temperature=0.0))

    def test_sampled_generate_reproducible_and_in_range(self):
        a = tg.generate(self.model, self.prompt, 4, temperature=0.8, seed=7)
        b = tg.generate(self.model, self.prompt, 4, temperature=0.8, seed=7)
        np.testing.assert_array_equal(a, b)
        assert a.min() >= 0 and a.max() < 50
        g1, g2 = torch.Generator().manual_seed(3), \
            torch.Generator().manual_seed(3)
        np.testing.assert_array_equal(
            tg.generate(self.model, self.prompt, 4, rng=g1, top_k=3),
            tg.generate(self.model, self.prompt, 4, rng=g2, top_k=3))

    def test_capacity_and_position_guards(self):
        with pytest.raises(ValueError, match="capacity"):
            tg.generate(self.model, self.prompt, 5, capacity=10)
        m = CausalLM(**dict(SMALL, num_layers=1), device="cpu").build()
        m.init()
        for i, l in enumerate(m.layers):
            if isinstance(l, PositionalEmbedding):
                m.layers[i] = PositionalEmbedding(max_len=12)
        with pytest.raises(ValueError, match="max_len"):
            tg.generate(m, self.prompt, 5)

    def test_rejects_non_causal_and_sequence_global_models(self):
        def build(causal):
            m = Sequential(NetConfig(seed=0), [
                EmbeddingSequence(n_in=50, n_out=32),
                TransformerEncoderBlock(num_heads=4, causal=causal),
                GlobalPooling(mode="avg"),
                Output(n_out=3, loss="mcxent", activation="softmax")],
                (16,), device="cpu")
            m.init()
            return m

        ids = np.zeros((1, 4), np.int32)
        with pytest.raises(ValueError, match="causal"):
            tg.generate(build(False), ids, 3)
        with pytest.raises(ValueError, match="GlobalPooling"):
            tg.generate(build(True), ids, 3)

    def test_repeated_calls_give_the_same_ids(self):
        a = tg.generate(self.model, self.prompt, 3, temperature=0.0)
        b = tg.generate(self.model, self.prompt, 3, temperature=0.0)
        np.testing.assert_array_equal(a, b)


class TestSampling:
    def test_temperature_zero_is_argmax(self):
        logits = torch.tensor([[0.1, 3.0, -1.0], [2.0, 0.0, 5.0]])
        got = tg.sample_logits(logits, torch.Generator().manual_seed(0),
                               temperature=0.0)
        assert got.tolist() == [1, 2]

    def test_top_k_restricts_support(self):
        logits = torch.tensor([[0.0, 1.0, 2.0, 3.0, 4.0]] * 64)
        toks = tg.sample_logits(logits, torch.Generator().manual_seed(3),
                                temperature=1.0, top_k=2)
        assert set(toks.tolist()) <= {3, 4}

    def test_top_k_keeps_ties(self):
        # logits >= the k-th largest survive: a tie at the k-th value
        # widens the support, as in the reference
        logits = torch.tensor([[0.0, 2.0, 2.0, 1.0]] * 256)
        toks = tg.sample_logits(logits, torch.Generator().manual_seed(1),
                                temperature=1.0, top_k=1)
        assert set(toks.tolist()) == {1, 2}

    def test_low_temperature_concentrates(self):
        logits = torch.tensor([[0.0, 0.5, 1.0]] * 128)
        toks = tg.sample_logits(logits, torch.Generator().manual_seed(5),
                                temperature=0.05)
        assert (toks == 2).float().mean() > 0.95

    def test_frequencies_follow_the_softmax(self):
        logits = torch.tensor([[0.0, 1.0, 2.0]]).repeat(20000, 1)
        toks = tg.sample_logits(logits, torch.Generator().manual_seed(9))
        freq = torch.bincount(toks, minlength=3).float() / toks.numel()
        np.testing.assert_allclose(freq.numpy(),
                                   torch.softmax(logits[0], 0).numpy(),
                                   atol=0.015)


class TestRopeGqaWindow:
    def test_rope_has_no_learned_table(self):
        _, tm = _pair("rope")
        assert not any(isinstance(l, PositionalEmbedding) for l in tm.layers)

    def test_shift_invariance(self):
        from deeplearning4j_torch.nn.layers import rope_rotate

        rng = np.random.RandomState(2)
        q = torch.from_numpy(rng.randn(1, 3, 2, 8).astype(np.float32))
        k = torch.from_numpy(rng.randn(1, 3, 2, 8).astype(np.float32))

        def scores(shift):
            pos = torch.arange(3) + shift
            return torch.einsum("bqhd,bkhd->bhqk", rope_rotate(q, pos),
                                rope_rotate(k, pos)).numpy()

        np.testing.assert_allclose(scores(0), scores(37), rtol=2e-4,
                                   atol=2e-4)

    def test_cache_is_kv_head_sized(self):
        _, tm = _pair("gqa1")  # MQA
        caches = tg.init_caches(tm, 2, 16, tm.dtype)
        assert {tuple(c["k"].shape) for c in caches.values()} == \
            {(2, 16, 1, 8)}
        assert tg.cache_spec(tm) == [(lk, 1, 8) for lk in caches]

    def test_window_changes_the_distribution(self):
        common = dict(SMALL, pos="rope")
        mw = CausalLM(window=3, **common, device="cpu").build()
        mw.init()
        mf = CausalLM(**common, device="cpu").build()
        mf.params, mf.state = mw.params, mw.state
        prompt = np.random.RandomState(6).randint(0, 50, (1, 12)) \
            .astype(np.int32)
        ow, of = mw.output(prompt).numpy(), mf.output(prompt).numpy()
        np.testing.assert_allclose(ow[:, :3], of[:, :3], atol=1e-5)
        assert np.abs(ow[:, 8:] - of[:, 8:]).max() > 1e-4


class TestKVCacheContract:
    """cache_append/cache_read: the paged pool+table cache reads the same
    as the dense one wherever written, writes past the table land only in
    trash block 0, and every result equals JAX's bit for bit."""

    def _paged(self, B=2, Hkv=2, hd=4, bs=4, maxb=3, tables=None):
        if tables is None:  # rows own disjoint blocks 1..B*maxb
            tables = 1 + np.arange(B * maxb).reshape(B, maxb)
        n = 1 + B * maxb
        return {"k_pool": torch.zeros((n, bs, Hkv, hd)),
                "v_pool": torch.zeros((n, bs, Hkv, hd)),
                "tables": torch.as_tensor(np.asarray(tables, np.int32))}

    @staticmethod
    def _jax(cache):
        return {k: jnp.asarray(v.numpy()) for k, v in cache.items()}

    @staticmethod
    def _same(tcache, jcache):
        for k in tcache:
            np.testing.assert_array_equal(tcache[k].numpy(),
                                          np.asarray(jcache[k]))

    def test_paged_matches_dense_scalar_and_vector_pos(self):
        B, Hkv, hd = 2, 2, 4
        paged = self._paged()
        dense = {"k": torch.zeros((B, 12, Hkv, hd)),
                 "v": torch.zeros((B, 12, Hkv, hd))}
        jpaged, jdense = self._jax(paged), self._jax(dense)
        rng = np.random.RandomState(0)
        for T, pos in ((5, 0), (1, np.array([5, 3], np.int32)),
                       (2, np.array([6, 9], np.int32))):
            k = rng.randn(B, T, Hkv, hd).astype(np.float32)
            v = rng.randn(B, T, Hkv, hd).astype(np.float32)
            tpos = pos if isinstance(pos, int) else torch.from_numpy(pos)
            jpos = pos if isinstance(pos, int) else jnp.asarray(pos)
            tk, tv = torch.from_numpy(k), torch.from_numpy(v)
            paged = tg.cache_append(paged, tk, tv, tpos)
            dense = tg.cache_append(dense, tk, tv, tpos)
            jpaged = jg.cache_append(jpaged, jnp.asarray(k), jnp.asarray(v),
                                     jpos)
            jdense = jg.cache_append(jdense, jnp.asarray(k), jnp.asarray(v),
                                     jpos)
        self._same(paged, jpaged)
        self._same(dense, jdense)
        pk, pv = tg.cache_read(paged)
        dk, dv = tg.cache_read(dense)
        assert pk.shape == dk.shape == (B, 12, Hkv, hd)
        assert torch.equal(pk, dk) and torch.equal(pv, dv)
        jk, jv = jg.cache_read(jpaged)
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))

    def test_dense_vector_writes_past_capacity_are_dropped(self):
        dense = {"k": torch.zeros((2, 4, 1, 2)),
                 "v": torch.zeros((2, 4, 1, 2))}
        jdense = self._jax(dense)
        for T in (1, 3):
            k = torch.ones((2, T, 1, 2)) * (T + 1)
            pos = np.array([4, 2], np.int32)  # row 0 entirely past C = 4
            dense = tg.cache_append(dense, k, k, torch.from_numpy(pos))
            jdense = jg.cache_append(jdense, jnp.asarray(k.numpy()),
                                     jnp.asarray(k.numpy()),
                                     jnp.asarray(pos))
        self._same(dense, jdense)
        assert torch.all(dense["k"][0] == 0)

    def test_out_of_table_writes_hit_only_the_trash_block(self):
        paged = self._paged(maxb=2)  # rows: [1,2], [3,4]; 8 logical slots
        jpaged = self._jax(paged)
        k = np.random.RandomState(1).randn(2, 4, 2, 4).astype(np.float32)
        # positions 6..9: 6, 7 in the table; 8, 9 overflow -> trash 0
        out = tg.cache_append(paged, torch.from_numpy(k),
                              torch.from_numpy(k), 6)
        jout = jg.cache_append(jpaged, jnp.asarray(k), jnp.asarray(k), 6)
        for name in ("k_pool", "v_pool"):  # trash rows race: compare 1..
            np.testing.assert_array_equal(out[name][1:].numpy(),
                                          np.asarray(jout[name])[1:])
        rk, _ = tg.cache_read(out)
        np.testing.assert_array_equal(rk[:, 6:8].numpy(), k[:, :2])
        kp = out["k_pool"].numpy()
        assert np.all(kp[1] == 0) and np.all(kp[3] == 0)
        assert np.all(kp[2, :2] == 0) and np.all(kp[4, :2] == 0)
        assert np.abs(kp[0]).sum() > 0  # trash absorbed the overflow

    def test_zero_table_entries_route_to_trash(self):
        paged = self._paged(maxb=2, tables=[[1, 0], [2, 0]])
        k = torch.ones((2, 1, 2, 4))
        out = tg.cache_append(paged, k, k, torch.tensor([4, 4]))
        kp = out["k_pool"].numpy()
        assert np.all(kp[1] == 0) and np.all(kp[2] == 0)  # real blocks clean
        assert np.abs(kp[0, 0]).sum() > 0  # landed in trash instead
