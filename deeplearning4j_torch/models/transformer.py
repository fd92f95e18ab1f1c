"""Transformer models — counterpart of ``BertBase``, ``CausalLM`` and
``sharded_lm_step`` in ``deeplearning4j_tpu/models/transformer.py``: the
same layer stacks and updaters, so params, configs and zips cross between
the packages."""

from __future__ import annotations

from ..nn import layers as L
from ..nn.model import NetConfig, Sequential, SequentialBuilder
from .zoo import ZooModel, register_model


@register_model
class BertBase(ZooModel):
    """BERT-base-uncased shape: 12 layers, d_model 768, 12 heads, vocab
    30522, learned positions up to 512, non-causal pre-LN blocks, a final
    LayerNorm, masked average pooling and a softmax classification head
    (adamw 1e-4). ``small=True`` is the test-sized variant (2 layers,
    d_model 64, 4 heads, vocab 1000, max_len 128). ``ragged=True`` (the
    default) declares (B, T) masks right-padded, as BERT tokenizers pad:
    the flash path then takes per-example lengths; ``ragged=False`` keeps
    the exact key mask for gappy masks."""

    num_layers = 12
    d_model = 768
    num_heads = 12
    vocab = 30522
    max_len = 512
    input_shape = (128,)
    num_classes = 2

    def __init__(self, num_classes=None, seed=12345, input_shape=None, *,
                 small=False, flash=False, remat=False, ragged=True,
                 device=None, **kw):
        super().__init__(num_classes, seed, input_shape, device=device, **kw)
        self.flash = flash
        self.remat = remat
        self.ragged = ragged
        if small:
            (self.num_layers, self.d_model, self.num_heads, self.vocab,
             self.max_len) = 2, 64, 4, 1000, 128

    def build(self) -> Sequential:
        T = self.input_shape[0]
        b = (SequentialBuilder(NetConfig(seed=self.seed,
                                         updater={"type": "adamw",
                                                  "learning_rate": 1e-4}),
                               device=self.device)
             .input_shape(T)
             .layer(L.EmbeddingSequence(n_in=self.vocab, n_out=self.d_model))
             .layer(L.PositionalEmbedding(max_len=self.max_len)))
        for _ in range(self.num_layers):
            b.layer(L.TransformerEncoderBlock(
                num_heads=self.num_heads, causal=False, flash=self.flash,
                remat=self.remat, ragged=self.ragged))
        return (b.layer(L.LayerNorm())
                .layer(L.GlobalPooling(mode="avg"))
                .layer(L.Output(n_out=self.num_classes, activation="softmax",
                                loss="mcxent"))
                .build())


@register_model
class CausalLM(ZooModel):
    """GPT-style causal LM: embedding, learned positions (or rope),
    pre-LN blocks, LayerNorm, per-token softmax over the vocabulary."""

    num_layers = 4
    d_model = 256
    num_heads = 8
    vocab = 512
    input_shape = (256,)

    def __init__(self, num_classes=None, seed=12345, input_shape=None, *,
                 num_layers=None, d_model=None, num_heads=None, vocab=None,
                 flash=False, remat=False, ring=False, pos="learned",
                 num_kv_heads=None, window=None, device=None, **kw):
        super().__init__(num_classes, seed, input_shape, device=device, **kw)
        self.num_layers = num_layers or self.num_layers
        self.d_model = d_model or self.d_model
        self.num_heads = num_heads or self.num_heads
        self.vocab = vocab or self.vocab
        self.num_classes = self.vocab
        self.flash = flash
        self.remat = remat
        self.ring = ring
        if pos not in ("learned", "rope"):
            raise ValueError(f"pos must be 'learned' or 'rope', got {pos!r}")
        self.pos = pos
        self.num_kv_heads = num_kv_heads
        self.window = window

    def build(self) -> Sequential:
        T = self.input_shape[0]
        b = (SequentialBuilder(NetConfig(seed=self.seed,
                                         updater={"type": "adamw",
                                                  "learning_rate": 3e-4}),
                               device=self.device)
             .input_shape(T)
             .layer(L.EmbeddingSequence(n_in=self.vocab, n_out=self.d_model)))
        rope = self.pos == "rope"
        if not rope:
            b.layer(L.PositionalEmbedding(max_len=max(T, 512)))
        for _ in range(self.num_layers):
            b.layer(L.TransformerEncoderBlock(
                num_heads=self.num_heads, causal=True, flash=self.flash,
                remat=self.remat, ring=self.ring, rope=rope,
                num_kv_heads=self.num_kv_heads, window=self.window))
        b.layer(L.LayerNorm())
        b.layer(L.RnnOutput(n_out=self.vocab, activation="softmax",
                            loss="mcxent"))
        return b.build()


def sharded_lm_step(model: Sequential, mesh, tx):
    """A dp x tp x sp train step for a language model over ``mesh``: params
    sharded per ``TRANSFORMER_RULES`` over ``model``, batches over
    ``data``, sequences over ``seq``. A thin wrapper over the one sharding
    API (``Trainer(mesh=, rules=TRANSFORMER_RULES)``, whose machinery it
    uses). Returns ``(step, params, opt_state, place_batch)``:
    ``step(params, opt_state, tokens, targets, rng=None) -> (params,
    opt_state, loss)`` updates this rank's shards in place (the loss is
    the global batch's, a 0-d device tensor); ``place_batch(tokens,
    targets)`` gives this rank's block of a global batch. ``step.trainer``
    is the trainer underneath (``full_params()`` gathers the shards)."""
    if model.params is None:
        raise ValueError("init() the model first")
    from ..parallel.sharding import TRANSFORMER_RULES
    from ..train.trainer import Trainer

    trainer = Trainer(model, updater=tx, mesh=mesh, rules=TRANSFORMER_RULES)

    def step(params, opt_state, tokens, targets, rng=None):
        params, opt_state, _, loss = trainer.step(
            params, opt_state, {}, tokens, targets,
            trainer._gen if rng is None else rng)
        return params, opt_state, loss

    def place_batch(tokens, targets):
        x, y, _, _ = trainer._rank_batch((tokens, targets, None, None))
        return x, y

    step.trainer = trainer
    return step, trainer.params, trainer.opt_state, place_batch
