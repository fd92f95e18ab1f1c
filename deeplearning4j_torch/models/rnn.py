"""Sequence zoo models — counterpart of ``deeplearning4j_tpu/models/rnn.py``:
``TextGenerationLSTM`` and the GravesLSTM char-RNN, with the reference's
layers, updaters and tBPTT lengths, so configs, params and zips cross
between the packages."""

from __future__ import annotations

from ..nn import layers as L
from ..nn.model import NetConfig, Sequential, SequentialBuilder
from .zoo import ZooModel, register_model


@register_model
class TextGenerationLSTM(ZooModel):
    """zoo/model/TextGenerationLSTM.java: 2 x LSTM(256) over (T, V) one-hot
    characters, softmax output, adam 1e-3."""

    input_shape = (64, 77)
    num_classes = 77

    def build(self) -> Sequential:
        T, V = self.input_shape
        cfg = NetConfig(seed=self.seed,
                        tbptt_length=self.kwargs.get("tbptt", 0),
                        updater={"type": "adam", "learning_rate": 1e-3})
        return (SequentialBuilder(cfg, device=self.device)
                .input_shape(T, V)
                .layer(L.LSTM(n_out=256))
                .layer(L.LSTM(n_out=256))
                .layer(L.RnnOutput(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent"))
                .build())


@register_model
class GravesLSTMCharRNN(ZooModel):
    """The GravesLSTM char-RNN of dl4j-examples'
    GravesLSTMCharModellingExample: 2 x GravesLSTM(200) over (64, 98)
    one-hot characters, softmax output, rmsprop 0.1, tBPTT of 50 steps
    (``tbptt=0`` trains full BPTT)."""

    input_shape = (64, 98)
    num_classes = 98
    hidden = 200

    def build(self) -> Sequential:
        T, V = self.input_shape
        unroll = self.kwargs.get("scan_unroll", 1)
        cfg = NetConfig(seed=self.seed,
                        tbptt_length=self.kwargs.get("tbptt", 50),
                        updater={"type": "rmsprop", "learning_rate": 1e-1})
        return (SequentialBuilder(cfg, device=self.device)
                .input_shape(T, V)
                .layer(L.GravesLSTM(n_out=self.hidden, scan_unroll=unroll))
                .layer(L.GravesLSTM(n_out=self.hidden, scan_unroll=unroll))
                .layer(L.RnnOutput(n_out=self.num_classes,
                                   activation="softmax", loss="mcxent"))
                .build())
