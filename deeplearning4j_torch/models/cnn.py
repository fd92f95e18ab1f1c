"""Zoo CNN models — counterpart of ``LeNet``, ``SimpleCNN``, ``VGG16``,
``VGG19`` and ``ResNet50`` in ``deeplearning4j_tpu/models/cnn.py``: the
same layers, node names, layer configs and updater (adam at 1e-3), so
params, configs and zips cross between the packages. The other CNNs of
the reference's zoo are not ported yet (ROADMAP.md, Queue 1, "The rest of
``models/cnn.py`` and ``models/zoo.py``")."""

from __future__ import annotations

from typing import Sequence

from ..nn import layers as L
from ..nn import vertices as V
from ..nn.model import (Graph, GraphBuilder, NetConfig, Sequential,
                        SequentialBuilder)
from .zoo import ZooModel, register_model


def _net_config(seed, updater=None, **kw):
    return NetConfig(seed=seed, updater=updater or {"type": "adam",
                                                    "learning_rate": 1e-3},
                     **kw)


@register_model
class LeNet(ZooModel):
    """zoo/model/LeNet.java: two 5x5 conv + 2x2 max pool stages (20, 50
    channels), Dense 500, softmax output."""

    input_shape = (28, 28, 1)
    num_classes = 10

    def build(self) -> Sequential:
        return (SequentialBuilder(_net_config(self.seed), device=self.device)
                .input_shape(*self.input_shape)
                .layer(L.Conv2D(n_out=20, kernel=(5, 5), stride=(1, 1),
                                padding="same", activation="relu"))
                .layer(L.Subsampling2D(kernel=(2, 2), stride=(2, 2)))
                .layer(L.Conv2D(n_out=50, kernel=(5, 5), stride=(1, 1),
                                padding="same", activation="relu"))
                .layer(L.Subsampling2D(kernel=(2, 2), stride=(2, 2)))
                .layer(L.Flatten())
                .layer(L.Dense(n_out=500, activation="relu"))
                .layer(L.Output(n_out=self.num_classes, activation="softmax",
                                loss="mcxent"))
                .build())


@register_model
class SimpleCNN(ZooModel):
    """zoo/model/SimpleCNN.java: three pairs of 3x3 conv + BatchNorm
    (16, 32, 64 channels) with a max pool after each pair, global average
    pooling, dropout 0.5, softmax output."""

    input_shape = (48, 48, 3)
    num_classes = 10

    def build(self) -> Sequential:
        b = (SequentialBuilder(_net_config(self.seed), device=self.device)
             .input_shape(*self.input_shape))
        for n_out, pool in [(16, False), (16, True), (32, False), (32, True),
                            (64, False), (64, True)]:
            b.layer(L.Conv2D(n_out=n_out, kernel=(3, 3), padding="same",
                             activation="identity"))
            b.layer(L.BatchNorm(activation="relu"))
            if pool:
                b.layer(L.Subsampling2D(kernel=(2, 2), stride=(2, 2)))
        return (b.layer(L.GlobalPooling(mode="avg"))
                .layer(L.DropoutLayer(rate=0.5))
                .layer(L.Output(n_out=self.num_classes, activation="softmax",
                                loss="mcxent"))
                .build())


def _vgg(seed, input_shape, num_classes, cfg: Sequence,
         device=None) -> Sequential:
    """A VGG stack: 3x3 same convs (an int in ``cfg``) and 2x2 max pools
    ("M"), then two Dense 4096 with dropout 0.5 on their inputs and a
    softmax output."""
    b = SequentialBuilder(_net_config(seed), device=device) \
        .input_shape(*input_shape)
    for item in cfg:
        if item == "M":
            b.layer(L.Subsampling2D(kernel=(2, 2), stride=(2, 2)))
        else:
            b.layer(L.Conv2D(n_out=item, kernel=(3, 3), padding="same",
                             activation="relu"))
    return (b.layer(L.Flatten())
            .layer(L.Dense(n_out=4096, activation="relu", dropout=0.5))
            .layer(L.Dense(n_out=4096, activation="relu", dropout=0.5))
            .layer(L.Output(n_out=num_classes, activation="softmax",
                            loss="mcxent"))
            .build())


@register_model
class VGG16(ZooModel):
    """zoo/model/VGG16.java."""

    input_shape = (224, 224, 3)

    def build(self) -> Sequential:
        return _vgg(self.seed, self.input_shape, self.num_classes,
                    [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                     512, 512, 512, "M", 512, 512, 512, "M"],
                    device=self.device)


@register_model
class VGG19(ZooModel):
    """zoo/model/VGG19.java."""

    input_shape = (224, 224, 3)

    def build(self) -> Sequential:
        return _vgg(self.seed, self.input_shape, self.num_classes,
                    [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                     512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
                    device=self.device)


@register_model
class ResNet50(ZooModel):
    """zoo/model/ResNet50.java — bottleneck v1 graph: conv 7x7/2 + BN +
    ReLU, max pool 3x3/2, stages [3, 4, 6, 3] at widths (64/256, 128/512,
    256/1024, 512/2048), global average pool, softmax output."""

    input_shape = (224, 224, 3)

    def build(self) -> Graph:
        g = GraphBuilder(_net_config(self.seed), device=self.device) \
            .add_input("in", self.input_shape)

        def conv_bn(name, inp, n_out, k, stride=1, act="relu"):
            g.add_layer(f"{name}_c", L.Conv2D(
                n_out=n_out, kernel=(k, k), stride=(stride, stride),
                padding="same", use_bias=False, activation="identity"), inp)
            g.add_layer(name, L.BatchNorm(activation=act), f"{name}_c")
            return name

        def bottleneck(name, inp, mid, out, stride=1, project=False):
            a = conv_bn(f"{name}_a", inp, mid, 1, stride)
            b = conv_bn(f"{name}_b", a, mid, 3)
            g.add_layer(f"{name}_cc", L.Conv2D(
                n_out=out, kernel=(1, 1), padding="same", use_bias=False,
                activation="identity"), b)
            g.add_layer(f"{name}_cbn", L.BatchNorm(activation="identity"),
                        f"{name}_cc")
            sc = (conv_bn(f"{name}_proj", inp, out, 1, stride, act="identity")
                  if project else inp)
            g.add_vertex(f"{name}_add", V.ElementWise(op="add"),
                         f"{name}_cbn", sc)
            g.add_layer(name, L.ActivationLayer(activation="relu"),
                        f"{name}_add")
            return name

        x = conv_bn("stem", "in", 64, 7, stride=2)
        g.add_layer("pool1", L.Subsampling2D(kernel=(3, 3), stride=(2, 2),
                                             padding="same"), x)
        x = "pool1"
        stages = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2),
                  (3, 512, 2048, 2)]
        for si, (blocks, mid, out, stride) in enumerate(stages):
            for bi in range(blocks):
                x = bottleneck(f"s{si}b{bi}", x, mid, out,
                               stride=stride if bi == 0 else 1,
                               project=bi == 0)
        g.add_layer("gap", L.GlobalPooling(mode="avg"), x)
        g.add_layer("out", L.Output(n_out=self.num_classes,
                                    activation="softmax", loss="mcxent"),
                    "gap")
        return g.set_outputs("out").build()
