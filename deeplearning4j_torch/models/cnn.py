"""Zoo CNN models — counterpart of ``deeplearning4j_tpu/models/cnn.py``,
all twelve: LeNet, SimpleCNN, AlexNet, VGG16, VGG19, Darknet19, TinyYOLO,
YOLO2, ResNet50, GoogLeNet, InceptionResNetV1 and FaceNetNN4Small2, with
the same layers, node names, layer configs, anchors and updater (adam at
1e-3), so params, configs and zips cross between the packages."""

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


@register_model
class AlexNet(ZooModel):
    """zoo/model/AlexNet.java, with the LRN layers of the original: conv
    11x11/4 (96), LRN, max pool 3x3/2, conv 5x5 (256), LRN, max pool,
    three 3x3 convs (384, 384, 256), max pool, two Dense 4096 with dropout
    0.5 on their inputs, softmax output."""

    input_shape = (224, 224, 3)
    num_classes = 1000

    def build(self) -> Sequential:
        return (SequentialBuilder(_net_config(self.seed), device=self.device)
                .input_shape(*self.input_shape)
                .layer(L.Conv2D(n_out=96, kernel=(11, 11), stride=(4, 4),
                                padding="valid", activation="relu"))
                .layer(L.LRN())
                .layer(L.Subsampling2D(kernel=(3, 3), stride=(2, 2)))
                .layer(L.Conv2D(n_out=256, kernel=(5, 5), padding="same",
                                activation="relu"))
                .layer(L.LRN())
                .layer(L.Subsampling2D(kernel=(3, 3), stride=(2, 2)))
                .layer(L.Conv2D(n_out=384, kernel=(3, 3), padding="same",
                                activation="relu"))
                .layer(L.Conv2D(n_out=384, kernel=(3, 3), padding="same",
                                activation="relu"))
                .layer(L.Conv2D(n_out=256, kernel=(3, 3), padding="same",
                                activation="relu"))
                .layer(L.Subsampling2D(kernel=(3, 3), stride=(2, 2)))
                .layer(L.Flatten())
                .layer(L.Dense(n_out=4096, activation="relu", dropout=0.5))
                .layer(L.Dense(n_out=4096, activation="relu", dropout=0.5))
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


def _darknet_conv(b: SequentialBuilder, n_out: int, kernel: int):
    """DarknetHelper.addLayers: conv without bias, then BatchNorm with
    leaky ReLU."""
    b.layer(L.Conv2D(n_out=n_out, kernel=(kernel, kernel), padding="same",
                     use_bias=False, activation="identity"))
    b.layer(L.BatchNorm(activation="leakyrelu"))


@register_model
class Darknet19(ZooModel):
    """zoo/model/Darknet19.java: 18 darknet convs with five 2x2 max pools,
    a 1x1 conv to the classes, global average pooling and a softmax
    ``LossLayer``."""

    input_shape = (224, 224, 3)

    def build(self) -> Sequential:
        b = SequentialBuilder(_net_config(self.seed), device=self.device) \
            .input_shape(*self.input_shape)
        plan = [(32, 3, True), (64, 3, True),
                (128, 3, False), (64, 1, False), (128, 3, True),
                (256, 3, False), (128, 1, False), (256, 3, True),
                (512, 3, False), (256, 1, False), (512, 3, False),
                (256, 1, False), (512, 3, True),
                (1024, 3, False), (512, 1, False), (1024, 3, False),
                (512, 1, False), (1024, 3, False)]
        for n_out, k, pool in plan:
            _darknet_conv(b, n_out, k)
            if pool:
                b.layer(L.Subsampling2D(kernel=(2, 2), stride=(2, 2)))
        b.layer(L.Conv2D(n_out=self.num_classes, kernel=(1, 1),
                         padding="same", activation="identity"))
        b.layer(L.GlobalPooling(mode="avg"))
        b.layer(L.LossLayer(activation="softmax", loss="mcxent"))
        return b.build()


@register_model
class TinyYOLO(ZooModel):
    """zoo/model/TinyYOLO.java: a darknet-tiny backbone (six darknet convs
    with 2x2 max pools, the last one SAME at stride 1, then two 1024-wide
    convs), a 1x1 conv to 5 anchors x (5 + classes) and ``Yolo2Output``
    with the VOC anchors."""

    input_shape = (416, 416, 3)
    num_classes = 20
    anchors = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38), (9.42, 5.11),
               (16.62, 10.52))

    def build(self) -> Sequential:
        b = SequentialBuilder(_net_config(self.seed), device=self.device) \
            .input_shape(*self.input_shape)
        for n_out in [16, 32, 64, 128, 256]:
            _darknet_conv(b, n_out, 3)
            b.layer(L.Subsampling2D(kernel=(2, 2), stride=(2, 2)))
        _darknet_conv(b, 512, 3)
        b.layer(L.Subsampling2D(kernel=(2, 2), stride=(1, 1),
                                padding="same"))
        _darknet_conv(b, 1024, 3)
        _darknet_conv(b, 1024, 3)
        b.layer(L.Conv2D(n_out=len(self.anchors) * (5 + self.num_classes),
                         kernel=(1, 1), padding="same",
                         activation="identity"))
        b.layer(L.Yolo2Output(anchors=self.anchors))
        return b.build()


@register_model
class YOLO2(ZooModel):
    """zoo/model/YOLO2.java: the Darknet19 backbone as a graph (conv + BN
    + leaky ReLU blocks ``c1``-``c20``), the passthrough of ``c13``
    (26x26x512) through space-to-depth to 13x13x2048, concatenated before
    the trunk, ``c21``, a 1x1 conv to 5 anchors x (5 + classes) and
    ``Yolo2Output`` with the COCO anchors."""

    input_shape = (416, 416, 3)
    num_classes = 80
    anchors = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
               (7.88282, 3.52778), (9.77052, 9.16828))

    def build(self) -> Graph:
        g = GraphBuilder(_net_config(self.seed), device=self.device) \
            .add_input("in", self.input_shape)

        def conv_bn(name, inp, n_out, k, act="leakyrelu"):
            g.add_layer(f"{name}_conv", L.Conv2D(
                n_out=n_out, kernel=(k, k), padding="same", use_bias=False,
                activation="identity"), inp)
            g.add_layer(name, L.BatchNorm(activation=act), f"{name}_conv")
            return name

        def pool(name, inp):
            g.add_layer(name, L.Subsampling2D(kernel=(2, 2), stride=(2, 2)),
                        inp)
            return name

        x = pool("p1", conv_bn("c1", "in", 32, 3))
        x = pool("p2", conv_bn("c2", x, 64, 3))
        x = conv_bn("c3", x, 128, 3)
        x = conv_bn("c4", x, 64, 1)
        x = pool("p3", conv_bn("c5", x, 128, 3))
        x = conv_bn("c6", x, 256, 3)
        x = conv_bn("c7", x, 128, 1)
        x = pool("p4", conv_bn("c8", x, 256, 3))
        x = conv_bn("c9", x, 512, 3)
        x = conv_bn("c10", x, 256, 1)
        x = conv_bn("c11", x, 512, 3)
        x = conv_bn("c12", x, 256, 1)
        passthrough = conv_bn("c13", x, 512, 3)  # 26x26x512
        x = pool("p5", passthrough)
        x = conv_bn("c14", x, 1024, 3)
        x = conv_bn("c15", x, 512, 1)
        x = conv_bn("c16", x, 1024, 3)
        x = conv_bn("c17", x, 512, 1)
        x = conv_bn("c18", x, 1024, 3)
        x = conv_bn("c19", x, 1024, 3)
        x = conv_bn("c20", x, 1024, 3)
        g.add_layer("s2d", L.SpaceToDepth(block_size=2), passthrough)
        g.add_vertex("concat", V.Merge(), "s2d", x)
        x = conv_bn("c21", "concat", 1024, 3)
        g.add_layer("det", L.Conv2D(
            n_out=len(self.anchors) * (5 + self.num_classes), kernel=(1, 1),
            padding="same", activation="identity"), x)
        g.add_layer("out", L.Yolo2Output(anchors=self.anchors), "det")
        return g.set_outputs("out").build()


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


@register_model
class GoogLeNet(ZooModel):
    """zoo/model/GoogLeNet.java — inception-v1: stem convs and pools, nine
    inception modules (four branches merged), global average pooling,
    dropout 0.4, softmax output."""

    input_shape = (224, 224, 3)

    def build(self) -> Graph:
        g = GraphBuilder(_net_config(self.seed), device=self.device) \
            .add_input("in", self.input_shape)

        def conv(name, inp, n_out, k, stride=1, pad="same"):
            g.add_layer(name, L.Conv2D(n_out=n_out, kernel=(k, k),
                                       stride=(stride, stride), padding=pad,
                                       activation="relu"), inp)
            return name

        def pool(name, inp, stride):
            g.add_layer(name, L.Subsampling2D(kernel=(3, 3),
                                              stride=(stride, stride),
                                              padding="same"), inp)
            return name

        def inception(name, inp, c1, c3r, c3, c5r, c5, pp):
            b1 = conv(f"{name}_1", inp, c1, 1)
            b3 = conv(f"{name}_3", conv(f"{name}_3r", inp, c3r, 1), c3, 3)
            b5 = conv(f"{name}_5", conv(f"{name}_5r", inp, c5r, 1), c5, 5)
            bp = conv(f"{name}_pp", pool(f"{name}_p", inp, 1), pp, 1)
            g.add_vertex(name, V.Merge(), b1, b3, b5, bp)
            return name

        x = pool("pool1", conv("stem1", "in", 64, 7, stride=2), 2)
        x = conv("stem3", conv("stem2", x, 64, 1), 192, 3)
        x = pool("pool2", x, 2)
        x = inception("i3a", x, 64, 96, 128, 16, 32, 32)
        x = inception("i3b", x, 128, 128, 192, 32, 96, 64)
        x = pool("pool3", x, 2)
        x = inception("i4a", x, 192, 96, 208, 16, 48, 64)
        x = inception("i4b", x, 160, 112, 224, 24, 64, 64)
        x = inception("i4c", x, 128, 128, 256, 24, 64, 64)
        x = inception("i4d", x, 112, 144, 288, 32, 64, 64)
        x = inception("i4e", x, 256, 160, 320, 32, 128, 128)
        x = pool("pool4", x, 2)
        x = inception("i5a", x, 256, 160, 320, 32, 128, 128)
        x = inception("i5b", x, 384, 192, 384, 48, 128, 128)
        g.add_layer("gap", L.GlobalPooling(mode="avg"), x)
        g.add_layer("drop", L.DropoutLayer(rate=0.4), "gap")
        g.add_layer("out", L.Output(n_out=self.num_classes,
                                    activation="softmax", loss="mcxent"),
                    "drop")
        return g.set_outputs("out").build()


@register_model
class InceptionResNetV1(ZooModel):
    """zoo/model/InceptionResNetV1.java — a residual inception net for face
    embeddings: a conv + BN stem, five Inception-ResNet-A blocks (three
    towers merged, a 1x1 conv, scaled by 0.17 and added to the block's
    input), global average pooling, a Dense embedding and its L2 norm."""

    input_shape = (160, 160, 3)
    num_classes = 128  # the embedding size

    def build(self) -> Graph:
        g = GraphBuilder(_net_config(self.seed), device=self.device) \
            .add_input("in", self.input_shape)

        def conv_bn(name, inp, n_out, k, stride=1, act="relu", pad="same"):
            g.add_layer(f"{name}_c", L.Conv2D(
                n_out=n_out, kernel=(k, k) if isinstance(k, int) else k,
                stride=(stride, stride), padding=pad, use_bias=False,
                activation="identity"), inp)
            g.add_layer(name, L.BatchNorm(activation=act), f"{name}_c")
            return name

        def block35(name, inp, channels):
            b0 = conv_bn(f"{name}_b0", inp, 32, 1)
            b1 = conv_bn(f"{name}_b1b", conv_bn(f"{name}_b1a", inp, 32, 1),
                         32, 3)
            b2 = conv_bn(f"{name}_b2c", conv_bn(
                f"{name}_b2b", conv_bn(f"{name}_b2a", inp, 32, 1), 32, 3),
                32, 3)
            g.add_vertex(f"{name}_cat", V.Merge(), b0, b1, b2)
            g.add_layer(f"{name}_up", L.Conv2D(
                n_out=channels, kernel=(1, 1), padding="same",
                activation="identity"), f"{name}_cat")
            g.add_vertex(f"{name}_scale", V.Scale(factor=0.17), f"{name}_up")
            g.add_vertex(f"{name}_add", V.ElementWise(op="add"), inp,
                         f"{name}_scale")
            g.add_layer(name, L.ActivationLayer(activation="relu"),
                        f"{name}_add")
            return name

        x = conv_bn("stem1", "in", 32, 3, stride=2)
        x = conv_bn("stem2", x, 32, 3)
        x = conv_bn("stem3", x, 64, 3)
        g.add_layer("pool1", L.Subsampling2D(kernel=(3, 3), stride=(2, 2),
                                             padding="same"), x)
        x = conv_bn("stem4", "pool1", 80, 1)
        x = conv_bn("stem5", x, 192, 3)
        x = conv_bn("stem6", x, 256, 3, stride=2)
        for i in range(5):
            x = block35(f"a{i}", x, 256)
        g.add_layer("gap", L.GlobalPooling(mode="avg"), x)
        g.add_layer("emb", L.Dense(n_out=self.num_classes,
                                   activation="identity"), "gap")
        g.add_vertex("out", V.L2Norm(), "emb")
        return g.set_outputs("out").build()


@register_model
class FaceNetNN4Small2(ZooModel):
    """zoo/model/FaceNetNN4Small2.java — the nn4.small2 face-embedding
    net: a conv + BN stem, five inception modules (branches merged, some
    without the 1x1 or 5x5 branch), global average pooling, a Dense
    embedding and its L2 norm."""

    input_shape = (96, 96, 3)
    num_classes = 128

    def build(self) -> Graph:
        g = GraphBuilder(_net_config(self.seed), device=self.device) \
            .add_input("in", self.input_shape)

        def conv_bn(name, inp, n_out, k, stride=1):
            g.add_layer(f"{name}_c", L.Conv2D(
                n_out=n_out, kernel=(k, k), stride=(stride, stride),
                padding="same", use_bias=False, activation="identity"), inp)
            g.add_layer(name, L.BatchNorm(activation="relu"), f"{name}_c")
            return name

        def pool(name, inp, stride):
            g.add_layer(name, L.Subsampling2D(kernel=(3, 3),
                                              stride=(stride, stride),
                                              padding="same"), inp)
            return name

        def inception(name, inp, c1, c3r, c3, c5r, c5, pp):
            branches = []
            if c1:
                branches.append(conv_bn(f"{name}_1", inp, c1, 1))
            branches.append(conv_bn(f"{name}_3",
                                    conv_bn(f"{name}_3r", inp, c3r, 1), c3, 3))
            if c5:
                branches.append(conv_bn(
                    f"{name}_5", conv_bn(f"{name}_5r", inp, c5r, 1), c5, 5))
            branches.append(conv_bn(f"{name}_pp", pool(f"{name}_p", inp, 1),
                                    pp, 1))
            g.add_vertex(name, V.Merge(), *branches)
            return name

        x = pool("p1", conv_bn("c1", "in", 64, 7, stride=2), 2)
        x = conv_bn("c2", x, 64, 1)
        x = pool("p2", conv_bn("c3", x, 192, 3), 2)
        x = inception("i3a", x, 64, 96, 128, 16, 32, 32)
        x = inception("i3b", x, 64, 96, 128, 32, 64, 64)
        x = pool("p3", x, 2)
        x = inception("i4a", x, 256, 96, 192, 32, 64, 128)
        x = inception("i4e", x, 0, 160, 256, 64, 128, 128)
        x = pool("p4", x, 2)
        x = inception("i5a", x, 256, 96, 384, 0, 0, 96)
        g.add_layer("gap", L.GlobalPooling(mode="avg"), x)
        g.add_layer("emb", L.Dense(n_out=self.num_classes,
                                   activation="identity"), "gap")
        g.add_vertex("out", V.L2Norm(), "emb")
        return g.set_outputs("out").build()
