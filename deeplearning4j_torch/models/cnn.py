"""Zoo CNN models — counterpart of ``ResNet50`` in
``deeplearning4j_tpu/models/cnn.py``: the same graph, node names, layer
configs and updater (adam at 1e-3), so params and configs cross between
the packages. The other CNNs of the reference's zoo are not ported yet
(ROADMAP.md, Queue 1, "The rest of ``models/cnn.py`` and
``models/zoo.py``")."""

from __future__ import annotations

from ..nn import layers as L
from ..nn import vertices as V
from ..nn.model import Graph, GraphBuilder, NetConfig
from .zoo import ZooModel, register_model


def _net_config(seed, updater=None, **kw):
    return NetConfig(seed=seed, updater=updater or {"type": "adam",
                                                    "learning_rate": 1e-3},
                     **kw)


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
