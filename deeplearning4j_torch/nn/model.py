"""Network containers — counterpart of ``Sequential``, ``Graph``, their
builders and ``NetConfig`` in ``deeplearning4j_tpu/nn/model.py``.

A container is a config plus pure functions over a params dict keyed by
layer name (``layer_i`` unless the layer is named; a ``Graph``'s node
name), the reference's tree: params cross between the packages key for
key. ``to_json``/``from_json`` write and read the reference's
``deeplearning4j_tpu/sequential/v1`` and ``deeplearning4j_tpu/graph/v1``
formats.

Mixed precision follows the reference: with ``compute_dtype`` set, each
layer's float params are cast to it at the layer, a float input is cast,
and the output is cast back to ``dtype``. ``Sequential.score`` runs every
layer but the last that way and then the output layer on the f32 features
with its uncast params, as the reference does: a bf16 ``Sequential``'s
training loss (the head and its log-softmax) is f32. ``Graph.score`` runs
its output layers in the compute dtype too, with cast params, and casts
each loss to f32 before summing, as the reference's ``Graph.score`` does.
``NetConfig.remat`` checkpoints each layer through
``torch.utils.checkpoint``.
"""

from __future__ import annotations

import contextvars
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.utils.checkpoint

from ..device import DeviceLike, resolve_device
from ..ops.losses import reduction_mass
from .api import (Layer, Params, Shape, State, apply_input_dropout,
                  draws_random, layer_from_dict, rewinding)
from .layers.recurrent import RecurrentLayer
from .vertices import GraphVertex, vertex_from_dict

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}
FORMAT = "deeplearning4j_tpu/sequential/v1"
GRAPH_FORMAT = "deeplearning4j_tpu/graph/v1"


def _cast_floats(tree, cdt):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, cdt) for k, v in tree.items()}
    return tree.to(cdt) if tree.is_floating_point() else tree


def _tree_shapes(tree):
    if isinstance(tree, dict):
        return {k: _tree_shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _tree_size(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_size(v) for v in tree.values())
    return tree.numel()


@dataclass
class NetConfig:
    """Global config (the reference's fields, so its JSON round-trips)."""

    seed: int = 12345
    dtype: str = "float32"
    updater: Union[str, dict] = field(
        default_factory=lambda: {"type": "sgd", "learning_rate": 1e-1})
    l1: float = 0.0
    l2: float = 0.0
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    tbptt_length: int = 0
    compute_dtype: Optional[str] = None  # e.g. "bfloat16"
    remat: bool = False

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


def _layer_key(i: int, layer: Layer) -> str:
    return layer.name or f"layer_{i}"


def _is_loss_layer(layer) -> bool:
    return hasattr(layer, "score")


# The layer hook of a sharded step (``parallel.sharding.MeshContext``,
# installed by ``activation_sharding``): called around every layer of a
# Sequential or Graph as ``hook(run, layer, key, params, x, mask, index)``
# with ``run(params, x, mask)`` the plain application, it picks the
# layer's tensor- and sequence-parallel layout; the reference's hook pins
# each layer output's sharding. None: no hook. A ContextVar, as in the
# reference.
ACTIVATION_CONSTRAINT: "contextvars.ContextVar" = contextvars.ContextVar(
    "dl4j_torch_activation_constraint", default=None)


def _run_layer(cfg: NetConfig, layer: Layer, key, p, s, x, *, training, rng,
               mask, index):
    """:func:`_apply_layer`, through the sharded step's hook when one is
    installed."""
    hook = ACTIVATION_CONSTRAINT.get()
    if hook is None:
        return _apply_layer(cfg, layer, p, s, x, training=training, rng=rng,
                            mask=mask)
    return hook(lambda p_, x_, m_: _apply_layer(
        cfg, layer, p_, s, x_, training=training, rng=rng, mask=m_),
        layer, key, p, x, mask, index)


def _loss_params(key, p):
    """An output layer's params for its score: gathered by the sharded
    step's hook where the rules shard them."""
    hook = ACTIVATION_CONSTRAINT.get()
    return p if hook is None else hook.params_of(key, p)


def _apply_layer(cfg: NetConfig, layer: Layer, p, s, x, *, training, rng,
                 mask):
    """One layer, checkpointed when ``cfg.remat`` asks for it — unless the
    layer checkpoints itself (its own ``remat=True``): nesting would
    recompute twice for no memory saved. Checkpointing only applies while
    autograd records; a layer that draws from ``rng`` recomputes with the
    draws of its forward (:func:`rewinding`)."""
    if cfg.remat and not getattr(layer, "remat", False) \
            and torch.is_grad_enabled():
        fn = lambda p_, x_: layer.apply(p_, s, x_, training=training,
                                        rng=rng, mask=mask)
        if training and draws_random(layer):
            fn = rewinding(fn, rng)
        return torch.utils.checkpoint.checkpoint(fn, p, x,
                                                 use_reentrant=False)
    return layer.apply(p, s, x, training=training, rng=rng, mask=mask)


class _SingleBatch:
    """One-DataSet iterator for the fit(x, y) / fit(DataSet) overloads."""

    def __init__(self, ds):
        self.ds = ds

    def __iter__(self):
        return iter([self.ds])

    def reset(self):
        pass


class TrainableModel:
    """The ``net.fit(iterator)`` front door (the reference's
    ``TrainableModel``): builds and caches ONE ``Trainer``, so repeated
    fits resume — params, updater state, the generator's stream and the
    iteration count carry across calls, as refitting the same network
    object does. ``net.trainer()`` exposes the cached one; evaluation and
    scoring go through it when it exists, and otherwise run at the model's
    own params and state (no updater state is made)."""

    _trainer = None
    _trainer_kw = None

    def trainer(self, reset: bool = False, **kw):
        """The cached Trainer (built on first use, seeded from
        ``config.seed``). A call with no kwargs always returns the cached
        one; different kwargs rebuild it, which resets the updater state,
        the generator and the iteration count (with a warning when the old
        trainer has trained, unless ``reset=True`` acknowledges it); the
        same kwargs reuse it. ``reset=True`` forces a rebuild, with the
        cached kwargs when none are given."""
        if not kw and self._trainer is not None and not reset:
            return self._trainer
        if reset and not kw and self._trainer_kw is not None:
            kw = dict(self._trainer_kw)
        kw.setdefault("seed", self.config.seed)
        if self._trainer is None or reset or kw != self._trainer_kw:
            from ..train.trainer import Trainer

            old = self._trainer
            if (old is not None and getattr(old, "iteration", 0) > 0
                    and not reset):
                import warnings

                warnings.warn(
                    f"net.trainer(**{kw!r}) discards the existing trainer at "
                    f"iteration {old.iteration} — optimizer state, rng "
                    f"stream and iteration count reset. Pass reset=True to "
                    f"acknowledge, or call net.trainer() with no kwargs to "
                    f"keep training with the current one.", stacklevel=2)
            self._trainer = Trainer(self, **kw)
            self._trainer_kw = dict(kw)
        return self._trainer

    def fit(self, data, labels=None, epochs: int = 1, **kw):
        """fit(iterator), fit(iterator, num_epochs), fit(DataSet) or
        fit(x, y), the reference's overloads; other keywords go to
        ``Trainer.fit``. Arrays or a single DataSet train as one full
        batch per epoch."""
        from ..data.iterators import DataSet

        if isinstance(labels, int):  # fit(iterator, numEpochs)
            labels, epochs = None, labels
        it = data
        if labels is not None:
            if not hasattr(data, "shape") or not hasattr(labels, "shape"):
                raise TypeError(
                    "fit(x, y) expects two arrays; to set the epoch count "
                    "use fit(iterator, epochs=N)")
            it = _SingleBatch(DataSet(data, labels))
            kw.setdefault("prefetch", False)  # nothing to prefetch
        elif isinstance(data, DataSet):
            it = _SingleBatch(data)
            kw.setdefault("prefetch", False)
        return self.trainer().fit(it, epochs=epochs, **kw)

    def evaluate(self, iterator, evaluation=None):
        """Streaming evaluation of the primary output (an ``Evaluation``
        unless one is given)."""
        if self._trainer is not None:
            return self._trainer.evaluate(iterator, evaluation)
        from ..train.trainer import evaluate_model

        if self.params is None:
            self.init()
        return evaluate_model(self, self.params, self.state, iterator,
                              evaluation)

    def output_iterator(self, iterator):
        """Inference outputs over an iterator, batches concatenated along
        axis 0 (``output(DataSetIterator)``): one tensor for a Sequential,
        a list of all the outputs for a Graph. A fit leaves the model's
        params and state the trainer's own."""
        from ..train.staging import BatchStager
        from ..train.trainer import unpack_batch

        if self.params is None:
            self.init()
        stage = BatchStager(self.device)
        chunks = []
        with torch.no_grad():
            for ds in iterator:
                x, _, fm, _ = unpack_batch(self, ds)
                x, fm = stage(x), stage(fm)
                if isinstance(self, Graph):
                    chunks.append(self.forward(self.params, self.state, x,
                                               training=False, masks=fm)[0])
                else:
                    chunks.append(self.forward(self.params, self.state, x,
                                               training=False, mask=fm)[0])
        if hasattr(iterator, "reset"):
            iterator.reset()
        if not chunks:
            return []
        if isinstance(chunks[0], (list, tuple)):  # Graph: all outputs
            return [torch.cat([c[i] for c in chunks], dim=0)
                    for i in range(len(chunks[0]))]
        return torch.cat(chunks, dim=0)

    def score_iterator(self, iterator) -> float:
        """The average inference-mode loss over an iterator."""
        if self._trainer is not None:
            return self._trainer.score_iterator(iterator)
        from ..train.trainer import score_model

        if self.params is None:
            self.init()
        return score_model(self, self.params, self.state, iterator)


class Sequential(TrainableModel):
    """An ordered stack of layers on one device (the card unless
    ``device`` names another)."""

    def __init__(self, config: NetConfig, layers: Sequence[Layer],
                 input_shape: Shape, device: DeviceLike = None):
        self.config = config
        self.layers = list(layers)
        self.input_shape = tuple(input_shape)
        self.device = resolve_device(device)
        self.dtype = DTYPES[config.dtype]
        self._shapes = [self.input_shape]
        for layer in self.layers:
            self._shapes.append(tuple(layer.output_shape(self._shapes[-1])))
        self.params: Optional[Params] = None
        self.state: Optional[State] = None

    @property
    def output_shape(self) -> Shape:
        return self._shapes[-1]

    def layer_input_shape(self, i: int) -> Shape:
        return self._shapes[i]

    def _init_on(self, gen, device) -> Tuple[Params, State]:
        params: Params = {}
        state: State = {}
        for i, layer in enumerate(self.layers):
            p, s = layer.init(gen, self._shapes[i], self.dtype, device)
            if p:
                params[_layer_key(i, layer)] = p
            if s:
                state[_layer_key(i, layer)] = s
        return params, state

    def init(self, seed: Optional[int] = None) -> Tuple[Params, State]:
        """Random params on the model's device from a ``torch.Generator``
        seeded with ``seed`` (default ``config.seed``)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed if seed is None else seed)
        self.params, self.state = self._init_on(gen, self.device)
        return self.params, self.state

    def param_shapes(self) -> Dict[str, dict]:
        """The params tree's shapes, computed without allocating."""
        return _tree_shapes(self._init_on(None, torch.device("meta"))[0])

    def param_count(self) -> int:
        if self.params is None:
            raise ValueError("call init() first")
        return _tree_size(self.params)

    def forward(self, params: Params, state: State, x: torch.Tensor, *,
                training: bool = False, rng: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None,
                up_to: Optional[int] = None, return_mask: bool = False):
        """Apply the first ``up_to`` layers (default all); returns
        ``(y, new_state)``, plus the layer-propagated mask with
        ``return_mask=True`` (the mask the loss reduces with)."""
        n = len(self.layers) if up_to is None else up_to
        new_state = dict(state)
        cdt = DTYPES[self.config.compute_dtype] if self.config.compute_dtype else None
        if cdt is not None and x.is_floating_point():
            x = x.to(cdt)
        for i in range(n):
            layer = self.layers[i]
            k = _layer_key(i, layer)
            p = params.get(k, {})
            if cdt is not None:
                p = _cast_floats(p, cdt)
            x, s_out, mask = _run_layer(self.config, layer, k, p,
                                        state.get(k, {}), x,
                                        training=training, rng=rng,
                                        mask=mask, index=i)
            if s_out:
                new_state[k] = s_out
        if cdt is not None:
            x = x.to(self.dtype)
        if return_mask:
            return x, new_state, mask
        return x, new_state

    def activations(self, params: Params, state: State, x, **kw
                    ) -> List[torch.Tensor]:
        """Each layer's output in order (the feedForward list), for
        listeners and debugging: the layers applied one by one with
        ``kw`` (``training``, ``rng``, ``mask``), without casting to
        ``compute_dtype``, as the reference's."""
        outs = []
        mask = kw.pop("mask", None)
        for i, layer in enumerate(self.layers):
            k = _layer_key(i, layer)
            x, _, mask = layer.apply(params.get(k, {}), state.get(k, {}), x,
                                     mask=mask, **kw)
            outs.append(x)
        return outs

    def score(self, params: Params, state: State, x: torch.Tensor,
              labels: torch.Tensor, *, training: bool = True,
              rng: Optional[torch.Generator] = None,
              mask: Optional[torch.Tensor] = None,
              label_mask: Optional[torch.Tensor] = None,
              with_mass: bool = False):
        """Training loss (a 0-d f32 tensor) and the new state. The loss
        reduces with ``label_mask`` when given, else with the
        layer-propagated feature mask. The output layer scores the f32
        features with its f32 params, whatever ``compute_dtype`` is.
        ``with_mass=True`` also returns ``losses.reduction_mass``."""
        (loss,), (reduction,), aux, new_state = self.score_parts(
            params, state, x, labels, training=training, rng=rng, mask=mask,
            label_mask=label_mask)
        if aux is not None:  # an MoE's load-balancing loss
            loss = loss + aux
        if with_mass:
            return loss, new_state, reduction_mass(*reduction)
        return loss, new_state

    def score_parts(self, params: Params, state: State, x, labels, *,
                    training: bool = True,
                    rng: Optional[torch.Generator] = None, mask=None,
                    label_mask=None):
        """:meth:`score` in its parts (data parallelism reduces them by
        loss mass): ``(losses, reductions, aux, new_state)``, the output
        layer's masked-mean loss and its (labels, mask) pair, the mask it
        reduced with (the label mask, else the propagated feature mask,
        else None), one each; and the auxiliary loss (None when no layer
        adds one)."""
        out_layer = self.layers[-1]
        if not _is_loss_layer(out_layer):
            raise ValueError("Last layer must be an Output/Loss layer to "
                             "compute score")
        feats, new_state, prop_mask = self.forward(
            params, state, x, training=training, rng=rng, mask=mask,
            up_to=len(self.layers) - 1, return_mask=True)
        k = _layer_key(len(self.layers) - 1, out_layer)
        eff_mask = label_mask if label_mask is not None else prop_mask
        loss = out_layer.score(_loss_params(k, params.get(k, {})),
                               state.get(k, {}), feats, labels, mask=eff_mask)
        aux = (_collect_aux_losses(new_state, loss.device)
               if _has_aux_losses(new_state) else None)
        return [loss], [(labels, eff_mask)], aux, new_state

    def output(self, x, params: Optional[Params] = None,
               state: Optional[State] = None, mask=None) -> torch.Tensor:
        """Inference on ``x`` (a tensor or array; moved to the model's
        device) with the given or the model's own params."""
        p = params if params is not None else self.params
        s = state if state is not None else self.state
        if p is None:
            raise ValueError("call init() first")
        x = torch.as_tensor(x, device=self.device)
        with torch.inference_mode():
            y, _ = self.forward(p, s, x, training=False, mask=mask)
        return y

    # --- carries (rnnTimeStep / truncated BPTT) ---

    def rnn_layers(self) -> List[Tuple[str, Layer]]:
        """(params key, layer) of every recurrent layer."""
        return [(_layer_key(i, l), l) for i, l in enumerate(self.layers)
                if isinstance(l, RecurrentLayer)]

    def init_carries(self, batch: int) -> Dict[str, object]:
        """Zero carries of every recurrent layer, keyed as its params, in
        the param dtype (``dtype``, not ``compute_dtype``: the reference's
        contract, so a carried step promotes to f32)."""
        out = {}
        for i, layer in enumerate(self.layers):
            if isinstance(layer, RecurrentLayer):
                out[_layer_key(i, layer)] = layer.init_carry(
                    batch, self._shapes[i], self.dtype, self.device)
        return out

    def forward_with_carry(self, params: Params, state: State, x, carries,
                           *, training: bool = False,
                           rng: Optional[torch.Generator] = None, mask=None):
        """The forward with explicit carries for the recurrent layers:
        returns ``(y, new_state, new_carries)``. As the reference's, it
        neither casts to ``compute_dtype`` nor checkpoints."""
        new_state, new_carries = dict(state), dict(carries)
        for i, layer in enumerate(self.layers):
            k = _layer_key(i, layer)
            p = params.get(k, {})
            if isinstance(layer, RecurrentLayer):
                x = apply_input_dropout(layer, x, rng, training)
                x, new_carries[k] = layer.apply_sequence(p, x, carries[k],
                                                         mask=mask)
            else:
                x, s_out, mask = layer.apply(p, state.get(k, {}), x,
                                             training=training, rng=rng,
                                             mask=mask)
                if s_out:
                    new_state[k] = s_out
        return x, new_state, new_carries

    def score_with_carry(self, params: Params, state: State, x, labels,
                         carries, *, training: bool = True,
                         rng: Optional[torch.Generator] = None, mask=None,
                         label_mask=None):
        """The training loss of one tBPTT chunk from ``carries``: returns
        ``(loss, new_state, new_carries)``. As the reference's, it casts
        neither x nor the params to ``compute_dtype`` and does not
        checkpoint, so a chunk trains in the param dtype whatever the
        config's compute dtype; the recurrent layers take no input
        dropout here. The loss reduces with ``label_mask`` when given,
        else with the propagated feature mask."""
        out_layer = self.layers[-1]
        n = len(self.layers)
        new_state, new_carries = dict(state), dict(carries)
        h, m = x, mask
        for i in range(n - 1):
            layer = self.layers[i]
            k = _layer_key(i, layer)
            p = params.get(k, {})
            if isinstance(layer, RecurrentLayer):
                h, new_carries[k] = layer.apply_sequence(p, h, carries[k],
                                                         mask=m)
            else:
                h, s_out, m = layer.apply(p, state.get(k, {}), h,
                                          training=training, rng=rng, mask=m)
                if s_out:
                    new_state[k] = s_out
        k = _layer_key(n - 1, out_layer)
        loss = out_layer.score(params.get(k, {}), state.get(k, {}), h,
                               labels,
                               mask=label_mask if label_mask is not None
                               else m)
        return (loss + _collect_aux_losses(new_state, loss.device),
                new_state, new_carries)

    def summary(self) -> str:
        """MultiLayerNetwork.summary(): one row per layer (index, key,
        type, input and output shapes, params), then the total; the
        reference's text."""
        lines = [f"{'idx':<4}{'name':<24}{'type':<26}{'in':<18}{'out':<18}"
                 f"{'params':<10}"]
        total = 0
        for i, layer in enumerate(self.layers):
            n = layer.param_count(self._shapes[i]) if layer.has_params() else 0
            total += n
            lines.append(f"{i:<4}{_layer_key(i, layer):<24}"
                         f"{type(layer).__name__:<26}{str(self._shapes[i]):<18}"
                         f"{str(self._shapes[i + 1]):<18}{n:<10}")
        lines.append(f"Total params: {total}")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "format": FORMAT,
            "config": self.config.to_dict(),
            "input_shape": list(self.input_shape),
            "layers": [l.to_dict() for l in self.layers],
        }, indent=2)

    @classmethod
    def from_json(cls, s: str, device: DeviceLike = None) -> "Sequential":
        d = json.loads(s)
        if "sequential" not in d.get("format", ""):
            raise ValueError(f"not a Sequential config: format "
                             f"{d.get('format')!r} (a Graph's loads with "
                             f"Graph.from_json)")
        return cls(NetConfig.from_dict(d["config"]),
                   [layer_from_dict(ld) for ld in d["layers"]],
                   tuple(d["input_shape"]), device=device)


class SequentialBuilder:
    """Fluent builder: ``.input_shape(...).layer(...).build()``."""

    def __init__(self, config: Optional[NetConfig] = None,
                 device: DeviceLike = None):
        self.config = config or NetConfig()
        self.device = device
        self._layers: List[Layer] = []
        self._input_shape: Optional[Shape] = None

    def input_shape(self, *shape: int) -> "SequentialBuilder":
        self._input_shape = tuple(shape)
        return self

    def layer(self, layer: Layer) -> "SequentialBuilder":
        self._layers.append(layer)
        return self

    def build(self) -> Sequential:
        if self._input_shape is None:
            raise ValueError("set input_shape first")
        return Sequential(self.config, self._layers, self._input_shape,
                          device=self.device)


def _has_aux_losses(new_state) -> bool:
    return any(isinstance(s, dict) and "aux_loss" in s
               for s in new_state.values())


def _collect_aux_losses(new_state, device) -> torch.Tensor:
    """Sum of per-layer auxiliary training losses surfaced through layer
    state (``state["aux_loss"]``), as f32; zero when no layer adds one."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    for s in new_state.values():
        if isinstance(s, dict) and "aux_loss" in s:
            total = total + torch.as_tensor(s["aux_loss"]).float()
    return total


def _wants_flat_input(spec) -> bool:
    """Feed-forward layers that take flattened features when wired to
    conv-shaped (H, W, C) activations (the reference's implicit
    CnnToFeedForwardPreProcessor)."""
    from .layers.core import Dense, Output, RnnOutput
    from .layers.special import VAE, AutoEncoder

    return (isinstance(spec, (Dense, Output, AutoEncoder, VAE))
            and not isinstance(spec, RnnOutput))


@dataclass(frozen=True)
class GraphNode:
    """One node of a Graph config: a Layer or GraphVertex and its input
    names."""

    spec: Union[Layer, GraphVertex]
    inputs: Tuple[str, ...]

    def is_layer(self) -> bool:
        return isinstance(self.spec, Layer)


class Graph(TrainableModel):
    """ComputationGraph equivalent: a DAG of layers and vertices on one
    device (the card unless ``device`` names another).

    ``nodes``: name -> GraphNode; ``inputs``: the external input names;
    ``outputs``: the output node names, whose order is the order of the
    labels in ``score`` and ``fit``. Nodes run in the reference's
    topological order (Kahn's, ties by name), so params are drawn and
    layers applied in the same order in both packages."""

    def __init__(self, config: NetConfig, inputs: Sequence[str],
                 input_shapes: Dict[str, Shape], nodes: Dict[str, GraphNode],
                 outputs: Sequence[str], device: DeviceLike = None):
        self.config = config
        self.inputs = list(inputs)
        self.input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        self.nodes = dict(nodes)
        self.outputs = list(outputs)
        self.device = resolve_device(device)
        self.dtype = DTYPES[config.dtype]
        self.topo_order = self._topo_sort()
        self._shapes = self._infer_shapes()
        self.params: Optional[Params] = None
        self.state: Optional[State] = None

    def _topo_sort(self) -> List[str]:
        indeg = {name: 0 for name in self.nodes}
        children: Dict[str, List[str]] = {name: [] for name in self.nodes}
        for name, node in self.nodes.items():
            for inp in node.inputs:
                if inp in self.nodes:
                    indeg[name] += 1
                    children[inp].append(name)
                elif inp not in self.inputs:
                    raise ValueError(f"Node '{name}' references unknown "
                                     f"input '{inp}'")
        queue = sorted(n for n, d in indeg.items() if d == 0)
        order = []
        while queue:
            n = queue.pop(0)
            order.append(n)
            for c in children[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    queue.append(c)
            queue.sort()
        if len(order) != len(self.nodes):
            cyc = set(self.nodes) - set(order)
            raise ValueError(f"Graph has a cycle involving: {sorted(cyc)}")
        return order

    def _infer_shapes(self) -> Dict[str, Shape]:
        shapes: Dict[str, Shape] = dict(self.input_shapes)
        for name in self.topo_order:
            node = self.nodes[name]
            in_shapes = [shapes[i] for i in node.inputs]
            shapes[name] = tuple(node.spec.output_shape(in_shapes[0])
                                 if node.is_layer()
                                 else node.spec.output_shape(in_shapes))
        return shapes

    @property
    def output_shapes(self) -> List[Shape]:
        return [self._shapes[o] for o in self.outputs]

    def node_shape(self, name: str) -> Shape:
        """The feature shape (without batch) of a node's output or an
        input."""
        return self._shapes[name]

    def _layer_names(self) -> List[str]:
        return [n for n in self.topo_order if self.nodes[n].is_layer()]

    def _init_on(self, gen, device) -> Tuple[Params, State]:
        params: Params = {}
        state: State = {}
        for name in self._layer_names():
            node = self.nodes[name]
            p, s = node.spec.init(gen, self._shapes[node.inputs[0]],
                                  self.dtype, device)
            if p:
                params[name] = p
            if s:
                state[name] = s
        return params, state

    def init(self, seed: Optional[int] = None) -> Tuple[Params, State]:
        """Random params on the model's device from a ``torch.Generator``
        seeded with ``seed`` (default ``config.seed``), drawn node by node
        in topological order."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed if seed is None else seed)
        self.params, self.state = self._init_on(gen, self.device)
        return self.params, self.state

    def param_shapes(self) -> Dict[str, dict]:
        """The params tree's shapes, computed without allocating."""
        return _tree_shapes(self._init_on(None, torch.device("meta"))[0])

    def param_count(self) -> int:
        if self.params is None:
            raise ValueError("call init() first")
        return _tree_size(self.params)

    def _start(self, inputs, masks):
        """The activations and masks dicts a pass starts from."""
        if not isinstance(inputs, dict):
            inputs = {self.inputs[0]: inputs}
        if masks is not None and not isinstance(masks, dict):
            masks = {self.inputs[0]: masks}
        cdt = (DTYPES[self.config.compute_dtype]
               if self.config.compute_dtype else None)
        if cdt is not None:
            inputs = {k: v.to(cdt) if v.is_floating_point() else v
                      for k, v in inputs.items()}
        acts = dict(inputs)
        act_masks = {k: (masks or {}).get(k) for k in inputs}
        return cdt, acts, act_masks

    def _run_layer(self, name, params, state, acts, act_masks, new_state,
                   cdt, training, rng):
        node = self.nodes[name]
        p = params.get(name, {})
        if cdt is not None:
            p = _cast_floats(p, cdt)
        y, s_out, m_out = _run_layer(
            self.config, node.spec, name, p, state.get(name, {}),
            acts[node.inputs[0]], training=training, rng=rng,
            mask=act_masks.get(node.inputs[0]), index=None)
        acts[name], act_masks[name] = y, m_out
        if s_out:
            new_state[name] = s_out

    def _run_vertex(self, name, acts, act_masks):
        node = self.nodes[name]
        acts[name] = node.spec.apply([acts[i] for i in node.inputs])
        act_masks[name] = act_masks.get(node.inputs[0])

    def forward(self, params: Params, state: State, inputs, *,
                training: bool = False, rng: Optional[torch.Generator] = None,
                masks=None) -> Tuple[List[torch.Tensor], State]:
        """Every node in topological order; returns ``(outputs, new_state)``
        with ``outputs`` in ``self.outputs`` order. ``inputs`` (and
        ``masks``) are a tensor for the first input or a dict by input
        name."""
        cdt, acts, act_masks = self._start(inputs, masks)
        new_state = dict(state)
        for name in self.topo_order:
            if self.nodes[name].is_layer():
                self._run_layer(name, params, state, acts, act_masks,
                                new_state, cdt, training, rng)
            else:
                self._run_vertex(name, acts, act_masks)
        outs = [acts[o] for o in self.outputs]
        if cdt is not None:
            outs = [o.to(self.dtype) if o.is_floating_point() else o
                    for o in outs]
        return outs, new_state

    def score(self, params: Params, state: State, inputs, labels, *,
              training: bool = True, rng: Optional[torch.Generator] = None,
              masks=None, label_masks=None) -> Tuple[torch.Tensor, State]:
        """Training loss (a 0-d f32 tensor): the sum of the losses of the
        output layers, each scored in the compute dtype and cast to f32,
        plus any auxiliary loss in the layers' state; and the new state.
        ``labels`` (and ``label_masks``) are one per output, or a single
        one for a one-output graph."""
        losses, _, aux, new_state = self.score_parts(
            params, state, inputs, labels, training=training, rng=rng,
            masks=masks, label_masks=label_masks)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for loss in losses:
            total = total + loss
        return total + aux, new_state

    def score_parts(self, params: Params, state: State, inputs, labels, *,
                    training: bool = True,
                    rng: Optional[torch.Generator] = None, masks=None,
                    label_masks=None):
        """:meth:`score` in its parts (data parallelism reduces them by
        loss mass): ``(losses, reductions, aux, new_state)``, each
        loss-bearing output's masked-mean loss (f32) and its (labels,
        mask) pair, in ``self.outputs`` order, and the auxiliary loss
        (f32, zero when no layer adds one)."""
        if not any(_is_loss_layer(self.nodes[o].spec) for o in self.outputs):
            raise ValueError("Graph has no loss-bearing output layer — "
                             "score/fit would silently return 0")
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        cdt, acts, act_masks = self._start(inputs, masks)
        new_state = dict(state)
        losses, reductions = [], []
        out_idx = {o: i for i, o in enumerate(self.outputs)}
        consumed = {i for node in self.nodes.values() for i in node.inputs}
        for name in self.topo_order:
            node = self.nodes[name]
            if not node.is_layer():
                self._run_vertex(name, acts, act_masks)
                continue
            if name in out_idx and _is_loss_layer(node.spec):
                li = out_idx[name]
                lm = None
                if label_masks is not None:
                    lm = (label_masks[li]
                          if isinstance(label_masks, (list, tuple))
                          else label_masks)
                if lm is None:
                    lm = act_masks.get(node.inputs[0])
                p = params.get(name, {})
                if cdt is not None:
                    p = _cast_floats(p, cdt)
                losses.append(node.spec.score(
                    _loss_params(name, p), state.get(name, {}),
                    acts[node.inputs[0]],
                    labels[li], mask=lm).float())
                reductions.append((labels[li], lm))
                if name not in consumed:  # nothing downstream needs it
                    continue
            self._run_layer(name, params, state, acts, act_masks, new_state,
                            cdt, training, rng)
        return (losses, reductions,
                _collect_aux_losses(new_state, self.device), new_state)

    def output(self, inputs, params: Optional[Params] = None,
               state: Optional[State] = None, masks=None) -> List[torch.Tensor]:
        """Inference on ``inputs`` (tensors or arrays; moved to the model's
        device) with the given or the model's own params."""
        p = params if params is not None else self.params
        s = state if state is not None else self.state
        if p is None:
            raise ValueError("call init() first")
        if isinstance(inputs, dict):
            inputs = {k: torch.as_tensor(v, device=self.device)
                      for k, v in inputs.items()}
        else:
            inputs = torch.as_tensor(inputs, device=self.device)
        with torch.inference_mode():
            ys, _ = self.forward(p, s, inputs, training=False, masks=masks)
        return ys

    def summary(self) -> str:
        """ComputationGraph.summary(): one row per node in topological
        order (name, type, inputs, output shape); the reference's text."""
        lines = [f"{'name':<28}{'type':<26}{'inputs':<36}{'out shape':<18}"]
        for name in self.topo_order:
            node = self.nodes[name]
            lines.append(f"{name:<28}{type(node.spec).__name__:<26}"
                         f"{','.join(node.inputs):<36}"
                         f"{str(self._shapes[name]):<18}")
        return "\n".join(lines)

    def to_json(self) -> str:
        nodes = {name: {"kind": "layer" if node.is_layer() else "vertex",
                        "spec": node.spec.to_dict(),
                        "inputs": list(node.inputs)}
                 for name, node in self.nodes.items()}
        return json.dumps({
            "format": GRAPH_FORMAT,
            "config": self.config.to_dict(),
            "inputs": self.inputs,
            "input_shapes": {k: list(v) for k, v in self.input_shapes.items()},
            "nodes": nodes,
            "outputs": self.outputs,
        }, indent=2)

    @classmethod
    def from_json(cls, s: str, device: DeviceLike = None) -> "Graph":
        d = json.loads(s)
        if "graph" not in d.get("format", ""):
            raise ValueError(f"not a Graph config: format "
                             f"{d.get('format')!r}")
        nodes = {}
        for name, nd in d["nodes"].items():
            spec = (layer_from_dict(nd["spec"]) if nd["kind"] == "layer"
                    else vertex_from_dict(nd["spec"]))
            nodes[name] = GraphNode(spec, tuple(nd["inputs"]))
        return cls(NetConfig.from_dict(d["config"]), d["inputs"],
                   {k: tuple(v) for k, v in d["input_shapes"].items()},
                   nodes, d["outputs"], device=device)


class GraphBuilder:
    """Fluent builder (ComputationGraphConfiguration.GraphBuilder)."""

    def __init__(self, config: Optional[NetConfig] = None,
                 device: DeviceLike = None):
        self.config = config or NetConfig()
        self.device = device
        self._inputs: List[str] = []
        self._input_shapes: Dict[str, Shape] = {}
        self._nodes: Dict[str, GraphNode] = {}
        self._outputs: List[str] = []

    def add_input(self, name: str, shape: Shape) -> "GraphBuilder":
        self._inputs.append(name)
        self._input_shapes[name] = tuple(shape)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str) -> "GraphBuilder":
        self._nodes[name] = GraphNode(layer, tuple(inputs))
        return self

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        self._nodes[name] = GraphNode(vertex, tuple(inputs))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def build(self) -> Graph:
        """The Graph, with a ``Flatten`` node (``<layer>_flatten``)
        inserted wherever a Dense or Output layer is wired to conv-shaped
        (H, W, C) activations, as the reference's builder inserts it.
        ``Graph.from_json`` bypasses the builder, so a round trip never
        inserts twice."""
        from .layers.pooling import Flatten

        probe = Graph(self.config, self._inputs, self._input_shapes,
                      self._nodes, self._outputs,
                      device=self.device or "meta")  # validates, sorts
        shapes: Dict[str, Shape] = dict(probe.input_shapes)
        nodes: Dict[str, GraphNode] = {}
        for name in probe.topo_order:
            node = self._nodes[name]
            in_shape = shapes[node.inputs[0]] if node.inputs else None
            if (node.is_layer() and _wants_flat_input(node.spec)
                    and len(in_shape) == 3):
                fname = f"{name}_flatten"
                while fname in self._nodes or fname in nodes:
                    fname += "_"
                flatten = Flatten()
                nodes[fname] = GraphNode(flatten, node.inputs)
                node = GraphNode(node.spec, (fname,))
                in_shape = tuple(flatten.output_shape(in_shape))
            nodes[name] = node
            shapes[name] = tuple(
                node.spec.output_shape(in_shape) if node.is_layer()
                else node.spec.output_shape([shapes[i] for i in node.inputs]))
        return Graph(self.config, self._inputs, self._input_shapes, nodes,
                     self._outputs, device=self.device)
