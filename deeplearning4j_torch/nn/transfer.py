"""Transfer learning — counterpart of ``deeplearning4j_tpu/nn/transfer.py``:
``FineTuneConfiguration``, ``TransferLearningBuilder`` (Sequential),
``TransferGraphBuilder`` (Graph) and ``TransferLearningHelper``.

Surgery is config surgery, as in the reference: a build makes a new
Sequential or Graph config (frozen layers wrapped in ``Frozen``, whose
``"@type"`` JSON is the reference's) and its params, drawn fresh from the
config's seed on the source's device, with every surviving entry of the
source carried over where its shapes still match (params and layer state
such as BatchNorm running statistics). The trainer gives frozen layers the
``noop`` updater and keeps their leaves out of autograd.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..ops.updaters import tree_leaves
from .api import Layer, layer_from_dict
from .layers.special import Frozen
from .model import Graph, GraphNode, NetConfig, Sequential, _layer_key


@dataclass
class FineTuneConfiguration:
    """FineTuneConfiguration.java — the global config's fields to override
    on build; a field left None keeps the source's."""

    updater: Optional[Any] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    seed: Optional[int] = None
    dtype: Optional[str] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None
    tbptt_length: Optional[int] = None
    compute_dtype: Optional[str] = None

    def apply_to(self, cfg: NetConfig) -> NetConfig:
        d = cfg.to_dict()
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None:
                d[f.name] = v
        return NetConfig.from_dict(d)


def _freeze(layer: Layer) -> Layer:
    if isinstance(layer, Frozen):
        return layer
    return Frozen(name=layer.name, inner=layer.to_dict())


def _inner(layer: Layer) -> Layer:
    return layer._sub() if isinstance(layer, Frozen) else layer


def _replace_n_out(layer: Layer, n_out: int,
                   weight_init: Optional[str]) -> Layer:
    """The layer with a new ``n_out`` (and weight init), frozen again if it
    was: the builder composes freezing and replacement in either order."""
    inner = _inner(layer)
    if "n_out" not in {f.name for f in dataclasses.fields(inner)}:
        raise ValueError(f"nOutReplace target {type(inner).__name__} has "
                         f"no n_out")
    d = inner.to_dict()
    d["n_out"] = n_out
    if weight_init is not None:
        d["weight_init"] = weight_init
    new = layer_from_dict(d)
    return _freeze(new) if isinstance(layer, Frozen) else new


def _shapes_match(fresh, old) -> bool:
    """Whether two trees have the same structure and leaf shapes: the gate
    for carrying a source entry into the edited network."""
    def struct(t):
        return ({k: struct(v) for k, v in t.items()} if isinstance(t, dict)
                else None)

    if struct(fresh) != struct(old):
        return False
    return all(tuple(a.shape) == tuple(b.shape)
               for a, b in zip(tree_leaves(fresh), tree_leaves(old)))


class TransferLearningBuilder:
    """TransferLearning.Builder for a Sequential::

        net, params, state = (TransferLearningBuilder(src)
            .fine_tune_configuration(FineTuneConfiguration(
                updater={"type": "nesterovs", "learning_rate": 1e-3}))
            .set_feature_extractor(3)      # freeze layers 0..3
            .n_out_replace(5, 10)          # a new head width
            .build())
    """

    def __init__(self, model: Sequential, params: Optional[dict] = None,
                 state: Optional[dict] = None):
        self.model = model
        src_params = params if params is not None else model.params
        src_state = state if state is not None else model.state
        if src_params is None:
            raise ValueError("source network has no params — call "
                             "init()/load first")
        # (layer, carried params or None, carried state or None)
        self._entries: List[Tuple[Layer, Optional[dict], Optional[dict]]] = [
            (layer, src_params.get(_layer_key(i, layer)),
             (src_state or {}).get(_layer_key(i, layer)))
            for i, layer in enumerate(model.layers)]
        self._ftc: Optional[FineTuneConfiguration] = None

    def fine_tune_configuration(self, ftc: FineTuneConfiguration
                                ) -> "TransferLearningBuilder":
        self._ftc = ftc
        return self

    def set_feature_extractor(self, layer_index: int
                              ) -> "TransferLearningBuilder":
        """Freeze layers 0..``layer_index`` inclusive."""
        for i in range(layer_index + 1):
            layer, p, s = self._entries[i]
            self._entries[i] = (_freeze(layer), p, s)
        return self

    def n_out_replace(self, layer_index: int, n_out: int,
                      weight_init: Optional[str] = None,
                      weight_init_next: Optional[str] = None
                      ) -> "TransferLearningBuilder":
        """A new ``n_out`` for a layer: its params and the next parametric
        layer's are drawn afresh (their shapes change)."""
        layer, _, _ = self._entries[layer_index]
        self._entries[layer_index] = (
            _replace_n_out(layer, n_out, weight_init), None, None)
        for j in range(layer_index + 1, len(self._entries)):
            inner = _inner(self._entries[j][0])
            if inner.has_params():
                d = inner.to_dict()
                if weight_init_next is not None:
                    d["weight_init"] = weight_init_next
                self._entries[j] = (layer_from_dict(d), None, None)
                break
        return self

    def remove_output_layer(self) -> "TransferLearningBuilder":
        self._entries.pop()
        return self

    def remove_layers_from_output(self, n: int) -> "TransferLearningBuilder":
        if not 0 <= n <= len(self._entries):
            raise ValueError(f"cannot remove {n} layers from a "
                             f"{len(self._entries)}-layer network")
        del self._entries[len(self._entries) - n:]
        return self

    def add_layer(self, layer: Layer) -> "TransferLearningBuilder":
        self._entries.append((layer, None, None))
        return self

    def build(self) -> Tuple[Sequential, dict, dict]:
        cfg = self.model.config
        if self._ftc is not None:
            cfg = self._ftc.apply_to(cfg)
        net = Sequential(cfg, [e[0] for e in self._entries],
                         self.model.input_shape, device=self.model.device)
        params, state = net.init(cfg.seed)
        for i, (layer, p, s) in enumerate(self._entries):
            k = _layer_key(i, layer)
            if p is not None and k in params and _shapes_match(params[k], p):
                params[k] = p
            if s is not None and k in state and _shapes_match(state[k], s):
                state[k] = s
        net.params, net.state = params, state
        return net, params, state


class TransferGraphBuilder:
    """TransferLearning.GraphBuilder for a Graph."""

    def __init__(self, model: Graph, params: Optional[dict] = None,
                 state: Optional[dict] = None):
        self.model = model
        self._params = dict(params if params is not None
                            else (model.params or {}))
        self._state = dict(state if state is not None
                           else (model.state or {}))
        if not self._params:
            raise ValueError("source network has no params — call "
                             "init()/load first")
        self._nodes: Dict[str, GraphNode] = dict(model.nodes)
        self._outputs = list(model.outputs)
        self._ftc: Optional[FineTuneConfiguration] = None
        self._reinit: set = set()  # nodes whose params are not carried

    def fine_tune_configuration(self, ftc: FineTuneConfiguration
                                ) -> "TransferGraphBuilder":
        self._ftc = ftc
        return self

    def set_feature_extractor(self, *names: str) -> "TransferGraphBuilder":
        """Freeze the named nodes and every ancestor of them."""
        to_freeze, stack = set(), list(names)
        while stack:
            n = stack.pop()
            if n in to_freeze or n not in self._nodes:
                continue
            to_freeze.add(n)
            stack.extend(self._nodes[n].inputs)
        for n in to_freeze:
            node = self._nodes[n]
            if node.is_layer() and node.spec.has_params():
                self._nodes[n] = GraphNode(_freeze(node.spec), node.inputs)
        return self

    def n_out_replace(self, name: str, n_out: int,
                      weight_init: Optional[str] = None,
                      weight_init_next: Optional[str] = None
                      ) -> "TransferGraphBuilder":
        """A new ``n_out`` for a node: its params are drawn afresh, and so
        are those of every parametric consumer reached through
        non-parametric ones (activations, merges), which absorb the new
        width."""
        node = self._nodes[name]
        self._nodes[name] = GraphNode(
            _replace_n_out(node.spec, n_out, weight_init), node.inputs)
        self._reinit.add(name)
        frontier, seen = {name}, set()
        while frontier:
            cur = frontier.pop()
            for cname, cnode in list(self._nodes.items()):
                if cname in seen or cur not in cnode.inputs:
                    continue
                seen.add(cname)
                if cnode.is_layer() and cnode.spec.has_params():
                    if weight_init_next is not None:
                        d = _inner(cnode.spec).to_dict()
                        d["weight_init"] = weight_init_next
                        self._nodes[cname] = GraphNode(layer_from_dict(d),
                                                       cnode.inputs)
                    self._reinit.add(cname)
                else:
                    frontier.add(cname)
        return self

    def remove_vertex(self, name: str, remove_connections: bool = False
                      ) -> "TransferGraphBuilder":
        """Drop a node, and with ``remove_connections`` every node that
        consumed it, transitively."""
        removed = {name}
        self._nodes.pop(name, None)
        if remove_connections:
            changed = True
            while changed:
                changed = False
                for n, node in list(self._nodes.items()):
                    if any(i in removed for i in node.inputs):
                        removed.add(n)
                        del self._nodes[n]
                        changed = True
        self._outputs = [o for o in self._outputs if o not in removed]
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str
                  ) -> "TransferGraphBuilder":
        self._nodes[name] = GraphNode(layer, tuple(inputs))
        self._reinit.add(name)
        return self

    def add_vertex(self, name: str, vertex, *inputs: str
                   ) -> "TransferGraphBuilder":
        self._nodes[name] = GraphNode(vertex, tuple(inputs))
        return self

    def set_outputs(self, *names: str) -> "TransferGraphBuilder":
        self._outputs = list(names)
        return self

    def build(self) -> Tuple[Graph, dict, dict]:
        cfg = self.model.config
        if self._ftc is not None:
            cfg = self._ftc.apply_to(cfg)
        net = Graph(cfg, self.model.inputs, self.model.input_shapes,
                    self._nodes, self._outputs, device=self.model.device)
        params, state = net.init(cfg.seed)
        for name in net.topo_order:
            if name in self._reinit:
                continue
            old = self._params.get(name)
            if old is not None and name in params \
                    and _shapes_match(params[name], old):
                params[name] = old
            if name in self._state and name in state \
                    and _shapes_match(state[name], self._state[name]):
                state[name] = self._state[name]
        net.params, net.state = params, state
        return net, params, state


class TransferLearningHelper:
    """TransferLearningHelper.java for a Sequential whose leading layers
    are frozen: ``featurize`` runs the frozen prefix once (inference mode,
    no autograd), ``unfrozen_network`` is the rest as a Sequential of its
    own over the features (sharing the source's params), and
    ``merge_back`` writes its trained params into the full network."""

    def __init__(self, model: Sequential, params: Optional[dict] = None,
                 state: Optional[dict] = None):
        if not isinstance(model, Sequential):
            raise TypeError("TransferLearningHelper supports Sequential nets")
        self.model = model
        self.params = params if params is not None else model.params
        self.state = state if state is not None else model.state
        if self.params is None:
            raise ValueError("source network has no params — call "
                             "init()/load first")
        self.split = 0
        for layer in model.layers:
            if not isinstance(layer, Frozen):
                break
            self.split += 1
        if self.split == 0:
            raise ValueError("no frozen prefix — call set_feature_extractor "
                             "first")
        suffix = model.layers[self.split:]
        self.unfrozen = Sequential(model.config, suffix,
                                   model.layer_input_shape(self.split),
                                   device=model.device)
        up, us = {}, {}
        for j, layer in enumerate(suffix):
            old_k = _layer_key(self.split + j, layer)
            new_k = _layer_key(j, layer)
            if old_k in self.params:
                up[new_k] = self.params[old_k]
            if old_k in (self.state or {}):
                us[new_k] = self.state[old_k]
        self.unfrozen.params, self.unfrozen.state = up, us

    def featurize(self, x) -> torch.Tensor:
        """The frozen prefix's output for ``x`` (moved to the model's
        device)."""
        x = torch.as_tensor(x, device=self.model.device)
        with torch.no_grad():
            return self.model.forward(self.params, self.state, x,
                                      training=False, up_to=self.split)[0]

    def unfrozen_network(self) -> Sequential:
        return self.unfrozen

    def merge_back(self) -> dict:
        """The full network's params with the unfrozen network's trained
        ones written back; also set as the model's params."""
        params = dict(self.params)
        for j, layer in enumerate(self.unfrozen.layers):
            old_k = _layer_key(self.split + j, self.model.layers[self.split + j])
            new_k = _layer_key(j, layer)
            if new_k in self.unfrozen.params:
                params[old_k] = self.unfrozen.params[new_k]
        self.params = params
        self.model.params = params
        return params
