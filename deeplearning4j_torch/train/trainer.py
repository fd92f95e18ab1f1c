"""Trainer — counterpart of ``deeplearning4j_tpu/train/trainer.py``.

One training step is the reference's ``_step_math``: the model's ``score``
(a ``Sequential`` or a ``Graph``), its gradient, the updater
(``ops.updaters``), then ``params + updates``; the layers' new state (a
BatchNorm's running statistics) is threaded from step to step.
The reference jits it with the params' buffers donated; here the params
are leaf tensors that the step updates in place under ``no_grad``, which
is the same thing on the card: no second copy of the params. The step
runs on the model's device (the card unless the model was built with
``device="cpu"``); each batch moves there inside the step.

``fit`` is the plain-step path with prefetch and deferred loss readback.
Not ported yet, each raising ``NotImplementedError`` (ROADMAP.md, Queue
1): ``grad_accum``, ``steps_per_execution``, truncated BPTT, ``mesh=``,
``telemetry=``, ``Frozen`` layers, and a multi-input Graph fed
``MultiDataSet``-style batches (a list or dict of feature arrays).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from ..data.iterators import AsyncIterator
from ..nn.model import Graph, Sequential, _layer_key
from ..ops import updaters as upd
from ..ops.updaters import Transform, tree_leaves
from .listeners import DeferredScoreReporter, PerformanceListener, TrainingListener
from .serialization import load_model, load_opt_state, save_model

_NOT_PORTED = "not ported yet (ROADMAP.md, Queue 1: slice 2 left-outs)"
_NOT_PORTED_GRAPH = "not ported yet (ROADMAP.md, Queue 1: slice 3 left-outs)"


def _leaf_owners(tree) -> List[str]:
    """The top-level key of each leaf of a params tree, in
    ``tree_leaves`` order."""
    def count(t):
        return sum(count(v) for v in t.values()) if isinstance(t, dict) else 1

    return [k for k in sorted(tree) for _ in range(count(tree[k]))]


def _named_layers(model):
    """(params key, layer) of every layer: ``layer_i``/name in a
    Sequential, the node name in a Graph."""
    if isinstance(model, Graph):
        return [(n, model.nodes[n].spec) for n in model.topo_order
                if model.nodes[n].is_layer()]
    return [(_layer_key(i, l), l) for i, l in enumerate(model.layers)]


def _score(model, params, state, x, y, *, training, rng, mask, label_mask):
    """``model.score`` with the mask keywords of its container."""
    if isinstance(model, Graph):
        return model.score(params, state, x, y, training=training, rng=rng,
                           masks=mask, label_masks=label_mask)
    return model.score(params, state, x, y, training=training, rng=rng,
                       mask=mask, label_mask=label_mask)


def build_updater(model) -> Transform:
    """The update pipeline from ``NetConfig`` (updater, l1, l2, gradient
    normalization) and per-layer ``updater`` overrides, which become a
    multi-transform keyed by layer (a Graph's by node name), labelled as
    the reference labels them (``__default__``, ``override_<key>``)."""
    cfg = model.config

    def base_tx(updater_cfg):
        return upd.build(updater_cfg,
                         gradient_normalization=cfg.gradient_normalization,
                         gradient_normalization_threshold=cfg.gradient_normalization_threshold,
                         l1=cfg.l1, l2=cfg.l2)

    overrides: Dict[str, Any] = {}
    for key, layer in _named_layers(model):
        if type(layer).__name__ == "Frozen":
            raise NotImplementedError(f"Frozen layers are {_NOT_PORTED}")
        if getattr(layer, "updater", None) is not None:
            overrides[key] = layer.updater
    if not overrides:
        return base_tx(cfg.updater)
    transforms = {"__default__": base_tx(cfg.updater)}
    labels_by_name = {}
    for name, ov in overrides.items():
        transforms[f"override_{name}"] = base_tx(ov)
        labels_by_name[name] = f"override_{name}"
    labels = [labels_by_name.get(k, "__default__")
              for k in _leaf_owners(model.param_shapes())]
    return upd.multi_transform(transforms, labels)


class Trainer:
    """Owns the params, net state and updater state of one model and runs
    its training steps (Solver parity)."""

    def __init__(self, model: Union[Sequential, Graph],
                 updater: Optional[Transform] = None,
                 seed: int = 0, mesh=None, rules=None, grad_accum: int = 1):
        if mesh is not None or rules is not None:
            raise NotImplementedError(f"training over a mesh is {_NOT_PORTED}")
        if int(grad_accum) != 1:
            raise NotImplementedError(f"grad_accum is {_NOT_PORTED}")
        if getattr(model.config, "tbptt_length", 0):
            raise NotImplementedError(f"truncated BPTT is {_NOT_PORTED}")
        self.model = model
        self.tx = updater if updater is not None else build_updater(model)
        if model.params is None:
            model.init()
        self.device = model.device
        # leaf tensors updated in place by every step (the counterpart of
        # the reference's donated buffers)
        self.params = upd.tree_unflatten(model.params, [
            p.detach().requires_grad_(p.is_floating_point())
            for p in tree_leaves(model.params)])
        self.state = model.state if model.state is not None else {}
        self.opt_state = self.tx.init(tree_leaves(self.params))
        self.iteration = 0
        self.epoch = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

    def _to_device(self, a):
        if isinstance(a, (list, tuple)):
            return [self._to_device(t) for t in a]
        return None if a is None else torch.as_tensor(a, device=self.device)

    def step(self, params, opt_state, net_state, x, y, gen=None, mask=None,
             label_mask=None):
        """One training step on one batch: returns ``(params, opt_state,
        net_state, loss)`` with the params updated in place and the loss a
        0-d tensor on the device (not read back)."""
        x, y, mask, label_mask = (self._to_device(a)
                                  for a in (x, y, mask, label_mask))
        leaves = tree_leaves(params)
        trained = [p for p in leaves if p.requires_grad]
        with torch.enable_grad():
            loss, new_state = _score(self.model, params, net_state, x, y,
                                     training=True, rng=gen, mask=mask,
                                     label_mask=label_mask)
            grads = torch.autograd.grad(loss, trained, allow_unused=True)
        grads = iter(grads)
        with torch.no_grad():
            full = []
            for p in leaves:
                g = next(grads) if p.requires_grad else None
                full.append(torch.zeros_like(p) if g is None else g)
            updates, opt_state = self.tx.update(full, opt_state, leaves)
            torch._foreach_add_(leaves, list(updates))
        return params, opt_state, new_state, loss.detach()

    def fit(self, iterator, epochs: int = 1,
            listeners: Sequence[TrainingListener] = (), prefetch: bool = True,
            steps_per_execution: int = 1, telemetry=None) -> "Trainer":
        """Train over ``iterator`` for ``epochs``. The loss of iteration k
        is read back only after iteration k+1 has been dispatched (unless a
        listener needs in-order reporting); every iteration is reported to
        the listeners exactly once, in order. ``prefetch`` draws batches on
        a background thread."""
        if int(steps_per_execution) != 1:
            raise NotImplementedError(f"steps_per_execution is {_NOT_PORTED}")
        if telemetry is not None or any(getattr(l, "telemetry", None) is not None
                                        for l in listeners):
            raise NotImplementedError(f"step telemetry is {_NOT_PORTED}")
        reporter = DeferredScoreReporter(self, listeners)
        perf = [l for l in listeners if isinstance(l, PerformanceListener)]
        for epoch in range(epochs):
            self.epoch = epoch
            for lst in listeners:
                lst.on_epoch_start(self, epoch)
            it = AsyncIterator(iterator) if prefetch else iterator
            for ds in it:
                if isinstance(ds.features, (list, tuple, dict)):
                    raise NotImplementedError(
                        f"multi-input (MultiDataSet) batches are "
                        f"{_NOT_PORTED_GRAPH}")
                for lst in perf:
                    lst.step_begin(ds.num_examples)
                self.params, self.opt_state, self.state, loss = self.step(
                    self.params, self.opt_state, self.state, ds.features,
                    ds.labels, self._gen, ds.features_mask, ds.labels_mask)
                reporter.report(self.iteration, epoch, loss)
                self.iteration += 1
            reporter.flush()
            if hasattr(iterator, "reset"):
                iterator.reset()
            for lst in listeners:
                lst.on_epoch_end(self, epoch)
        self.model.params, self.model.state = self.params, self.state
        return self

    def score_iterator(self, iterator) -> float:
        """Average loss over an iterator (model.score(DataSetIterator))."""
        total, n = 0.0, 0
        with torch.no_grad():
            for ds in iterator:
                loss, _ = _score(
                    self.model, self.params, self.state,
                    self._to_device(ds.features), self._to_device(ds.labels),
                    training=False, rng=None,
                    mask=self._to_device(ds.features_mask),
                    label_mask=self._to_device(ds.labels_mask))
                total += float(loss)
                n += 1
        if hasattr(iterator, "reset"):
            iterator.reset()
        return total / max(n, 1)

    def save(self, path: str) -> None:
        """The model zip with params, state and updater state."""
        save_model(path, self.model, params=self.params, state=self.state,
                   opt_state=self.opt_state)

    @classmethod
    def load(cls, path: str, seed: int = 0, device=None) -> "Trainer":
        """A trainer resuming from a zip written by either package: params,
        state and (when saved) updater state, on ``device`` (the card
        unless named)."""
        model, _, _ = load_model(path, device=device)
        t = cls(model, seed=seed)
        opt_state = load_opt_state(path, t.opt_state)
        if opt_state is not None:
            t.opt_state = opt_state
        return t
