"""Trainer — counterpart of ``deeplearning4j_tpu/train/trainer.py``.

One training step is the reference's ``_step_math``: the model's ``score``
(a ``Sequential`` or a ``Graph``), its gradient, the updater
(``ops.updaters``), then ``params + updates``; the layers' new state (a
BatchNorm's running statistics) is threaded from step to step.
The reference jits it with the params' buffers donated; here the params
are leaf tensors that the step updates in place under ``no_grad``, which
is the same thing on the card: no second copy of the params. The step
runs on the model's device (the card unless the model was built with
``device="cpu"``); each batch gets there through ``staging.BatchStager``
(pinned buffers and a ``non_blocking`` copy on a copy stream).

``fit`` is the plain-step path with prefetch and deferred loss readback,
and the reference's two ways to batch work per update or per dispatch:

- ``Trainer(grad_accum=N)``: each batch as N sequential microbatches,
  their gradients summed weighted by each microbatch's loss-reduction
  mass, net state threaded through them, one updater call (the
  reference's ``_make_accum_step``; eager here on every device);
- ``fit(steps_per_execution=K)``: K steps as one program. On the card it
  is a CUDA graph, captured once per batch signature and replayed once per
  window of K batches; on the CPU the same K steps run eagerly through the
  same code (:meth:`Trainer._k_steps`).

Truncated BPTT (``NetConfig.tbptt_length``, the reference's
``_fit_tbptt_batch``): a batch whose features have 3 or more dimensions is
cut along time into chunks of that length (a ragged tail padded to it,
with a feature mask of ones over its real steps and zeros over the pad,
its labels padded too); each chunk is one update from the recurrent
layers' carries (``Sequential.score_with_carry``), which are detached at
the chunk's end; the batch's loss is the unweighted mean of the chunk
losses. ``steps_per_execution`` is ignored under tBPTT, and a ``Graph``
refuses it, as in the reference.

Frozen layers (``nn.layers.special.Frozen``, made by ``nn.transfer``)
take the ``noop`` updater, as the reference labels them: their leaves are
kept out of autograd (no gradient is computed or stored for them) and out
of the in-place add, and their (empty) updater state sits where optax
puts it. A ``Graph`` fits on ``MultiDataSet`` batches (:func:`unpack_batch`:
features by input name, labels and label masks by output); such batches
run as single steps under ``steps_per_execution``.

Beside training: :func:`evaluate_model` (``Trainer.evaluate`` and the
model's own ``evaluate``), :func:`score_model`, ``save(path,
normalizer=)`` and ``pretrain_layer`` (layerwise unsupervised fit of an
``AutoEncoder`` or ``VAE`` with adam, as the reference's).

``fit(telemetry=)`` takes an ``obs.StepTelemetry``-shaped object
(duck-typed: this module never imports ``obs``, so a fit without telemetry
makes no call into it); a listener's ``.telemetry`` is adopted when none
is given. Telemetry times each step's data wait, dispatch and device
compute, fencing every step, so it forces single steps.

``Trainer(model, mesh=make_mesh({"data": n}))`` is pure data parallelism
over the mesh's process group (``parallel/``), the reference's "no rules"
case: every rank builds the trainer, rank 0's params and net state are
broadcast to the others, and every rank feeds the same global batches to
``fit``, of which it trains on its own contiguous block of rows
(``Mesh.rows``: the batch must divide over the data axis); gradients and
the loss are reduced over the group by loss mass (``parallel.dp``), so
each step is the global batch's step. ``score_iterator`` and
``evaluate`` split each global batch over the ranks the same way, and
``save`` writes from rank 0. Under a mesh ``steps_per_execution`` runs
single steps, and tBPTT is refused.

``Trainer(model, mesh=, rules=)`` is the one sharding API: tensor and
sequence parallelism by a rule table (``parallel/sharding.py``). Each
rank holds its shard of every leaf (``params``; ``full_params()`` gathers
them), its block of rows and, for a ``Sequential``, its seq block of each
batch (``_rank_batch``); every step runs under the rules' layer hook
(``MeshContext``), and the loss and gradients reduce by loss mass over
every axis but ``model``. ``fit`` leaves the trainer's leaves in
``model.params``, as the reference leaves its sharded arrays there: this
rank's shards where the model axis splits a leaf, so no rank holds a
whole copy beside them (a model axis of 1 shards nothing: they are the
whole params). Whole leaves are gathered only where they are needed:
``full_params()`` (a collective; call it on every rank) and ``save``,
which writes whole params and updater state from rank 0. ``evaluate``
and ``score_iterator`` split each batch's rows over the data axis and
run whole sequences. Gradient normalization and
``pretrain_layer`` are refused under rules that shard a leaf.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..data.iterators import AsyncIterator, MultiDataSet
from ..nn.layers.special import Frozen
from ..nn.model import Graph, Sequential, _layer_key
from ..ops import updaters as upd
from ..ops.updaters import Transform, tree_leaves
from .listeners import DeferredScoreReporter, PerformanceListener, TrainingListener
from .serialization import load_model, load_opt_state, save_model
from .staging import BatchStager


def accum_supported(model, mask, label_mask) -> bool:
    """Whether ``grad_accum``'s microbatch accumulation is exact for this
    batch (the reference's rule): unmasked batches always; a masked
    ``Sequential`` through mass-weighted recombination (one effective loss
    mask); a masked ``Graph`` never (per-output masks would need
    per-output masses). Otherwise the batch takes the plain step."""
    if mask is None and label_mask is None:
        return True
    if not isinstance(model, Sequential):
        return False
    return not any(getattr(l, "aux_loss_weight", None) is not None
                   for l in model.layers)


def _one_loss_output(model) -> bool:
    """A Sequential, or a Graph with one output: grad_accum over a mesh
    divides one summed loss by one summed mass."""
    return not isinstance(model, Graph) or len(model.outputs) == 1


def _clone_tree(tree):
    return upd.tree_unflatten(tree, [
        t.detach().clone().requires_grad_(t.requires_grad)
        for t in tree_leaves(tree)])


def _detached(tree):
    return upd.tree_unflatten(tree, [t.detach() for t in tree_leaves(tree)])


def _pad_time(t, pad: int):
    """``t`` with ``pad`` zero steps appended along axis 1."""
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))],
                     dim=1)


def _ndim(a) -> int:
    return a.ndim if hasattr(a, "ndim") else np.ndim(a)


def _batch_sig(obj):
    """Structure, shapes and dtypes of a batch's parts (arrays or tensors,
    in tuples, lists and dicts): the batches of one captured window must
    agree on it, and telemetry counts a compile miss per new one."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return ("dict",) + tuple((k, _batch_sig(v)) for k, v in
                                 sorted(obj.items()))
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,) + tuple(_batch_sig(v) for v in obj)
    return (tuple(np.shape(obj)), str(getattr(obj, "dtype", type(obj))))


class _Captured:
    """K training steps captured as one CUDA graph for one batch
    signature: the slot buffers it reads the K batches from ((K, ...) per
    part, None where the signature has no such part) and the (K,) losses
    it writes."""

    def __init__(self, graph, slots, losses):
        self.graph, self.slots, self.losses = graph, slots, losses


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
    normalization) and per-layer ``updater`` overrides and ``Frozen``
    layers, which become a multi-transform keyed by layer (a Graph's by
    node name), labelled as the reference labels them (``__default__``,
    ``noop`` for frozen layers, ``override_<key>``). Each branch's
    per-layer gradient normalization sees its own leaves only."""
    cfg = model.config
    owners = _leaf_owners(model.param_shapes())

    def base_tx(updater_cfg, idx):
        return upd.build(updater_cfg,
                         gradient_normalization=cfg.gradient_normalization,
                         gradient_normalization_threshold=cfg.gradient_normalization_threshold,
                         l1=cfg.l1, l2=cfg.l2,
                         owners=[owners[i] for i in idx])

    labels_by_name: Dict[str, str] = {}
    overrides: Dict[str, Any] = {}
    for key, layer in _named_layers(model):
        if isinstance(layer, Frozen):
            labels_by_name[key] = "noop"
        elif getattr(layer, "updater", None) is not None:
            labels_by_name[key] = f"override_{key}"
            overrides[f"override_{key}"] = layer.updater
    if not labels_by_name:
        return base_tx(cfg.updater, range(len(owners)))
    labels = [labels_by_name.get(k, "__default__") for k in owners]

    def idx(label):
        return [i for i, lb in enumerate(labels) if lb == label]

    transforms = {"__default__": base_tx(cfg.updater, idx("__default__"))}
    if "noop" in labels:
        transforms["noop"] = upd.set_to_zero()
    for label, ov in overrides.items():
        transforms[label] = base_tx(ov, idx(label))
    return upd.multi_transform(transforms, labels)


def frozen_leaves(model) -> List[bool]:
    """Whether each leaf of ``model``'s params (in ``tree_leaves`` order)
    belongs to a ``Frozen`` layer."""
    frozen = {k for k, l in _named_layers(model) if isinstance(l, Frozen)}
    return [k in frozen for k in _leaf_owners(model.param_shapes())]


def model_output_width(model) -> int:
    """Width of the model's primary output (Sequential or Graph)."""
    return (model.output_shape[-1] if isinstance(model, Sequential)
            else model.output_shapes[0][-1])


def default_evaluation(model):
    """A multiclass ``Evaluation`` sized to the model's primary output."""
    from ..eval import Evaluation

    return Evaluation(model_output_width(model))


def unpack_batch(model, ds):
    """(x, y, feature mask, label mask) of a ``DataSet`` or a
    ``MultiDataSet`` (the reference's rule): a MultiDataSet's features map
    onto a Graph's inputs by position (a dict by input name), its labels
    and label masks stay lists in output order."""
    if not isinstance(ds, MultiDataSet):
        return ds.features, ds.labels, ds.features_mask, ds.labels_mask
    if not isinstance(model, Graph):
        raise TypeError("MultiDataSet batches require a Graph model")
    names, outs = model.inputs, model.outputs
    for what, seq, want in (("feature arrays", ds.features, names),
                            ("feature masks", ds.features_masks, names),
                            ("label arrays", ds.labels, outs),
                            ("label masks", ds.labels_masks, outs)):
        if seq is not None and len(seq) != len(want):
            raise ValueError(f"MultiDataSet has {len(seq)} {what}; Graph "
                             f"expects {want}")
    if getattr(model.config, "tbptt_length", 0):
        raise ValueError(
            "tbptt_length is set but tBPTT is not supported for "
            "MultiDataSet/Graph fit — train full-BPTT "
            "(tbptt_length=0) or use a Sequential model")
    x = dict(zip(names, ds.features))
    fm = (dict(zip(names, ds.features_masks))
          if ds.features_masks is not None else None)
    lm = list(ds.labels_masks) if ds.labels_masks is not None else None
    return x, list(ds.labels), fm, lm


def _inference(model, params, state, x, mask):
    """The primary output of an inference forward."""
    with torch.no_grad():
        if isinstance(model, Sequential):
            return model.forward(params, state, x, training=False,
                                 mask=mask)[0]
        return model.forward(params, state, x, training=False,
                             masks=mask)[0][0]


def evaluate_model(model, params, state, iterator, evaluation=None,
                   stage=None):
    """Streaming evaluation of ``model`` at (params, state) over an
    iterator, on the model's device (the engine behind
    ``Trainer.evaluate`` and the model's own ``evaluate``): a multi-output
    Graph is evaluated on its first output, with its first label mask."""
    if evaluation is None:
        evaluation = default_evaluation(model)
    stage = stage or BatchStager(model.device)
    for ds in iterator:
        x, y, fm, lm = unpack_batch(model, ds)
        preds = _inference(model, params, state, stage(x), stage(fm))
        if isinstance(y, list):
            y = y[0]
            lm = lm[0] if lm else None
        evaluation.eval(y, preds, mask=lm)
    if hasattr(iterator, "reset"):
        iterator.reset()
    return evaluation


def score_model(model, params, state, iterator, stage=None) -> float:
    """Average inference-mode loss over an iterator
    (``model.score(DataSetIterator)``)."""
    stage = stage or BatchStager(model.device)
    total, n = 0.0, 0
    with torch.no_grad():
        for ds in iterator:
            x, y, fm, lm = (stage(a) for a in unpack_batch(model, ds))
            loss, _ = _score(model, params, state, x, y, training=False,
                             rng=None, mask=fm, label_mask=lm)
            total += float(loss)
            n += 1
    if hasattr(iterator, "reset"):
        iterator.reset()
    return total / max(n, 1)


def dp_score_iterator(dp, model, params, state, iterator, stage) -> float:
    """:func:`score_model` with each global batch split over ``dp``'s
    ranks (``DataParallel.score``): the mean of the batches' losses."""
    total, n = 0.0, 0
    for ds in iterator:
        x, y, fm, lm = (stage(a) for a in unpack_batch(model, ds))
        total += float(dp.score(model, params, state, x, y, fm, lm))
        n += 1
    if hasattr(iterator, "reset"):
        iterator.reset()
    return total / max(n, 1)


def dp_evaluate(dp, model, params, state, iterator, evaluation=None,
                stage=None):
    """:func:`evaluate_model` with each global batch's forward split over
    ``dp``'s ranks (``DataParallel.infer``); every rank evaluates the
    whole batch's predictions."""
    if evaluation is None:
        evaluation = default_evaluation(model)
    stage = stage or BatchStager(model.device)
    for ds in iterator:
        x, y, fm, lm = unpack_batch(model, ds)
        preds = dp.infer(model, params, state, stage(x), stage(fm))
        if isinstance(y, list):
            y = y[0]
            lm = lm[0] if lm else None
        evaluation.eval(y, preds, mask=lm)
    if hasattr(iterator, "reset"):
        iterator.reset()
    return evaluation


class Trainer:
    """Owns the params, net state and updater state of one model and runs
    its training steps (Solver parity)."""

    def __init__(self, model: Union[Sequential, Graph],
                 updater: Optional[Transform] = None,
                 seed: int = 0, mesh=None, rules=None, grad_accum: int = 1):
        self.model = model
        self.grad_accum = max(1, int(grad_accum))
        self.tx = updater if updater is not None else build_updater(model)
        if model.params is None:
            model.init()
        self.device = model.device
        # leaf tensors updated in place by every step (the counterpart of
        # the reference's donated buffers)
        # frozen leaves take no gradient; under build_updater's noop they
        # take no update either (a caller's own updater gets their zeros,
        # as the reference's stop-gradient gives it)
        self._frozen = frozen_leaves(model)
        self._noop = updater is None
        self.params = upd.tree_unflatten(model.params, [
            p.detach().requires_grad_(p.is_floating_point() and not frozen)
            for p, frozen in zip(tree_leaves(model.params), self._frozen)])
        self.state = model.state if model.state is not None else {}
        self.mesh = mesh
        self.rules = tuple(rules) if rules is not None else None
        self._dp = None
        self._zero = None  # parallel.dp.ZeroOne: ParallelWrapper's ZeRO-1
        self._ctx = None   # parallel.sharding.MeshContext under rules=
        self._specs = None
        self._sharded = None  # per leaf: sharded over the model or expert axis
        if mesh is None and rules is not None:
            raise ValueError("rules= shards params over a mesh: pass mesh=")
        if mesh is not None:
            from ..parallel.dp import DataParallel
            from ..parallel.mesh import replicate

            if not mesh.drives(self.device):
                raise ValueError(f"the model is on {self.device}, the "
                                 f"mesh's rank drives {mesh.device}")
            # one program: every rank starts from rank 0's params and state
            replicate(self.params, mesh)
            self.state = replicate(self.state, mesh)
            if self.rules is None:
                self._dp = DataParallel(mesh)
            else:
                self._init_rules()
        self.opt_state = self.tx.init(tree_leaves(self.params))
        self.iteration = 0
        self.epoch = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._stage = BatchStager(self.device)
        # steps_per_execution: windows run, CUDA graphs captured (one per
        # batch signature), the trees the graphs read and write in place
        self.windows = 0
        self.captures = 0
        self._graphs: Dict[tuple, _Captured] = {}
        self._graph_stream = None
        self._static = None

    def _init_rules(self) -> None:
        """Tensor and sequence parallelism (``parallel/sharding.py``): each
        leaf held as this rank's shard under the rules (a view where the
        shard is the whole leaf), the layer hook of a ``MeshContext``, and
        the gradients reduced over every axis but ``model`` and ``expert``
        (an expert rank holds the same tokens as its peers: its experts'
        gradients are its own, the router's whole on every rank)."""
        from ..parallel.dp import DataParallel
        from ..parallel.mesh import EXPERT_AXIS, MODEL_AXIS
        from ..parallel.sharding import (MeshContext, check_specs,
                                         param_split, shard_leaf,
                                         sharding_tree, spec_leaves)

        mesh = self.mesh
        self._specs = sharding_tree(self.params, mesh, self.rules)
        flat = spec_leaves(self._specs)
        check_specs(self._specs)
        self._sharded = [param_split(sp)[0] is not None for sp in flat]
        if any(self._sharded) and self.model.config.gradient_normalization:
            raise ValueError(
                "gradient normalization needs whole leaves; rules= shards "
                "some over the model axis: train without gradient "
                "normalization or with rules that replicate every leaf")
        self.params = upd.tree_unflatten(self.params, [
            shard_leaf(p.detach(), sp, mesh).contiguous().requires_grad_(
                p.requires_grad)
            for p, sp in zip(tree_leaves(self.params), flat)])
        self._dp = DataParallel(mesh, [a for a in mesh.axis_names
                                       if a not in (MODEL_AXIS, EXPERT_AXIS)])
        self._ctx = MeshContext(mesh, self._specs)

    def _rank_batch(self, batch, rows: bool = True):
        """This rank's part of one batch ``(x, y, mask, label_mask)``: its
        block of rows (``rows``: the batch is global; otherwise it is this
        rank's shard already) and, under rules for a ``Sequential``, its
        seq block of every array that ``batch_sharding`` puts over ``seq``
        — a mask with the features or labels it masks. Sets the step's
        ``seq_input``."""
        from ..parallel.dp import n_rows, take_rows

        if rows:
            sl = self.mesh.rows(n_rows(batch[0]))
            batch = tuple(take_rows(a, sl) for a in batch)
        if self._ctx is None:
            return batch
        x, y, fm, lm = batch
        self._ctx.seq_input = False
        if not isinstance(self.model, Sequential) or self._ctx.sp == 1:
            return batch
        from ..parallel.mesh import SEQ_AXIS
        from ..parallel.sharding import batch_sharding

        def cut(a, along=None):
            if a is None:
                return None, False
            spec = batch_sharding(self.mesh, a, batch_axis=None)
            if along is not None:  # a mask: with what it masks
                seq = along[1] and _ndim(a) >= 2 \
                    and a.shape[1] == along[0].shape[1]
            else:
                seq = len(spec) > 1 and spec[1] == SEQ_AXIS
            if not seq:
                return a, False
            sl = self.mesh.rows(a.shape[1], SEQ_AXIS)
            return a[:, sl], True

        x2, x_seq = cut(x)
        y2, y_seq = cut(y)
        fm2, _ = cut(fm, (x, x_seq))
        lm2, _ = cut(lm, (y, y_seq))
        self._ctx.seq_input = x_seq
        return x2, y2, fm2, lm2

    def full_params(self):
        """The whole params: this rank's own under data parallelism or on
        one device; under rules the shards gathered (a collective over the
        model axis; none where that axis is 1)."""
        if self._ctx is None:
            return self.params
        from ..parallel.sharding import gather_params

        return gather_params(self.params, self.mesh, self._specs)

    def full_opt_state(self):
        """The updater state with every leaf that mirrors a sharded param
        gathered (collective under rules)."""
        if self._ctx is None:
            return self.opt_state
        from ..parallel.sharding import gather_opt_state

        from ..parallel.sharding import spec_leaves

        return gather_opt_state(self.opt_state, tree_leaves(self.params),
                                spec_leaves(self._specs), self.mesh)

    def replace_updater(self, tx: Transform, opt_state) -> None:
        """Train on with ``tx`` from ``opt_state`` (a rollback's
        learning-rate backoff chains a scale stage onto the updater). The
        steps captured under the old updater are dropped, so none of them
        replays it or writes the old state's tensors."""
        self.tx = tx
        self.opt_state = opt_state
        self._graphs = {}
        self._static = None

    def step(self, params, opt_state, net_state, x, y, gen=None, mask=None,
             label_mask=None):
        """One training step on one batch: returns ``(params, opt_state,
        net_state, loss)`` with the params updated in place and the loss a
        0-d tensor on the device (not read back)."""
        x, y, mask, label_mask = (self._stage(a)
                                  for a in (x, y, mask, label_mask))
        leaves = tree_leaves(params)
        trained = [p for p in leaves if p.requires_grad]
        if self._dp is not None:  # the global batch's loss and gradient
            with self._sharded_step():
                loss, new_state, grads = self._dp.loss_and_grads(
                    self.model, params, trained, net_state, x, y, gen, mask,
                    label_mask)
        else:
            with torch.enable_grad():
                loss, new_state = _score(self.model, params, net_state, x,
                                         y, training=True, rng=gen,
                                         mask=mask, label_mask=label_mask)
                grads = torch.autograd.grad(loss, trained, allow_unused=True)
        opt_state = self._apply_update(leaves, grads, opt_state)
        return params, opt_state, new_state, loss.detach()

    def tbptt_step(self, params, opt_state, net_state, x, y, carries,
                   gen=None, mask=None, label_mask=None):
        """One tBPTT chunk: the loss from ``carries`` (no gradient flows
        into them: they are detached first), its gradient, one updater
        call. Returns ``(params, opt_state, net_state, new_carries,
        loss)``, the new carries detached and the loss a 0-d device
        tensor."""
        carries = _detached(carries)
        leaves = tree_leaves(params)
        trained = [p for p in leaves if p.requires_grad]
        with torch.enable_grad():
            loss, new_state, new_carries = self.model.score_with_carry(
                params, net_state, x, y, carries, training=True, rng=gen,
                mask=mask, label_mask=label_mask)
            grads = torch.autograd.grad(loss, trained, allow_unused=True)
        opt_state = self._apply_update(leaves, grads, opt_state)
        return (params, opt_state, new_state, _detached(new_carries),
                loss.detach())

    def _fit_tbptt_batch(self, x, y, mask, label_mask):
        """One batch as tBPTT chunks of ``tbptt_length`` steps (see the
        module docstring). No host sync: returns the mean chunk loss as a
        device tensor."""
        if not isinstance(self.model, Sequential):
            raise ValueError(
                "tbptt_length is set but tBPTT is not supported for "
                "MultiDataSet/Graph fit — train full-BPTT "
                "(tbptt_length=0) or use a Sequential model")
        chunk = int(self.model.config.tbptt_length)
        x, y, mask, label_mask = (self._stage(a)
                                  for a in (x, y, mask, label_mask))
        B, T = x.shape[:2]
        carries = self.model.init_carries(B)
        total, n = None, 0
        for t0 in range(0, T, chunk):
            xc, yc = x[:, t0:t0 + chunk], y[:, t0:t0 + chunk]
            mc = None if mask is None else mask[:, t0:t0 + chunk]
            lmc = None if label_mask is None else label_mask[:, t0:t0 + chunk]
            pad = chunk - xc.shape[1]
            if pad:
                if mc is None:
                    mc = torch.ones((B, xc.shape[1]), dtype=torch.float32,
                                    device=x.device)
                xc, yc, mc = (_pad_time(t, pad) for t in (xc, yc, mc))
                if lmc is not None:
                    lmc = _pad_time(lmc, pad)
            (self.params, self.opt_state, self.state, carries,
             loss) = self.tbptt_step(self.params, self.opt_state, self.state,
                                     xc, yc, carries, self._gen, mc, lmc)
            total = loss if total is None else total + loss
            n += 1
        return total / max(n, 1)

    def _updates(self, leaves, grads, opt_state):
        """The updater on the trained leaves' gradients (zeros for unused
        params and the other leaves; None for frozen leaves under the
        ``noop`` of ``build_updater``, whose update is None): returns
        ``(updates, opt_state)``, an update (or None) a leaf. Under
        ParallelWrapper's ZeRO-1 the updater runs on this rank's shards
        and the updates are gathered."""
        grads = iter(grads)
        with torch.no_grad():
            full = []
            for p, frozen in zip(leaves, self._frozen):
                if frozen and self._noop:
                    full.append(None)
                    continue
                g = next(grads) if p.requires_grad else None
                full.append(torch.zeros_like(p) if g is None else g)
            if self._zero is not None:
                return self._zero.updates(full, opt_state, leaves)
            return self.tx.update(full, opt_state, leaves)

    def _apply_update(self, leaves, grads, opt_state):
        """:meth:`_updates`, added to the params in place where the update
        is not None."""
        updates, opt_state = self._updates(leaves, grads, opt_state)
        with torch.no_grad():
            pairs = [(p, u) for p, u in zip(leaves, updates) if u is not None]
            if pairs:
                torch._foreach_add_([p for p, _ in pairs],
                                    [u for _, u in pairs])
        return opt_state

    def accum_step(self, params, opt_state, net_state, x, y, gen=None,
                   mask=None, label_mask=None):
        """One update from ``grad_accum`` sequential microbatches of one
        batch (rows split in order, as the reference reshapes them): each
        microbatch's loss and gradients weigh in by its loss-reduction
        mass (``Sequential.score(with_mass=True)``; 1 for a Graph), the
        sums are divided by the total mass clamped at 1 (an all-masked
        batch gives 0, not NaN), the net state is threaded through every
        microbatch, and the updater runs once. Same return as
        :meth:`step`; the batch must divide by ``grad_accum``."""
        x, y, mask, label_mask = (self._stage(a)
                                  for a in (x, y, mask, label_mask))
        n = self.grad_accum
        mb = x.shape[0] // n
        leaves = tree_leaves(params)
        trained = [p for p in leaves if p.requires_grad]
        if self._dp is not None:  # strided microbatches, mass over the group
            with self._sharded_step():
                loss, net_state, grads = self._dp.accum_loss_and_grads(
                    self.model, params, trained, net_state, x, y, gen, mask,
                    label_mask, n)
            opt_state = self._apply_update(leaves, grads, opt_state)
            return params, opt_state, net_state, loss
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        g_sum, loss_sum, w_sum = None, zero, zero
        for i in range(n):
            rows = slice(i * mb, (i + 1) * mb)
            part = [None if t is None else t[rows]
                    for t in (x, y, mask, label_mask)]
            with torch.enable_grad():
                if isinstance(self.model, Sequential):
                    loss, net_state, w = self.model.score(
                        params, net_state, part[0], part[1], training=True,
                        rng=gen, mask=part[2], label_mask=part[3],
                        with_mass=True)
                    w = w.to(device=self.device, dtype=torch.float32)
                else:
                    loss, net_state = _score(
                        self.model, params, net_state, part[0], part[1],
                        training=True, rng=gen, mask=part[2],
                        label_mask=part[3])
                    w = torch.ones((), dtype=torch.float32,
                                   device=self.device)
                wloss = loss * w
                grads = torch.autograd.grad(wloss, trained,
                                            allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(trained, grads)]
            g_sum = grads if g_sum is None else [a + b for a, b in
                                                 zip(g_sum, grads)]
            loss_sum = loss_sum + wloss.detach()
            w_sum = w_sum + w
        w_sum = torch.clamp(w_sum, min=1.0)
        opt_state = self._apply_update(leaves, [g / w_sum for g in g_sum],
                                       opt_state)
        return params, opt_state, net_state, loss_sum / w_sum

    def _sharded_step(self, seq_input: Optional[bool] = None):
        """The layer hook of rules= for one step (a no-op context without
        rules); ``seq_input`` overrides the batch's (False: every rank
        holds whole sequences, as evaluation does)."""
        import contextlib

        if self._ctx is None:
            return contextlib.nullcontext()
        if seq_input is not None:
            self._ctx.seq_input = seq_input
        return self._ctx

    def _dispatch_train_step(self, x, y, mask, label_mask):
        """One batch through :meth:`accum_step` when ``grad_accum`` > 1,
        the batch divides by it and :func:`accum_supported` holds, else
        through :meth:`step` (one update either way). Returns the device
        loss."""
        x, y, mask, label_mask = (self._stage(a)
                                  for a in (x, y, mask, label_mask))
        fn = self.step
        if self.grad_accum > 1 and x.shape[0] % self.grad_accum == 0 \
                and accum_supported(self.model, mask, label_mask) \
                and (self._dp is None or _one_loss_output(self.model)):
            fn = self.accum_step
        self.params, self.opt_state, self.state, loss = fn(
            self.params, self.opt_state, self.state, x, y, self._gen, mask,
            label_mask)
        return loss

    def fit(self, iterator, epochs: int = 1,
            listeners: Sequence[TrainingListener] = (), prefetch: bool = True,
            steps_per_execution: int = 1, telemetry=None) -> "Trainer":
        """Train over ``iterator`` for ``epochs``. The loss of iteration k
        is read back only after iteration k+1 has been dispatched (unless a
        listener needs in-order reporting); every iteration is reported to
        the listeners exactly once, in order. ``prefetch`` draws batches on
        a background thread.

        ``steps_per_execution=K`` (K > 1) runs K steps as one program
        (:meth:`_exec_window`), with the reference's rules: iteration 0
        always runs alone (a layer may add net state on its first training
        step); batches are buffered K at a time and run as singles when
        their signatures differ or at a ragged epoch tail; one
        ``PerformanceListener.step_begin`` gets the window's total samples.
        It is off with ``grad_accum`` > 1 and with any listener that
        ``requires_sync`` or ``snapshots_state`` (under a window such a
        listener would act or read up to K steps late), and under
        truncated BPTT (``tbptt_length`` set), whose batches of 3 or more
        dimensions go through :meth:`_fit_tbptt_batch`.

        ``telemetry``: an ``obs.StepTelemetry``-shaped object; when
        omitted, the first listener with a ``.telemetry`` attribute
        (``obs.TelemetryListener``) lends its own. Active telemetry times
        data wait, dispatch and device compute of every step (fencing
        each) and turns the window off: K steps as one program have no
        per-iteration edges to time."""
        tel = telemetry
        if tel is None:
            for lst in listeners:
                tel = getattr(lst, "telemetry", None)
                if tel is not None:
                    break
        reporter = DeferredScoreReporter(self, listeners)
        perf = [l for l in listeners if isinstance(l, PerformanceListener)]
        spe = max(1, int(steps_per_execution))
        use_window = (spe > 1 and self.grad_accum == 1 and tel is None
                      and self._dp is None
                      and not self.model.config.tbptt_length
                      and not any(getattr(l, "requires_sync", False)
                                  or getattr(l, "snapshots_state", False)
                                  for l in listeners))
        buf: List[tuple] = []
        for epoch in range(epochs):
            self.epoch = epoch
            if tel is not None:
                tel.tracer.instant("epoch_start", epoch=epoch)
            for lst in listeners:
                lst.on_epoch_start(self, epoch)
            it = AsyncIterator(iterator) if prefetch else iterator
            if tel is not None:
                it = tel.wrap_iterator(it)
            for ds in it:
                batch = unpack_batch(self.model, ds)
                if self._dp is not None:  # this rank's block (and seq block)
                    batch = self._rank_batch(batch)
                if use_window and self.iteration > 0 \
                        and not isinstance(ds, MultiDataSet):
                    buf.append((tuple(self._stage(a) for a in batch),
                                ds.num_examples))
                    if len(buf) == spe:
                        self._exec_window(buf, reporter, epoch, perf)
                        buf.clear()
                    continue
                # a MultiDataSet batch runs alone, after what is buffered
                self._exec_singles(buf + [(batch, ds.num_examples)],
                                   reporter, epoch, perf, tel)
                buf.clear()
            if buf:  # ragged tail: fewer than K buffered at epoch end
                self._exec_singles(buf, reporter, epoch, perf)
                buf.clear()
            reporter.flush()
            if hasattr(iterator, "reset"):
                iterator.reset()
            for lst in listeners:
                lst.on_epoch_end(self, epoch)
        self.model.params, self.model.state = self.params, self.state
        return self

    def _exec_singles(self, buf, reporter, epoch, perf, tel=None):
        """Buffered batches through the single-batch step, in order; each
        through ``tel.step`` when telemetry is on."""
        for batch, n in buf:
            for lst in perf:
                lst.step_begin(n)
            tbptt = (self.model.config.tbptt_length
                     and _ndim(batch[0]) >= 3)
            if tbptt and self._dp is not None:
                raise NotImplementedError(
                    "truncated BPTT over a mesh is not ported; train "
                    "full-BPTT (tbptt_length=0) or without mesh=")
            fn = self._fit_tbptt_batch if tbptt else self._dispatch_train_step
            if tel is not None:
                loss = tel.step(lambda: fn(*batch), sig=_batch_sig(batch),
                                batch_size=n,
                                kind="tbptt" if tbptt else "train")
            else:
                loss = fn(*batch)
            reporter.report(self.iteration, epoch, loss)
            self.iteration += 1

    def _exec_window(self, buf, reporter, epoch, perf):
        """K buffered batches as one program: a CUDA graph replay on the
        card (:meth:`_replay`), the same K steps eagerly on the CPU. Runs
        them as singles when their signatures differ."""
        batches = [b for b, _ in buf]
        if len({_batch_sig(b) for b in batches}) > 1:
            self._exec_singles(buf, reporter, epoch, perf)
            return
        for lst in perf:
            lst.step_begin(sum(n for _, n in buf))
        if self.device.type == "cuda":
            losses = self._replay(batches)
        else:
            slots = self._slots(batches)
            losses = torch.empty(len(batches), dtype=torch.float32,
                                 device=self.device)
            self.params, self.opt_state, self.state = self._k_steps(
                self.params, self.opt_state, self.state, slots, losses)
        self.windows += 1
        reporter.report_window(self.iteration, epoch, losses)
        self.iteration += len(batches)

    @staticmethod
    def _slots(batches, out=None):
        """The K batches stacked part by part into (K, ...) tensors (into
        ``out``'s when given); None for a part the batches lack."""
        slots = []
        for j, parts in enumerate(zip(*batches)):
            if parts[0] is None:
                slots.append(None)
            elif out is None:
                slots.append(torch.stack(parts))
            else:
                slots.append(torch.stack(parts, out=out[j]))
        return slots

    def _k_steps(self, params, opt_state, net_state, slots, losses):
        """K training steps, batch i from slot i of each part, loss i
        written into ``losses[i]``: the body of a window on every device
        (captured on the card). Returns the final trees."""
        xs, ys, fms, lms = slots
        for i in range(losses.shape[0]):
            params, opt_state, net_state, loss = self.step(
                params, opt_state, net_state, xs[i], ys[i], self._gen,
                None if fms is None else fms[i],
                None if lms is None else lms[i])
            losses[i].copy_(loss)
        return params, opt_state, net_state

    # --- steps_per_execution on the card: one CUDA graph per signature ---

    def _adopt(self):
        """Make the live trees the ones the graphs read and write in place
        (the first live trees seen): a step outside a graph (iteration 0,
        a batch run alone) leaves new updater-state and net-state tensors,
        whose values are copied in here."""
        live = (self.params, self.opt_state, self.state)
        if self._static is None:
            self._static = live
            return
        with torch.no_grad():
            for static, new in zip(self._static, live):
                if static is new:
                    continue
                a, b = tree_leaves(static), tree_leaves(new)
                if [(t.shape, t.dtype) for t in a] != \
                        [(t.shape, t.dtype) for t in b]:
                    raise RuntimeError("the trainer's state changed its "
                                       "structure since a step was captured")
                for dst, src in zip(a, b):
                    dst.copy_(src)
        self.params, self.opt_state, self.state = self._static

    def _warm_up(self, slots):
        """One step on copies of the params and states, with the first
        slot's batch, on the graph stream before a capture (as CUDA
        graphs are warmed up): what a library or a kernel wrapper makes
        lazily for a stream (workspaces, K4a's ticketed workspace) is then
        made outside the capture. The generator is put back, so training
        draws what it would have; the copies are dropped."""
        params, opt_state, net_state = (_clone_tree(t) for t in self._static)
        gen_state = self._gen.get_state()
        self.step(params, opt_state, net_state,
                  *(None if s is None else s[0] for s in slots[:2]),
                  self._gen, *(None if s is None else s[0] for s in slots[2:]))
        self._gen.set_state(gen_state)

    def _capture(self, batches) -> _Captured:
        """Capture :meth:`_k_steps` over slot buffers for these batches'
        signature, on the trainer's graph stream, after a warm-up step;
        the graph ends by copying the final updater and net state into
        the trees it started from, so a replay updates them in place. The
        trainer's generator is registered with the graph, so each replay
        draws new dropout masks."""
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        gs = self._graph_stream
        graph = torch.cuda.CUDAGraph()
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                "this PyTorch's CUDAGraph has no register_generator_state: "
                "a captured step would replay the same dropout masks")
        self._adopt()
        slots = self._slots(batches)
        losses = torch.empty(len(batches), dtype=torch.float32,
                             device=self.device)
        gs.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(gs):
            self._warm_up(slots)
        graph.register_generator_state(self._gen)
        params, opt_state, net_state = self._static
        with torch.cuda.graph(graph, stream=gs):
            _, opt_end, state_end = self._k_steps(
                params, opt_state, net_state, slots, losses)
            with torch.no_grad():
                for dst, src in zip(tree_leaves((opt_state, net_state)),
                                    tree_leaves((opt_end, state_end))):
                    if dst is not src:
                        dst.copy_(src)
        torch.cuda.current_stream(self.device).wait_stream(gs)
        self.captures += 1
        return _Captured(graph, slots, losses)

    def _replay(self, batches) -> torch.Tensor:
        """One window on the card: the signature's graph (captured first
        if new), its slots filled with the K staged batches, one replay on
        the graph stream. Returns a copy of the (K,) losses."""
        sig = _batch_sig(batches[0])
        cap = self._graphs.get(sig)
        if cap is None:
            cap = self._graphs[sig] = self._capture(batches)
        self._adopt()
        self._slots(batches, out=cap.slots)
        user = torch.cuda.current_stream(self.device)
        gs = self._graph_stream
        gs.wait_stream(user)
        with torch.cuda.stream(gs):
            cap.graph.replay()
            losses = cap.losses.clone()
        user.wait_stream(gs)
        return losses

    def score_iterator(self, iterator) -> float:
        """Average loss over an iterator (model.score(DataSetIterator));
        over a mesh each global batch is split over the ranks."""
        if self._dp is not None:
            with self._sharded_step(seq_input=False):
                return dp_score_iterator(self._dp, self.model, self.params,
                                         self.state, iterator, self._stage)
        return score_model(self.model, self.params, self.state, iterator,
                           self._stage)

    def evaluate(self, iterator, evaluation=None):
        """Streaming evaluation (an ``Evaluation`` of the primary output
        unless one is given) at the trainer's params and state; over a
        mesh each rank forwards its block and every rank evaluates the
        gathered predictions."""
        if self._dp is not None:
            with self._sharded_step(seq_input=False):
                return dp_evaluate(self._dp, self.model, self.params,
                                   self.state, iterator, evaluation,
                                   self._stage)
        return evaluate_model(self.model, self.params, self.state, iterator,
                              evaluation, self._stage)

    def pretrain_layer(self, layer_index: int, iterator, epochs: int = 1,
                       learning_rate: float = 1e-2, noise=None) -> float:
        """MultiLayerNetwork.pretrainLayer: unsupervised fit of one
        ``AutoEncoder`` or ``VAE`` layer of a Sequential on the inference
        activations of the layers below it, with its own adam at
        ``learning_rate``, one update per batch. ``noise(step, feats)``,
        when given, supplies the layer's noise for step ``step`` (the
        AutoEncoder's ``keep`` mask, the VAE's ``eps``) instead of the
        trainer's generator. Returns the last batch's loss."""
        model = self.model
        if not isinstance(model, Sequential):
            raise TypeError("pretrain_layer needs a Sequential model")
        if self._ctx is not None:
            raise ValueError("pretrain_layer trains one layer on one "
                             "device: call it on a Trainer without rules=")
        layer = model.layers[layer_index]
        if not hasattr(layer, "pretrain_loss"):
            raise TypeError(f"{type(layer).__name__} is not pretrainable")
        key = _layer_key(layer_index, layer)
        kw_name = "eps" if hasattr(layer, "encode") else "keep"
        tx = upd.adam(learning_rate)
        lp = upd.tree_unflatten(self.params[key], [
            t.detach().requires_grad_() for t in tree_leaves(self.params[key])])
        leaves = tree_leaves(lp)
        opt = tx.init(leaves)
        loss, step = None, 0
        for _ in range(epochs):
            for ds in iterator:
                x = self._stage(ds.features)
                with torch.no_grad():
                    feats, _ = model.forward(self.params, self.state, x,
                                             training=False, up_to=layer_index)
                kw = ({kw_name: noise(step, feats)} if noise is not None
                      else {"rng": self._gen})
                with torch.enable_grad():
                    loss = layer.pretrain_loss(lp, feats, **kw)
                    grads = torch.autograd.grad(loss, leaves)
                with torch.no_grad():
                    updates, opt = tx.update(list(grads), opt, leaves)
                    torch._foreach_add_(leaves, list(updates))
                step += 1
            if hasattr(iterator, "reset"):
                iterator.reset()
        self.params = {**self.params, key: lp}
        self.model.params = self.params
        return float(loss.detach())

    def save(self, path: str, normalizer=None) -> None:
        """The model zip with params, state and updater state, and the
        data normalizer when given (``normalizer.json``). Over a mesh rank
        0 writes and every rank waits for it (call it on every rank)."""
        params, opt_state = self.full_params(), self.full_opt_state()
        if self._dp is None or self.mesh.rank == 0:
            save_model(path, self.model, params=params, state=self.state,
                       opt_state=opt_state, normalizer=normalizer)
        if self._dp is not None:
            import torch.distributed as dist

            dist.barrier(group=self.mesh.group)

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
