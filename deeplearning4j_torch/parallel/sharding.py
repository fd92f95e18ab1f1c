"""Sharding rules and the one sharding API — counterpart of
``deeplearning4j_tpu/parallel/sharding.py``.

**Rules and specs.** A rule table maps a param path regex to a spec: a
tuple of mesh axis names (or None) per dimension, the JAX package's
``PartitionSpec`` as a tuple. :func:`spec_for` and :func:`sharding_tree`
give exactly the reference's specs, including its drop to replication for
an axis missing from the mesh or not dividing the dim. :func:`place_params`
gives each rank its own shard of every leaf (contiguous blocks, as a
``NamedSharding`` lays them out); :func:`gather_params` puts them back
together. Param specs may name the ``model`` axis only.

**Tensor parallelism over ``model``, with explicit collectives**
(``parallel/collectives.py``) where GSPMD inserts them implicitly; the
hook that :class:`activation_sharding` installs on every layer of a
``Sequential`` or ``Graph`` picks each layer's layout from its specs:

- a transformer block (or attention layer) ruled as
  ``TRANSFORMER_RULES`` rules it runs Megatron's layout
  (``nn/layers/attention.py``): its input through ``copy_to`` (identity
  forward, all-reduce backward), the column-parallel ``w_qkv`` and
  ``w_up``, attention on this rank's heads, the row-parallel ``w_o`` and
  ``w_down`` each closed by one ``reduce_from`` (all-reduce forward,
  identity backward). The fused ``w_qkv`` is held as its contiguous
  column block — the reference's shard, whose block at tp 2 holds all of
  q and half of k — so the projection is **gathered after it**
  (``gather_sum``: all-gather forward, reduce-scatter backward) and each
  rank takes its heads' q, k and v from the gathered (B, T, 3D); this
  keeps every leaf's shard the reference's, at one activation gather a
  block;
- a ``Dense``, ``Conv2D``, ``EmbeddingSequence`` or ``Embedding`` whose
  kernel is split along its output dim (``DENSE_RULES``, ``CNN_RULES``,
  ``.*embedding.*/w``) computes its output columns (channels) and the
  activation is gathered along that dim before the next layer
  (``gather_split``), GSPMD's own choice for consecutive column splits;
  the input enters through ``copy_to``. A non-elementwise activation
  (softmax) takes the next route;
- any other layer with a sharded leaf gathers its params first
  (``gather_split``) and runs as on one device.

Gradients then reduce per axis: each rank reduces its own leaves (shards
or whole) over the data x seq sub-group only, so a leaf sharded over
``model`` sums its shard's partials and a replicated leaf is not counted
tp times (``parallel/dp.py``, ``DataParallel(reduce_axes=...)``).

**Sequence parallelism over ``seq``** (a ``Sequential`` fed a batch whose
features are seq-sharded: dim 1 of rank >= 3 arrays and of rank-2 integer
arrays, :func:`batch_sharding`): activations are held as T/sp blocks
through the layers that act position by position (embeddings, learned
positions and rope at global positions — block offset + local index —
transformer blocks, norms, dense and output layers); attention takes the
ring where the reference does (``ring=True``, no mask, no dropout, no
window, T divisible) and otherwise gathers q, k and v over ``seq``; any
other layer gathers its input over ``seq`` first (correct, but no memory
saved) and its output is cut back to this rank's block when it keeps the
sequence dim. A feature or label mask is cut along with the features or
labels it masks. A ``Graph``'s batch is not seq-sharded (every seq rank
holds the whole sequence).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, SEQ_AXIS

Spec = Tuple[Optional[str], ...]
Rules = Sequence[Tuple[str, Spec]]

# the transformer layer family (attention.py param names)
TRANSFORMER_RULES: Rules = (
    (r"(.*/)?w_qkv", (None, MODEL_AXIS)),  # column parallel
    (r"(.*/)?b_qkv", (MODEL_AXIS,)),
    (r"(.*/)?w_o", (MODEL_AXIS, None)),    # row parallel
    (r"(.*/)?w_up", (None, MODEL_AXIS)),
    (r"(.*/)?b_up", (MODEL_AXIS,)),
    (r"(.*/)?w_down", (MODEL_AXIS, None)),
    (r".*embedding.*/w", (None, MODEL_AXIS)),
    (r"(.*/)?pos", ()),
)

# conv stacks (zoo CNNs): HWIO kernels split on output channels
CNN_RULES: Rules = (
    (r".*/w$", (None, None, None, MODEL_AXIS)),
    (r".*/b$", (MODEL_AXIS,)),
)

# plain MLP stacks: every dense kernel column parallel
DENSE_RULES: Rules = (
    (r".*/w$", (None, MODEL_AXIS)),
    (r".*/b$", (MODEL_AXIS,)),
)


def zero_shard_dim(shape: Sequence[int], n: int) -> Optional[int]:
    """The dimension a ZeRO-1 updater-state leaf of ``shape`` shards over
    ``n`` data-parallel ranks (the largest that ``n`` divides; the first
    of equal ones), or None (kept whole on every rank)."""
    n = int(n)
    if n <= 1 or not shape:
        return None
    divisible = [(d, shape[d]) for d in range(len(shape))
                 if shape[d] % n == 0 and shape[d] >= n]
    if not divisible:
        return None
    return max(divisible, key=lambda t: t[1])[0]


def zero_opt_spec(shape: Sequence[int], n: int) -> Spec:
    """:func:`zero_shard_dim` as a spec over the data axis: () when the
    leaf is kept whole."""
    d = zero_shard_dim(shape, n)
    if d is None:
        return ()
    spec: List[Optional[str]] = [None] * len(shape)
    spec[d] = DATA_AXIS
    return tuple(spec)


# --------------------------------------------------------------- specs

def _tree_paths(tree, prefix=""):
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.extend(_tree_paths(v, f"{prefix}{k}/"))
    else:
        out.append((prefix.rstrip("/"), tree))
    return out


def _map_paths(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix.rstrip("/"), tree)


def spec_for(path: str, leaf, rules: Rules, mesh) -> Spec:
    """The spec of the leaf at ``path``: the first rule whose regex matches
    the whole path, with each axis that is missing from ``mesh`` or does
    not divide its dim dropped (replicated); () when no rule matches."""
    for pattern, spec in rules:
        if re.fullmatch(pattern, path):
            dims = tuple(leaf.shape)
            fixed: List[Any] = []
            for i, ax in enumerate(spec):
                if i >= len(dims):  # a rule written for a higher rank
                    break
                if ax is None:
                    fixed.append(None)
                    continue
                size = mesh.shape.get(ax, 0) if isinstance(ax, str) else 1
                fixed.append(ax if size > 0 and dims[i] % size == 0 else None)
            return tuple(fixed)
    return ()


def sharding_tree(params, mesh, rules: Rules = TRANSFORMER_RULES):
    """The spec of every leaf of ``params``, as a tree of the same
    structure."""
    return _map_paths(lambda p, leaf: spec_for(p, leaf, rules, mesh), params)


def spec_leaves(specs) -> List[Spec]:
    """The specs of a :func:`sharding_tree` in ``tree_leaves`` order (dict
    keys sorted), one a param leaf."""
    if isinstance(specs, dict):
        return [sp for k in sorted(specs) for sp in spec_leaves(specs[k])]
    return [specs]


def sharded_dim(spec: Spec, axis: str = MODEL_AXIS) -> Optional[int]:
    """The dimension ``spec`` splits over ``axis``, or None."""
    for i, ax in enumerate(spec):
        if ax == axis:
            return i
    return None


# an MoE layer's expert leaves, which the reference places over the expert
# axis on their leading (expert) dimension
EXPERT_LEAVES = ("w_up", "b_up", "w_down", "b_down")


def _check_spec(path: str, spec: Spec) -> None:
    for i, ax in enumerate(spec):
        if ax is None or ax == MODEL_AXIS:
            continue
        if ax == EXPERT_AXIS and i == 0 \
                and path.rsplit("/", 1)[-1] in EXPERT_LEAVES:
            continue
        raise ValueError(f"param {path!r} ruled over {ax!r}: params shard "
                         f"over the {MODEL_AXIS!r} axis, and an MoE layer's "
                         f"{', '.join(EXPERT_LEAVES)} over {EXPERT_AXIS!r} "
                         f"on their leading dimension")


def check_specs(specs) -> None:
    """Raises unless every spec of the tree names the model axis, or the
    expert axis on an MoE expert leaf's leading dimension."""
    for path, spec in _tree_paths(specs):
        _check_spec(path, spec)


def param_split(spec: Spec) -> Tuple[Optional[int], Optional[str]]:
    """The dimension a param spec splits and the axis it splits over
    (``model`` or ``expert``), or (None, None)."""
    for axis in (MODEL_AXIS, EXPERT_AXIS):
        d = sharded_dim(spec, axis)
        if d is not None:
            return d, axis
    return None, None


def shard_leaf(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` under ``spec``."""
    d, axis = param_split(spec)
    if d is None:
        return t
    k = mesh.shape[axis]
    size = t.shape[d] // k
    return t.narrow(d, mesh.index(axis) * size, size)


def place_params(params, mesh, rules: Rules = TRANSFORMER_RULES):
    """``params`` (tensors or numpy arrays; every rank holds the same
    values) as this rank's shard of every leaf under ``rules``: contiguous
    copies on the mesh's device (a replicated leaf whole), each leaf as
    the reference's ``addressable_shards`` hold it on this rank's
    device."""
    specs = sharding_tree(params, mesh, rules)

    def place(path, leaf):
        spec = _get(specs, path)
        _check_spec(path, spec)
        t = leaf if torch.is_tensor(leaf) else torch.as_tensor(np.asarray(leaf))
        return shard_leaf(t.detach(), spec, mesh).to(
            mesh.device, copy=True).contiguous()

    return _map_paths(place, params)


shard_params = place_params


def _get(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def gather_leaves(leaves, specs, mesh) -> List[torch.Tensor]:
    """The whole leaves from every rank's ``leaves`` (each its shard under
    its spec in ``specs``, over the model or the expert axis); a
    replicated leaf as it is. One all-gather over the axis's group a
    dtype, whatever the count of leaves; none where the axis is 1 (each
    shard is whole). Collective."""
    from .collectives import all_gather_dim

    out = list(leaves)
    groups: Dict[Tuple[str, torch.dtype], List[int]] = {}
    for i, (t, spec) in enumerate(zip(leaves, specs)):
        d, axis = param_split(spec)
        if d is not None and mesh.shape.get(axis, 1) > 1:
            groups.setdefault((axis, t.dtype), []).append(i)
    for (axis, _), idx in groups.items():
        n = mesh.shape[axis]
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        every = all_gather_dim(flat[None], mesh.axis_group(axis), 0)
        o = 0
        for i in idx:
            t, d = leaves[i], param_split(specs[i])[0]
            out[i] = torch.cat([every[r, o:o + t.numel()].view(t.shape)
                                for r in range(n)], dim=d)
            o += t.numel()
    return out


def gather_params(params, mesh, specs):
    """The whole params from this rank's shards (``specs`` from
    :func:`sharding_tree` on the whole tree). Collective."""
    paths = _tree_paths(params)
    whole = dict(zip([p for p, _ in paths], gather_leaves(
        [t for _, t in paths], [_get(specs, p) for p, _ in paths], mesh)))
    return _map_paths(lambda p, _: whole[p], params)


def _map_param_lists(tree, shapes, fn):
    """``tree`` (an updater state) with ``fn(i, t)`` applied to each tensor
    of every list or tuple that mirrors the params (one entry a leaf,
    shaped as ``shapes[i]``, or None); everything else kept."""
    n = len(shapes)
    if isinstance(tree, dict):
        return {k: _map_param_lists(v, shapes, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        if fields is None and len(tree) == n and all(
                t is None or (torch.is_tensor(t)
                              and tuple(t.shape) == tuple(shapes[i]))
                for i, t in enumerate(tree)):
            return type(tree)(None if t is None else fn(i, t)
                              for i, t in enumerate(tree))
        items = [_map_param_lists(v, shapes, fn) for v in tree]
        return type(tree)(*items) if fields is not None else type(tree)(items)
    return tree


def gather_opt_state(opt_state, local_leaves, flat_specs, mesh):
    """The updater state with each entry that mirrors a sharded param
    gathered whole (collective over the model group, one gather a list of
    entries)."""
    shapes = [tuple(t.shape) for t in local_leaves]
    found: List[Tuple[int, torch.Tensor]] = []
    _map_param_lists(opt_state, shapes, lambda i, t: found.append((i, t)))
    whole = iter(gather_leaves([t for _, t in found],
                               [flat_specs[i] for i, _ in found], mesh))
    return _map_param_lists(opt_state, shapes, lambda i, t: next(whole))


def shard_opt_state(opt_state, full_leaves, flat_specs, mesh):
    """A whole updater state (as :func:`gather_opt_state` gives it) cut to
    this rank's shards."""
    shapes = [tuple(t.shape) for t in full_leaves]
    return _map_param_lists(
        opt_state, shapes,
        lambda i, t: shard_leaf(t, flat_specs[i], mesh).contiguous())


# --------------------------------------------------------------- batches

def batch_sharding(mesh, x, *, batch_axis: str = DATA_AXIS,
                   seq_axis: Optional[str] = SEQ_AXIS) -> Spec:
    """dp(+sp) spec of one batch array, by rank and dtype:

    - dim 0 over ``data`` when divisible;
    - dim 1 over ``seq`` for rank >= 3 arrays and for rank-2 INTEGER arrays
      (token ids, sparse targets (B, T)) when divisible: rank-2 floats are
      (B, features) batches whose dim 1 is not a sequence.
    """
    shape = tuple(x.shape)
    dims: List[Optional[str]] = [None] * len(shape)
    if batch_axis in mesh.shape and len(shape) >= 1 and \
            shape[0] % mesh.shape[batch_axis] == 0:
        dims[0] = batch_axis
    integer = (not x.is_floating_point() if torch.is_tensor(x)
               else np.issubdtype(np.asarray(x).dtype, np.integer))
    seqish = len(shape) >= 3 or (len(shape) == 2 and integer)
    if seq_axis and seq_axis in mesh.shape and mesh.shape[seq_axis] > 1 \
            and seqish and shape[1] % mesh.shape[seq_axis] == 0:
        dims[1] = seq_axis
    return tuple(dims)


def place_batch(mesh, *arrays, batch_axis: str = DATA_AXIS,
                seq_axis: Optional[str] = SEQ_AXIS):
    """This rank's block of each (non-None) array under its
    :func:`batch_sharding`."""
    def block(a):
        t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        spec = batch_sharding(mesh, t, batch_axis=batch_axis,
                              seq_axis=seq_axis)
        for d, ax in enumerate(spec):
            if ax is not None:
                sl = mesh.rows(t.shape[d], ax)
                t = t.narrow(d, sl.start, sl.stop - sl.start)
        return t.to(mesh.device)

    return tuple(None if a is None else block(a) for a in arrays)


# --------------------------------------------------------------- activations

def constrain_activations(x, mesh, *, batch_axis: str = DATA_AXIS,
                          seq_axis: Optional[str] = None):
    """The counterpart of ``with_sharding_constraint`` on a whole
    activation every rank holds: this rank's block of it (a
    differentiable slice) — batch over ``data``, and for (B, T, D) T over
    ``seq_axis`` when it divides."""
    batch_axis = batch_axis if batch_axis in mesh.shape else None
    spec = (batch_axis,) + (None,) * (x.ndim - 1)
    if x.ndim == 3 and seq_axis and mesh.shape.get(seq_axis, 1) > 1 \
            and x.shape[1] % mesh.shape[seq_axis] == 0:
        spec = (batch_axis, seq_axis, None)
    for d, ax in enumerate(spec):
        if ax is not None:
            sl = mesh.rows(x.shape[d], ax)
            x = x.narrow(d, sl.start, sl.stop - sl.start)
    return x


# layers that act on each position alone (or, for attention, take care of
# the sequence themselves): they run on a seq block as it is
POSITIONWISE = frozenset((
    "EmbeddingSequence", "PositionalEmbedding", "TransformerEncoderBlock",
    "MultiHeadAttention", "LayerNorm", "RMSNorm", "Dense", "ActivationLayer",
    "DropoutLayer", "GaussianNoise", "GaussianDropout", "AlphaDropout",
    "ElementWiseMultiplication", "PReLU", "Output", "RnnOutput", "LossLayer",
    "RnnLossLayer"))

# layers whose kernel split on the output dim gives their output columns
COLUMN_LOCAL = frozenset(("Dense", "Conv2D", "EmbeddingSequence",
                          "Embedding"))

# (path in the layer's params, spec) of Megatron's block layout
_ATTN_TP = (("w_qkv", (None, MODEL_AXIS)), ("b_qkv", (MODEL_AXIS,)),
            ("w_o", (MODEL_AXIS, None)))
_MLP_TP = (("w_up", (None, MODEL_AXIS)), ("b_up", (MODEL_AXIS,)),
           ("w_down", (MODEL_AXIS, None)))


def _has_model(specs) -> bool:
    return any(sharded_dim(s) is not None for _, s in _tree_paths(specs))


def _megatron_ok(layer, specs) -> bool:
    """Whether a block's or attention layer's specs are Megatron's layout
    (the tp path in ``attention.py``), every other leaf replicated."""
    name = type(layer).__name__
    want = dict(_ATTN_TP)
    if name == "TransformerEncoderBlock":
        want = {f"attn/{k}": v for k, v in _ATTN_TP}
        want.update(dict(_MLP_TP))
    elif name != "MultiHeadAttention":
        return False
    for path, spec in _tree_paths(specs):
        if path in want:
            if spec != want[path]:
                return False
        elif sharded_dim(spec) is not None:
            return False
    return all(_has_path(specs, p) for p in want)


def _has_path(tree, path: str) -> bool:
    try:
        _get(tree, path)
        return True
    except (KeyError, TypeError):
        return False


def _column_ok(layer, specs) -> bool:
    """Whether a layer can compute its output columns from its kernel's
    output-dim split (see the module docstring)."""
    name = type(layer).__name__
    if name not in COLUMN_LOCAL or set(specs) - {"w", "b"} or "w" not in specs:
        return False
    if getattr(layer, "activation", "identity") in ("softmax",) or \
            getattr(layer, "groups", 1) != 1:
        return False
    w = specs["w"]
    if sharded_dim(w) != len(w) - 1 or len(w) < 2:
        return False
    return "b" not in specs or specs["b"] == (MODEL_AXIS,)


@dataclasses.dataclass
class Scope:
    """What the layer being run reads from ``ACTIVE_MESH``: the model
    group when it runs Megatron's layout (else None), its size and this
    rank's index in it; whether its input is a seq block, the seq group
    and the block's first global position."""

    tp_group: Any = None
    tp_size: int = 1
    tp_index: int = 0
    seq: bool = False
    seq_group: Any = None
    offset: int = 0


class MeshContext:
    """The one object behind both ContextVars while a sharded step runs:
    ``ACTIVE_MESH`` (layers read :attr:`scope`) and
    ``ACTIVATION_CONSTRAINT`` (the container calls it around each layer). ``specs`` is the params' spec tree (None: no
    tensor parallelism); ``seq_input`` whether the batch being run feeds
    seq blocks (set per batch by the trainer)."""

    def __init__(self, mesh, specs=None, *,
                 seq_axis: Optional[str] = SEQ_AXIS):
        self.mesh = mesh
        self.specs = specs or {}
        self.seq_axis = (seq_axis if seq_axis and seq_axis in mesh.shape
                         else None)
        self.sp = mesh.shape.get(self.seq_axis, 1) if self.seq_axis else 1
        self.tp = mesh.shape.get(MODEL_AXIS, 1)
        # every sub-group is made here, on every rank in the same order
        self.model_group = mesh.axis_group(MODEL_AXIS)
        self.seq_group = mesh.axis_group(self.seq_axis or ())
        # an MoE layer under a mesh with an expert axis runs its own experts
        # and sums the shares over this group (``nn/layers/moe.py``)
        self.expert_group = (mesh.axis_group(EXPERT_AXIS)
                             if EXPERT_AXIS in mesh.shape else None)
        self.seq_input = False
        self.scope = Scope()
        self._live = False

    # --- the layer hook (Sequential: index = position; Graph: None) ---
    def __call__(self, run, layer, key, p, x, mask, index):
        from .collectives import (all_gather_dim, copy_to, gather_split,
                                  gather_sum)

        specs = self.specs.get(key, {}) if key is not None else {}
        seq = index is not None and self.sp > 1 and (
            self.seq_input if index == 0 else self._live)
        name = type(layer).__name__
        gathered = False
        if seq and name not in POSITIONWISE:
            x = gather_sum(x, self.seq_group, 1)
            if mask is not None and mask.ndim >= 2:
                mask = all_gather_dim(mask, self.seq_group, 1)
            gathered, seq = True, False
        self.scope = Scope(tp_size=self.tp,
                           tp_index=self.mesh.index(MODEL_AXIS), seq=seq,
                           seq_group=self.seq_group,
                           offset=self.mesh.index(self.seq_axis) * x.shape[1]
                           if seq else 0)
        try:
            if not _has_model(specs):
                y, s, m = run(p, x, mask)
            elif _column_ok(layer, specs):
                xin = (copy_to(x, self.model_group)
                       if x.is_floating_point() else x)
                y, s, m = run(p, xin, mask)
                y = gather_split(y, self.model_group, -1)
            elif _megatron_ok(layer, specs):
                self.scope.tp_group = self.model_group
                y, s, m = run(p, x, mask)
            else:
                y, s, m = run(self.gather(p, specs), x, mask)
        finally:
            self.scope = Scope()
        if gathered and torch.is_tensor(y) and y.ndim >= 2 \
                and y.shape[1] == x.shape[1]:
            sl = self.mesh.rows(y.shape[1], self.seq_axis)
            y = y[:, sl]
            if torch.is_tensor(m) and m.ndim >= 2 and m.shape[1] == x.shape[1]:
                m = m[:, sl]
            seq = True
        self._live = seq
        return y, s, m

    def gather(self, p, specs):
        """A layer's params with every model-sharded leaf gathered
        (``gather_split``: its gradient is this rank's slice)."""
        from .collectives import gather_split

        def one(path, leaf):
            d = sharded_dim(_get(specs, path)) if _has_path(specs, path) \
                else None
            return leaf if d is None else gather_split(leaf, self.model_group,
                                                       d)

        return _map_paths(one, p)

    def params_of(self, key, p):
        """The loss layer's params, gathered where sharded."""
        specs = self.specs.get(key, {})
        return self.gather(p, specs) if _has_model(specs) else p

    def __enter__(self):
        from ..nn import api as _api, model as _m

        self._tokens = (_m.ACTIVATION_CONSTRAINT.set(self),
                        _api.ACTIVE_MESH.set(self))
        return self

    def __exit__(self, *exc):
        from ..nn import api as _api, model as _m

        _m.ACTIVATION_CONSTRAINT.reset(self._tokens[0])
        _api.ACTIVE_MESH.reset(self._tokens[1])
        return False


def activation_sharding(mesh, *, seq_axis: Optional[str] = SEQ_AXIS,
                        specs=None, seq_input: bool = False) -> MeshContext:
    """Context manager: while active, every layer of a ``Sequential`` or
    ``Graph`` runs through :class:`MeshContext`'s hook (tensor parallelism
    by ``specs``, seq blocks when ``seq_input``), and mesh-aware layers
    (ring attention) see the mesh. Collective to make (it makes the
    model and seq sub-groups)."""
    ctx = MeshContext(mesh, specs, seq_axis=seq_axis)
    ctx.seq_input = seq_input
    return ctx
