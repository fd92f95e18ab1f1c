"""Sharded training checkpoints — counterpart of
``deeplearning4j_tpu/train/orbax_io.py``, with the same functions.

The reference writes through orbax, which the card's machine does not
have; this module keeps the name so a reader finds the counterpart, and
writes a format of its own. Neither package reads the other's directory
(the model zip, ``train/serialization.py``, is the format both read).

A checkpoint is a directory:

- ``model.json``: the model's JSON (``model.to_json()``);
- ``meta.json``: the format, whether updater state was saved and the
  trainer's iteration;
- ``arrays/<writer>.bin`` and ``arrays/<writer>.json``: the blocks one
  writer holds, raw bytes one after another, and their index (each
  block's key, dtype, the whole leaf's shape, the block's box of index
  intervals in it, and its offset in the file).

Each leaf, or each leaf's shard, is written by the rank (or, in the
elastic trainer, the replica) that holds it, with no gather to one host:
a leaf that every rank holds whole is written by rank 0; a leaf split
over a mesh axis by the ranks at coordinate 0 of every other axis; a
ZeRO-1 updater leaf by each data rank for its own block. In the replica
modes (averaging, encoded), where each rank's replica is its own, every
leaf is a (world, ...) array of which each rank writes its row. Keys: ``params/<path>``,
``net_state/<path>``, ``opt_state/<path>`` (the updater state's leaves
by position, ``elastic.reshard.tree_paths``), ``extras/generator`` (the
trainer's ``torch.Generator`` state) and ``extras/residual``.

Restore places each leaf onto a live template: every block the target
holds (a whole leaf, a rules shard, a ZeRO-1 block at any width) is
filled from the saved blocks that overlap it, so a ZeRO-1 updater
restores sharded and a change of width redistributes. It works for
``Trainer`` (with or without ``mesh=``/``rules=``), ``ParallelWrapper``,
``MultiHostTrainer`` and ``elastic.ElasticTrainer``; over a mesh, save
and restore are collective (call them on every rank).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.updaters import tree_leaves, tree_unflatten

FORMAT = "deeplearning4j_torch.orbax_io/1"
ALIGN = 64  # each block starts at a multiple of this in its file

Box = List[Tuple[int, int]]


def _paths(tree):
    # imported here: elastic/ imports the trainer, which this package holds
    from ..elastic.reshard import tree_paths

    return tree_paths(tree)


class Piece(NamedTuple):
    """One block of one leaf as a trainer holds it: ``tensor`` is the
    block (written from, restored into), ``shape`` the whole leaf's,
    ``box`` the block's index intervals in it, ``writer`` the file stem
    that writes it (None: another rank or replica writes this block)."""

    key: str
    tensor: torch.Tensor
    shape: Tuple[int, ...]
    box: Box
    writer: Optional[str]


def whole(key: str, t: torch.Tensor, writer: Optional[str]) -> Piece:
    shape = tuple(int(s) for s in t.shape)
    return Piece(key, t, shape, [(0, s) for s in shape], writer)


def split(key: str, t: torch.Tensor, dim: Optional[int], index: int, n: int,
          writer: Optional[str]) -> Piece:
    """Block ``index`` of ``n`` along ``dim`` (None: the whole leaf)."""
    if dim is None:
        return whole(key, t, writer)
    shape = [int(s) for s in t.shape]
    size = shape[dim]
    shape[dim] = size * n
    box = [(0, s) for s in shape]
    box[dim] = (index * size, (index + 1) * size)
    return Piece(key, t, tuple(shape), box, writer)


# --- the blocks of each kind of trainer ---

def _inner(obj):
    """The ``Trainer`` under a wrapper (or the object itself) and the mesh
    its ranks form (None on one device)."""
    tr = getattr(obj, "trainer", obj)
    mesh = tr.mesh if getattr(tr, "mesh", None) is not None \
        else getattr(obj, "mesh", None)
    return tr, mesh


def _writer(mesh, axis: Optional[str] = None) -> Optional[str]:
    """This rank's file stem when it writes a block split over ``axis``
    (None: a whole leaf): the rank at coordinate 0 of every other axis."""
    if mesh is None:
        return "rank0"
    if any(c for a, c in mesh.coords.items() if a != axis):
        return None
    return f"rank{mesh.rank}"


def _trainer_pieces(obj) -> List[Piece]:
    from ..parallel.mesh import DATA_AXIS
    from ..parallel.sharding import _map_param_lists, param_split, spec_leaves

    tr, mesh = _inner(obj)
    if tr.mesh is None and mesh is not None:
        # a replica mode (averaging, encoded): every rank's replica its own,
        # params, updater state, net state, generator (and residual) alike
        trees = (("params", tr.params), ("net_state", tr.state),
                 ("opt_state", tr.opt_state))
        leaves = [(f"{name}/{p}", t) for name, tree in trees
                  for p, t in _paths(tree)]
        leaves.append(("extras/generator", tr._gen.get_state()))
        if getattr(obj, "residual", None) is not None:
            leaves.append(("extras/residual", obj.residual))
        return [split(k, t[None], 0, mesh.rank, mesh.size, f"rank{mesh.rank}")
                for k, t in leaves]
    params = tree_leaves(tr.params)
    # per param: (dim, axis) of its rules shard, (None, None) when whole
    splits = ([param_split(s) for s in spec_leaves(tr._specs)]
              if tr._specs is not None else [(None, None)] * len(params))

    def ruled(key, t, i):
        d, axis = splits[i]
        if d is None:
            return whole(key, t, _writer(mesh))
        return split(key, t, d, mesh.index(axis), mesh.shape[axis],
                     _writer(mesh, axis))

    out = [ruled(f"params/{path}", p, i)
           for i, (path, p) in enumerate(_paths(tr.params))]
    for path, t in _paths(tr.state):
        out.append(whole(f"net_state/{path}", t, _writer(mesh)))
    # the updater leaves that mirror params, by the local params' shapes
    zero = tr._zero
    local = zero.shards(params) if zero is not None else params
    owner: Dict[int, int] = {}
    _map_param_lists(tr.opt_state, [tuple(t.shape) for t in local],
                     lambda i, t: owner.setdefault(id(t), i))
    for path, t in _paths(tr.opt_state):
        i = owner.get(id(t))
        key = f"opt_state/{path}"
        if i is not None and zero is not None and zero.dims[i] is not None:
            out.append(split(key, t, zero.dims[i], zero.r, zero.n,
                             _writer(mesh, DATA_AXIS)))
        elif i is not None:
            out.append(ruled(key, t, i))
        else:
            out.append(whole(key, t, _writer(mesh)))
    out.append(whole("extras/generator", tr._gen.get_state(), _writer(mesh)))
    return out


def _pieces(obj) -> List[Piece]:
    if hasattr(obj, "checkpoint_pieces"):  # the elastic trainer's replicas
        return obj.checkpoint_pieces()
    return _trainer_pieces(obj)


# --- files ---

def _barrier(obj) -> None:
    _, mesh = _inner(obj)
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier(group=mesh.group)


def _fsync_write(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


def _write_blocks(arrays: str, pieces: List[Piece]) -> None:
    """Each writer's blocks into its own ``.bin`` (streamed a block at a
    time through host memory) and ``.json`` index, both fsynced."""
    by_writer: Dict[str, List[Piece]] = {}
    for pc in pieces:
        if pc.writer is not None:
            by_writer.setdefault(pc.writer, []).append(pc)
    for stem, pcs in by_writer.items():
        index = []
        with open(os.path.join(arrays, f"{stem}.bin"), "wb") as f:
            for pc in pcs:
                f.write(b"\0" * (-f.tell() % ALIGN))
                raw = pc.tensor.detach().reshape(-1).to(
                    "cpu", copy=True).view(torch.uint8).numpy()
                index.append({"key": pc.key, "dtype": str(pc.tensor.dtype),
                              "shape": list(pc.shape),
                              "box": [list(iv) for iv in pc.box],
                              "offset": f.tell(), "nbytes": raw.nbytes})
                f.write(memoryview(raw))
            f.flush()
            os.fsync(f.fileno())
        _fsync_write(os.path.join(arrays, f"{stem}.json"),
                     json.dumps(index))


def _save(directory: str, model, pieces: List[Piece], main: bool,
          meta: dict, barrier=lambda: None) -> str:
    """Every writer's blocks, then (from ``main``) the model's JSON and the
    meta. ``barrier`` runs after the check that the directory holds no
    checkpoint, so no rank writes before every rank has checked."""
    directory = os.path.abspath(directory)
    if os.path.exists(os.path.join(directory, "meta.json")):
        raise FileExistsError(f"{directory} already holds a checkpoint")
    barrier()
    arrays = os.path.join(directory, "arrays")
    os.makedirs(arrays, exist_ok=True)
    _write_blocks(arrays, pieces)
    if main:
        _fsync_write(os.path.join(directory, "model.json"), model.to_json())
        _fsync_write(os.path.join(directory, "meta.json"),
                     json.dumps({"format": FORMAT, **meta}, sort_keys=True))
    return directory


class _Saved:
    """A checkpoint directory's meta and the index of every block."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        meta = os.path.join(self.directory, "meta.json")
        if not os.path.exists(meta):
            raise FileNotFoundError(f"{self.directory} holds no checkpoint "
                                    f"(no meta.json)")
        with open(meta) as f:
            self.meta = json.load(f)
        if self.meta.get("format") != FORMAT:
            raise ValueError(f"{self.directory}: not a checkpoint of this "
                             f"format ({self.meta.get('format')!r})")
        self.blocks: Dict[str, List[Tuple[str, dict]]] = {}
        arrays = os.path.join(self.directory, "arrays")
        for idx in sorted(glob.glob(os.path.join(arrays, "*.json"))):
            stem = os.path.splitext(idx)[0]
            with open(idx) as f:
                for rec in json.load(f):
                    self.blocks.setdefault(rec["key"], []).append(
                        (stem + ".bin", rec))

    def fill(self, pc: Piece) -> None:
        """Copy into ``pc.tensor`` every saved byte of its box."""
        from ..elastic.reshard import box_index, intersect

        recs = self.blocks.get(pc.key)
        if recs is None:
            raise KeyError(f"{self.directory}: no leaf {pc.key!r}")
        covered = 0
        for path, rec in recs:
            if tuple(rec["shape"]) != pc.shape \
                    or rec["dtype"] != str(pc.tensor.dtype):
                raise ValueError(
                    f"{pc.key}: saved {rec['dtype']}{tuple(rec['shape'])}, "
                    f"want {pc.tensor.dtype}{pc.shape}")
            src_box = [tuple(iv) for iv in rec["box"]]
            inter = intersect(pc.box, src_box)
            if inter is None:
                continue
            raw = np.memmap(path, dtype=np.uint8, mode="c",
                            offset=rec["offset"], shape=(rec["nbytes"],))
            src = torch.from_numpy(raw).view(pc.tensor.dtype).reshape(
                [hi - lo for lo, hi in src_box])
            with torch.no_grad():
                pc.tensor[box_index(inter, pc.box)].copy_(
                    src[box_index(inter, src_box)])
            covered += src.numel()
        if covered < pc.tensor.numel():  # blocks of one leaf do not overlap
            raise ValueError(f"{pc.key}: the checkpoint covers {covered} of "
                             f"the {pc.tensor.numel()} elements wanted")


# --- the reference's functions ---

def save_checkpoint(directory: str, model, *, params=None, state=None,
                    opt_state=None, extras=None) -> str:
    """Write ``model``'s params and net state (default: its own), the
    updater state when given and ``extras`` (name -> tensor, saved as
    ``extras/<name>``) as one writer's checkpoint, with the model's JSON.
    ``directory`` must not already hold a checkpoint."""
    params = params if params is not None else model.params
    state = state if state is not None else (model.state or {})
    pieces = [whole(f"params/{p}", t, "rank0") for p, t in _paths(params)]
    pieces += [whole(f"net_state/{p}", t, "rank0")
               for p, t in _paths(state)]
    if opt_state is not None:
        pieces += [whole(f"opt_state/{p}", t, "rank0")
                   for p, t in _paths(opt_state)]
    pieces += [whole(f"extras/{k}", v, "rank0")
               for k, v in (extras or {}).items()]
    return _save(directory, model, pieces, True,
                 {"has_opt_state": opt_state is not None})


def restore_checkpoint(directory: str, template_payload) -> Dict[str, Any]:
    """Whole leaves restored onto the structure, dtypes and devices of
    ``template_payload`` (keys ``params``, ``net_state`` and optionally
    ``opt_state``, as :func:`save_checkpoint` wrote them); the template is
    not modified. An ``opt_state`` the checkpoint lacks comes back as
    ``{}``."""
    saved = _Saved(directory)
    out: Dict[str, Any] = {}
    for name, tree in template_payload.items():
        if name == "opt_state" and not saved.meta["has_opt_state"]:
            out[name] = {}
            continue
        leaves = []
        for path, t in _paths(tree):
            dst = torch.empty_like(t)
            saved.fill(whole(f"{name}/{path}", dst, None))
            leaves.append(dst.requires_grad_(t.requires_grad))
        out[name] = tree_unflatten(tree, leaves)
    return out


def load_model_json(directory: str, device=None):
    """The model rebuilt from the checkpoint's ``model.json`` (params not
    initialized), on ``device`` (the card unless named)."""
    from .serialization import model_from_json

    with open(os.path.join(os.path.abspath(directory), "model.json")) as f:
        return model_from_json(f.read(), device=device)


def save_trainer(directory: str, trainer) -> str:
    """Save a ``Trainer``, ``ParallelWrapper``, ``MultiHostTrainer`` or
    ``ElasticTrainer``: params, net state, updater state, the generator's
    state, the iteration and the encoded mode's residual. Collective over
    a mesh (every rank returns after every rank has written)."""
    _, mesh = _inner(trainer)
    main = mesh is None or mesh.rank == 0
    out = _save(directory, trainer.model, _pieces(trainer), main,
                {"has_opt_state": True,
                 "iteration": int(getattr(trainer, "iteration", 0))},
                barrier=lambda: _barrier(trainer))
    _barrier(trainer)
    return out


def restore_trainer(directory: str, trainer):
    """Restore a saved trainer in place, each leaf onto the trainer's own
    layout (its shards under rules or ZeRO-1, at any width); the updater
    state only when one was saved, the generator's state, the iteration
    and the residual when the checkpoint has them. The model's params and
    state are pointed at the restored ones. Returns the trainer."""
    saved = _Saved(directory)
    for pc in _pieces(trainer):
        if pc.key.startswith("opt_state/") and not saved.meta["has_opt_state"]:
            continue
        if pc.key.startswith("extras/") and pc.key not in saved.blocks:
            continue
        saved.fill(pc)
        if pc.key == "extras/generator":  # get_state() gave a copy
            _inner(trainer)[0]._gen.set_state(pc.tensor.reshape(-1))
    if "iteration" in saved.meta:
        trainer.iteration = int(saved.meta["iteration"])
    if hasattr(trainer, "_sync_model"):
        trainer._sync_model()
    else:
        trainer.model.params, trainer.model.state = (trainer.params,
                                                     trainer.state)
    _barrier(trainer)
    return trainer
