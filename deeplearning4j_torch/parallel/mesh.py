"""Process groups and the data mesh — counterpart of
``deeplearning4j_tpu/parallel/mesh.py``.

The JAX package is single-controller: one process drives a ``Mesh`` of
devices. Here a rank is a process of a ``torch.distributed`` group that
drives one device, NCCL on the card and gloo on the CPU, and rank ``r``
stands for device ``r`` of the JAX mesh: its coordinates are ``r``
unravelled over the mesh's axis sizes in C order, as ``np.reshape`` lays
the devices out there. A global batch splits into contiguous blocks of
rows in data-axis order, block ``i`` to the ranks whose data coordinate
is ``i``. ``Mesh.axis_group(axes)`` is the sub-group of the ranks that
differ only on ``axes`` (the model group of tensor parallelism, the seq
ring, the data x seq group that reduces gradients), made collectively on
first use.

:func:`distributed_init` joins the group (NCCL for a CUDA device, gloo for
the CPU; a failed init raises, it never switches backend), :func:`make_mesh`
names its axes. :class:`RankGroup` and :func:`run_ranks` stand in for the
JAX package's ``cpu_test_mesh``: ``n`` spawned CPU processes in one gloo
group, rendezvousing through a ``file://`` store, each with one intra-op
thread, that run module-level functions (pickled by reference, so the
function's module is what a rank imports) and hand back rank 0's result.
"""

from __future__ import annotations

import os
import queue as _queue
import shutil
import tempfile
import traceback
import uuid
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from .collectives import global_rank

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"


def distributed_init(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, device: DeviceLike = None,
                     backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> bool:
    """Join the default process group: NCCL when ``device`` (default: the
    current CUDA card) is a CUDA device, gloo for the CPU, unless
    ``backend`` names one. ``init_method`` is a ``tcp://`` or ``file://``
    rendezvous (default ``env://``, which reads ``MASTER_ADDR`` and
    friends). Returns True when this call made the group; False when one
    exists already, or when there is nothing to join (no ``init_method``,
    no ``MASTER_ADDR`` and at most one rank). A world of one rank with an
    ``init_method`` is a real group: its collectives run."""
    if dist.is_initialized():
        return False
    if init_method is None and world_size in (None, 1) \
            and "MASTER_ADDR" not in os.environ:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw: Dict[str, Any] = {}
    if backend == "nccl":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank,
                            timeout=timedelta(seconds=timeout_s), **kw)
    return True


class Mesh:
    """Named axes over the ranks of a process group. ``shape`` maps axis
    name to size (in order), ``devices`` is the array of ranks laid out
    over them, ``coords`` this rank's coordinate on each axis, ``device``
    the device this rank drives."""

    def __init__(self, axes: Dict[str, int], group=None, device=None):
        self.shape = dict(axes)
        self.axis_names = tuple(self.shape)
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.devices = np.arange(self.size).reshape(tuple(self.shape.values()))
        self.coords = {k: int(c) for k, c in zip(
            self.axis_names, np.unravel_index(self.rank, self.devices.shape))}
        self.device = torch.device(device)
        self._groups: Dict[tuple, Any] = {}

    @property
    def data_size(self) -> int:
        """Blocks a global batch splits into (1 without a data axis)."""
        return self.shape.get(DATA_AXIS, 1)

    @property
    def data_index(self) -> int:
        """This rank's block of every global batch."""
        return self.coords.get(DATA_AXIS, 0)

    def rows(self, n: int, axis: str = DATA_AXIS) -> slice:
        """This rank's contiguous block of ``n`` global rows (or entries of
        any dimension), which must divide over ``axis`` (the data axis by
        default; one block without such an axis)."""
        k = self.shape.get(axis, 1)
        if n % k:
            raise ValueError(f"{n} rows do not divide over the {axis} "
                             f"axis of size {k}")
        b = n // k
        i = self.index(axis)
        return slice(i * b, (i + 1) * b)

    def axis_group(self, axes: Sequence[str]):
        """The process group of the ranks that differ from this one only on
        ``axes`` (a name or names of this mesh's axes), made on first use
        and kept. Collective: every rank of the mesh makes every such group
        of the same axes in the same order, so all ranks call this with the
        same ``axes`` together."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        if key not in self._groups:
            moving = [self.axis_names.index(a) for a in key]
            fixed = [i for i in range(len(self.axis_names))
                     if i not in moving]
            order = fixed + moving
            grid = np.transpose(self.devices, order)
            n = int(np.prod([self.devices.shape[i] for i in moving] or [1]))
            mine = None
            for block in grid.reshape(-1, n):
                ranks = [global_rank(self.group, int(r)) for r in block]
                g = dist.new_group(ranks)
                if self.rank in block:
                    mine = g
            self._groups[key] = (mine, n)
        return self._groups[key][0]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 off the mesh)."""
        return self.coords.get(axis, 0)

    def drives(self, device) -> bool:
        """Whether ``device`` is this rank's (``"cuda"`` meaning the
        current card)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device == self.device


def _group_device(group=None) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(axes: Optional[Dict[str, int]] = None, group=None,
              device: DeviceLike = None) -> Mesh:
    """Name the axes of ``group`` (default: the default group). ``axes``
    maps axis name to size, -1 once to take the remaining ranks; default:
    every rank on the data axis (the ParallelWrapper topology). The
    device is the card for an NCCL group, the CPU for gloo, unless
    named."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call distributed_init (or "
                           "run the function in a RankGroup) first")
    n = dist.get_world_size(group)
    axes = dict(axes) if axes else {DATA_AXIS: n}
    known = int(np.prod([v for v in axes.values() if v != -1]))
    for k, v in axes.items():
        if v == -1:
            axes[k] = n // known
    total = int(np.prod(list(axes.values())))
    if total != n:
        raise ValueError(f"Mesh {axes} needs {total} ranks, have {n}")
    dev = _group_device(group) if device is None else torch.device(device)
    return Mesh(axes, group, dev)


def shard_batch(batch, mesh: Mesh, axis: str = DATA_AXIS):
    """This rank's block of rows of every array in ``batch`` (an array,
    or a dict, list or tuple of them), as tensors on the mesh's device:
    dim 0 split over ``axis``, as the reference's ``PartitionSpec(axis)``
    places it."""
    if batch is None:
        return None
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, axis) for v in batch)
    t = torch.as_tensor(np.asarray(batch) if not torch.is_tensor(batch)
                        else batch)
    return t[mesh.rows(t.shape[0], axis)].to(mesh.device)


def replicate(tree, mesh: Mesh):
    """``tree``'s tensors (arrays become tensors on the mesh's device)
    broadcast from rank 0, in place, so every rank holds rank 0's
    values."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(replicate(v, mesh) for v in tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*[replicate(v, mesh) for v in tree])
    if tree is None:
        return None
    t = tree if torch.is_tensor(tree) else torch.as_tensor(
        np.asarray(tree), device=mesh.device)
    with torch.no_grad():
        dist.broadcast(t.data, src=dist.get_global_rank(mesh.group, 0)
                       if mesh.group is not None else 0, group=mesh.group)
    return t


def local_device_count() -> int:
    """Devices this process drives: one, whatever the group."""
    return 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


# --- spawned gloo ranks: the counterpart of cpu_test_mesh ---

def _rank_main(rank: int, n: int, store: str, inq, outq,
               timeout_s: float) -> None:
    """A spawned rank: one intra-op thread, the gloo group through the
    file store, then the functions sent to it until ``None``; each
    outcome goes back as (rank, ok, result or traceback)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=n, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    try:
        while True:
            msg = inq.get()
            if msg is None:
                break
            fn, args, kwargs = msg
            try:
                outq.put((rank, True, fn(*args, **kwargs)))
            except BaseException:  # noqa: BLE001 - reported to the caller
                outq.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankGroup:
    """``n`` spawned CPU processes in one gloo group, kept alive between
    calls (a spawn costs seconds; a group serves many calls). ``run(fn,
    *args, **kwargs)`` calls ``fn`` on every rank and returns rank 0's
    result; ``run_all`` returns every rank's. ``fn`` must be a module-level
    function (it is pickled by reference). A call that raises on any rank,
    or outlasts ``timeout_s``, raises here and tears the group down; the
    next call starts a new one. ``close`` ends the ranks (each destroys its
    process group) and removes the store's directory when it made it."""

    def __init__(self, n: int, workdir: Optional[str] = None,
                 timeout_s: float = 120.0):
        self.n = int(n)
        self.timeout_s = float(timeout_s)
        self._own_dir = workdir is None
        self.workdir = workdir if workdir is not None else tempfile.mkdtemp(
            prefix="rankgroup-")
        self._procs: List[Any] = []

    def _start(self) -> None:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        store = os.path.join(self.workdir, f"store-{uuid.uuid4().hex}")
        self._inq = [ctx.Queue() for _ in range(self.n)]
        self._outq = ctx.Queue()
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, self.n, store, self._inq[r], self._outq,
                  self.timeout_s)) for r in range(self.n)]
        for p in self._procs:
            p.start()

    def run_all(self, fn: Callable, *args, **kwargs) -> List[Any]:
        if not self._procs:
            self._start()
        for q in self._inq:
            q.put((fn, args, kwargs))
        got: Dict[int, Any] = {}
        errors = []
        try:
            while len(got) + len(errors) < self.n:
                rank, ok, out = self._outq.get(timeout=self.timeout_s + 30)
                if ok:
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
        except _queue.Empty:
            errors.append(f"no answer from ranks "
                          f"{sorted(set(range(self.n)) - set(got))} within "
                          f"{self.timeout_s + 30:.0f} s")
        if errors:
            self._stop(kill=True)
            raise RuntimeError(f"{getattr(fn, '__name__', fn)} failed on "
                               f"{self.n} ranks:\n" + "\n".join(errors))
        return [got[r] for r in range(self.n)]

    def run(self, fn: Callable, *args, **kwargs) -> Any:
        return self.run_all(fn, *args, **kwargs)[0]

    def _stop(self, kill: bool = False) -> None:
        if not kill:
            for q in self._inq:
                q.put(None)
        for p in self._procs:
            if not kill:
                p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = []

    def close(self) -> None:
        if self._procs:
            self._stop()
        if self._own_dir:
            shutil.rmtree(self.workdir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_ranks(fn: Callable, n: int, *args, workdir: Optional[str] = None,
              **kwargs) -> Any:
    """``fn(*args, **kwargs)`` on ``n`` fresh gloo ranks; rank 0's
    result."""
    with RankGroup(n, workdir) as group:
        return group.run(fn, *args, **kwargs)
