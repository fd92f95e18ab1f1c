"""Model zips — counterpart of ``deeplearning4j_tpu/train/serialization.py``.

The same zip layout in both packages: ``configuration.json`` (the
Sequential or Graph JSON), ``params.npz`` and ``state.npz`` (the params
and state trees flattened to ``/``-joined key paths, e.g.
``layer_2/attn/w_qkv`` or a Graph's ``s0b0_a_c/w``; a BatchNorm's running
statistics are ``<node>/mean`` and ``<node>/var`` in ``state.npz``) and
``updater_state.npz`` (the updater state's leaves under their index,
``"0"``, ``"1"``, ..., in ``jax.tree_util.tree_leaves`` order — the order
``ops.updaters.tree_leaves`` gives the port's optax-shaped state) and
``normalizer.json`` (the data normalizer's ``to_dict``, when one was
saved). A zip written by either package loads in the other, and training
resumes from it in either.

:func:`params_from_numpy` carries a params tree of numpy arrays (the JAX
package's tree: keys ``layer_i/...`` or a Graph's node names, dense
weights (in, out), conv weights HWIO) into the port's tensors on a
device; :func:`state_from_numpy` does the same for a layer-state tree and
:func:`opt_state_from_numpy` for the leaves of an optax state.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..nn.model import Graph, Sequential
from ..ops.updaters import tree_leaves, tree_unflatten


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix.rstrip("/")] = tree.detach().cpu().numpy()
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _to_tensors(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(np.shape(tree))


def params_from_numpy(model: Union[Sequential, Graph], tree: dict,
                      device: DeviceLike = None) -> dict:
    """The port's params from a tree of arrays with the reference's keys
    and layouts, on ``device`` (default: the model's). Raises if the tree's
    keys or shapes are not the model's."""
    want = model.param_shapes()
    got = _shapes(tree)
    if got != want:
        raise ValueError(f"params tree does not match the model: got {got}, "
                         f"want {want}")
    dev = model.device if device is None else torch.device(device)
    return _to_tensors(tree, dev)


def opt_state_from_numpy(template, leaves: Sequence[Any],
                         device: DeviceLike = None):
    """The port's updater state with ``template``'s structure (a state from
    ``Transform.init`` or ``Trainer``) and ``leaves`` as its leaves, in
    ``tree_leaves`` order: e.g. ``jax.tree_util.tree_leaves`` of the JAX
    package's optax state, as numpy arrays. Raises unless the count,
    shapes and dtypes are the template's."""
    want = tree_leaves(template)
    leaves = [np.asarray(a) for a in leaves]
    if len(leaves) != len(want):
        raise ValueError(f"updater state has {len(leaves)} leaves, the "
                         f"updater {len(want)}")
    out = []
    for i, (a, t) in enumerate(zip(leaves, want)):
        if tuple(a.shape) != tuple(t.shape) or \
                torch.from_numpy(np.zeros((), a.dtype)).dtype != t.dtype:
            raise ValueError(f"updater state leaf {i}: {a.dtype}{a.shape}, "
                             f"want {t.dtype}{tuple(t.shape)}")
        dev = t.device if device is None else torch.device(device)
        out.append(torch.from_numpy(np.array(a, copy=True)).to(dev))
    return tree_unflatten(template, out)


def _save_npz(zf: zipfile.ZipFile, name: str, tree: Any) -> None:
    buf = io.BytesIO()
    np.savez(buf, **_flatten(tree))
    zf.writestr(name, buf.getvalue())


def _load_npz(zf: zipfile.ZipFile, name: str) -> Optional[dict]:
    if name not in zf.namelist():
        return None
    with zf.open(name) as f:
        data = np.load(io.BytesIO(f.read()))
        return _unflatten({k: data[k] for k in data.files})


def model_from_json(js: str, device: DeviceLike = None
                    ) -> Union[Sequential, Graph]:
    """A Sequential or a Graph from its JSON, by the config's format."""
    fmt = json.loads(js).get("format", "")
    cls = Sequential if "sequential" in fmt else Graph
    return cls.from_json(js, device=device)


def state_from_numpy(tree: dict, device: DeviceLike = None) -> dict:
    """A layer-state tree (e.g. BatchNorm running statistics) of arrays as
    the port's tensors on ``device`` (the card unless named)."""
    return _to_tensors(tree, resolve_device(device))


def save_model(path: str, model: Union[Sequential, Graph], *, params=None,
               state=None, opt_state=None, normalizer=None) -> None:
    """Write ``model``'s config and params (default: its own), and the
    updater state and the data normalizer when given, as a zip."""
    params = params if params is not None else model.params
    state = state if state is not None else model.state
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("configuration.json", model.to_json())
        _save_npz(zf, "params.npz", params or {})
        if state:
            _save_npz(zf, "state.npz", state)
        if opt_state is not None:
            _save_npz(zf, "updater_state.npz",
                      {str(i): leaf for i, leaf in
                       enumerate(tree_leaves(opt_state))})
        if normalizer is not None:
            zf.writestr("normalizer.json", json.dumps(normalizer.to_dict()))


def load_normalizer(path: str):
    """The data normalizer saved in the zip at ``path``, or None."""
    from ..data.normalizers import Normalizer

    with zipfile.ZipFile(path) as zf:
        if "normalizer.json" not in zf.namelist():
            return None
        return Normalizer.from_dict(json.loads(
            zf.read("normalizer.json").decode()))


def load_opt_state(path: str, template, device: DeviceLike = None):
    """The updater state saved in the zip at ``path``, rebuilt with
    ``template``'s structure (see :func:`opt_state_from_numpy`), or None
    when the zip holds none."""
    with zipfile.ZipFile(path) as zf:
        if "updater_state.npz" not in zf.namelist():
            return None
        with zf.open("updater_state.npz") as f:
            data = np.load(io.BytesIO(f.read()))
            leaves = [data[str(i)] for i in range(len(data.files))]
    return opt_state_from_numpy(template, leaves, device)


def load_model(path: str, device: DeviceLike = None
               ) -> Tuple[Union[Sequential, Graph], dict, dict]:
    """Read a model zip (a Sequential or a Graph) onto ``device`` (the
    card unless named). Returns ``(model, params, state)``;
    ``model.params``/``state`` are set."""
    dev = resolve_device(device)
    with zipfile.ZipFile(path) as zf:
        model = model_from_json(zf.read("configuration.json").decode(),
                                device=dev)
        params = params_from_numpy(model, _load_npz(zf, "params.npz") or {})
        state = state_from_numpy(_load_npz(zf, "state.npz") or {}, dev)
    model.params, model.state = params, state
    return model, params, state
