"""Deterministic cache keys — counterpart of
``deeplearning4j_tpu/aot/keys.py``.

A serving graph is only reusable when everything that shaped it matches:
the torch and CUDA versions, the card (its name and compute capability),
the kernel sources the port builds with nvcc, the model architecture
(param tree structure and leaf shapes/dtypes: values never matter, shapes
always do) and the exact call signature (the bucket the serving tier
padded to). Every component lands in one SHA-256, so a mismatch in any of
them is a clean cache miss, never a crash and never a wrong graph.

Key strings are pure functions of their inputs (no timestamps, no paths),
so two processes on identical machines, or the same replica across
restarts, compute identical keys.
"""

from __future__ import annotations

import hashlib
from typing import Any, Iterable, Optional, Sequence, Tuple

_SCHEMA = "aot-torch-v1"  # bump to invalidate every existing key


def kernel_sources_hash() -> str:
    """16-hex digest of every kernel source under ``kernels/csrc`` and the
    nvcc flags: what a built kernel library depends on."""
    from ..kernels import _build

    digest = hashlib.sha256()
    for path in sorted(_build.CSRC.iterdir()):
        if path.is_file():
            digest.update(path.name.encode() + b"\0" + path.read_bytes()
                          + b"\0")
    digest.update("\0".join(_build.NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def runtime_fingerprint(device=None) -> dict:
    """torch/CUDA versions, the backend and the card, and the kernel
    sources' hash, as a stable dict. ``device`` (a ``torch.device`` or
    string) names the backend; None means the CUDA card when there is
    one, else the CPU. Device ordinals are left out: the same graph
    recipe serves any card of the same kind."""
    import torch

    dev = (torch.device(device) if device is not None else
           torch.device("cuda" if torch.cuda.is_available() else "cpu"))
    rt = {"torch": torch.__version__, "cuda": str(torch.version.cuda),
          "backend": dev.type, "kernels": kernel_sources_hash()}
    if dev.type == "cuda":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        major, minor = torch.cuda.get_device_capability(index)
        rt.update(device_kind=torch.cuda.get_device_name(index),
                  capability=f"{major}.{minor}",
                  device_count=torch.cuda.device_count())
    else:
        rt.update(device_kind=dev.type, capability="", device_count=1)
    return rt


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _leaf_sig(leaf: Any) -> str:
    """One tree leaf as a stable string: arrays and tensors by
    shape/dtype (``torch.int32`` reads ``int32``, as numpy's does),
    Python scalars by type."""
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is not None and dtype is not None:
        return f"{tuple(shape)}:{_dtype_name(dtype)}"
    if leaf is None:
        return "none"
    return f"py:{type(leaf).__name__}"


def _flatten(tree: Any) -> Tuple[list, str]:
    """Leaves in a fixed order and the tree's structure as a string
    (dict keys sorted, as JAX's tree utilities order them)."""
    if isinstance(tree, dict):
        leaves, parts = [], []
        for k in sorted(tree):
            sub, struct = _flatten(tree[k])
            leaves += sub
            parts.append(f"{k!r}:{struct}")
        return leaves, "{" + ",".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        leaves, parts = [], []
        for v in tree:
            sub, struct = _flatten(v)
            leaves += sub
            parts.append(struct)
        kind = "[" if isinstance(tree, list) else "("
        return leaves, kind + ",".join(parts) + ("]" if kind == "[" else ")")
    return [tree], "*"


def arch_fingerprint(params: Any, state: Any = None) -> str:
    """Model-architecture hash: param (+state) tree structure and leaf
    shapes/dtypes. Two checkpoints of the same architecture share it; a
    resized layer, changed dtype, or restructured tree does not."""
    parts = []
    for tag, tree in (("params", params), ("state", state)):
        leaves, struct = _flatten(tree)
        parts.append(f"{tag}|{struct}|"
                     + ";".join(_leaf_sig(leaf) for leaf in leaves))
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:16]


def call_signature(args: Sequence[Any]) -> Tuple[str, ...]:
    """The bucket signature of one call: leaf shapes/dtypes plus the
    argument structure. Hashable (a tuple of strings), so it doubles as
    the in-memory graph-map key."""
    leaves, struct = _flatten(tuple(args))
    return tuple(_leaf_sig(leaf) for leaf in leaves) + (struct,)


def cache_key(tag: str, arch: str, sig: Iterable[str],
              donate: Sequence[int] = (),
              runtime: Optional[dict] = None,
              extra: str = "") -> str:
    """One SHA-256 hex key from every component that shapes a graph.

    ``tag`` names the function (``gen_decode_paged``, ``engine_forward``,
    ...): two programs with identical signatures must not collide.
    ``runtime`` defaults to :func:`runtime_fingerprint`, injectable so
    tests can simulate an upgrade and see it miss cleanly. ``donate`` is
    kept for the reference's key layout (the port donates nothing)."""
    rt = runtime if runtime is not None else runtime_fingerprint()
    material = "\x1f".join([
        _SCHEMA, tag, arch,
        "|".join(f"{k}={rt[k]}" for k in sorted(rt)),
        "|".join(sig),
        "donate=" + ",".join(str(int(i)) for i in donate),
        extra,
    ])
    return hashlib.sha256(material.encode()).hexdigest()
