"""ZeRO-1's layout rule — the part of
``deeplearning4j_tpu/parallel/sharding.py`` that data parallelism needs.

:func:`zero_shard_dim` is the one rule by which an updater-state leaf
shards over ``n`` data-parallel ranks: along its largest dimension that
``n`` divides, or not at all. :func:`zero_opt_spec` gives it as a spec
(a tuple with the data axis at that dimension, None elsewhere).

The rule tables for tensor and sequence parallelism, ``spec_for``,
``place_params`` and activation sharding are not ported yet (ROADMAP.md,
Queue 1: item 19).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from .mesh import DATA_AXIS

NOT_PORTED_RULES = ("not ported yet (ROADMAP.md, Queue 1: item 19, tensor, "
                    "sequence and pipeline parallelism)")


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


def zero_opt_spec(shape: Sequence[int], n: int) -> Tuple[Optional[str], ...]:
    """:func:`zero_shard_dim` as a spec over the data axis: () when the
    leaf is kept whole."""
    d = zero_shard_dim(shape, n)
    if d is None:
        return ()
    spec = [None] * len(shape)
    spec[d] = DATA_AXIS
    return tuple(spec)


def not_ported(name):
    """A stand-in for ``parallel.<name>`` that raises, naming item 19."""
    def stub(*args, **kwargs):
        raise NotImplementedError(f"parallel.{name} is {NOT_PORTED_RULES}")

    stub.__name__ = name
    return stub


spec_for = not_ported("spec_for")
shard_params = not_ported("shard_params")
place_params = not_ported("place_params")
sharding_tree = not_ported("sharding_tree")
activation_sharding = not_ported("activation_sharding")
constrain_activations = not_ported("constrain_activations")
