"""The prebuilt-executable store — counterpart of
``deeplearning4j_tpu/aot/``, for the H100.

The reference lowers each serving executable once, serializes it and keys
it by everything that shaped the compile, so replicas boot from disk and
a publish warms the incoming generation before traffic flips onto it.
Nothing like a serialized executable persists on a GPU, so here:

- **The executable is a ``torch.cuda.CUDAGraph`` per (tag, signature,
  params generation)**, captured at warm time over static input and
  output buffers, every graph of one component in one memory pool. A call
  copies its inputs into the static buffers, replays, and reads the
  static outputs. The graph bakes in the weights' addresses, so a publish
  captures the candidate generation's graphs before the flip and the old
  generation's go at the first call on the new one; a fleet page-out
  drops a model's graphs and pool with its weights. On the CPU the
  executable is the eager function, recorded as warmed for its signature:
  strict mode, the counters and the typed errors behave as on the card.
- **The store persists what a second boot would otherwise produce**: the
  kernel libraries ``kernels/_build.py`` builds with nvcc (keyed by the
  runtime fingerprint: torch and CUDA versions, the card's name and
  capability, a hash of ``kernels/csrc``), the coverage record of a
  manifest's signatures, tuned configs and cost profiles. A boot from a
  prebuilt store runs no nvcc. The coverage records decide whether a
  signature is covered: a key one of them names is a store hit, and a
  capture outside a prebuild stamps its key into the runtime's record of
  captures. A "compile" on the serving counters (``compile_counter``) is
  a capture of a key no record names; strict mode raises
  :class:`~..serve.errors.AotTraceError` instead, so there it is 0.
- ``torch.export`` / AOTInductor and ``torch.compile`` are not used: they
  generate kernels of their own in place of the port's.

- :mod:`~.keys` — deterministic cache keys
- :mod:`~.store` — content-addressed on-disk store: atomic
  write-then-rename, index, LRU GC, corrupt-entry quarantine
- :mod:`~.manifest` — a serving config's signature product, coverage
  records and the lookup of covered keys
- :mod:`~.tuned` — tuned serving configs
- :mod:`~.compile` — :class:`AotFunction`, the store-backed wrapper
  ``serve/`` runs through, and the kernel libraries' round trip

``python -m deeplearning4j_torch.aot`` prebuilds, lists, verifies and GCs
a store from the command line.
"""

from .compile import (AotFunction, boot_kernels, graphable, install_kernels,
                      save_kernels)
from .keys import arch_fingerprint, cache_key, call_signature, \
    runtime_fingerprint
from .manifest import (covered_keys, enumerate_config, load_coverage,
                       load_manifest, manifest_hash, missing_signatures,
                       record_coverage)
from .store import AotCorruptEntry, AotStore, AotStoreError, AotVersionError
from .tuned import get_tuned, put_tuned, tuned_group, tuned_key

__all__ = ["AotCorruptEntry", "AotFunction", "AotStore", "AotStoreError",
           "AotVersionError", "arch_fingerprint", "boot_kernels",
           "cache_key", "call_signature", "covered_keys",
           "enumerate_config", "get_tuned",
           "graphable", "install_kernels", "load_coverage", "load_manifest",
           "manifest_hash", "missing_signatures", "put_tuned",
           "record_coverage", "runtime_fingerprint", "save_kernels",
           "tuned_group", "tuned_key"]
